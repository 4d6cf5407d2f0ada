"""The variational-density-propagation U-Net, parameterized over depth.

One model covers both reference variants (SURVEY.md §2.2):
- Hippocampus: depth 3, 64x64x1 -> [B, 54*54, 3] (`Hippocampus.py:335-421`)
- BraTS: depth 5 with a (1,0) pre-pad on the bottleneck block,
  204x204x4 -> [B, 186*186, 5] (`Brats.py:323-457`)

Design: a pure-functional model — parameters are a flat dict
``{layer_name: {"w_mu": [k,k,Cin,Cout], "w_sigma": [Cout]}}`` — so the
forward pass is a plain jittable function, checkpointing is a pytree dump,
and the Keras-H5 importer (supernet_tpu.checkpoint) can key directly on the
reference's layer names (`conv_input`, `conv1..conv9`, `up{j}_conv2x2`,
`up{j}_conv1`, `up{j}_conv2`, `conv_final`).

Block choreography (rigid in the reference, `Hippocampus.py:373-421`):
  encoder block i:  [pre-pad?] conv3 -> relu -> conv3 -> relu -> [pool if i<d]
  decoder block j:  unpool -> conv2 -> pad(3,3) -> concat(skip d-j) ->
                    conv3 -> relu -> pad(2,2) -> conv3 -> relu
  head:             conv1x1 -> vsoftmax  (flattened [B, H*W, C] outputs)

Here conv+relu pairs go through ``vconv_relu`` and unpool+conv2 collapses to four parity 1x1 convs (vunpool_conv2) —
numerically identical to the reference choreography, proven in tests.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

from supernet_tpu.configs import ModelConfig
from supernet_tpu.ops import (
    crop_center,
    vconv,
    vconv_input_relu,
    vconv_relu,
    vcrop_concat,
    vglue_conv_relu,
    vmaxpool,
    vpad,
    vsoftmax,
    vunpool_conv2,
)
from supernet_tpu.ops.moments import get_backend, get_glue_fold

Array = jax.Array
Params = Dict[str, Dict[str, Array]]


def _encoder_channels(cfg: ModelConfig) -> List[int]:
    """Channels of encoder block i (1-indexed): base * 2^(i-1)."""
    return [cfg.base_kernels * (2 ** i) for i in range(cfg.depth)]


def _decoder_channels(cfg: ModelConfig) -> List[int]:
    """Channels of decoder block j (1-indexed): base * 2^(depth-1-j)."""
    return [
        cfg.base_kernels * (2 ** (cfg.depth - 2 - j))
        for j in range(cfg.depth - 1)
    ]


def layer_names(cfg: ModelConfig) -> List[Tuple[str, int, int, int]]:
    """Ordered (name, ksize, c_in, c_out) of every conv layer.

    Names mirror the reference's attribute names so checkpoints map 1:1:
    encoder convs are ``conv_input, conv1, conv2, conv3, ...`` (two per
    block), decoder blocks are ``up{j}_conv2x2 / up{j}_conv1 / up{j}_conv2``,
    head is ``conv_final``.
    """
    enc = _encoder_channels(cfg)
    dec = _decoder_channels(cfg)
    out: List[Tuple[str, int, int, int]] = []
    c_prev = cfg.in_channels
    # Encoder block i (0-indexed): convs named conv{2i} and conv{2i+1},
    # except block 0's first conv which is conv_input
    # (Hippocampus.py:343-350, Brats.py:331-345).
    for i, c in enumerate(enc):
        first_name = "conv_input" if i == 0 else f"conv{2 * i}"
        out.append((first_name, 3, c_prev, c))
        out.append((f"conv{2 * i + 1}", 3, c, c))
        c_prev = c
    for j, c in enumerate(dec, start=1):
        out.append((f"up{j}_conv2x2", 2, c_prev, c))
        # after concat with the skip (same channel count c):
        out.append((f"up{j}_conv1", 3, 2 * c, c))
        out.append((f"up{j}_conv2", 3, c, c))
        c_prev = c
    out.append(("conv_final", 1, c_prev, cfg.n_classes))
    return out


def _tight_layers(cfg: ModelConfig) -> set:
    """Layers initialized with the tighter sigma range [-4.6, -2.2]:
    the first ``tight_upconvs`` decoder 2x2 convs and the 1x1 head
    (`Hippocampus.py:354-363`, `Brats.py:349-367`)."""
    names = {f"up{j}_conv2x2" for j in range(1, cfg.tight_upconvs + 1)}
    names.add("conv_final")
    return names


def init_params(key: Array, cfg: ModelConfig) -> Params:
    """TruncatedNormal(mean_mu, mean_sigma) for w_mu (truncated at 2 std,
    matching ``tf.keras.initializers.TruncatedNormal``), Uniform on the raw
    (pre-softplus) w_sigma (`Hippocampus.py:109-123`)."""
    params: Params = {}
    tight = _tight_layers(cfg)
    for name, k, cin, cout in layer_names(cfg):
        key, k1, k2 = jax.random.split(key, 3)
        w_mu = cfg.mean_mu + cfg.mean_sigma * jax.random.truncated_normal(
            k1, -2.0, 2.0, (k, k, cin, cout), dtype=jnp.float32
        )
        lo, hi = (
            (cfg.tight_sigma_min, cfg.tight_sigma_max)
            if name in tight
            else (cfg.sigma_min, cfg.sigma_max)
        )
        w_sigma = jax.random.uniform(
            k2, (cout,), minval=lo, maxval=hi, dtype=jnp.float32
        )
        params[name] = {"w_mu": w_mu, "w_sigma": w_sigma}
    return params


def kl_regularizer(params: Params) -> Array:
    """Sum of the per-layer weight regularizers, equal to the reference's
    ``tf.math.add_n(model.losses)`` (`Hippocampus.py:526`):

      l2:     1.0 * sum(w_mu^2)                      (Hippocampus.py:116)
      KL:     -k^2 * mean(1 + log softplus(ws) - softplus(ws))
                                                     (Hippocampus.py:325-331)
    """
    total = jnp.float32(0.0)
    for p in params.values():
        w_mu, w_sigma = p["w_mu"], p["w_sigma"]
        k = w_mu.shape[0]
        total = total + jnp.sum(jnp.square(w_mu))
        f_s = jax.nn.softplus(w_sigma)
        total = total - (k * k) * jnp.mean(1.0 + jnp.log(f_s) - f_s)
    return total


def forward(
    params: Params, x: Array, cfg: ModelConfig, tap=None, constrain=None
) -> Tuple[Array, Array]:
    """Full VDP forward pass: image [B,H,W,Cin] -> (probs, sigma), both
    flattened to [B, H_out*W_out, n_classes] like the reference
    (`Hippocampus.py:419-421`).

    ``tap(stage_name, shape)``, when given, is called with every
    intermediate's shape during tracing — used (under ``jax.eval_shape``) to
    pin the exact pad/crop/pool choreography against the reference's
    documented chains (`Hippocampus.py:375-418`, `Brats.py:379-455`). It
    must be None for jitted production calls.

    ``constrain(m, s) -> (m, s)``, when given, is applied to the moment pair
    after every block — the hook ``parallel.spatial.make_spatial_forward``
    uses to re-pin the H axis's mesh sharding (GSPMD spatial partitioning)
    between blocks.
    """
    depth = cfg.depth
    fill = cfg.sigma_fill
    # "fold" computes each pad -> (concat ->) conv -> relu stage
    # algebraically inside the conv (ops.moments.vglue_conv_relu) so the
    # padded/cropped/concatenated tensors never hit HBM; the naive backend
    # must keep the explicit choreography (it IS the reference algorithm).
    glue_fold = get_glue_fold() == "fold" and get_backend() != "naive"
    if constrain is None:
        constrain = lambda m, s: (m, s)  # noqa: E731

    def _tap(name: str, m: Array) -> None:
        if tap is not None:
            tap(name, tuple(m.shape))

    def conv(name: str, m: Array, s: Array) -> Tuple[Array, Array]:
        p = params[name]
        # named_scope puts the layer name into the HLO metadata op_name —
        # trace-time only, no runtime effect; tools/exact_join.py
        # --by-layer keys per-layer attribution on it
        with jax.named_scope(name):
            m, s = vconv(m, s, p["w_mu"], p["w_sigma"])
        _tap(name, m)
        return m, s

    def conv_relu(name: str, m: Array, s: Array) -> Tuple[Array, Array]:
        p = params[name]
        with jax.named_scope(name):
            m, s = vconv_relu(m, s, p["w_mu"], p["w_sigma"])
        _tap(name, m)
        return m, s

    def block(fn):
        # cfg.remat: recompute each block's activations during backprop
        # instead of keeping the (mu, sigma) pairs live — halves peak HBM
        # for BraTS-scale training at ~1/3 extra forward FLOPs. The block
        # index (arg 0) is static: it selects parameter names.
        return jax.checkpoint(fn, static_argnums=(0,)) if cfg.remat else fn

    def encoder_block(i: int, m: Array, s: Array) -> Tuple[Array, Array]:
        if i == depth - 1 and cfg.bottleneck_pre_pad is not None:
            if glue_fold:
                p = params[f"conv{2 * i}"]
                with jax.named_scope(f"conv{2 * i}"):
                    m, s = vglue_conv_relu(
                        m, s, p["w_mu"], p["w_sigma"],
                        cfg.bottleneck_pre_pad, fill,
                    )
                _tap(f"conv{2 * i}", m)
                return conv_relu(f"conv{2 * i + 1}", m, s)
            m, s = vpad(m, s, cfg.bottleneck_pre_pad, fill)
            _tap("pre_pad", m)
        m, s = conv_relu(f"conv{2 * i}", m, s)
        return conv_relu(f"conv{2 * i + 1}", m, s)

    def decoder_block(
        j: int, m: Array, s: Array, m_e: Array, s_e: Array
    ) -> Tuple[Array, Array]:
        # fused unpool + 2x2 conv: the zero-interleave means one nonzero
        # input per conv window — four 1x1 convs, 4x fewer FLOPs (see
        # ops.moments.vunpool_conv2)
        p = params[f"up{j}_conv2x2"]
        with jax.named_scope(f"up{j}_conv2x2"):
            m, s = vunpool_conv2(m, s, p["w_mu"], p["w_sigma"])
        _tap(f"up{j}_conv2x2", m)
        if glue_fold:
            p1, p2 = params[f"up{j}_conv1"], params[f"up{j}_conv2"]
            with jax.named_scope(f"up{j}_conv1"):
                m, s = vglue_conv_relu(
                    m, s, p1["w_mu"], p1["w_sigma"], (3, 3), fill, m_e, s_e
                )
            _tap(f"up{j}_conv1", m)
            with jax.named_scope(f"up{j}_conv2"):
                m, s = vglue_conv_relu(
                    m, s, p2["w_mu"], p2["w_sigma"], (2, 2), fill
                )
            _tap(f"up{j}_conv2", m)
            return m, s
        m, s = vpad(m, s, (3, 3), fill)
        _tap(f"up{j}_pad", m)
        m, s = vcrop_concat(m, s, m_e, s_e)
        _tap(f"up{j}_concat", m)
        m, s = conv_relu(f"up{j}_conv1", m, s)
        m, s = vpad(m, s, (2, 2), fill)
        _tap(f"up{j}_pad2", m)
        return conv_relu(f"up{j}_conv2", m, s)

    skips: List[Tuple[Array, Array]] = []
    p = params["conv_input"]
    with jax.named_scope("conv_input"):
        m, s = vconv_input_relu(x, p["w_mu"], p["w_sigma"])
    _tap("conv_input", m)
    m, s = conv_relu("conv1", m, s)
    m, s = constrain(m, s)
    for i in range(depth):
        if i > 0:
            m, s = block(encoder_block)(i, m, s)
            m, s = constrain(m, s)
        if i < depth - 1:
            skips.append((m, s))
            m, s = vmaxpool(m, s)
            _tap(f"pool{i}", m)
            m, s = constrain(m, s)

    for j in range(1, depth):
        m_e, s_e = skips[depth - 1 - j]
        m, s = block(decoder_block)(j, m, s, m_e, s_e)
        m, s = constrain(m, s)

    m, s = conv("conv_final", m, s)
    return vsoftmax(m, s)


def sample_weights(params: Params, key: Array) -> Dict[str, Array]:
    """One draw from the weight posterior: w ~ N(w_mu, softplus(w_sigma))
    per conv layer (the per-output-channel variance broadcast over the
    kernel, `Hippocampus.py:94-136`). Feed to `forward_sampled` for the
    Monte-Carlo ensemble the VDP moments approximate."""
    out: Dict[str, Array] = {}
    for name, p in params.items():
        key, sub = jax.random.split(key)
        s_w = jax.nn.softplus(p["w_sigma"])  # [Cout]
        eps = jax.random.normal(sub, p["w_mu"].shape, p["w_mu"].dtype)
        out[name] = p["w_mu"] + jnp.sqrt(s_w) * eps
    return out


def forward_sampled(
    weights: Dict[str, Array], x: Array, cfg: ModelConfig
) -> Array:
    """Deterministic twin of `forward`: ONE ordinary U-Net pass with
    concrete conv kernels (e.g. from `sample_weights`); returns softmax
    probabilities [B, H_out*W_out, n_classes].

    Exactly the architecture the moment propagation models — VALID convs,
    relu, 2x2/2 max pool, zero-interleave unpool + 2x2 conv, the [3,3]/[2,2]
    pad choreography, crop-concat skips (`Hippocampus.py:373-421`) — so
    `vmap(forward_sampled)` over weight draws is the MC ground truth that
    `forward`'s (probs, sigma) approximate (tested full-model in
    test_moments.py). Also usable as a plain (non-Bayesian) U-Net or an
    MC-ensemble baseline at inference."""
    from jax import lax

    depth = cfg.depth

    def conv(name: str, h: Array) -> Array:
        from supernet_tpu.ops.moments import get_mxu_precision

        # same matmul precision as the propagated path, so MC-vs-VDP
        # comparisons measure the method, not the multiply mode
        return lax.conv_general_dilated(
            h, weights[name], (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=get_mxu_precision(),
        )

    def conv_relu(name: str, h: Array) -> Array:
        return jax.nn.relu(conv(name, h))

    def pad(h: Array, p) -> Array:
        # p = (lo, hi) applied to BOTH spatial dims, vpad's convention
        # (mypadding, incl. the asymmetric BraTS bottleneck (1, 0))
        lo, hi = (p, p) if isinstance(p, int) else p
        return jnp.pad(h, ((0, 0), (lo, hi), (lo, hi), (0, 0)))

    def unpool_conv2(name: str, h: Array) -> Array:
        # zero-interleave to 2w+1 with a 1-px top/left pad, then 2x2 VALID
        # (`Hippocampus.py:26-51,200-208`; same lo=1,hi=1,interior=1 pad as
        # ops.moments._unpool_one)
        h = lax.pad(
            h, jnp.zeros((), h.dtype),
            ((0, 0, 0), (1, 1, 1), (1, 1, 1), (0, 0, 0)),
        )
        return conv(name, h)

    def crop_concat(h: Array, enc: Array) -> Array:
        # decoder channels FIRST, like vcrop_concat and the reference's
        # tf.concat([muD, mu_cropped]) (`Hippocampus.py:268`) — the twin
        # must bind w[:, :, :c] to the same channel block as `forward`
        size = h.shape[1]
        return jnp.concatenate([h, crop_center(enc, size, size)], axis=-1)

    skips: List[Array] = []
    h = conv_relu("conv_input", x)
    h = conv_relu("conv1", h)
    for i in range(depth):
        if i > 0:
            if i == depth - 1 and cfg.bottleneck_pre_pad is not None:
                h = pad(h, cfg.bottleneck_pre_pad)
            h = conv_relu(f"conv{2 * i}", h)
            h = conv_relu(f"conv{2 * i + 1}", h)
        if i < depth - 1:
            skips.append(h)
            h = lax.reduce_window(
                h, -jnp.inf, lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "SAME"
            )
    for j in range(1, depth):
        h = unpool_conv2(f"up{j}_conv2x2", h)
        h = pad(h, (3, 3))
        h = crop_concat(h, skips[depth - 1 - j])
        h = conv_relu(f"up{j}_conv1", h)
        h = pad(h, (2, 2))
        h = conv_relu(f"up{j}_conv2", h)
    h = conv("conv_final", h)
    b, hh, ww, c = h.shape
    return jax.nn.softmax(h.reshape(b, hh * ww, c), axis=-1)


def forward_images(
    params: Params, x: Array, cfg: ModelConfig
) -> Tuple[Array, Array]:
    """Forward pass returning image-shaped [B, H_out, W_out, C] moments."""
    probs, sigma = forward(params, x, cfg)
    b = x.shape[0]
    hw = probs.shape[1]
    side = int(math.isqrt(hw))
    return (
        probs.reshape(b, side, side, cfg.n_classes),
        sigma.reshape(b, side, side, cfg.n_classes),
    )


class VDPUNet:
    """Thin OO wrapper bundling a config with the functional API.

    ``model = VDPUNet(cfg); params = model.init(key); probs, sigma =
    model.apply(params, x)``.
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, key: Array) -> Params:
        return init_params(key, self.cfg)

    def apply(self, params: Params, x: Array) -> Tuple[Array, Array]:
        return forward(params, x, self.cfg)

    def apply_images(self, params: Params, x: Array) -> Tuple[Array, Array]:
        return forward_images(params, x, self.cfg)

    def kl(self, params: Params) -> Array:
        return kl_regularizer(params)

    @property
    def n_params(self) -> int:
        return sum(
            math.prod(s)
            for _, k, cin, cout in layer_names(self.cfg)
            for s in ((k, k, cin, cout), (cout,))
        )
