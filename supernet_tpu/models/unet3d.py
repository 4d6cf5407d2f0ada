"""Volumetric (3-D) VDP U-Net — net-new model family.

The reference discards volumetric context by slicing the MSD/BraTS 3-D
volumes into 2-D images (`Hippocampus.py:479-481`); this model applies the
same architecture — VALID convs, relu, 2^3 max pool, zero-interleave
unpool + 2-kernel conv, the [3,3]/[2,2] pad choreography, crop-concat
skips, softmax-moment head (`Hippocampus.py:335-421`, one rank up) — to
whole sub-volumes, consuming what `data/nifti.py` reads directly.

Reuses `ModelConfig` (image_size = cube side; out_size follows the
identical per-axis arithmetic, so e.g. 64 -> 54 at depth 3 exactly like
2-D) and the 2-D loss head: the flattened [B, D*H*W, C] output feeds
`losses.nll_gaussian` / `train`'s ELBO unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

from supernet_tpu.configs import ModelConfig
from supernet_tpu.models.unet import _decoder_channels, _encoder_channels
from supernet_tpu.ops.moments import get_backend, get_glue_fold
from supernet_tpu.ops.moments3d import (
    vconv3d,
    vconv3d_input,
    vconv3d_relu,
    vcrop_concat3d,
    vglue_conv3d_relu,
    vmaxpool3d,
    vpad3d,
    vrelu,
    vsoftmax3d,
    vunpool3d_conv2,
)

Array = jax.Array
Params = Dict[str, Dict[str, Array]]


def layer_names3d(cfg: ModelConfig) -> List[Tuple[str, int, int, int]]:
    """(name, k, cin, cout) per conv layer — the 2-D naming scheme with
    k^3 kernels (kernel shape [k, k, k, cin, cout])."""
    enc = _encoder_channels(cfg)
    dec = _decoder_channels(cfg)
    names: List[Tuple[str, int, int, int]] = [
        ("conv_input", 3, cfg.in_channels, enc[0]),
        ("conv1", 3, enc[0], enc[0]),
    ]
    for i in range(1, cfg.depth):
        names.append((f"conv{2 * i}", 3, enc[i - 1], enc[i]))
        names.append((f"conv{2 * i + 1}", 3, enc[i], enc[i]))
    ch = enc[cfg.depth - 1]
    for j in range(1, cfg.depth):
        up = dec[j - 1]
        names.append((f"up{j}_conv2x2", 2, ch, up))
        names.append((f"up{j}_conv1", 3, up + enc[cfg.depth - 1 - j], up))
        names.append((f"up{j}_conv2", 3, up, up))
        ch = up
    names.append(("conv_final", 1, ch, cfg.n_classes))
    return names


def init_params3d(key: Array, cfg: ModelConfig) -> Params:
    """Same init scheme as 2-D (`models.unet.init_params`,
    `Hippocampus.py:97-123`): TruncatedNormal(0, mean_sigma) clipped at
    2 sigma for w_mu; Uniform[sigma_min, sigma_max] raw sigma, the tighter
    range on the leading decoder 2-kernel convs + head."""
    from supernet_tpu.models.unet import _tight_layers

    tight = _tight_layers(cfg)
    params: Params = {}
    for name, k, cin, cout in layer_names3d(cfg):
        key, k1, k2 = jax.random.split(key, 3)
        w_mu = cfg.mean_mu + cfg.mean_sigma * jax.random.truncated_normal(
            k1, -2.0, 2.0, (k, k, k, cin, cout), jnp.float32
        )
        lo, hi = (
            (cfg.tight_sigma_min, cfg.tight_sigma_max)
            if name in tight
            else (cfg.sigma_min, cfg.sigma_max)
        )
        w_sigma = jax.random.uniform(k2, (cout,), jnp.float32, lo, hi)
        params[name] = {"w_mu": w_mu, "w_sigma": w_sigma}
    return params


def kl_regularizer3d(params: Params) -> Array:
    """As `models.unet.kl_regularizer` with the KL strength equal to the
    kernel's spatial size — k^3 here (the reference's ``sigma_regularizer
    (k*k)``, `Hippocampus.py:325-331`, generalized)."""
    total = jnp.float32(0.0)
    for p in params.values():
        w_mu, w_sigma = p["w_mu"], p["w_sigma"]
        strength = math.prod(w_mu.shape[:-2])
        total = total + jnp.sum(jnp.square(w_mu))
        f_s = jax.nn.softplus(w_sigma)
        total = total - strength * jnp.mean(1.0 + jnp.log(f_s) - f_s)
    return total


def forward3d(
    params: Params, x: Array, cfg: ModelConfig, tap=None, constrain=None
) -> Tuple[Array, Array]:
    """Volume [B, S, S, S, Cin] -> (probs, sigma), both
    [B, out_size^3, n_classes].

    ``constrain(m, s) -> (m, s)``, when given, is applied to the moment
    pair after every block — the hook
    `parallel.spatial.make_spatial_forward3d` uses to keep the D axis
    mesh-sharded (GSPMD spatial partitioning of whole volumes)."""
    depth = cfg.depth
    fill = cfg.sigma_fill
    # same knob as the 2-D family: "fold" computes each pad -> (concat ->)
    # conv -> relu stage algebraically inside the conv (vglue_conv3d_relu)
    glue_fold = get_glue_fold() == "fold" and get_backend() != "naive"
    if constrain is None:
        constrain = lambda m, s: (m, s)  # noqa: E731

    def _tap(name: str, m: Array) -> None:
        if tap is not None:
            tap(name, tuple(m.shape))

    def conv_relu(name: str, m: Array, s: Array) -> Tuple[Array, Array]:
        p = params[name]
        # named_scope -> HLO metadata op_name; trace-time only, used by
        # tools/exact_join.py --by-layer for per-layer attribution
        with jax.named_scope(name):
            m, s = vconv3d_relu(m, s, p["w_mu"], p["w_sigma"])
        _tap(name, m)
        return m, s

    def block(fn):
        return jax.checkpoint(fn, static_argnums=(0,)) if cfg.remat else fn

    def encoder_block(i: int, m: Array, s: Array) -> Tuple[Array, Array]:
        if i == depth - 1 and cfg.bottleneck_pre_pad is not None:
            if glue_fold:
                p = params[f"conv{2 * i}"]
                with jax.named_scope(f"conv{2 * i}"):
                    m, s = vglue_conv3d_relu(
                        m, s, p["w_mu"], p["w_sigma"],
                        cfg.bottleneck_pre_pad, fill,
                    )
                _tap(f"conv{2 * i}", m)
                return conv_relu(f"conv{2 * i + 1}", m, s)
            m, s = vpad3d(m, s, cfg.bottleneck_pre_pad, fill)
            _tap("pre_pad", m)
        m, s = conv_relu(f"conv{2 * i}", m, s)
        return conv_relu(f"conv{2 * i + 1}", m, s)

    def decoder_block(
        j: int, m: Array, s: Array, m_e: Array, s_e: Array
    ) -> Tuple[Array, Array]:
        p = params[f"up{j}_conv2x2"]
        with jax.named_scope(f"up{j}_conv2x2"):
            m, s = vunpool3d_conv2(m, s, p["w_mu"], p["w_sigma"])
        _tap(f"up{j}_conv2x2", m)
        if glue_fold:
            p1, p2 = params[f"up{j}_conv1"], params[f"up{j}_conv2"]
            with jax.named_scope(f"up{j}_conv1"):
                m, s = vglue_conv3d_relu(
                    m, s, p1["w_mu"], p1["w_sigma"], (3, 3), fill, m_e, s_e
                )
            _tap(f"up{j}_conv1", m)
            with jax.named_scope(f"up{j}_conv2"):
                m, s = vglue_conv3d_relu(
                    m, s, p2["w_mu"], p2["w_sigma"], (2, 2), fill
                )
            _tap(f"up{j}_conv2", m)
            return m, s
        m, s = vpad3d(m, s, (3, 3), fill)
        m, s = vcrop_concat3d(m, s, m_e, s_e)
        _tap(f"up{j}_concat", m)
        m, s = conv_relu(f"up{j}_conv1", m, s)
        m, s = vpad3d(m, s, (2, 2), fill)
        return conv_relu(f"up{j}_conv2", m, s)

    skips: List[Tuple[Array, Array]] = []
    p = params["conv_input"]
    with jax.named_scope("conv_input"):
        m, s = vrelu(*vconv3d_input(x, p["w_mu"], p["w_sigma"]))
    _tap("conv_input", m)
    m, s = conv_relu("conv1", m, s)
    m, s = constrain(m, s)
    for i in range(depth):
        if i > 0:
            m, s = block(encoder_block)(i, m, s)
            m, s = constrain(m, s)
        if i < depth - 1:
            skips.append((m, s))
            m, s = vmaxpool3d(m, s)
            _tap(f"pool{i}", m)
            m, s = constrain(m, s)

    for j in range(1, depth):
        m_e, s_e = skips[depth - 1 - j]
        m, s = block(decoder_block)(j, m, s, m_e, s_e)
        m, s = constrain(m, s)

    p = params["conv_final"]
    with jax.named_scope("conv_final"):
        m, s = vconv3d(m, s, p["w_mu"], p["w_sigma"])
    _tap("conv_final", m)
    return vsoftmax3d(m, s)


def forward_sampled3d(
    weights: Dict[str, Array], x: Array, cfg: ModelConfig
) -> Array:
    """Deterministic twin of `forward3d`: ONE ordinary 3-D U-Net pass with
    concrete conv kernels (e.g. from `models.unet.sample_weights`, which is
    parameter-structure generic); returns softmax probabilities
    [B, out_size^3, n_classes].

    Exactly the architecture the 3-D moment propagation models — so mapping
    it over N posterior weight draws is the Monte-Carlo ensemble whose
    empirical (mean, variance) `forward3d`'s one propagated pass
    approximates (the volumetric analog of the 2-D MC baseline,
    `evaluate._forward_fn(mc_samples=N)`)."""
    from jax import lax

    depth = cfg.depth

    def conv(name: str, h: Array) -> Array:
        from supernet_tpu.ops.moments import get_mxu_precision

        # same matmul precision as the propagated path (see the 2-D twin)
        return lax.conv_general_dilated(
            h, weights[name], (1, 1, 1), "VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=get_mxu_precision(),
        )

    def conv_relu(name: str, h: Array) -> Array:
        return jax.nn.relu(conv(name, h))

    def pad(h: Array, p) -> Array:
        lo, hi = (p, p) if isinstance(p, int) else p
        return jnp.pad(
            h, ((0, 0), (lo, hi), (lo, hi), (lo, hi), (0, 0))
        )

    def unpool_conv2(name: str, h: Array) -> Array:
        # zero-interleave to 2n+1 per axis with a 1-voxel lo/hi pad, then
        # 2^3 VALID conv — `ops.moments3d.vunpool3d_conv2`'s mean path
        h = lax.pad(
            h, jnp.zeros((), h.dtype),
            ((0, 0, 0), (1, 1, 1), (1, 1, 1), (1, 1, 1), (0, 0, 0)),
        )
        return conv(name, h)

    def crop_concat(h: Array, enc: Array) -> Array:
        from supernet_tpu.ops.moments3d import crop_center3d

        # decoder channels first — must mirror `vcrop_concat3d` exactly or
        # the sampled twin consumes transposed channel groups
        d, hh, w = h.shape[1:4]
        return jnp.concatenate([h, crop_center3d(enc, d, hh, w)], axis=-1)

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
                h, -jnp.inf, lax.max,
                (1, 2, 2, 2, 1), (1, 2, 2, 2, 1), "SAME",
            )
    for j in range(1, depth):
        h = unpool_conv2(f"up{j}_conv2x2", h)
        h = pad(h, (3, 3))
        h = crop_concat(h, skips[depth - 1 - j])
        h = conv_relu(f"up{j}_conv1", h)
        h = pad(h, (2, 2))
        h = conv_relu(f"up{j}_conv2", h)
    h = conv("conv_final", h)
    b = h.shape[0]
    c = h.shape[-1]
    return jax.nn.softmax(h.reshape(b, -1, c), axis=-1)
