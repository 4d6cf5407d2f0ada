"""Variational-density-propagation (VDP) moment primitives.

Each primitive pushes the first two moments (mean ``mu`` and diagonal
variance ``sigma``, both NHWC ``float32``) of the activation distribution
through one network operation, matching the analytic forms of the reference
(`Hippocampus.py:26-331`, `Brats.py:34-320`) but re-derived for XLA:

* The reference computes the three variance terms of a Bayesian conv with
  ``tf.image.extract_patches`` + dense matmuls, materializing
  ``[B, H'W', k^2*C]`` patch matrices (up to ~1.7 GB transient per layer on
  BraTS — `Brats.py:118-137`). Because the kernel variance ``softplus(w_sigma)``
  is a *per-output-channel scalar*, every variance term is itself a
  convolution:

      sigma1 = patches(mu^2)    @ bcast(s_w)  ==  winsum(mu^2)    * s_w
      sigma2 = patches(sigma)   @ w_mu^2      ==  conv(sigma, w_mu^2)
      sigma3 = patches(sigma)   @ bcast(s_w)  ==  winsum(sigma)   * s_w

  where ``winsum`` is a windowed sum over the k x k receptive field *and*
  input channels. So one VDP conv = 2 convolutions + 1 cheap elementwise
  window-sum — one HBM pass over (mu, sigma), zero patch materialization.

* ``vrelu`` needs no autodiff tape (the reference runs an inner
  ``tf.GradientTape`` per call, `Hippocampus.py:85-90`): the first-order
  Taylor factor is just ``(mu > 0)``.

* ``vmaxpool`` replaces ``tf.nn.max_pool_with_argmax`` + flat ``tf.gather``
  (which bakes the batch size into a reshape, `Hippocampus.py:54-64`) with a
  window reshape + ``argmax``/``take_along_axis`` that is batch-size agnostic
  and keeps TF's first-occurrence tie-breaking.

* ``vsoftmax`` collapses the reference's per-pixel ``(J ∘ J) @ sigma`` C x C
  matmul (`Hippocampus.py:273-292`) to the closed form

      sigma_out_c = p_c^2 * ((1 - 2 p_c) sigma_c + sum_j p_j^2 sigma_j)

  which is exact algebra on ``J = diag(p) - p p^T`` and purely elementwise.

All ops are shape-polymorphic pure functions, safe under ``jit``, ``grad``,
``vmap`` and ``shard_map``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array
MomentPair = Tuple[Array, Array]

# NHWC activations, HWIO kernels.
_DIMSPEC = ("NHWC", "HWIO", "NHWC")

# Matmul precision for the moment convolutions. "highest" = true f32,
# "default" = the backend's fastest f32 mode (TF32 on the GPU's tensor
# cores), with f32 accumulation. The reference is f32 cuDNN, so "highest"
# is the parity-grade default; switch to "default" for speed once a
# model's tolerance is validated.
_PRECISION: str = "highest"


def set_mxu_precision(precision: str) -> None:
    """Set the global matmul precision for moment convs
    ('highest'|'high'|'default')."""
    global _PRECISION
    if precision not in ("highest", "default", "high"):
        raise ValueError(f"unknown precision {precision!r}")
    _PRECISION = precision


def get_mxu_precision() -> str:
    return _PRECISION


# Kernel backend for the VDP convs: "xla" composes lax convolutions;
# "naive" runs the reference's patch-matmul algorithm (ops/naive.py) — the
# float32 reference the tests compare against and a same-hardware baseline
# for bench.py, never a production path.
_BACKEND: str = "xla"


def set_backend(backend: str) -> None:
    if backend not in ("xla", "naive"):
        raise ValueError(f"unknown backend {backend!r}")
    global _BACKEND
    _BACKEND = backend


def get_backend() -> str:
    return _BACKEND


# Conv-fold mode for the XLA backend's variance path:
#   "none"  — 3 kernels per vconv: mu conv, sigma conv, ones-kernel winsum.
#   "sigma" — fold the winsum into the sigma conv as an extra input+output
#             channel (blockdiag [w_mu^2, 0; 0, ones]): 2 kernels, same MACs,
#             no 1->1-channel conv.
#   "full"  — ONE conv for everything: input [mu ‖ sigma ‖ winsum-src],
#             kernel blockdiag [w_mu; w_mu^2; ones] -> [mu_out ‖ sig ‖ ws].
#             2x the MACs of "none" but a single HBM pass; wins only if the
#             layer is bandwidth/launch bound.
# The folds pay a pre-conv concatenate that materializes a full extra
# activation tensor per layer. "none" is the default; the folds are A/B-able
# modes (SUPERNET_CONV_FOLD), not yet measured on the GPU.
_CONV_FOLD: str = "none"

# Window-sum lowering: "shift" = separable slice-adds (elementwise, no
# 1-channel conv), "conv" = ones-kernel VALID conv. See _window_sum.
_WINSUM: str = "shift"


def set_winsum(mode: str) -> None:
    if mode not in ("conv", "shift"):
        raise ValueError(f"unknown winsum mode {mode!r}")
    global _WINSUM
    _WINSUM = mode


def get_winsum() -> str:
    return _WINSUM


def set_conv_fold(mode: str) -> None:
    if mode not in ("none", "sigma", "full"):
        raise ValueError(f"unknown conv fold mode {mode!r}")
    global _CONV_FOLD
    _CONV_FOLD = mode


def get_conv_fold() -> str:
    return _CONV_FOLD


# Decoder glue-fold mode: "fold" computes the decoder's pad -> (concat ->)
# conv stages algebraically inside the conv — the zero mu-pad becomes conv
# padding, the skip crop becomes negative conv padding, the concat becomes
# a channel-block split of the kernel, and the constant sigma_fill border
# becomes two analytic terms — so none of the padded / cropped /
# concatenated moment tensors is materialized in HBM. "none" keeps the
# explicit choreography. A/B via SUPERNET_GLUE_FOLD.
_GLUE_FOLD: str = "none"


def set_glue_fold(mode: str) -> None:
    if mode not in ("none", "fold"):
        raise ValueError(f"unknown glue fold mode {mode!r}")
    global _GLUE_FOLD
    _GLUE_FOLD = mode


def get_glue_fold() -> str:
    return _GLUE_FOLD


# Lowering of the `winsum * s_w` scale:
#   "mul" — broadcast multiply. AD transposes the two broadcasts into
#           transpose-reduces.
#   "dot" — a size-1-contraction einsum [..,1]x[1,Cout]. dot_general's
#           transpose is dot_general, so both backward contractions (the
#           channel spread AND the batchxspace reduce for d s_w) lower as
#           mat-vecs instead of transpose-reduces.
# A/B-able via SUPERNET_SW_SCALE.
_SW_SCALE: str = "mul"


def set_sw_scale(mode: str) -> None:
    if mode not in ("mul", "dot"):
        raise ValueError(f"unknown sw scale mode {mode!r}")
    global _SW_SCALE
    _SW_SCALE = mode


def get_sw_scale() -> str:
    return _SW_SCALE


def scale_sw(ws: Array, s_w: Array) -> Array:
    """`ws [..., 1] * s_w [Cout] -> [..., Cout]` — the per-output-channel
    variance scale shared by every vconv sigma term (SURVEY §7.1 conv-form
    identity; `Hippocampus.py:118-125` does it as patches @ bcast(s_w)).
    Lowering per SUPERNET_SW_SCALE above."""
    s_w = s_w.astype(ws.dtype)
    if _SW_SCALE == "dot":
        return jnp.einsum(
            "...x,xo->...o",
            ws,
            s_w[None, :],
            precision=get_mxu_precision(),
            preferred_element_type=ws.dtype,
        )
    return ws * s_w


# Channel-sum lowering inside the window sums (`sum over C_in` feeding the
# k x k window accumulation):
#   "reduce" — jnp.sum over the minor-most axis.
#   "dot"    — mat-vec against a ones [C, 1] kernel: same bytes, matmul
#              accumulation.
# A/B-able via SUPERNET_CHANSUM.
_CHANSUM: str = "reduce"


def set_chansum(mode: str) -> None:
    if mode not in ("reduce", "dot"):
        raise ValueError(f"unknown chansum mode {mode!r}")
    global _CHANSUM
    _CHANSUM = mode


def get_chansum() -> str:
    return _CHANSUM


def chan_sum(x: Array) -> Array:
    """Sum over the trailing channel axis -> [..., 1], accumulated in f32
    (bf16 accumulation over wide C would inject sqrt(C)-scale sigma noise).
    Lowering per SUPERNET_CHANSUM above."""
    if _CHANSUM == "dot":
        ones = jnp.ones((x.shape[-1], 1), x.dtype)
        return jnp.einsum(
            "...c,co->...o",
            x,
            ones,
            precision=get_mxu_precision(),
            preferred_element_type=jnp.float32,
        )
    return jnp.sum(x.astype(jnp.float32), axis=-1, keepdims=True)


# Activation dtype for the moment tensors between layers. float32 is the
# parity-grade default. bfloat16 halves the HBM traffic of every layer.
# Convs always accumulate in f32 (preferred_element_type); the loss head
# runs in f32.
_ACT_DTYPE = jnp.float32


def set_act_dtype(dtype: str) -> None:
    """Set the inter-layer activation dtype ('float32'|'bfloat16')."""
    global _ACT_DTYPE
    if dtype in ("float32", "f32"):
        _ACT_DTYPE = jnp.float32
    elif dtype in ("bfloat16", "bf16"):
        _ACT_DTYPE = jnp.bfloat16
    else:
        raise ValueError(f"unknown activation dtype {dtype!r}")


def get_act_dtype():
    return _ACT_DTYPE


def apply_env_overrides() -> None:
    """Apply the SUPERNET_* env knobs to the ops-module globals:

    SUPERNET_PRECISION=highest|high|default   (matmul precision, f32 moments)
    SUPERNET_BACKEND=xla|naive                (conv kernel backend)
    SUPERNET_CONV_FOLD=none|sigma|full        (variance-path fusion mode)
    SUPERNET_WINSUM=shift|conv                (window-sum lowering)
    SUPERNET_SW_SCALE=mul|dot                 (winsum * s_w scale lowering)
    SUPERNET_CHANSUM=reduce|dot               (channel-sum lowering)
    SUPERNET_ACT_DTYPE=float32|bfloat16       (inter-layer activation dtype)
    SUPERNET_CONV2D=conv|im2col               (2-D moment-conv lowering)
    SUPERNET_CONV3D=conv|im2col               (3-D moment-conv lowering)

    Called by the CLI entry point and bench.py so one process-level switch
    controls every jitted function built afterwards.
    """
    import os

    v = os.environ.get("SUPERNET_PRECISION")
    if v:
        set_mxu_precision(v)
    v = os.environ.get("SUPERNET_BACKEND")
    if v:
        set_backend(v)
    v = os.environ.get("SUPERNET_CONV_FOLD")
    if v:
        set_conv_fold(v)
    v = os.environ.get("SUPERNET_ACT_DTYPE")
    if v:
        set_act_dtype(v)
    v = os.environ.get("SUPERNET_GLUE_FOLD")
    if v:
        set_glue_fold(v)
    v = os.environ.get("SUPERNET_WINSUM")
    if v:
        set_winsum(v)
    v = os.environ.get("SUPERNET_SW_SCALE")
    if v:
        set_sw_scale(v)
    v = os.environ.get("SUPERNET_CHANSUM")
    if v:
        set_chansum(v)
    v = os.environ.get("SUPERNET_CONV2D")
    if v:
        set_conv2d_impl(v)
    v = os.environ.get("SUPERNET_CONV3D")
    if v:
        # late import: moments3d imports this module at load time
        from supernet_tpu.ops import moments3d

        moments3d.set_conv3d_impl(v)


def _act(x: Array) -> Array:
    """Cast an activation (or a weight entering a conv) to the activation
    dtype. For f32 this is a no-op; for bf16 the cast's transpose also
    returns weight gradients to f32 for the optimizer."""
    return x.astype(_ACT_DTYPE)


def _conv_valid(x: Array, w: Array, stride: int = 1) -> Array:
    """VALID 2-D convolution (cross-correlation), NHWC x HWIO -> NHWC.

    The output dtype matches the input dtype (conv_general_dilated's
    transpose rule rejects mixed in/out dtypes, which reverse-mode AD needs).
    For bf16 inputs the partial products still accumulate in f32; only
    the final output is rounded to bf16.
    """
    return lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(stride, stride),
        padding="VALID",
        dimension_numbers=_DIMSPEC,
        precision=_PRECISION,
        preferred_element_type=x.dtype,
    )


# -- 2-D conv lowering A/B (SUPERNET_CONV2D=conv|im2col) --------------------
# The 2-D twin of moments3d's contraction-packing knob: "im2col" lowers
# the k>1 moment convs as k^2 shifted-slice patch concat + dot_general
# with the packed k^2*C_in contraction (288 at k=3, C_in=32), A/B-testable
# against the conv lowering in pure XLA; "conv" is the default.
_CONV2D_IMPL: str = "conv"


def set_conv2d_impl(mode: str) -> None:
    if mode not in ("conv", "im2col"):
        raise ValueError(f"unknown conv2d impl {mode!r}")
    global _CONV2D_IMPL
    _CONV2D_IMPL = mode


def get_conv2d_impl() -> str:
    return _CONV2D_IMPL


def _im2col2d(x: Array, k: int, stride: int = 1) -> Array:
    """The k^2 VALID-window taps concatenated on channels:
    [B, H, W, C] -> [B, H', W', k^2*C], tap-major (dy, dx) order, C minor
    — ``w.reshape(k^2*C_in, C_out)``'s row order, so ``patches @ w_flat``
    equals the VALID conv."""
    b, h, w, c = x.shape
    taps = [
        x[:, dy:h - (k - 1) + dy:stride, dx:w - (k - 1) + dx:stride, :]
        for dy in range(k) for dx in range(k)
    ]
    return jnp.concatenate(taps, axis=-1)


def _im2col2d_dot(patches: Array, w_flat: Array) -> Array:
    return jnp.einsum(
        "bhwp,po->bhwo",
        patches,
        w_flat.astype(patches.dtype),
        precision=_PRECISION,
        preferred_element_type=patches.dtype,
    )


def _winsum_shift(xc: Array, k: int, stride: int) -> Array:
    """Separable shift-add VALID window sum over every spatial axis of a
    single-channel [B, *spatial, 1] tensor: per axis, the k strided views
    are added elementwise (k-1 adds), so the k^d window sum costs d*(k-1)
    full-tensor adds and no matmul. The transpose is the same chain of
    pads+adds."""
    s = xc
    for axis in range(1, xc.ndim - 1):
        n = s.shape[axis]
        out_len = (n - k) // stride + 1
        acc = lax.slice_in_dim(
            s, 0, (out_len - 1) * stride + 1, stride=stride, axis=axis
        )
        for i in range(1, k):
            acc = acc + lax.slice_in_dim(
                s, i, i + (out_len - 1) * stride + 1, stride=stride,
                axis=axis,
            )
        s = acc
    return s


def _winsum_shift_pads(src: Array, k: int, *pads) -> Array:
    """Shift-add window sum of a single-channel [B, *spatial, 1] tensor with
    per-axis (lo, hi) conv-style padding — positive = zero pad, negative =
    crop (the glue-fold paths express the skip crop as negative conv
    padding). Accumulates in f32, rounds once to src.dtype."""
    s = src.astype(jnp.float32)
    pos = [(0, 0)] + [(max(lo, 0), max(hi, 0)) for lo, hi in pads] + [(0, 0)]
    if any(p != (0, 0) for p in pos):
        s = jnp.pad(s, pos)
    for axis, (lo, hi) in enumerate(pads, start=1):
        a, b = max(-lo, 0), max(-hi, 0)
        if a or b:
            s = lax.slice_in_dim(s, a, s.shape[axis] - b, axis=axis)
    return _winsum_shift(s, k, 1).astype(src.dtype)


def _window_sum(x: Array, k: int, stride: int = 1) -> Array:
    """Sum of x over each k x k VALID window and over all input channels.

    Returns shape [B, H', W', 1]. Two lowerings behind SUPERNET_WINSUM:

    - "shift" (default): channel-sum, then ``_winsum_shift`` — 2(k-1)
      full-tensor adds on a single-channel tensor, no C_in==C_out==1 conv.
    - "conv": the original single-output-channel ones-kernel VALID conv.

    Both are robustly reverse-mode differentiable inside ``jit`` — unlike
    ``lax.reduce_window``, whose generic primitive fails linearization
    under jit(grad) in current JAX (needed by FGSM/PGD, attacks.py).
    """
    # channel reduction accumulates in f32 even under bf16 activations
    # (bf16 accumulation over wide channel dims would inject sqrt(C)-scale
    # noise into sigma); only the single-channel RESULT is stored in the
    # activation dtype — one rounding, same 2^-8 relative error as every
    # other bf16 op in the sigma chain, and it keeps the f32 upcast out of
    # the backward broadcast. The k x k window accumulation stays in f32 in
    # both modes (convs accumulate f32; the shift path adds in f32 and
    # rounds once).
    xc = chan_sum(x)
    if _WINSUM == "shift":
        return _winsum_shift(xc, k, stride).astype(x.dtype)
    ones = jnp.ones((k, k, 1, 1), x.dtype)
    return _conv_valid(xc.astype(x.dtype), ones, stride)


def vconv_input(
    x: Array, w_mu: Array, w_sigma: Array, stride: int = 1
) -> MomentPair:
    """First VDP conv: deterministic input, Gaussian weights.

    Reference: ``myConv_input.call`` (`Hippocampus.py:125-136`).
      mu_out    = conv(x, w_mu)                      (VALID)
      sigma_out = winsum(x^2) * softplus(w_sigma)    (per-output-channel)

    Args:
      x: input image, [B, H, W, C_in].
      w_mu: kernel means, [k, k, C_in, C_out].
      w_sigma: raw (pre-softplus) per-output-channel kernel variances, [C_out].
    """
    if _BACKEND == "naive":
        from supernet_tpu.ops.naive import vconv_input_naive

        return vconv_input_naive(x, w_mu, w_sigma, stride)
    k = w_mu.shape[0]
    s_w = jax.nn.softplus(w_sigma)
    x = _act(x)
    if k == 1 and stride == 1:
        # 1x1 conv: the k x k window-sum over input channels is a plain
        # channel sum — no ones-kernel conv with C_out == 1.
        w2 = _act(w_mu[0, 0])
        mu_out = jnp.einsum(
            "bhwc,co->bhwo",
            x,
            w2,
            precision=_PRECISION,
            preferred_element_type=x.dtype,
        )
        t = jnp.sum(jnp.square(x.astype(jnp.float32)), -1, keepdims=True)
        # cast the single-channel window-sum BEFORE the broadcast multiply:
        # t * s_w at f32 would materialize a full-width f32 tensor per layer
        return _act(mu_out), scale_sw(_act(t), s_w)
    if _CONV_FOLD != "none":
        # one conv computes mu AND the window-sum: input [x ‖ sum(x^2)],
        # kernel blockdiag [w_mu, 0; 0, ones] — the 1-channel winsum rides
        # the mu conv.
        cin, cout = w_mu.shape[2], w_mu.shape[3]
        # f32 accumulation, result in the activation dtype (same policy
        # as _window_sum)
        t = jnp.sum(
            jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True
        ).astype(x.dtype)
        z = jnp.concatenate([x, t], axis=-1)
        kern = jnp.pad(w_mu, ((0, 0), (0, 0), (0, 1), (0, 1)))
        kern = kern.at[:, :, cin, cout].set(1.0)
        out = _conv_valid(z, kern, stride)
        return _act(out[..., :cout]), _act(out[..., cout:] * s_w)
    if _CONV2D_IMPL == "im2col":
        mu_out = _im2col2d_dot(
            _im2col2d(x, k, stride), w_mu.reshape(-1, w_mu.shape[-1])
        )
        ws = _act(_window_sum(jnp.square(x), k, stride))
        return _act(mu_out), scale_sw(ws, s_w)
    mu_out = _conv_valid(x, w_mu, stride)
    ws = _act(_window_sum(jnp.square(x), k, stride))
    return _act(mu_out), scale_sw(ws, s_w)


def vconv(
    mu: Array, sigma: Array, w_mu: Array, w_sigma: Array, stride: int = 1
) -> MomentPair:
    """Intermediate VDP conv: Gaussian input AND Gaussian weights.

    Reference: ``myConv_intermediate.call`` (`Hippocampus.py:178-197`), with
    sigma1 + sigma3 fused into a single window-sum (see module docstring):

      mu_out    = conv(mu, w_mu)
      sigma_out = winsum(mu^2 + sigma) * softplus(w_sigma) + conv(sigma, w_mu^2)
    """
    if _BACKEND == "naive":
        from supernet_tpu.ops.naive import vconv_naive

        return vconv_naive(mu, sigma, w_mu, w_sigma, stride)
    k = w_mu.shape[0]
    cin, cout = w_mu.shape[2], w_mu.shape[3]
    s_w = jax.nn.softplus(w_sigma)
    mu, sigma = _act(mu), _act(sigma)
    if k == 1 and stride == 1:
        # 1x1 conv (the softmax head): window-sum == channel sum; both
        # matmuls are einsums — no conv machinery, no C_out==1 kernel.
        w2 = _act(w_mu[0, 0])
        mu_out = jnp.einsum(
            "bhwc,co->bhwo",
            mu,
            w2,
            precision=_PRECISION,
            preferred_element_type=mu.dtype,
        )
        t = jnp.sum(
            (jnp.square(mu) + sigma).astype(jnp.float32), -1, keepdims=True
        )
        sigma_out = scale_sw(_act(t), s_w) + jnp.einsum(
            "bhwc,co->bhwo",
            sigma,
            jnp.square(w2),
            precision=_PRECISION,
            preferred_element_type=sigma.dtype,
        )
        return _act(mu_out), _act(sigma_out)
    if _CONV_FOLD == "full":
        # ONE conv: input [mu ‖ sigma ‖ sum(mu^2+sigma)], kernel blockdiag
        # [w_mu -> mu_out; w_mu^2 -> sig; ones -> winsum]. 2x the MACs of
        # the split form, but a single kernel / single HBM pass.
        t = jnp.sum(
            (jnp.square(mu) + sigma).astype(jnp.float32),
            axis=-1,
            keepdims=True,
        ).astype(mu.dtype)
        z = jnp.concatenate([mu, sigma, t], axis=-1)
        kern = jnp.zeros(
            (k, k, 2 * cin + 1, 2 * cout + 1), jnp.float32
        )
        kern = kern.at[:, :, :cin, :cout].set(w_mu)
        kern = kern.at[:, :, cin : 2 * cin, cout : 2 * cout].set(
            jnp.square(w_mu)
        )
        kern = kern.at[:, :, 2 * cin, 2 * cout].set(1.0)
        out = _conv_valid(z, kern, stride)
        mu_out = out[..., :cout]
        sigma_out = out[..., cout : 2 * cout] + out[..., 2 * cout :] * s_w
        return _act(mu_out), _act(sigma_out)
    if _CONV2D_IMPL == "im2col":
        # both moment products on the packed-contraction dot; winsum stays
        # on its own (shift) lowering — mirrors moments3d's im2col branch
        w_flat = w_mu.reshape(-1, cout)
        mu_out = _im2col2d_dot(_im2col2d(mu, k, stride), w_flat)
        sigma2 = _im2col2d_dot(
            _im2col2d(sigma, k, stride),
            jnp.square(w_flat.astype(jnp.float32)),
        )
        ws = _act(_window_sum(jnp.square(mu) + sigma, k, stride))
        return _act(mu_out), _act(scale_sw(ws, s_w) + sigma2)
    mu_out = _conv_valid(mu, w_mu, stride)
    if _CONV_FOLD == "sigma":
        # fold the winsum into the sigma conv: input [sigma ‖ sum(mu^2+sigma)],
        # kernel blockdiag [w_mu^2, 0; 0, ones] — 2 kernels per vconv instead
        # of 3, and no 1->1-channel conv.
        t = jnp.sum(
            (jnp.square(mu) + sigma).astype(jnp.float32),
            axis=-1,
            keepdims=True,
        ).astype(mu.dtype)
        z = jnp.concatenate([sigma, t], axis=-1)
        kern = jnp.pad(jnp.square(w_mu), ((0, 0), (0, 0), (0, 1), (0, 1)))
        kern = kern.at[:, :, cin, cout].set(1.0)
        out = _conv_valid(z, kern, stride)
        sigma_out = out[..., :cout] + out[..., cout:] * s_w
        return _act(mu_out), _act(sigma_out)
    # cast the [B,H',W',1] window-sum before the broadcast multiply so the
    # full-width sigma chain stays in the activation dtype
    ws = _act(_window_sum(jnp.square(mu) + sigma, k, stride))
    sigma_out = scale_sw(ws, s_w) + _conv_valid(sigma, jnp.square(w_mu), stride)
    return _act(mu_out), _act(sigma_out)


def vconv_relu(
    mu: Array, sigma: Array, w_mu: Array, w_sigma: Array
) -> MomentPair:
    """``vrelu(*vconv(...))`` — the conv -> relu pair of the encoder and
    decoder blocks (`Hippocampus.py:374-415`)."""
    return vrelu(*vconv(mu, sigma, w_mu, w_sigma))


def vconv_input_relu(x: Array, w_mu: Array, w_sigma: Array) -> MomentPair:
    """``vrelu(*vconv_input(...))`` — the first block's conv -> relu."""
    return vrelu(*vconv_input(x, w_mu, w_sigma))


def vrelu(mu: Array, sigma: Array) -> MomentPair:
    """First-order Taylor ReLU: ``sigma_out = relu'(mu)^2 * sigma``.

    Reference: ``myReLU.call`` + ``grad_ReLU`` (`Hippocampus.py:85-90,237-247`).
    TF's ReLU gradient is 0 at mu == 0, so the mask is strict ``mu > 0``.
    The mask is idempotent under squaring, so no square is materialized.
    """
    mask = mu > 0
    return jnp.where(mask, mu, 0.0), jnp.where(mask, sigma, 0.0)


def vmaxpool(mu: Array, sigma: Array) -> MomentPair:
    """2x2/stride-2 max-pool of ``mu``; ``sigma`` taken at the argmax.

    Reference: ``mymaxpooling.call`` + ``get_pooled``
    (`Hippocampus.py:54-64,226-234`) — SAME padding,
    ``include_batch_in_index=True``. TF's argmax resolves ties to the lowest
    flat index; within a window, row-major order == flat-index order.

    Instead of window reshape + argmax + gather (a 6-D relayout plus a
    gather), take the four strided window elements as plain slices and
    select sigma with a nested ``where`` in row-major order, which
    reproduces first-occurrence tie-breaking exactly. Purely elementwise.
    The max itself is a 3-op maximum tree
    whose gradient also routes ties to the earlier element (lax.max takes
    the lhs branch on equality), matching TF's pool gradient.

    Odd spatial dims are SAME-padded at the bottom/right; padded mu lanes
    are -inf so they never win the max (all pool inputs in the reference
    models are even-sized, but partial windows stay correct).
    """
    if _BACKEND == "naive":
        from supernet_tpu.ops.naive import vmaxpool_naive

        return vmaxpool_naive(mu, sigma)
    return _vmaxpool_fast(mu, sigma)


def _pool_taps(x: Array):
    """The four 2x2-window elements as quarter-size views, in row-major
    (TF flat-index) order.

    Expressed as one reshape splitting H and W by 2 plus unit-index
    slices instead of four stride-2 slices: identical values, but XLA
    lowers this to a single relayout feeding cheap contiguous reads
    rather than four strided-window passes."""
    b, h, w, c = x.shape
    r = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return (
        r[:, :, 0, :, 0],
        r[:, :, 0, :, 1],
        r[:, :, 1, :, 0],
        r[:, :, 1, :, 1],
    )


@jax.custom_vjp
def _vmaxpool_fast(mu: Array, sigma: Array) -> MomentPair:
    mu_out, sigma_out, _ = _vmaxpool_fwd_impl(mu, sigma)
    return mu_out, sigma_out


def _vmaxpool_fwd_impl(mu: Array, sigma: Array):
    b, h, w, c = mu.shape
    hp, wp = -(-h // 2) * 2, -(-w // 2) * 2
    if (hp, wp) != (h, w):
        pad = ((0, 0), (0, hp - h), (0, wp - w), (0, 0))
        fill = jnp.finfo(mu.dtype).min
        mu = jnp.pad(mu, pad, constant_values=fill)
        sigma = jnp.pad(sigma, pad)
    m00, m01, m10, m11 = _pool_taps(mu)
    mx = jnp.maximum(jnp.maximum(m00, m01), jnp.maximum(m10, m11))
    s00, s01, s10, s11 = _pool_taps(sigma)
    # first-occurrence masks (p_k = "tap k was selected", TF argmax ties)
    p0 = m00 == mx
    p1 = jnp.logical_and(~p0, m01 == mx)
    p2 = jnp.logical_and(~jnp.logical_or(p0, p1), m10 == mx)
    sigma_out = jnp.where(p0, s00, jnp.where(p1, s01, jnp.where(p2, s10, s11)))
    # backward residual: the selected-tap index in the activation dtype
    # (0..3 exact) — one quarter-res tensor instead of three bool masks
    dt = mu.dtype
    idx = jnp.where(
        p0,
        jnp.asarray(0, dt),
        jnp.where(p1, jnp.asarray(1, dt), jnp.where(p2, jnp.asarray(2, dt), jnp.asarray(3, dt))),
    )
    return mx, sigma_out, (idx, (h, w))


def _vmaxpool_fwd(mu, sigma):
    mu_out, sigma_out, res = _vmaxpool_fwd_impl(mu, sigma)
    return (mu_out, sigma_out), res


def _upsample2_nearest(x: Array) -> Array:
    """[B,h,w,C] -> [B,2h,2w,C] nearest-neighbor 2x (broadcast+reshape)."""
    b, h, w, c = x.shape
    y = jnp.broadcast_to(x[:, :, None, :, None, :], (b, h, 2, w, 2, c))
    return y.reshape(b, 2 * h, 2 * w, c)


def _vmaxpool_bwd(res, g):
    """Route each output grad to its selected window tap, at full
    resolution: upsample the grad and the tap index 2x nearest and keep
    only pixels whose window-parity equals the index.

    Transpose-of-slices (plain AD) lowers to scatter chains, and four
    masked quarter-grids + a stack/reshape pixel-shuffle to 6-D relayout
    copies; this parity form is pure broadcast+elementwise.
    """
    g_mu, g_sigma = g
    idx, (h, w) = res
    iu = _upsample2_nearest(idx)
    b, hp, wp, c = iu.shape
    par_h = lax.broadcasted_iota(jnp.int32, (b, hp, wp, c), 1) % 2
    par_w = lax.broadcasted_iota(jnp.int32, (b, hp, wp, c), 2) % 2
    k = (2 * par_h + par_w).astype(idx.dtype)
    sel = iu == k
    zero = jnp.asarray(0, g_mu.dtype)
    d_mu = jnp.where(sel, _upsample2_nearest(g_mu), zero)
    d_sigma = jnp.where(sel, _upsample2_nearest(g_sigma), zero)
    return d_mu[:, :h, :w, :], d_sigma[:, :h, :w, :]


_vmaxpool_fast.defvjp(_vmaxpool_fwd, _vmaxpool_bwd)


def _unpool_one(x: Array) -> Array:
    """Zero-interleaved 2x upsample with a 1-px top/left pad: [B,H,W,C] ->
    [B,2H+1,2W+1,C], input values landing at odd indices.

    Reference: ``unpool`` (`Hippocampus.py:26-51`). Expressed as a single
    ``lax.pad`` with interior padding (lo=1, hi=1, interior=1 per spatial dim)
    instead of the reference's concat-with-zeros + reshape + pad dance.
    """
    cfg = [(0, 0, 0), (1, 1, 1), (1, 1, 1), (0, 0, 0)]
    return lax.pad(x, jnp.float32(0.0), cfg)


def vunpool(mu: Array, sigma: Array) -> MomentPair:
    """Apply the zero-interleave upsample to both moments.

    Reference: ``myupsampling.call`` (`Hippocampus.py:200-208`).
    """
    return _unpool_one(mu), _unpool_one(sigma)


def vunpool_conv2(
    mu: Array, sigma: Array, w_mu: Array, w_sigma: Array
) -> MomentPair:
    """Fused ``vunpool`` + 2x2 VALID ``vconv`` (the decoder's first pair,
    `Hippocampus.py:394-396`), exploiting the unpool's structure.

    The zero-interleaved upsample places x[i,j] at odd coordinates
    (2i+1, 2j+1) of a (2w+1)-sized map; a following 2x2 VALID conv therefore
    sees EXACTLY ONE nonzero input per output pixel:

        out[2i+1-a, 2j+1-b] = sum_c x[i,j,c] * W[a,b,c,o]

    Expressed as ONE input-dilated (lhs_dilation=2) convolution per moment,
    with none of the stack/reshape pixel-shuffle relayouts of a
    four-parity-1x1-convs formulation.
    The 2x2 window sum of the interleaved (mu^2 + sigma) sees exactly one
    nonzero pixel per window, so it is the channel sum nearest-upsampled.
    """
    if _BACKEND == "naive":
        # the reference choreography: materialize the zero-interleaved
        # upsample, then a full 2x2 patch-matmul conv (Hippocampus.py:394-396)
        from supernet_tpu.ops.naive import vconv_naive

        m_up, s_up = vunpool(mu, sigma)
        return vconv_naive(m_up, s_up, w_mu, w_sigma)
    sw = jax.nn.softplus(w_sigma)
    mu, sigma = _act(mu), _act(sigma)
    t = (jnp.square(mu) + sigma).astype(jnp.float32)
    # [B,h,w,1] channel sum in f32, cast back before the broadcast ops so
    # the sigma chain stays in the activation dtype
    t_up = _upsample2_nearest(_act(jnp.sum(t, axis=-1, keepdims=True)))

    def dconv(x: Array, kernel: Array) -> Array:
        # unpool + 2x2 VALID conv == conv with 2x input dilation and a
        # 1-px border (the unpool's top/left zero pad + the symmetric tail)
        return lax.conv_general_dilated(
            x,
            kernel.astype(x.dtype),
            window_strides=(1, 1),
            padding=((1, 1), (1, 1)),
            lhs_dilation=(2, 2),
            dimension_numbers=_DIMSPEC,
            precision=_PRECISION,
            preferred_element_type=x.dtype,
        )

    mu_out = dconv(mu, w_mu)
    sigma_out = t_up * _act(sw) + dconv(sigma, jnp.square(w_mu))
    return mu_out, _act(sigma_out)


def vpad(
    mu: Array,
    sigma: Array,
    pad_size: Sequence[int] = (2, 2),
    sigma_fill: float = 0.0,
) -> MomentPair:
    """Pad both spatial dims; mu with zeros, sigma with ``sigma_fill``.

    ``pad_size = (lo, hi)`` is applied identically to H and W, matching
    ``mypadding`` (`Hippocampus.py:211-223`): the fill is a pseudo-variance
    assigned to invented pixels (0.02 Hippocampus / 0.1 BraTS).
    """
    lo, hi = int(pad_size[0]), int(pad_size[1])
    pad = ((0, 0), (lo, hi), (lo, hi), (0, 0))
    return (
        jnp.pad(mu, pad),
        jnp.pad(sigma, pad, constant_values=sigma_fill),
    )


def crop_center(x: Array, target_h: int, target_w: int) -> Array:
    """Center-crop spatial dims of an NHWC (or NHW) array to (th, tw).

    Offsets follow the reference's ``(H - h) // 2`` convention
    (`Hippocampus_functions.py:313-321`).
    """
    oh = (x.shape[1] - target_h) // 2
    ow = (x.shape[2] - target_w) // 2
    return x[:, oh : oh + target_h, ow : ow + target_w, ...]


def crop_to_match(x: Array, like: Array) -> Array:
    """Center-crop ``x`` to the spatial shape of ``like`` (``crop_tensor``)."""
    return crop_center(x, like.shape[1], like.shape[2])


def vcrop_concat(
    mu_dec: Array, sigma_dec: Array, mu_enc: Array, sigma_enc: Array
) -> MomentPair:
    """Skip connection: center-crop encoder moments to the decoder's spatial
    size and concatenate on channels — decoder channels first.

    Reference: ``myConc.call`` (`Hippocampus.py:250-270`).
    """
    mu_out = jnp.concatenate([mu_dec, crop_to_match(mu_enc, mu_dec)], axis=-1)
    sigma_out = jnp.concatenate(
        [sigma_dec, crop_to_match(sigma_enc, sigma_dec)], axis=-1
    )
    return mu_out, sigma_out


def _conv_pad(x: Array, w: Array, pad_h, pad_w, stride: int = 1) -> Array:
    """2-D convolution with an explicit per-dim (lo, hi) padding config.

    Negative entries are legal and perform an implicit slice (XLA HLO
    semantics) — the mechanism that lets a center-crop fold into the conv
    itself instead of materializing the cropped tensor.
    """
    return lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(stride, stride),
        padding=(tuple(pad_h), tuple(pad_w)),
        dimension_numbers=_DIMSPEC,
        precision=_PRECISION,
        preferred_element_type=x.dtype,
    )


def _moment_src(mu: Array, sigma: Array) -> Array:
    """Channel-sum of (mu^2 + sigma) in f32, result in the activation
    dtype — the winsum source column, same accumulation policy as
    ``_window_sum``."""
    t = jnp.sum(
        (jnp.square(mu) + sigma).astype(jnp.float32), axis=-1, keepdims=True
    )
    return t.astype(mu.dtype)


def vglue_conv_relu(
    mu: Array,
    sigma: Array,
    w_mu: Array,
    w_sigma: Array,
    pad_size: Sequence[int],
    sigma_fill: float,
    mu_enc: Array | None = None,
    sigma_enc: Array | None = None,
) -> MomentPair:
    """Algebraic fusion of ``vpad -> [vcrop_concat ->] vconv -> vrelu``:
    none of the padded, cropped, or concatenated moment tensors is ever
    materialized in HBM.

    Equivalent (to f32 summation-order tolerance) to::

        m, s = vpad(mu, sigma, pad_size, sigma_fill)
        if mu_enc is not None:
            m, s = vcrop_concat(m, s, mu_enc, sigma_enc)
        return vrelu(*vconv(m, s, w_mu, w_sigma))

    which is the reference's decoder glue choreography — ``mypadding`` +
    ``myConc`` + ``myConv_intermediate`` + ``myReLU``
    (`Hippocampus.py:397-415`) — and its bottleneck pre-pad
    (`Brats.py:370-372,407`). The identities used:

    * zero mu-pad == the conv's own padding config;
    * the encoder skip's center-crop == NEGATIVE conv padding (an implicit
      slice in the conv read pattern);
    * channel concat == splitting the kernel into its decoder block
      ``w_mu[:, :, :c_d]`` and encoder block ``w_mu[:, :, c_d:]`` and
      summing two convs (concat order is decoder-first, matching
      ``vcrop_concat`` and `Hippocampus.py:268`);
    * the constant ``sigma_fill`` border of the padded sigma splits into
      two analytic terms computed from a 1-channel ring mask: its winsum
      contribution ``c_d * fill * winsum(ring)`` (weight-independent) and
      its variance-conv contribution ``fill * conv(ring, sum_cin w_mu^2)``
      (a [k,k,1,C_out] conv on a batch-1 map, broadcast over the batch).

    Enabled by ``set_glue_fold("fold")`` / ``SUPERNET_GLUE_FOLD=fold``;
    dispatched from the model's decoder blocks (models/unet.py).
    """
    lo, hi = int(pad_size[0]), int(pad_size[1])
    k = w_mu.shape[0]
    c_d = mu.shape[-1]
    s_w = jax.nn.softplus(w_sigma)
    mu, sigma = _act(mu), _act(sigma)
    w_d = w_mu[:, :, :c_d] if mu_enc is not None else w_mu
    pad_d = (lo, hi)
    shift = _WINSUM == "shift"
    # in shift mode every window sum below is slice-adds on a padded or
    # cropped SINGLE-channel source (1/C the bytes of the activation pad
    # the fold avoids) — no 1-channel conv passes
    ones = None if shift else jnp.ones((k, k, 1, 1), mu.dtype)

    mu_out = _conv_pad(mu, w_d, pad_d, pad_d)
    src = _moment_src(mu, sigma)
    if shift:
        ws = _winsum_shift_pads(src, k, pad_d, pad_d)
    else:
        ws = _conv_pad(src, ones, pad_d, pad_d)
    sig_conv = _conv_pad(sigma, jnp.square(w_d), pad_d, pad_d)

    if sigma_fill != 0.0 and (lo or hi):
        # 1-channel ring mask of the padded border: pad zeros with ones.
        b_, h, w, _ = mu.shape
        ring = jnp.pad(
            jnp.zeros((1, h, w, 1), mu.dtype),
            ((0, 0), (lo, hi), (lo, hi), (0, 0)),
            constant_values=1.0,
        )
        fill = jnp.asarray(sigma_fill, mu.dtype)
        # each border pixel contributes (mu=0, sigma=fill) per dec channel
        ring_ws = (
            _winsum_shift_pads(ring, k, (0, 0), (0, 0))
            if shift
            else _conv_valid(ring, ones)
        )
        ws = ws + ring_ws * (c_d * fill)
        w2_sum = jnp.sum(jnp.square(w_d), axis=2, keepdims=True)
        sig_conv = sig_conv + _conv_valid(ring, w2_sum) * fill

    if mu_enc is not None:
        mu_enc, sigma_enc = _act(mu_enc), _act(sigma_enc)
        w_e = w_mu[:, :, c_d:]
        # center-crop of the encoder map to the padded decoder size,
        # expressed as negative conv padding per spatial dim
        sh, sw = mu.shape[1] + lo + hi, mu.shape[2] + lo + hi
        he, we = mu_enc.shape[1], mu_enc.shape[2]
        oh, ow = (he - sh) // 2, (we - sw) // 2
        pad_eh = (-oh, -(he - oh - sh))
        pad_ew = (-ow, -(we - ow - sw))
        mu_out = mu_out + _conv_pad(mu_enc, w_e, pad_eh, pad_ew)
        src_e = _moment_src(mu_enc, sigma_enc)
        ws = ws + (
            _winsum_shift_pads(src_e, k, pad_eh, pad_ew)
            if shift
            else _conv_pad(src_e, ones, pad_eh, pad_ew)
        )
        sig_conv = sig_conv + _conv_pad(
            sigma_enc, jnp.square(w_e), pad_eh, pad_ew
        )

    sigma_out = scale_sw(_act(ws), s_w) + sig_conv
    return vrelu(_act(mu_out), _act(sigma_out))


def vsoftmax(mu: Array, sigma: Array) -> MomentPair:
    """Pixel-wise softmax with variance pushed through the softmax Jacobian.

    Reference: ``mysoftmax.call`` (`Hippocampus.py:273-292`) computes
    ``sigma_out = (J ∘ J) @ sigma`` with ``J = diag(p) - p p^T`` as a C x C
    matmul per pixel. Expanding ``J_cj^2 = p_c^2 (delta_cj - p_j)^2`` gives the
    exact elementwise form used here:

        sigma_out_c = p_c^2 * ((1 - 2 p_c) * sigma_c + sum_j p_j^2 sigma_j)

    Flattens to ``[B, H*W, C]`` like the reference, but never squeezes the
    batch dim (the reference's bare ``tf.squeeze`` collapses B == 1 — a
    catalogued defect, SURVEY.md §2.7.7).
    """
    if _BACKEND == "naive":
        from supernet_tpu.ops.naive import vsoftmax_naive

        return vsoftmax_naive(mu, sigma)
    b, h, w, c = mu.shape
    # head runs in f32 regardless of the activation dtype: the probabilities
    # feed log() in the NLL loss and the uncertainty artifacts.
    mu_flat = mu.reshape(b, h * w, c).astype(jnp.float32)
    sigma_flat = sigma.reshape(b, h * w, c).astype(jnp.float32)
    p = jax.nn.softmax(mu_flat, axis=-1)
    p_sq = jnp.square(p)
    s_tot = jnp.sum(p_sq * sigma_flat, axis=-1, keepdims=True)
    sigma_out = p_sq * ((1.0 - 2.0 * p) * sigma_flat + s_tot)
    return p, sigma_out
