"""3-D moment-propagation primitives (net-new model family).

The reference operates on 2-D slices extracted from the Medical
Segmentation Decathlon / BraTS 3-D volumes (`Hippocampus.py:479-481` loads
pre-extracted 2-D pickles); volumetric context is simply discarded. This
module extends the VDP algebra to NDHWC volumes so the framework can also
train a 3-D variant (`models/unet3d.py`) directly on what `data/nifti.py`
reads.

Same math as `ops/moments.py`, one rank up, correctness-first:

- variance terms of the variational conv stay CONVOLUTIONS
  (`sigma = winsum3d(mu^2 + sigma) * s_w + conv3d(sigma, w_mu^2)`; the
  conv-form identity of SURVEY §7.1 is rank-independent because ``s_w``
  is per-output-channel),
- `vrelu` is reused verbatim from the 2-D module (elementwise,
  rank-agnostic),
- max-pool is the 2x2x2 first-occurrence-argmax gather expressed as eight
  strided taps + a select chain (TF tie-break order preserved),
- unpool is one `lax.pad` with interior padding on all three spatial dims
  (2w+1 geometry, values at odd indices, `Hippocampus.py:26-51` per axis).

This path deliberately has NO hand-written kernels: the 3-D ops are the
XLA composition, like the 2-D ones (the max-pool's custom VJP aside).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from supernet_tpu.ops.moments import (  # noqa: F401
    _act,
    chan_sum,
    scale_sw,
    _winsum_shift,
    _winsum_shift_pads,
    get_act_dtype,
    get_mxu_precision,
    get_winsum,
    vrelu,
)

Array = jax.Array
MomentPair = Tuple[Array, Array]

_DN = ("NDHWC", "DHWIO", "NDHWC")

# --------------------------------------------------------------------------
# 3-D conv lowering knob: "im2col" re-lowers the k>1 moment convs as
# patch-concat + dot_general with the FULL k^3*C_in (= 864 at k=3,
# C_in=32) contraction — a pure-XLA test of whether a deeper contraction
# fills the matrix units better than the C_in=32 conv. Costs a k^3-times
# patch materialization per conv input, so it pays only if that win beats
# the extra HBM traffic; "conv" is the default.
# --------------------------------------------------------------------------
_CONV3D_IMPL = "conv"


def set_conv3d_impl(mode: str) -> None:
    if mode not in ("conv", "im2col"):
        raise ValueError(f"unknown conv3d impl {mode!r}")
    global _CONV3D_IMPL
    _CONV3D_IMPL = mode


def get_conv3d_impl() -> str:
    return _CONV3D_IMPL


def _im2col3d(x: Array, k: int, stride: int = 1) -> Array:
    """The k^3 VALID-window taps concatenated on channels:
    [B, D, H, W, C] -> [B, D', H', W', k^3*C], tap-major (dz, dy, dx)
    order, C minor — exactly ``w.reshape(k^3*C_in, C_out)``'s row order,
    so ``patches @ w.reshape(-1, C_out)`` equals the VALID conv."""
    b, d, h, w, c = x.shape
    taps = [
        x[:, dz:d - (k - 1) + dz:stride,
          dy:h - (k - 1) + dy:stride,
          dx:w - (k - 1) + dx:stride, :]
        for dz in range(k) for dy in range(k) for dx in range(k)
    ]
    return jnp.concatenate(taps, axis=-1)


def _im2col_dot(patches: Array, w_flat: Array) -> Array:
    """[B, D', H', W', k^3*Cin] @ [k^3*Cin, Cout] with the full packed
    contraction."""
    return jnp.einsum(
        "bdhwp,po->bdhwo",
        patches,
        w_flat.astype(patches.dtype),
        precision=get_mxu_precision(),
        preferred_element_type=patches.dtype,
    )


def _conv3d_valid(x: Array, w: Array, stride: int = 1) -> Array:
    # output dtype matches the input: conv's transpose rule rejects mixed
    # in/out dtypes under reverse-mode AD (same as 2-D `_conv_valid`);
    # partial products still accumulate in f32.
    # precision follows the same global knob as the 2-D family
    # (SUPERNET_PRECISION; 'highest' = parity-grade f32 multiplies)
    return lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        (stride,) * 3,
        "VALID",
        dimension_numbers=_DN,
        preferred_element_type=x.dtype,
        precision=get_mxu_precision(),
    )


def _window_sum3d(x: Array, k: int, stride: int = 1) -> Array:
    """Channel sum then k^3 VALID window sum -> [B, D', H', W', 1].

    Lowering follows the shared SUPERNET_WINSUM knob (see 2-D
    ``_window_sum``): "shift" does 3(k-1) separable slice-adds; "conv"
    runs a ones-kernel conv with C_in == C_out == 1."""
    s = chan_sum(x)
    if get_winsum() == "shift":
        return _act(_winsum_shift(s, k, stride))
    ones = jnp.ones((k, k, k, 1, 1), jnp.float32)
    out = lax.conv_general_dilated(
        s, ones, (stride,) * 3, "VALID", dimension_numbers=_DN,
        preferred_element_type=jnp.float32,
        precision=get_mxu_precision(),
    )
    return _act(out)


def vconv3d_input(
    x: Array, w_mu: Array, w_sigma: Array, stride: int = 1
) -> MomentPair:
    """First conv: deterministic input, Gaussian weights (3-D analog of
    `myConv_input`, `Hippocampus.py:94-136`). w_mu [k,k,k,Cin,Cout],
    w_sigma [Cout] (raw; softplus-parameterized)."""
    k = w_mu.shape[0]
    s_w = jax.nn.softplus(w_sigma.astype(jnp.float32))
    x = _act(x)
    if k == 1 and stride == 1:
        # 1x1x1 conv: window-sum == channel sum, both products are plain
        # einsums (same rationale as the 2-D k=1 path — no C_out==1
        # ones-kernel conv pass, and dot_general partitions cleanly under
        # GSPMD where vmap's feature-grouped conv does not, which is what
        # member-sharded ensemble training relies on)
        w2 = _act(w_mu[0, 0, 0])
        mu_out = jnp.einsum(
            "bdhwc,co->bdhwo",
            x,
            w2,
            precision=get_mxu_precision(),
            preferred_element_type=x.dtype,
        )
        t = jnp.sum(jnp.square(x.astype(jnp.float32)), -1, keepdims=True)
        return _act(mu_out), scale_sw(_act(t), s_w)
    if get_conv3d_impl() == "im2col":
        mu_out = _im2col_dot(
            _im2col3d(x, k, stride), w_mu.reshape(-1, w_mu.shape[-1])
        )
    else:
        mu_out = _conv3d_valid(x, w_mu, stride)
    ws = _window_sum3d(jnp.square(x), k, stride)
    return _act(mu_out), scale_sw(ws, s_w)


def vconv3d(
    mu: Array, sigma: Array, w_mu: Array, w_sigma: Array, stride: int = 1
) -> MomentPair:
    """Conv with random input AND weights (3-D `myConv_intermediate`,
    `Hippocampus.py:140-197`): sigma1 + sigma3 fused into one window-sum
    (both scale by s_w), sigma2 = conv3d(sigma, w_mu^2)."""
    k = w_mu.shape[0]
    s_w = jax.nn.softplus(w_sigma.astype(jnp.float32))
    if k == 1 and stride == 1:
        # 1x1x1 conv (the segmentation head): einsum form — see
        # vconv3d_input's k=1 branch for why (no C_out-starved conv +
        # GSPMD partitionability under the ensemble member vmap)
        mu_a, sigma_a = _act(mu), _act(sigma)
        w2 = _act(w_mu[0, 0, 0])
        mu_out = jnp.einsum(
            "bdhwc,co->bdhwo",
            mu_a,
            w2,
            precision=get_mxu_precision(),
            preferred_element_type=mu_a.dtype,
        )
        t = jnp.sum(
            (jnp.square(mu) + sigma).astype(jnp.float32), -1, keepdims=True
        )
        sigma_out = scale_sw(_act(t), s_w) + jnp.einsum(
            "bdhwc,co->bdhwo",
            sigma_a,
            jnp.square(w2),
            precision=get_mxu_precision(),
            preferred_element_type=sigma_a.dtype,
        )
        return _act(mu_out), _act(sigma_out)
    if get_conv3d_impl() == "im2col":
        # both moment products ride the packed-contraction dot; the
        # window-sum term stays on the shift lowering (separable adds)
        w_flat = w_mu.reshape(-1, w_mu.shape[-1])
        mu_out = _im2col_dot(_im2col3d(_act(mu), k, stride), w_flat)
        sigma2 = _im2col_dot(
            _im2col3d(_act(sigma), k, stride),
            jnp.square(w_flat.astype(jnp.float32)),
        )
        ws = _window_sum3d(jnp.square(mu) + sigma, k, stride)
        return _act(mu_out), _act(scale_sw(ws, s_w) + sigma2)
    mu_out = _conv3d_valid(_act(mu), w_mu, stride)
    ws = _window_sum3d(jnp.square(mu) + sigma, k, stride)
    sigma_out = scale_sw(ws, s_w) + _conv3d_valid(
        _act(sigma), jnp.square(w_mu.astype(jnp.float32)), stride
    )
    return _act(mu_out), _act(sigma_out)


def vconv3d_relu(
    mu: Array, sigma: Array, w_mu: Array, w_sigma: Array
) -> MomentPair:
    return vrelu(*vconv3d(mu, sigma, w_mu, w_sigma))


def vmaxpool3d(mu: Array, sigma: Array) -> MomentPair:
    """2x2x2 / stride-2 max pool on the mean, variance gathered at the SAME
    argmax (3-D `mymaxpooling` + `get_pooled`, `Hippocampus.py:54-64,
    226-234`). SAME padding; TF's first-flat-index tie-break preserved by
    selecting taps in (d, h, w) scan order.

    Port of the two 2-D pool formulations: the eight window taps come from ONE reshape
    splitting each spatial dim by 2 plus unit-index slices (a single
    relayout feeding contiguous reads, not 8 strided-window passes), and
    a hand-derived parity-form custom VJP replaces the transpose of
    8 strided slices under a where-tree, which XLA lowers to sequential
    scatter chains.
    """
    return _vmaxpool3d_fast(mu, sigma)


def _pool_taps3d(x: Array):
    """The eight 2x2x2-window elements as eighth-size views, in (d, h, w)
    row-major (TF flat-index) order."""
    b, d, h, w, c = x.shape
    r = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    return [
        r[:, :, di, :, hi, :, wi]
        for di in (0, 1)
        for hi in (0, 1)
        for wi in (0, 1)
    ]


@jax.custom_vjp
def _vmaxpool3d_fast(mu: Array, sigma: Array) -> MomentPair:
    mu_out, sigma_out, _ = _vmaxpool3d_fwd_impl(mu, sigma)
    return mu_out, sigma_out


def _vmaxpool3d_fwd_impl(mu: Array, sigma: Array):
    b, d, h, w, c = mu.shape
    dp, hp, wp = -(-d // 2) * 2, -(-h // 2) * 2, -(-w // 2) * 2
    if (dp, hp, wp) != (d, h, w):
        pad = ((0, 0), (0, dp - d), (0, hp - h), (0, wp - w), (0, 0))
        fill = jnp.finfo(mu.dtype).min
        mu = jnp.pad(mu, pad, constant_values=fill)
        sigma = jnp.pad(sigma, pad)
    m_taps = _pool_taps3d(mu)
    s_taps = _pool_taps3d(sigma)
    mx = m_taps[0]
    for t in m_taps[1:]:
        mx = jnp.maximum(mx, t)
    dt = mu.dtype
    # first-occurrence selection + selected-tap index (0..7 exact in
    # bf16/f32) in one backward-to-forward where chain: tap k wins iff it
    # equals the max and no earlier tap does
    sigma_out = s_taps[7]
    idx = jnp.asarray(7, dt)
    for k in range(6, -1, -1):
        hit = m_taps[k] == mx
        sigma_out = jnp.where(hit, s_taps[k], sigma_out)
        idx = jnp.where(hit, jnp.asarray(k, dt), idx)
    return mx, sigma_out, (idx, (d, h, w))


def _vmaxpool3d_fwd(mu, sigma):
    mu_out, sigma_out, res = _vmaxpool3d_fwd_impl(mu, sigma)
    return (mu_out, sigma_out), res


def _vmaxpool3d_bwd(res, g):
    """Route each output grad to its selected window tap at full
    resolution: nearest-upsample the grad and the tap index 2x and keep
    only voxels whose window parity (4*d%2 + 2*h%2 + w%2) equals the
    index — pure broadcast+elementwise, no scatters (the 2-D
    `_vmaxpool_bwd` argument, one rank up)."""
    g_mu, g_sigma = g
    idx, (d, h, w) = res
    iu = _upsample2_nearest3d(idx)
    b, dp, hp, wp, c = iu.shape
    par_d = lax.broadcasted_iota(jnp.int32, (b, dp, hp, wp, c), 1) % 2
    par_h = lax.broadcasted_iota(jnp.int32, (b, dp, hp, wp, c), 2) % 2
    par_w = lax.broadcasted_iota(jnp.int32, (b, dp, hp, wp, c), 3) % 2
    k = (4 * par_d + 2 * par_h + par_w).astype(idx.dtype)
    sel = iu == k
    zero = jnp.asarray(0, g_mu.dtype)
    d_mu = jnp.where(sel, _upsample2_nearest3d(g_mu), zero)
    d_sigma = jnp.where(sel, _upsample2_nearest3d(g_sigma), zero)
    return d_mu[:, :d, :h, :w, :], d_sigma[:, :d, :h, :w, :]


_vmaxpool3d_fast.defvjp(_vmaxpool3d_fwd, _vmaxpool3d_bwd)


def _unpool3d_one(x: Array) -> Array:
    """Zero-interleave 2x upsample with 1-px low pad on every spatial dim:
    [B,D,H,W,C] -> [B,2D+1,2H+1,2W+1,C], values at odd indices."""
    cfg = [(0, 0, 0), (1, 1, 1), (1, 1, 1), (1, 1, 1), (0, 0, 0)]
    return lax.pad(x, jnp.asarray(0.0, x.dtype), cfg)


def vunpool3d(mu: Array, sigma: Array) -> MomentPair:
    return _unpool3d_one(mu), _unpool3d_one(sigma)


def _upsample2_nearest3d(x: Array) -> Array:
    """[B,d,h,w,C] -> [B,2d,2h,2w,C] nearest-neighbor 2x (broadcast+reshape)."""
    b, d, h, w, c = x.shape
    y = jnp.broadcast_to(
        x[:, :, None, :, None, :, None, :],
        (b, d, 2, h, 2, w, 2, c),
    )
    return y.reshape(b, 2 * d, 2 * h, 2 * w, c)


def vunpool3d_conv2(
    mu: Array, sigma: Array, w_mu: Array, w_sigma: Array
) -> MomentPair:
    """Fused unpool + 2^3 VALID conv (the decoder's upsampling step) as ONE
    input-dilated convolution per moment — the 3-D port of the 2-D
    `vunpool_conv2` trick (`ops/moments.py`), same argument per axis: the
    zero-interleave places x[i] at odd coordinate 2i+1, so the following
    2-kernel VALID conv sees exactly one nonzero input per output voxel;
    `lhs_dilation=2` with a 1-voxel border is that map, and XLA's conv
    emitter skips the zero positions natively. The 2^3 window sum of the
    interleaved (mu^2 + sigma) likewise reduces to the channel sum
    nearest-upsampled. Bit-identical to the composition
    `vconv3d(*vunpool3d(...))` (tested); removes the materialized
    (2n+1)^3 interleaved pair — ~8x the input's HBM traffic — per decoder
    stage."""
    sw = jax.nn.softplus(w_sigma.astype(jnp.float32))
    mu, sigma = _act(mu), _act(sigma)
    # same cast order as `_window_sum3d` (square in the activation dtype,
    # reduce in f32) so the fused form stays bit-identical to the
    # composition under bf16 too
    t = jnp.square(mu) + sigma
    t_up = _upsample2_nearest3d(
        _act(jnp.sum(t.astype(jnp.float32), axis=-1, keepdims=True))
    )

    def dconv(x: Array, kernel: Array) -> Array:
        return lax.conv_general_dilated(
            x,
            kernel.astype(x.dtype),
            window_strides=(1, 1, 1),
            padding=((1, 1), (1, 1), (1, 1)),
            lhs_dilation=(2, 2, 2),
            dimension_numbers=_DN,
            preferred_element_type=x.dtype,
            precision=get_mxu_precision(),
        )

    mu_out = dconv(mu, w_mu)
    sigma_out = t_up * _act(sw) + dconv(
        sigma, jnp.square(w_mu.astype(jnp.float32))
    )
    return mu_out, _act(sigma_out)


def vpad3d(
    mu: Array,
    sigma: Array,
    pad_size: Sequence[int] = (2, 2),
    sigma_fill: float = 0.0,
) -> MomentPair:
    """(lo, hi) pad on all three spatial dims; mu zeros, sigma
    ``sigma_fill`` (3-D `mypadding`)."""
    lo, hi = int(pad_size[0]), int(pad_size[1])
    pad = ((0, 0), (lo, hi), (lo, hi), (lo, hi), (0, 0))
    return (
        jnp.pad(mu, pad),
        jnp.pad(sigma, pad, constant_values=sigma_fill),
    )


def crop_center3d(x: Array, td: int, th: int, tw: int) -> Array:
    od = (x.shape[1] - td) // 2
    oh = (x.shape[2] - th) // 2
    ow = (x.shape[3] - tw) // 2
    return x[:, od : od + td, oh : oh + th, ow : ow + tw, ...]


def vcrop_concat3d(
    mu: Array, sigma: Array, mu_e: Array, sigma_e: Array
) -> MomentPair:
    """Skip connection: center-crop the encoder pair to the decoder's
    spatial size, concat channels — DECODER channels first, the same
    layout as the 2-D `vcrop_concat`/`myConc` (`Hippocampus.py:250-270`),
    so per-channel tooling and 2-D→3-D weight inflation map identically
    across the families."""
    d, h, w = mu.shape[1:4]
    return (
        jnp.concatenate([mu, crop_center3d(mu_e, d, h, w)], axis=-1),
        jnp.concatenate([sigma, crop_center3d(sigma_e, d, h, w)], axis=-1),
    )


def _conv3d_pads(x: Array, w: Array, pads, stride: int = 1) -> Array:
    """3-D conv with an explicit per-spatial-dim (lo, hi) padding config;
    negative entries slice (the crop-as-conv-padding mechanism, see the
    2-D ``_conv_pad``)."""
    return lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        (stride,) * 3,
        padding=tuple(tuple(p) for p in pads),
        dimension_numbers=_DN,
        preferred_element_type=x.dtype,
        precision=get_mxu_precision(),
    )


def vglue_conv3d_relu(
    mu: Array,
    sigma: Array,
    w_mu: Array,
    w_sigma: Array,
    pad_size: Sequence[int],
    sigma_fill: float,
    mu_enc: Array | None = None,
    sigma_enc: Array | None = None,
) -> MomentPair:
    """Rank-3 port of ``ops.moments.vglue_conv_relu``: the decoder's
    ``vpad3d -> [vcrop_concat3d ->] vconv3d -> vrelu`` computed
    algebraically inside the conv — zero mu-pad as conv padding, skip
    crop as negative conv padding, channel concat as a kernel split on
    the DHWIO input axis, and the constant ``sigma_fill`` border as two
    analytic ring-mask terms. In 3-D the materialized pads are a larger
    fraction of the work (an 18^3 -> 24^3 (3,3)-pad is 2.4x the voxels),
    so this is the family's main HBM-glue lever. Equality with the
    explicit choreography is pinned in tests/test_glue_fold.py.
    """
    lo, hi = int(pad_size[0]), int(pad_size[1])
    k = w_mu.shape[0]
    c_d = mu.shape[-1]
    s_w = jax.nn.softplus(w_sigma.astype(jnp.float32))
    mu, sigma = _act(mu), _act(sigma)
    w_d = w_mu[..., :c_d, :] if mu_enc is not None else w_mu
    shift = get_winsum() == "shift"
    # shift mode: every window sum below is slice-adds on a padded/cropped
    # single-channel source — see the 2-D vglue_conv_relu counterpart
    ones = None if shift else jnp.ones((k, k, k, 1, 1), mu.dtype)
    pd = ((lo, hi),) * 3

    def _src(m, s):
        t = jnp.sum(
            (jnp.square(m) + s).astype(jnp.float32), axis=-1, keepdims=True
        )
        return t.astype(m.dtype)

    mu_out = _conv3d_pads(mu, w_d, pd)
    ws = (
        _winsum_shift_pads(_src(mu, sigma), k, *pd)
        if shift
        else _conv3d_pads(_src(mu, sigma), ones, pd)
    )
    sig_conv = _conv3d_pads(sigma, jnp.square(w_d.astype(jnp.float32)), pd)

    if sigma_fill != 0.0 and (lo or hi):
        b_, d, h, w, _ = mu.shape
        ring = jnp.pad(
            jnp.zeros((1, d, h, w, 1), mu.dtype),
            ((0, 0), (lo, hi), (lo, hi), (lo, hi), (0, 0)),
            constant_values=1.0,
        )
        fill = jnp.asarray(sigma_fill, mu.dtype)
        ring_ws = (
            _winsum_shift_pads(ring, k, (0, 0), (0, 0), (0, 0))
            if shift
            else _conv3d_valid(ring, ones)
        )
        ws = ws + ring_ws * (c_d * fill)
        w2_sum = jnp.sum(
            jnp.square(w_d.astype(jnp.float32)), axis=3, keepdims=True
        )
        sig_conv = sig_conv + _conv3d_valid(ring, w2_sum) * fill

    if mu_enc is not None:
        mu_enc, sigma_enc = _act(mu_enc), _act(sigma_enc)
        w_e = w_mu[..., c_d:, :]
        tgt = tuple(mu.shape[i] + lo + hi for i in (1, 2, 3))
        src = tuple(mu_enc.shape[i] for i in (1, 2, 3))
        offs = tuple((s - t) // 2 for s, t in zip(src, tgt))
        pe = tuple(
            (-o, -(s - o - t)) for s, t, o in zip(src, tgt, offs)
        )
        mu_out = mu_out + _conv3d_pads(mu_enc, w_e, pe)
        ws = ws + (
            _winsum_shift_pads(_src(mu_enc, sigma_enc), k, *pe)
            if shift
            else _conv3d_pads(_src(mu_enc, sigma_enc), ones, pe)
        )
        sig_conv = sig_conv + _conv3d_pads(
            sigma_enc, jnp.square(w_e.astype(jnp.float32)), pe
        )

    sigma_out = scale_sw(_act(ws), s_w) + sig_conv
    return vrelu(_act(mu_out), _act(sigma_out))


def vsoftmax3d(mu: Array, sigma: Array) -> MomentPair:
    """Voxel-wise softmax with variance through the softmax Jacobian:
    flattens to [B, D*H*W, C] and delegates to the (rank-agnostic,
    voxel-independent) 2-D closure so the formula lives in one place."""
    from supernet_tpu.ops.moments import vsoftmax

    b, d, h, w, c = mu.shape
    return vsoftmax(
        mu.reshape(b, d * h, w, c), sigma.reshape(b, d * h, w, c)
    )
