"""Analytic FLOP accounting for the VDP U-Net — holds throughput numbers to
the hardware (MFU) instead of free-floating images/sec.

Counts the matmul/conv FLOPs of the moment primitives in
``supernet_tpu.ops.moments`` per layer, using the exact geometry chain
recorded by ``models.unet.forward``'s shape tap (the same chain pinned by
tests/test_geometry.py against `Hippocampus.py:375-418` / `Brats.py:379-455`).
Elementwise work (ReLU masks, softplus, adds, the variance scaling) is
excluded, as is standard for MFU accounting.

Per-layer conv FLOP model (1 MAC = 2 FLOPs), per output pixel:

- ``vconv_input`` (moments.py:145): mu conv ``2 k^2 Cin Cout`` + the
  ones-kernel window-sum ``2 k^2`` (channel pre-sum excluded: elementwise).
- ``vconv`` (moments.py:170): mu conv + sigma conv (w_mu^2) =
  ``4 k^2 Cin Cout`` + window-sum ``2 k^2``.
- ``vunpool_conv2`` (moments.py:307): four 1x1 taps for mu and four for
  sigma, each output pixel hit exactly once per moment -> ``4 Cin Cout``.
- head / 1x1 convs follow the ``vconv`` formula with k = 1.

Training-step FLOPs use the standard fwd:bwd = 1:2 estimate (grad wrt
activations + grad wrt weights each cost one forward): ``3x`` forward.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

from supernet_tpu.configs import ModelConfig

# Published peaks per device, keyed by the exact ``device_kind`` JAX
# reports. NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16 on the tensor
# cores, 3.35 TB/s HBM3, both at the full 700 W power limit (a card set
# below it cannot hold its top clock under load, so report its
# ``power.limit`` beside any share of these peaks).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}


def _peak(device, key: str) -> float:
    if device is None:
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    try:
        return PEAKS[kind][key]
    except KeyError:
        raise KeyError(
            f"no published peak for device_kind {kind!r}; known: "
            f"{sorted(PEAKS)}"
        ) from None


def peak_hbm_gbps(device=None) -> float:
    """Peak HBM GB/s of ``device`` (default: first visible device). Raises
    KeyError for a device that is not in ``PEAKS``."""
    return _peak(device, "hbm_gbps")


def peak_tflops(device=None) -> float:
    """Dense bf16 peak TFLOP/s of ``device`` (default: first visible
    device). Raises KeyError for a device that is not in ``PEAKS``."""
    return _peak(device, "bf16_tflops")


def _conv_shapes(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(layer_name, output_H) for every conv layer via the forward tap,
    without running any compute (jax.eval_shape)."""
    import dataclasses

    from supernet_tpu.models import init_params, layer_names
    from supernet_tpu.models.unet import forward

    cfg_nr = dataclasses.replace(cfg, remat=False)  # remat re-traces blocks
    conv_names = {n for n, *_ in layer_names(cfg_nr)}
    rec: Dict[str, int] = {}

    def tap(name, shape):
        if name in conv_names:
            rec[name] = shape[1]

    params = jax.eval_shape(
        lambda k: init_params(k, cfg_nr), jax.random.PRNGKey(0)
    )
    x = jax.ShapeDtypeStruct(
        (1, cfg.image_size, cfg.image_size, cfg.in_channels), jnp.float32
    )
    jax.eval_shape(lambda p, xx: forward(p, xx, cfg_nr, tap=tap), params, x)
    return [(n, rec[n]) for n, *_ in layer_names(cfg_nr)]


def forward_flops_per_layer(cfg: ModelConfig) -> Dict[str, float]:
    """Conv FLOPs of one forward pass per conv layer, batch size 1."""
    from supernet_tpu.models import layer_names

    shapes = dict(_conv_shapes(cfg))
    out: Dict[str, float] = {}
    for name, k, cin, cout in layer_names(cfg):
        hw = shapes[name] ** 2
        if name == "conv_input":
            f = hw * (2 * k * k * cin * cout + 2 * k * k)
        elif name.endswith("_conv2x2"):
            f = hw * (4 * cin * cout)
        else:  # intermediate vconv (3x3 and the 1x1 head)
            f = hw * (4 * k * k * cin * cout + 2 * k * k)
        out[name] = float(f)
    return out


def forward_flops(cfg: ModelConfig, batch: int = 1) -> float:
    """Total conv FLOPs of one forward pass at ``batch``."""
    return batch * sum(forward_flops_per_layer(cfg).values())


def train_step_flops(cfg: ModelConfig, batch: int) -> float:
    """One optimizer step: forward + backward ~= 3x forward (standard MFU
    convention); ``cfg.remat`` recomputation is NOT charged (it is overhead,
    not useful work — charging it would flatter MFU)."""
    return 3.0 * forward_flops(cfg, batch)


def _conv_shapes3d(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(layer_name, output_D) per 3-D conv layer via forward3d's tap
    (outputs stay cubic: every pad/pool/unpool applies per-axis equally)."""
    import dataclasses

    from supernet_tpu.models import init_params3d, layer_names3d
    from supernet_tpu.models.unet3d import forward3d

    cfg_nr = dataclasses.replace(cfg, remat=False)
    conv_names = {n for n, *_ in layer_names3d(cfg_nr)}
    rec: Dict[str, int] = {}

    def tap(name, shape):
        if name in conv_names:
            rec[name] = shape[1]

    params = jax.eval_shape(
        lambda k: init_params3d(k, cfg_nr), jax.random.PRNGKey(0)
    )
    s = cfg.image_size
    x = jax.ShapeDtypeStruct((1, s, s, s, cfg.in_channels), jnp.float32)
    jax.eval_shape(
        lambda p, xx: forward3d(p, xx, cfg_nr, tap=tap), params, x
    )
    return [(n, rec[n]) for n, *_ in layer_names3d(cfg_nr)]


def forward_flops3d(cfg: ModelConfig, batch: int = 1) -> float:
    """Conv FLOPs of one volumetric forward at ``batch`` — the 2-D counting
    one rank up (k^2 -> k^3, HW -> DHW): mu conv + sigma convs per
    `ops.moments3d.vconv3d`; the fused lhs-dilated unpool-conv sees exactly
    one nonzero tap per output voxel, so it costs 4*cin*cout per voxel
    independent of rank."""
    from supernet_tpu.models import layer_names3d

    shapes = dict(_conv_shapes3d(cfg))
    total = 0.0
    for name, k, cin, cout in layer_names3d(cfg):
        dhw = shapes[name] ** 3
        k3 = k ** 3
        if name == "conv_input":
            f = dhw * (2 * k3 * cin * cout + 2 * k3)
        elif name.endswith("_conv2x2"):
            f = dhw * (4 * cin * cout)
        else:
            f = dhw * (4 * k3 * cin * cout + 2 * k3)
        total += float(f)
    return batch * total


def train_step_flops3d(cfg: ModelConfig, batch: int) -> float:
    """One volumetric optimizer step ~= 3x forward (same MFU convention as
    `train_step_flops`; remat recomputation not charged)."""
    return 3.0 * forward_flops3d(cfg, batch)


def mfu(flops_per_second: float, device=None) -> float:
    """Model FLOP utilization vs the device's bf16 peak (raises for a
    device without a published peak)."""
    return flops_per_second / (peak_tflops(device) * 1e12)


# ---------------------------------------------------------------------------
# HBM bytes model (the roofline's other axis)
# ---------------------------------------------------------------------------


def param_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> float:
    """Total parameter bytes (w_mu + w_sigma across all layers)."""
    import numpy as np

    from supernet_tpu.models import init_params

    params = jax.eval_shape(
        lambda k: init_params(k, cfg), jax.random.PRNGKey(0)
    )
    return float(
        sum(np.prod(l.shape) for l in jax.tree_util.tree_leaves(params))
        * dtype_bytes
    )


def forward_act_bytes(
    cfg: ModelConfig, batch: int = 1, act_bytes: int = 2
) -> float:
    """MINIMUM forward HBM activation traffic at ``act_bytes``/element.

    Counts, for every conv layer, one read of its (mu, sigma) input pair and
    one write of its output pair — i.e. every inter-layer tensor moves
    through HBM exactly once each way, with all elementwise ops (relu masks,
    pads, variance scaling) perfectly fused into the convs. Pool/concat
    re-reads are not charged. This is the optimistic lower bound a
    bandwidth-roofline needs: if even this traffic at peak HBM GB/s ~= the
    measured step time, the step is memory-bound.

    Geometry: VALID convs read (H_out + k - 1)^2; the fused unpool+2x2 convs
    (``vunpool_conv2``, ops/moments.py:629) read the PRE-unpool tensor of
    size (H_out / 2)^2 — one of the wins over the reference's materialized
    zero-interleave (`Hippocampus.py:26-51`).
    """
    from supernet_tpu.models import layer_names

    shapes = dict(_conv_shapes(cfg))
    total = 0.0
    for name, k, cin, cout in layer_names(cfg):
        h_out = shapes[name]
        if name.endswith("_conv2x2"):
            h_in = h_out // 2
        else:
            h_in = h_out + k - 1
        n_in_moments = 1 if name == "conv_input" else 2
        total += h_in * h_in * cin * n_in_moments  # read mu(,sigma)
        total += h_out * h_out * cout * 2  # write mu+sigma
    return float(total) * batch * act_bytes


def train_step_min_bytes(
    cfg: ModelConfig, batch: int, act_bytes: int = 2
) -> float:
    """HBM traffic model of one train step under the STORE-EVERYTHING
    strategy: forward + backward activation movement (bwd reads every
    residual and moves the grad stream both ways ~= 2x forward) +
    parameter/optimizer traffic (params read fwd+bwd, grads written+read,
    Adam m/v read+write, params written ~= 9x param bytes, f32).

    Two caveats vs the truth: (a) remat/fusion can UNDERCUT this by
    recomputing instead of storing (XLA fuses aggressively; its own
    bytes-accessed estimate for the compiled BraTS step is ~3x below this
    model); (b) re-reads from poor scheduling can exceed it. Treat it as
    the traffic scale of the classic roofline, reported alongside XLA's
    compiled-module estimate in bench.py, not as a hard bound."""
    return 3.0 * forward_act_bytes(cfg, batch, act_bytes) + 9.0 * param_bytes(
        cfg
    )


def forward_act_bytes3d(
    cfg: ModelConfig, batch: int = 1, act_bytes: int = 2
) -> float:
    """MINIMUM volumetric forward HBM activation traffic — the 2-D counting
    one rank up (see `forward_act_bytes` for the model and caveats): one
    read of each conv's input (mu, sigma) pair, one write of its output
    pair; the fused lhs-dilated unpool-conv (`ops.moments3d.vunpool3d_conv2`)
    reads the PRE-unpool cube of side D_out/2 instead of the materialized
    (2n+1)^3 interleave."""
    from supernet_tpu.models import layer_names3d

    shapes = dict(_conv_shapes3d(cfg))
    total = 0.0
    for name, k, cin, cout in layer_names3d(cfg):
        d_out = shapes[name]
        if name.endswith("_conv2x2"):
            d_in = d_out // 2
        else:
            d_in = d_out + k - 1
        n_in_moments = 1 if name == "conv_input" else 2
        total += d_in**3 * cin * n_in_moments
        total += d_out**3 * cout * 2
    return float(total) * batch * act_bytes


def train_step_min_bytes3d(
    cfg: ModelConfig, batch: int, act_bytes: int = 2
) -> float:
    """Volumetric analog of `train_step_min_bytes` (same 3x activation +
    9x parameter model; 3-D param bytes counted from layer_names3d)."""
    import math as _math

    from supernet_tpu.models import layer_names3d

    p_bytes = 4.0 * sum(
        _math.prod((k, k, k, cin, cout)) + cout
        for _, k, cin, cout in layer_names3d(cfg)
    )
    return 3.0 * forward_act_bytes3d(cfg, batch, act_bytes) + 9.0 * p_bytes


def hbm_utilization(
    bytes_per_second: float, device=None
) -> float:
    """Achieved HBM bandwidth vs the device's peak (raises for a device
    without a published peak)."""
    return bytes_per_second / (peak_hbm_gbps(device) * 1e9)
