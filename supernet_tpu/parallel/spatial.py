"""Spatial (halo-exchange) partitioning of the VDP moment convolution.

The reference has no sequence/spatial parallelism (SURVEY.md §2.8: the
spatial axis is this conv model's analog of sequence parallelism, listed as
a stretch item in §7.4). This module provides the building block: the
image's H axis is sharded over the mesh, each 3x3 VALID moment conv
exchanges one boundary row with each neighbor (``lax.ppermute``), and
every device computes its H_loc output rows locally — activation memory
and conv FLOPs scale 1/D with the mesh size, enabling inference on scans
far larger than one device's memory.

Exact-VALID bookkeeping: with one zero halo row materializing at the mesh
edges, device d computes global output rows ``[d*H_loc - 1, (d+1)*H_loc - 2]``;
the assembled output therefore carries ``(k-1)//2`` garbage rows at the
very top and bottom, and ``trim_valid(y, k)`` removes them, recovering the
unsharded VALID conv's result (zero observed error on the CPU mesh;
tests/test_spatial.py).
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from supernet_tpu.ops import vconv

Array = jax.Array


def halo_exchange_rows(x: Array, axis_name: str, halo: int = 1) -> Array:
    """Per-shard [B, H_loc, W, C] -> [B, H_loc + 2*halo, W, C].

    The top halo is the previous device's last rows, the bottom halo the
    next device's first rows; mesh-edge devices receive zeros (ppermute's
    semantics for missing senders), which the caller trims away globally.
    """
    n = lax.axis_size(axis_name)
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    top = lax.ppermute(x[:, -halo:], axis_name, fwd)
    bottom = lax.ppermute(x[:, :halo], axis_name, bwd)
    return jnp.concatenate([top, x, bottom], axis=1)


def make_spatial_vconv(mesh: Mesh, axis_name: str = "data"):
    """Spatially-sharded VDP conv: ``f(mu, sigma, w_mu, w_sigma)`` with the
    H axis of both moments sharded over ``axis_name`` and the weights
    replicated. Output H is sharded the same way; apply ``trim_valid`` to
    the assembled result for exact VALID semantics.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, axis_name),
            P(None, axis_name),
            P(),
            P(),
        ),
        out_specs=(P(None, axis_name), P(None, axis_name)),
        check_vma=False,
    )
    def f(mu, sigma, w_mu, w_sigma):
        k = w_mu.shape[0]
        halo = (k - 1) // 2
        if halo > mu.shape[1]:
            raise ValueError(
                f"per-device rows ({mu.shape[1]}) < halo ({halo}); use "
                "fewer devices or a larger input (single-hop ppermute "
                "cannot fetch rows beyond the nearest neighbor)"
            )
        mu = halo_exchange_rows(mu, axis_name, halo)
        sigma = halo_exchange_rows(sigma, axis_name, halo)
        return vconv(mu, sigma, w_mu, w_sigma)

    return f


def make_spatial_encoder_block(mesh: Mesh, axis_name: str = "data"):
    """A whole spatially-sharded encoder block:
    ``conv3+relu -> conv3+relu -> maxpool`` with halo exchange per conv and
    the 2x2/stride-2 pool running shard-locally (windows never straddle a
    shard boundary when the per-device row count is even).

    Margin bookkeeping: each halo conv leaves one zero-contaminated row per
    global edge, so pre-pool the assembled map carries rows [-2, H-3] of
    the true coordinate frame. Because the per-device offset stays even,
    the pool grid aligns with the unsharded grid and the two garbage rows
    per edge collapse into ONE garbage pooled row per edge — apply
    ``trim_valid(y, k=3)`` (one row per side) to the assembled pooled
    output to recover the unsharded block exactly (tests/test_spatial.py).

    Returns ``f(mu, sigma, w1, ws1, w2, ws2) -> (mu, sigma)`` with H
    sharded on ``axis_name`` in and out. Requires per-device rows even and
    >= 4.
    """
    from supernet_tpu.ops import vconv_relu, vmaxpool

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, axis_name),
            P(None, axis_name),
            P(),
            P(),
            P(),
            P(),
        ),
        out_specs=(P(None, axis_name), P(None, axis_name)),
        check_vma=False,
    )
    def f(mu, sigma, w1, ws1, w2, ws2):
        h_loc = mu.shape[1]
        if h_loc % 2 != 0 or h_loc < 4:
            raise ValueError(
                f"per-device rows ({h_loc}) must be even and >= 4 for the "
                "shard-local 2x2 pool to align with the global pool grid"
            )
        mu_h = halo_exchange_rows(mu, axis_name)
        sg_h = halo_exchange_rows(sigma, axis_name)
        mu, sigma = vconv_relu(mu_h, sg_h, w1, ws1)
        mu_h = halo_exchange_rows(mu, axis_name)
        sg_h = halo_exchange_rows(sigma, axis_name)
        mu, sigma = vconv_relu(mu_h, sg_h, w2, ws2)
        return vmaxpool(mu, sigma)

    return f


def make_spatial_forward(cfg, mesh: Mesh, axis_name: str = "data"):
    """The FULL U-Net forward with the image H axis sharded over the mesh —
    spatial (sequence-parallel analog) partitioning of the whole model.

    Design: instead of hand-rolling halo exchanges through every
    VALID conv / pool / unpool / crop-concat (the offset bookkeeping the
    manual blocks above do for one block), the model is jitted with the
    batch replicated and H sharded, with a ``lax.with_sharding_constraint``
    re-pinning H to the mesh after every encoder/decoder block. XLA's SPMD
    partitioner (GSPMD, built for exactly this spatial partitioning) inserts
    the minimal halo exchanges (collective-permutes) for each
    window op and handles the uneven shard sizes the VALID chain produces.
    Activation memory per chip scales ~1/D — this is the path for scans far
    larger than one chip's HBM.

    Returns ``f(params, x) -> (probs, sigma)`` (flattened like ``forward``);
    numerically identical to the unsharded forward
    (tests/test_spatial.py::test_spatial_forward_matches_unsharded).
    """
    from supernet_tpu.models.unet import forward

    repl, x_sharded, constrain = _spatial_shardings(mesh, axis_name)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, x_sharded),
        out_shardings=(repl, repl),
    )
    def f(params, x):
        return forward(params, x, cfg, constrain=constrain)

    return f


def _spatial_shardings(mesh: Mesh, axis_name: str):
    """The shared GSPMD spatial recipe: (replicated sharding, H-sharded
    activation sharding, per-block constrain hook re-pinning H to the mesh
    so the partitioner keeps the spatial split through the whole net —
    uneven H is padded internally)."""
    from jax.sharding import NamedSharding

    repl = NamedSharding(mesh, P())
    h_sharded = NamedSharding(mesh, P(None, axis_name))

    def constrain(m, s):
        m = jax.lax.with_sharding_constraint(m, h_sharded)
        s = jax.lax.with_sharding_constraint(s, h_sharded)
        return m, s

    return repl, h_sharded, constrain


def make_spatial_train_step(cfg, tc, mesh: Mesh, axis_name: str = "data"):
    """Full training step with the image H axis sharded over the mesh —
    spatial partitioning of forward AND backward.

    Same GSPMD recipe as ``make_spatial_forward``: parameters and labels
    replicated, the input's H axis sharded, the per-block ``constrain``
    hook re-pinning H to the mesh through the whole net. The partitioner
    inserts the halo exchanges for every conv, conv-transpose and pool
    gradient, and all-reduces the (replicated-output) weight gradients —
    so ACTIVATION memory for the step scales ~1/D while the optimizer
    state stays replicated. This is the training-side path for inputs
    too large for one chip's HBM, complementary to data parallelism
    (which needs batch >= mesh and scales neither activation height nor
    per-sample memory).

    Numerics match the unsharded step to f32 reduction-order tolerance
    (tests/test_spatial.py::test_spatial_train_step_matches_unsharded).
    """
    from supernet_tpu.train import _train_step, make_optimizer

    opt = make_optimizer(tc)
    repl, x_sharded, constrain = _spatial_shardings(mesh, axis_name)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, x_sharded, repl),
        # pin the carried state AND metrics replicated: without this GSPMD
        # may pick a sharded layout for some leaf and every iteration would
        # pay an implicit reshard to satisfy in_shardings (and break the
        # donation)
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )
    def step(state, x, y):
        new_state, metrics, _ = _train_step(
            state, x, y, opt, cfg, tc, constrain=constrain
        )
        return new_state, metrics

    return step


def trim_valid(y: Array, k: int = 3) -> Array:
    """Drop the ``(k-1)//2`` zero-halo-contaminated rows at the global top
    and bottom of a spatially-sharded conv output, recovering the exact
    unsharded VALID result."""
    t = (k - 1) // 2
    return y[:, t : y.shape[1] - t]


def _spatial_shardings3d(mesh: Mesh, axis_name: str):
    """3-D GSPMD spatial recipe: volumes sharded on the D (scan) axis —
    dim 1 of [B, D, H, W, C]."""
    from jax.sharding import NamedSharding

    repl = NamedSharding(mesh, P())
    d_sharded = NamedSharding(mesh, P(None, axis_name))

    def constrain(m, s):
        m = jax.lax.with_sharding_constraint(m, d_sharded)
        s = jax.lax.with_sharding_constraint(s, d_sharded)
        return m, s

    return repl, d_sharded, constrain


def make_spatial_forward3d(cfg, mesh: Mesh, axis_name: str = "data"):
    """Volumetric forward with the D (scan) axis sharded over the mesh —
    spatial partitioning of WHOLE VOLUMES, the case where it genuinely
    matters: a 240^3 BraTS volume's activation pairs do not fit one chip.

    Same GSPMD recipe as the 2-D `make_spatial_forward`: parameters
    replicated, the volume's D axis sharded, a per-block constraint
    re-pinning D to the mesh; the SPMD partitioner inserts the halo
    collective-permutes for every 3-D window op. Numerically identical to
    the unsharded `forward3d` (tests/test_spatial.py)."""
    from supernet_tpu.models.unet3d import forward3d

    repl, x_sharded, constrain = _spatial_shardings3d(mesh, axis_name)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, x_sharded),
        out_shardings=(repl, repl),
    )
    def f(params, x):
        return forward3d(params, x, cfg, constrain=constrain)

    return f


def make_spatial_train_step3d(cfg, tc, mesh: Mesh, axis_name: str = "data"):
    """Volumetric training step with the D axis sharded over the mesh —
    activation memory per chip scales ~1/n while parameters/optimizer
    state stay replicated (the 3-D analog of `make_spatial_train_step`).
    Reuses the SHARED step body (`train3d._train_step3d`), so augmentation
    and the objective are identical to the plain-jit path."""
    from supernet_tpu.train import make_optimizer
    from supernet_tpu.train3d import _train_step3d

    opt = make_optimizer(tc)
    repl, x_sharded, constrain = _spatial_shardings3d(mesh, axis_name)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, x_sharded, repl),
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )
    def step(state, x, y):
        return _train_step3d(state, x, y, opt, cfg, tc, constrain=constrain)

    return step
