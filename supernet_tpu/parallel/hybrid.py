"""Hybrid data x spatial partitioning over a 2-D device mesh.

The reference is single-GPU TF2 scripts (SURVEY.md §2.8 — no distributed
backend at all); data parallelism and spatial (halo-exchange)
partitioning were built separately in `parallel.data_parallel` and
`parallel.spatial`. This module composes them in ONE
``jax.sharding.Mesh`` with a ``data`` axis and a ``space`` axis, the
batch sharded over ``data`` AND the image H (or volume D) axis sharded
over ``space`` in the same jitted step. XLA's SPMD partitioner (GSPMD)
derives every collective from the sharding annotations alone:

- halo collective-permutes along ``space`` for each conv / pool /
  conv-transpose window op (as in `parallel.spatial`),
- the weight-gradient all-reduce along BOTH axes (params are replicated
  in and pinned replicated out, so each gradient is psum'd over the full
  mesh — the DP grad sync and the spatial grad assembly in one
  collective).

When to use which axis: ``data`` scales throughput with more chips
(needs global batch >= n_data); ``space`` scales the per-sample
activation footprint (whole-volume 3-D training where one sample's
activation pairs exceed a device's memory). The 2-D mesh covers the
regime where BOTH bind — e.g. batch 4 of 240^3 BraTS volumes on 16
devices as a (4 data) x (4 space) mesh. The ``space`` axis is the mesh's
minor dimension (adjacent device ids), where the per-step halo exchanges
run.

Numerics match the unsharded step to f32 reduction-order tolerance
(tests/test_hybrid.py), same as each 1-D specialization.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from supernet_tpu.configs import ModelConfig, TrainConfig

Array = jax.Array

_AXES: Tuple[str, str] = ("data", "space")


def make_mesh2d(
    n_data: int,
    n_space: int,
    axis_names: Tuple[str, str] = _AXES,
) -> Mesh:
    """A (n_data, n_space) device mesh. ``axis_names[1]`` (space) is the
    minor axis — adjacent device ids — because the halo exchanges run once
    per window op while the gradient all-reduce runs once per step."""
    devices = jax.devices()
    n = n_data * n_space
    if len(devices) < n:
        raise ValueError(
            f"mesh needs {n_data}x{n_space}={n} devices, "
            f"{len(devices)} available"
        )
    return Mesh(
        np.asarray(devices[:n]).reshape(n_data, n_space), axis_names
    )


def _hybrid_shardings(mesh: Mesh, data_axis: str, space_axis: str):
    """(replicated, batch+H-sharded activations, batch-sharded labels,
    per-block constrain hook). The hook re-pins every moment pair to
    P(data, space) so GSPMD keeps both splits through the whole net
    instead of collapsing one axis at the first uneven VALID shape."""
    repl = NamedSharding(mesh, P())
    act = NamedSharding(mesh, P(data_axis, space_axis))
    batch_only = NamedSharding(mesh, P(data_axis))

    def constrain(m, s):
        m = jax.lax.with_sharding_constraint(m, act)
        s = jax.lax.with_sharding_constraint(s, act)
        return m, s

    return repl, act, batch_only, constrain


def make_hybrid_train_step(
    cfg: ModelConfig,
    tc: TrainConfig,
    mesh: Mesh,
    data_axis: str = "data",
    space_axis: str = "space",
):
    """Full 2-D-model training step on a (data, space) mesh: the batch
    axis of ``x``/``y`` sharded over ``data_axis``, the image H axis of
    ``x`` (and of every activation, via the per-block constraint) sharded
    over ``space_axis``; parameters/optimizer state replicated.

    Requires batch % n_data == 0; H is padded internally by GSPMD when it
    does not divide n_space (the input enters batch-sharded and is
    re-pinned to (data, space) INSIDE the program — jit's in_shardings
    cannot express an unevenly divisible split, with_sharding_constraint
    can). Returns ``step(state, x, y)`` with the same
    signature/semantics as ``train.make_train_step``.
    """
    from supernet_tpu.train import _train_step, make_optimizer

    opt = make_optimizer(tc)
    repl, act, batch_only, constrain = _hybrid_shardings(
        mesh, data_axis, space_axis
    )

    @functools.partial(
        jax.jit,
        in_shardings=(repl, batch_only, batch_only),
        # pin state + metrics replicated (see make_spatial_train_step:
        # an unpinned leaf would reshard every iteration and break
        # donation)
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )
    def step(state, x, y):
        x = jax.lax.with_sharding_constraint(x, act)
        new_state, metrics, _ = _train_step(
            state, x, y, opt, cfg, tc, constrain=constrain
        )
        return new_state, metrics

    return step


def make_hybrid_forward(
    cfg: ModelConfig,
    mesh: Mesh,
    data_axis: str = "data",
    space_axis: str = "space",
):
    """Inference twin of ``make_hybrid_train_step``: batch over ``data``,
    H over ``space``, outputs replicated. ``f(params, x) -> (probs,
    sigma)`` flattened like ``models.forward``."""
    from supernet_tpu.models.unet import forward

    repl, act, batch_only, constrain = _hybrid_shardings(
        mesh, data_axis, space_axis
    )

    @functools.partial(
        jax.jit, in_shardings=(repl, batch_only), out_shardings=(repl, repl)
    )
    def f(params, x):
        x = jax.lax.with_sharding_constraint(x, act)
        return forward(params, x, cfg, constrain=constrain)

    return f


def make_hybrid_train_step3d(
    cfg: ModelConfig,
    tc: TrainConfig,
    mesh: Mesh,
    data_axis: str = "data",
    space_axis: str = "space",
):
    """Volumetric training step on a (data, space) mesh: batch over
    ``data_axis``, the D (scan) axis of [B, D, H, W, C] volumes over
    ``space_axis`` — the combination for whole-volume training where one
    volume's activations alone strain a chip AND the batch still has
    parallelism to give. Same shared step body as the 1-D paths
    (`train3d._train_step3d`), so augmentation/objective are identical."""
    from supernet_tpu.train import make_optimizer
    from supernet_tpu.train3d import _train_step3d

    opt = make_optimizer(tc)
    repl, act, batch_only, constrain = _hybrid_shardings(
        mesh, data_axis, space_axis
    )

    @functools.partial(
        jax.jit,
        in_shardings=(repl, batch_only, batch_only),
        out_shardings=(repl, repl),
        donate_argnums=(0,),
    )
    def step(state, x, y):
        # D enters batch-sharded only and is re-pinned here: in_shardings
        # cannot express a non-divisible D split, the internal constraint
        # can (GSPMD pads) — whole volumes rarely divide the space axis
        x = jax.lax.with_sharding_constraint(x, act)
        return _train_step3d(state, x, y, opt, cfg, tc, constrain=constrain)

    return step
