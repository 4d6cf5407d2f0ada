"""Inference/serving surface: AOT compilation, StableHLO export, and a
padded-batch inference session.

The reference has no deployment story — prediction happens inline in the
training scripts via ``model(...)`` calls (`Hippocampus.py:894-1049`,
`Brats.py:984-1049`). A production framework needs a frozen,
compile-once inference path. Design decisions:

- the forward pass is a pure function ``(params, x) -> (probs, sigma)``
  (models/unet.py), so serving is: AOT-compile that function ONCE at a
  fixed batch size and keep the parameters resident in device HBM;
- variable request sizes are handled by pad-to-batch + slice rather
  than recompilation — XLA specializes on static shapes, and a fresh
  compile (tens of seconds for the full model) in the request path would
  stall serving;
- ``export_stablehlo`` emits the portable StableHLO module for external
  runtimes (PJRT plugins / IFRT serving stacks) so deployment does not
  require Python or this package;
- a ``jax.sharding.Mesh`` turns the same session into a data-parallel
  server: parameters replicated, request batch sharded on the batch
  axis (same shardings as parallel/data_parallel.py).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from supernet_tpu.configs import ModelConfig
from supernet_tpu.models import forward_images

Array = jax.Array


def _input_spec(
    cfg: ModelConfig, batch_size: int, volumetric: bool = False
) -> jax.ShapeDtypeStruct:
    s = cfg.image_size
    spatial = (s, s, s) if volumetric else (s, s)
    return jax.ShapeDtypeStruct(
        (batch_size,) + spatial + (cfg.in_channels,), jnp.float32
    )


def _make_recalibrate(variance_scale: float, temperature: float):
    """Post-hoc recalibration inside the compiled program: the global
    variance scale and probability-space temperature fitted by
    `calibration.fit_variance_scale` / `fit_temperature` (a no-op at the
    1.0 defaults — XLA folds the identity away)."""
    if variance_scale <= 0.0 or temperature <= 0.0:
        raise ValueError(
            "variance_scale and temperature must be positive "
            f"(got {variance_scale}, {temperature})"
        )

    def _recalibrate(probs, sigma):
        if temperature != 1.0:
            p = jnp.power(jnp.maximum(probs, 1e-30), 1.0 / temperature)
            probs = p / jnp.sum(p, axis=-1, keepdims=True)
        if variance_scale != 1.0:
            sigma = sigma * variance_scale
        return probs, sigma

    return _recalibrate


def _make_fn(
    cfg: ModelConfig,
    mesh=None,
    volumetric: bool = False,
    shard: str = "batch",
    variance_scale: float = 1.0,
    temperature: float = 1.0,
):
    if shard not in ("batch", "scan"):
        raise ValueError(f"unknown shard mode {shard!r}")
    if shard == "scan" and not volumetric:
        raise ValueError(
            "shard='scan' shards a volume's D axis — volumetric only"
        )
    if shard == "scan" and mesh is None:
        raise ValueError(
            "shard='scan' needs a mesh to shard the D axis over — the "
            "whole point of the mode is multi-chip whole-volume serving"
        )
    constrain = None
    if mesh is not None and shard == "scan":
        # whole-volume regime: each volume's scan (D) axis over the mesh,
        # the same GSPMD recipe as parallel.make_spatial_forward3d —
        # serve scans whose activation pairs do not fit one chip
        from supernet_tpu.parallel.spatial import _spatial_shardings3d

        _, _d_sharded, constrain = _spatial_shardings3d(mesh, "data")

    _recalibrate = _make_recalibrate(variance_scale, temperature)

    if volumetric:
        from supernet_tpu.models import forward3d

        o = cfg.out_size

        def fn(params, x):
            if constrain is not None:
                x, _ = constrain(x, x)
            probs, sigma = forward3d(params, x, cfg, constrain=constrain)
            b = x.shape[0]
            shape = (b, o, o, o, cfg.n_classes)
            return _recalibrate(
                probs.reshape(shape), sigma.reshape(shape)
            )

    else:

        def fn(params, x):
            return _recalibrate(*forward_images(params, x, cfg))

    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    if shard == "scan":
        # outputs replicated: every device holds the full (small) result
        return jax.jit(fn, in_shardings=(rep, rep), out_shardings=(rep, rep))
    batched = NamedSharding(mesh, P("data"))
    return jax.jit(
        fn,
        in_shardings=(rep, batched),
        out_shardings=(batched, batched),
    )


def _stack_members(params_list):
    """Stack a list of same-structure member trees on a leading K axis."""
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *params_list
    )


def lower(
    params,
    cfg: ModelConfig,
    batch_size: int = 8,
    mesh=None,
    volumetric: bool = False,
    variance_scale: float = 1.0,
    temperature: float = 1.0,
):
    """``jax.jit(forward).lower(...)`` at a fixed batch size — the common
    stem for both AOT compilation and StableHLO export. ``volumetric``
    serves the 3-D family (`models.forward3d`) instead; a fitted
    recalibration is baked into the lowered module.

    A LIST/TUPLE of member trees lowers the deep-ensemble mixture instead
    (the ``EnsembleSession`` computation: vmapped members, uniform-mixture
    first two moments, recalibration after the mixture); the lowered
    module's parameter arguments then carry a leading K member axis.
    """
    if isinstance(params, (list, tuple)):
        member = _make_fn(cfg, mesh, volumetric)
        recal = _make_recalibrate(variance_scale, temperature)

        def efn(stacked, x):
            p, s = jax.vmap(lambda pr: member(pr, x))(stacked)
            mean = jnp.mean(p, axis=0)
            # stable mixture second moment (see EnsembleSession.efn)
            var = jnp.mean(s + jnp.square(p - mean[None]), axis=0)
            return recal(mean, var)

        return jax.jit(efn).lower(
            jax.eval_shape(lambda p: p, _stack_members(list(params))),
            _input_spec(cfg, batch_size, volumetric),
        )
    return _make_fn(
        cfg, mesh, volumetric,
        variance_scale=variance_scale, temperature=temperature,
    ).lower(
        jax.eval_shape(lambda p: p, params),
        _input_spec(cfg, batch_size, volumetric),
    )


def export_stablehlo(
    params,
    cfg: ModelConfig,
    batch_size: int = 8,
    path: Optional[str] = None,
    volumetric: bool = False,
    variance_scale: float = 1.0,
    temperature: float = 1.0,
) -> str:
    """Serialize the inference computation as StableHLO module text.

    The module closes over nothing: parameters are explicit arguments in
    ``layer_names`` order, so any PJRT-capable runtime can execute it
    against a checkpoint exported with ``checkpoint.save_npz``. A fitted
    post-hoc recalibration (variance_scale / temperature) becomes part
    of the exported computation itself.
    """
    text = lower(
        params, cfg, batch_size, volumetric=volumetric,
        variance_scale=variance_scale, temperature=temperature,
    ).as_text(
        dialect="stablehlo"
    )
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return text


def aot_compile(params, cfg: ModelConfig, batch_size: int = 8, mesh=None):
    """Ahead-of-time compile the inference step; returns the loaded
    executable (``jax.stages.Compiled``) plus XLA's cost analysis."""
    compiled = lower(params, cfg, batch_size, mesh).compile()
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, list):  # per-device list on some backends
            cost = cost[0] if cost else {}
    except Exception:  # pragma: no cover - backend-dependent
        cost = {}
    return compiled, cost


class InferenceSession:
    """Compile-once, padded-batch inference.

    ``predict(x)`` accepts any leading batch size: the input is chunked
    to the compiled batch size, the final partial chunk is padded by
    repeating its last row and the padding sliced off the outputs — the
    exact pad-and-mask scheme the mesh evaluation path uses
    (evaluate._pad_batch), so numbers match the library's own eval.

    ``variance_scale`` / ``temperature`` bake a fitted post-hoc
    recalibration (`calibration.fit_variance_scale` /
    `fit_temperature`) into the compiled program, so deployed
    predictions are the honest ones.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        batch_size: int = 8,
        mesh=None,
        volumetric: bool = False,
        shard: str = "batch",
        variance_scale: float = 1.0,
        temperature: float = 1.0,
    ):
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self._mesh = mesh
        self.volumetric = bool(volumetric)
        if mesh is not None and shard == "batch":
            n_dev = int(np.prod(mesh.devices.shape))
            if self.batch_size % n_dev != 0:
                # surface the sharding constraint at setup, not inside the
                # first predict() call's jit (scan mode shards the volume's
                # D axis instead and has no batch constraint)
                raise ValueError(
                    f"batch_size {self.batch_size} is not divisible by the "
                    f"{n_dev}-device mesh; the compiled batch must shard "
                    "evenly over the data axis"
                )
        if mesh is not None:
            from supernet_tpu.parallel import replicate

            params = replicate(mesh, params)
        else:
            params = jax.device_put(params)
        self._params = params
        self._fn = _make_fn(
            cfg, mesh, volumetric, shard,
            variance_scale=variance_scale, temperature=temperature,
        )

    def warmup(self) -> "InferenceSession":
        """Trigger compilation outside the request path."""
        x = jnp.zeros(
            _input_spec(self.cfg, self.batch_size, self.volumetric).shape,
            jnp.float32,
        )
        probs, sigma = self._fn(self._params, x)
        jax.block_until_ready((probs, sigma))
        return self

    def predict(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """[N, H, W, C] (or [N, D, H, W, C] volumetric) -> (probs, sigma),
        image/volume-shaped with a trailing class dim."""
        x = np.asarray(x, np.float32)
        n = len(x)
        if n == 0:
            o = self.cfg.out_size
            spatial = (o, o, o) if self.volumetric else (o, o)
            shape = (0,) + spatial + (self.cfg.n_classes,)
            return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
        probs_out, sigma_out = [], []
        for i in range(0, n, self.batch_size):
            chunk = x[i : i + self.batch_size]
            b = len(chunk)
            if b < self.batch_size:
                reps = np.repeat(
                    chunk[-1:], self.batch_size - b, axis=0
                )
                chunk = np.concatenate([chunk, reps], axis=0)
            p, s = self._fn(self._params, jnp.asarray(chunk))
            probs_out.append(np.asarray(p)[:b])
            sigma_out.append(np.asarray(s)[:b])
        return np.concatenate(probs_out), np.concatenate(sigma_out)

    def predict_volume(
        self,
        vol: np.ndarray,
        overlap: int = 0,
        weight: str = "gaussian",
        pad_mode: str = "reflect",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sliding-window ``(probs, sigma)`` over ONE whole volume of any
        spatial shape (``[D, H, W]`` or ``[D, H, W, C]``) — overlapping
        model cubes batched through the compiled program and blended per
        voxel (`tiling.predict_volume`). Volumetric sessions only."""
        if not self.volumetric:
            raise ValueError("predict_volume requires volumetric=True")
        from supernet_tpu.tiling import predict_volume as _pv

        return _pv(
            self.predict,
            vol,
            self.cfg.image_size,
            self.cfg.out_size,
            overlap=overlap,
            weight=weight,
            pad_mode=pad_mode,
        )

    def predict_image(
        self,
        img: np.ndarray,
        overlap: int = 0,
        weight: str = "gaussian",
        pad_mode: str = "reflect",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sliding-window ``(probs, sigma)`` over ONE 2-D image of any
        spatial shape (``[H, W]`` or ``[H, W, C]``) through the
        fixed-geometry 2-D model (`tiling.predict_image`). 2-D sessions
        only."""
        if self.volumetric:
            raise ValueError(
                "predict_image is for 2-D sessions; use predict_volume"
            )
        from supernet_tpu.tiling import predict_image as _pi

        return _pi(
            self.predict,
            img,
            self.cfg.image_size,
            self.cfg.out_size,
            overlap=overlap,
            weight=weight,
            pad_mode=pad_mode,
        )


class EnsembleSession(InferenceSession):
    """Deep-ensemble serving: K checkpoints of the SAME config answered by
    ONE compiled program (members vmapped over a stacked parameter tree —
    XLA batches the K forwards; no Python loop, no per-member dispatch).

    Each member emits a per-pixel Gaussian ``(p_k, s_k)``; the ensemble
    predictive is the uniform mixture, reported by its first two moments:

        mean = (1/K) sum p_k
        var  = (1/K) sum (s_k + p_k^2) - mean^2

    i.e. within-member (propagated) variance PLUS the between-member
    disagreement — the ensembles-over-VDP composition (Lakshminarayanan
    et al.'s deep-ensemble recipe applied to moment pairs). ``var >= mean
    member variance`` pointwise by Jensen; equal members reduce exactly
    to a single session. Fitted recalibration applies AFTER the mixture
    (fit it on ensemble outputs).

    With a ``mesh``, the MEMBER axis shards over the mesh's data axis:
    each device runs its members on the full (replicated) batch and the
    mixture means become one all-reduce — embarrassingly
    parallel ensemble serving in the same compiled program. When
    ``K % n_devices != 0`` the member axis is padded with zero-weight
    repeats of the last member, so any K serves on any mesh.
    ``predict`` / ``predict_volume`` / ``predict_image`` are inherited.
    """

    def __init__(
        self,
        params_list,
        cfg: ModelConfig,
        batch_size: int = 8,
        volumetric: bool = False,
        variance_scale: float = 1.0,
        temperature: float = 1.0,
        mesh=None,
    ):
        params_list = list(params_list)
        if not params_list:
            raise ValueError("params_list must hold at least one member")
        # member fn WITHOUT recalibration: recalibration is post-mixture;
        # the parent session is built meshless — the ensemble shards the
        # member axis itself below
        super().__init__(
            params_list[0], cfg, batch_size=batch_size,
            volumetric=volumetric,
        )
        self.n_members = len(params_list)
        member = self._fn
        recal = _make_recalibrate(variance_scale, temperature)
        # Mixture weights, uniform over the REAL members. When K does not
        # divide the mesh's device count, the member axis is padded by
        # repeating the last member with weight 0 — it computes but cannot
        # influence the mixture (weighted mean/second-moment below), so
        # K=6 on 8 devices serves instead of refusing. Meshless sessions
        # never pad.
        k = self.n_members
        n_pad = 0
        if mesh is not None:
            n_dev = int(np.prod(mesh.devices.shape))
            n_pad = (-k) % n_dev
            if n_pad:
                params_list = params_list + [params_list[-1]] * n_pad
        weights = jnp.concatenate(
            [jnp.full((k,), 1.0 / k, jnp.float32), jnp.zeros((n_pad,))]
        )
        stacked = _stack_members(params_list)

        def efn(params, x):
            p, s = jax.vmap(lambda pr: member(pr, x))(params)
            w = weights.reshape((-1,) + (1,) * (p.ndim - 1))
            mean = jnp.sum(w * p, axis=0)
            # Σw·s + Σw·(p−mean)² == Σw(s+p²) − mean², but without the
            # catastrophic cancellation (s ~1e-5 under p² ~1) and
            # non-negative by construction
            var = jnp.sum(w * (s + jnp.square(p - mean)), axis=0)
            return recal(mean, var)

        if mesh is None:
            self._params = jax.device_put(stacked)
            self._fn = jax.jit(efn)
        else:
            # shard_map over the member axis: each device vmaps its own
            # block of members and the weighted sums are psum'd. (Left to
            # the SPMD partitioner, the vmapped convs — grouped
            # convolutions over the member axis — came out wrong at full
            # width when sharded on that axis.)
            from jax import shard_map
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._mesh = mesh
            members_sh = NamedSharding(mesh, P("data"))
            self._params = jax.device_put(stacked, members_sh)
            w_sh = jax.device_put(weights, members_sh)

            def local(params, w, x):
                p, s = jax.vmap(lambda pr: member(pr, x))(params)
                w = w.reshape((-1,) + (1,) * (p.ndim - 1))
                mean = jax.lax.psum(jnp.sum(w * p, axis=0), "data")
                var = jax.lax.psum(
                    jnp.sum(w * (s + jnp.square(p - mean)), axis=0), "data")
                return recal(mean, var)

            smapped = shard_map(
                local, mesh=mesh, in_specs=(P("data"), P("data"), P()),
                out_specs=(P(), P()), check_vma=False)
            self._fn = jax.jit(lambda params, x: smapped(params, w_sh, x))


def export_bundle(
    params,
    cfg: ModelConfig,
    out_dir: str,
    batch_size: int = 8,
    config_name: str = "",
    volumetric: bool = False,
    variance_scale: float = 1.0,
    temperature: float = 1.0,
) -> dict:
    """Write a self-contained serving bundle:

    - ``model.stablehlo.mlir`` — the inference computation;
    - ``params.npz``            — flat parameter checkpoint
      (checkpoint.save_params_npz layout, keys
      ``{layer}/w_mu``/``{layer}/w_sigma``);
    - ``export_meta.json``      — shapes, dtypes, per-image FLOPs, config.

    ``volumetric`` exports the 3-D family's forward instead (cube in,
    cube out). ``variance_scale`` / ``temperature`` (from
    `calibration.fit_variance_scale` / `fit_temperature`) are baked into
    the exported computation and recorded in the metadata. Returns the
    metadata dict (also printed by ``cli.py export``).

    A LIST of member trees exports the deep-ensemble mixture (the
    ``EnsembleSession`` computation): ``params.npz`` then holds the
    STACKED parameters (leading K member axis on every array) and the
    metadata records ``ensemble_members``.
    """
    from supernet_tpu import flops as F
    from supernet_tpu.checkpoint import save_params_npz

    n_members = len(params) if isinstance(params, (list, tuple)) else 0
    os.makedirs(out_dir, exist_ok=True)
    hlo_path = os.path.join(out_dir, "model.stablehlo.mlir")
    export_stablehlo(
        params, cfg, batch_size, path=hlo_path, volumetric=volumetric,
        variance_scale=variance_scale, temperature=temperature,
    )
    save_params_npz(
        os.path.join(out_dir, "params.npz"),
        _stack_members(list(params)) if n_members else params,
    )
    spec = _input_spec(cfg, batch_size, volumetric)
    o = cfg.out_size
    out_spatial = [o, o, o] if volumetric else [o, o]
    meta = {
        "config": config_name,
        "volumetric": bool(volumetric),
        "variance_scale": float(variance_scale),
        "temperature": float(temperature),
        "batch_size": batch_size,
        "input_shape": list(spec.shape),
        "input_dtype": "float32",
        "output_shape": [batch_size, *out_spatial, cfg.n_classes],
        "outputs": ["probs", "sigma"],
        "forward_gflops_per_image": round(
            (
                F.forward_flops3d(cfg, 1)
                if volumetric
                else F.forward_flops(cfg, 1)
            )
            / 1e9,
            3,
        ),
        "param_count": int(
            sum(
                int(np.prod(v.shape))
                for p in (params[0] if n_members else params).values()
                for v in p.values()
            )
        ),
        "files": ["model.stablehlo.mlir", "params.npz"],
    }
    if n_members:
        meta["ensemble_members"] = n_members
    with open(os.path.join(out_dir, "export_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta
