"""Training driver for the volumetric model family (`models/unet3d.py`).

A compact epoch loop for 3-D cubes mirroring the essential `Trainer`
surface — jitted train/eval steps (same ELBO objective, Adam with the
reference's per-tensor clipnorm via `train.make_optimizer`), per-epoch
npz checkpoints in the same ``epoch_{N}`` scheme, loss/accuracy/val-dice
history, curve PNGs + history pickle. The 2-D `Trainer`'s full report
surface (per-structure curves, hyperparameter dumps) stays 2-D: the
reference's clinical-structure maskers are defined on slices.

Data: [N, S, S, S, C] cubes + [N, S, S, S] int labels — what
`data.nifti.volume_to_cube` produces from raw NIfTI volumes, or
`data.synthetic.synthetic_volumes` for smoke runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from supernet_tpu import checkpoint as ckpt
from supernet_tpu.configs import ExperimentConfig, ModelConfig, TrainConfig
from supernet_tpu.losses import elbo_loss, nll_gaussian
from supernet_tpu.models import forward3d, init_params3d, kl_regularizer3d
from supernet_tpu.train import (
    StepMetrics,
    TrainState,
    create_train_state,
    make_optimizer,
    one_hot_flatten,
)

Array = jax.Array


def _crop_center_vol(y: np.ndarray, size: int) -> np.ndarray:
    """Center-crop an [N, S, S, S] label volume to [N, size, size, size]
    (the VALID geometry shrinks the output exactly like 2-D, per axis);
    pure slicing, shared with the device ops
    (`ops.moments3d.crop_center3d`)."""
    from supernet_tpu.ops.moments3d import crop_center3d

    return crop_center3d(y, size, size, size)


def _train_step3d(
    state: TrainState,
    x: Array,
    y: Array,
    opt,
    cfg: ModelConfig,
    tc: TrainConfig,
    constrain=None,
    seed: Array | None = None,
) -> Tuple[TrainState, StepMetrics]:
    """The shared volumetric step body (the 3-D analog of
    `train._train_step`) — used by both the plain-jit `make_train_step3d`
    and the mesh-sharded `parallel.spatial.make_spatial_train_step3d`, so
    augmentation and the objective cannot diverge between paths.

    ``seed`` overrides ``tc.seed`` for the augmentation key — the ensemble
    step passes each member's own (traced) seed so member k's draws match
    a sequential run seeded ``tc.seed + k`` (same contract as the 2-D
    `train.maybe_augment`)."""
    if tc.augment is not None:
        from supernet_tpu.data.augment import augment_volumes

        base = tc.seed if seed is None else seed
        key = jax.random.fold_in(jax.random.PRNGKey(base), state.step)
        x, y = augment_volumes(key, x, y, tc.augment)
    y1h = one_hot_flatten(y, cfg.n_classes)

    def loss_fn(p):
        probs, sigma = forward3d(p, x, cfg, constrain=constrain)
        loss = elbo_loss(
            y1h, probs, sigma, kl_regularizer3d(p), tc.kl_factor,
            tc.sigma_clip_min, tc.sigma_clip_max,
        )
        nll = nll_gaussian(
            y1h, probs,
            jnp.clip(sigma, tc.sigma_clip_min, tc.sigma_clip_max),
        )
        return loss, (nll, probs)

    (loss, (nll, probs)), grads = jax.value_and_grad(
        loss_fn, has_aux=True
    )(state.params)
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    pred = jnp.argmax(probs, -1).astype(jnp.int32)
    acc = jnp.mean((pred == jnp.argmax(y1h, -1)).astype(jnp.float32))
    kl = kl_regularizer3d(params)
    return (
        TrainState(params, opt_state, state.step + 1),
        StepMetrics(loss, nll, kl, acc),
    )


def make_train_step3d(cfg: ModelConfig, tc: TrainConfig):
    """Jitted volumetric train step; donates the carried state. ``y`` is an
    int label cube [B, out, out, out] — one-hot happens on device."""
    opt = make_optimizer(tc)

    def _step(state: TrainState, x: Array, y: Array):
        return _train_step3d(state, x, y, opt, cfg, tc)

    return jax.jit(_step, donate_argnums=(0,))


def make_multi_train_step3d(cfg: ModelConfig, tc: TrainConfig, k_steps: int):
    """K volumetric train steps per dispatch via ``lax.scan`` — the 3-D
    twin of `train.make_multi_train_step`. Takes stacked batches
    ``x: [K, B, S, S, S, C]``, ``y: [K, B, o, o, o]`` and runs the chunk
    in one XLA program, removing the per-step host round-trip (the
    dispatch overhead is a fixed cost per program, amortized K-fold).
    Returns per-step StepMetrics stacked on the leading axis."""
    import functools

    opt = make_optimizer(tc)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def steps(state: TrainState, x: Array, y: Array):
        def body(s, xy):
            xb, yb = xy
            s, m = _train_step3d(s, xb, yb, opt, cfg, tc)
            return s, m

        return jax.lax.scan(body, state, (x, y), length=k_steps)

    return steps


def make_ensemble_train_step3d(
    cfg: ModelConfig, tc: TrainConfig, mesh=None, member_mode: str = "vmap"
):
    """One-compiled-program volumetric deep-ensemble training — the 3-D
    twin of `train.make_ensemble_train_step` (same member-axis contract:
    stacked ``state`` leaves ``[K, ...]``, ``x [K, B, S, S, S, C]``,
    ``y [K, B, o, o, o]`` int label cubes, ``seeds [K]`` int32 per-member
    augmentation seeds).

    ``member_mode``: ``"unroll"`` (single-device default in
    `ensemble.EnsembleTrainer3D` — Python loop over the K members inside
    one jit, no scan carry overhead, the single-device default),
    ``"scan"`` (one trace for all K, smallest program) or ``"vmap"``
    (members' convs batch together; required on a ``mesh``, where each
    device trains a contiguous member block, embarrassingly parallel)."""
    import functools

    opt = make_optimizer(tc)

    def one(state, x, y, seed):
        return _train_step3d(state, x, y, opt, cfg, tc, seed=seed)

    vstep = jax.vmap(one)

    if mesh is None:
        if member_mode == "scan":

            @functools.partial(jax.jit, donate_argnums=(0,))
            def step(state: TrainState, x: Array, y: Array, seeds: Array):
                def body(_, member):
                    s, xb, yb, sd = member
                    return None, one(s, xb, yb, sd)

                _, (new_state, m) = jax.lax.scan(
                    body, None, (state, x, y, seeds)
                )
                return new_state, m

            return step
        if member_mode == "unroll":

            @functools.partial(jax.jit, donate_argnums=(0,))
            def step(state: TrainState, x: Array, y: Array, seeds: Array):
                outs = [
                    one(
                        jax.tree_util.tree_map(lambda a: a[k], state),
                        x[k], y[k], seeds[k],
                    )
                    for k in range(x.shape[0])
                ]
                stack = lambda *ls: jnp.stack(ls)  # noqa: E731
                new_state = jax.tree_util.tree_map(
                    stack, *[o[0] for o in outs])
                m = jax.tree_util.tree_map(stack, *[o[1] for o in outs])
                return new_state, m

            return step
        if member_mode != "vmap":
            raise ValueError(f"unknown member_mode {member_mode!r}")

        return jax.jit(vstep, donate_argnums=(0,))

    if member_mode != "vmap":
        raise ValueError(
            "mesh-sharded ensemble training requires member_mode='vmap'"
        )

    # shard_map over the member axis, as in the 2-D
    # `train.make_ensemble_train_step`: each device vmaps its own block
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    members = P(mesh.axis_names[0])
    return jax.jit(
        shard_map(vstep, mesh=mesh, in_specs=(members,) * 4,
                  out_specs=members, check_vma=False),
        donate_argnums=(0,),
    )


def make_ensemble_eval_step3d(cfg: ModelConfig, tc: TrainConfig):
    """Per-member volumetric validation in one program (the 3-D twin of
    `train.make_ensemble_eval_step`): vmap the eval computation over the
    stacked member params; the batch is shared. Returns per-member
    (loss, acc, pred) with a leading [K] axis."""

    @jax.jit
    def step(params, x: Array, y: Array):
        y1h = one_hot_flatten(y, cfg.n_classes)

        def one(p):
            probs, sigma = forward3d(p, x, cfg)
            loss = elbo_loss(
                y1h, probs, sigma, kl_regularizer3d(p), tc.kl_factor,
                tc.sigma_clip_min, tc.sigma_clip_max,
            )
            pred = jnp.argmax(probs, -1).astype(jnp.int32)
            acc = jnp.mean(
                (pred == jnp.argmax(y1h, -1)).astype(jnp.float32)
            )
            return loss, acc, pred

        return jax.vmap(one)(params)

    return step


def make_eval_step3d(cfg: ModelConfig, tc: TrainConfig):
    @jax.jit
    def _eval(params, x: Array, y: Array):
        y1h = one_hot_flatten(y, cfg.n_classes)
        probs, sigma = forward3d(params, x, cfg)
        loss = elbo_loss(
            y1h, probs, sigma, kl_regularizer3d(params), tc.kl_factor,
            tc.sigma_clip_min, tc.sigma_clip_max,
        )
        pred = jnp.argmax(probs, -1).astype(jnp.int32)
        acc = jnp.mean((pred == jnp.argmax(y1h, -1)).astype(jnp.float32))
        return loss, acc, pred

    return _eval


def _dice_foreground(y_true: np.ndarray, pred: np.ndarray) -> float:
    """Whole-foreground dice for [N, ...] int volumes — reshaped to
    [N, -1, last] so the 2-D per-image dice kernel applies unchanged."""
    from supernet_tpu.metrics import dice

    t = (y_true > 0).astype(np.float64)
    p = (pred > 0).astype(np.float64)
    n = len(t)
    d, _ = dice(t.reshape(n, -1, t.shape[-1]), p.reshape(n, -1, p.shape[-1]))
    return d


class Trainer3D:
    """Epoch driver for cube datasets (in-memory arrays).

    ``mesh`` enables multi-chip training; ``shard`` picks the axis:
    ``"batch"`` = data parallel (volumes split over the mesh, gradient
    psum — requires batch_size % n_devices == 0), ``"scan"`` =
    spatial partitioning of each volume's D axis (for when one volume's
    activation pairs overflow a chip), ``"hybrid"`` = both at once on a
    2-D ``make_mesh2d(n_data, n_space)`` mesh (batch over its data axis,
    D over its space axis). All reuse the SHARED step body, so numerics
    match the single-device path."""

    def __init__(
        self,
        exp: ExperimentConfig,
        x: np.ndarray,
        y: np.ndarray,
        x_val: Optional[np.ndarray] = None,
        y_val: Optional[np.ndarray] = None,
        out_dir: Optional[str] = None,
        mesh=None,
        shard: str = "batch",
        initial_params=None,
        steps_per_dispatch: int = 1,
    ):
        self.exp, self.cfg, self.tc = exp, exp.model, exp.train
        self.initial_params = initial_params
        self.x, self.y = np.asarray(x, np.float32), np.asarray(y, np.int32)
        self.x_val = x_val if x_val is None else np.asarray(x_val, np.float32)
        self.y_val = y_val if y_val is None else np.asarray(y_val, np.int32)
        self.out_dir = out_dir or os.path.join(
            exp.out_dir, exp.name + "_3d", "saved_models_SUPER_u-Net"
        )
        if len(self.x) < self.tc.batch_size:
            raise ValueError(
                f"{len(self.x)} training volumes < batch_size "
                f"{self.tc.batch_size}: every epoch would run zero steps"
            )
        # crop labels once (not per epoch)
        self.y_crop = _crop_center_vol(self.y, self.cfg.out_size)
        self.y_val_crop = (
            None
            if self.y_val is None
            else _crop_center_vol(self.y_val, self.cfg.out_size)
        )
        self._put = jnp.asarray
        # steps_per_dispatch > 1: K batches per lax.scan dispatch
        # (make_multi_train_step3d); single-device path only, like the
        # 2-D Trainer
        self.k_steps = max(1, steps_per_dispatch)
        self._single_step = None
        if mesh is not None and self.k_steps > 1:
            raise ValueError(
                "steps_per_dispatch > 1 is not supported together with a "
                "device mesh yet; drop one of the two options"
            )
        if mesh is None:
            if self.k_steps > 1:
                self.step_fn = make_multi_train_step3d(
                    self.cfg, self.tc, self.k_steps
                )
            else:
                self.step_fn = make_train_step3d(self.cfg, self.tc)
        elif shard == "batch":
            from supernet_tpu.parallel import make_dp_train_step3d

            n_dev = len(mesh.devices.flat)
            if self.tc.batch_size % n_dev != 0:
                raise ValueError(
                    f"batch_size {self.tc.batch_size} does not divide over "
                    f"the {n_dev}-device mesh; use "
                    "parallel.make_mesh_for_batch or adjust batch_size"
                )
            self.step_fn = make_dp_train_step3d(self.cfg, self.tc, mesh)
            if jax.process_count() > 1:
                # multi-host: feed only this process's contiguous row block
                # and assemble the global batch-sharded array (same scope
                # as the 2-D Trainer: train loop + checkpoints; validation
                # is single-host)
                from supernet_tpu.parallel import (
                    global_batch,
                    process_local_rows,
                )

                def _put(a):
                    lo, hi = process_local_rows(len(a))
                    return global_batch(mesh, np.asarray(a)[lo:hi])

                self._put = _put
                if x_val is not None:
                    print(
                        "note: validation disabled on multi-host 3-D runs "
                        "(predictions span non-addressable devices)"
                    )
                    self.x_val = self.y_val = None
            else:
                from supernet_tpu.parallel import shard_batch

                self._put = lambda a: shard_batch(mesh, jnp.asarray(a))
        elif shard == "scan":
            from supernet_tpu.parallel import make_spatial_train_step3d

            self.step_fn = make_spatial_train_step3d(self.cfg, self.tc, mesh)
        elif shard == "hybrid":
            # 2-D (data, space) mesh: batch over "data", each volume's D
            # axis over "space" in the same step (parallel/hybrid.py)
            from supernet_tpu.parallel import make_hybrid_train_step3d

            if set(mesh.axis_names) != {"data", "space"}:
                raise ValueError(
                    "shard='hybrid' needs a 2-D mesh with axes "
                    "('data', 'space') — build it with "
                    f"parallel.make_mesh2d; got {mesh.axis_names}"
                )
            n_data = mesh.shape["data"]
            if self.tc.batch_size % n_data != 0:
                raise ValueError(
                    f"batch_size {self.tc.batch_size} does not divide "
                    f"over the mesh's {n_data}-way data axis"
                )
            self.step_fn = make_hybrid_train_step3d(self.cfg, self.tc, mesh)
            # plain host arrays: the step's in_shardings place them on
            # the (data, space) mesh at call time
            self._put = jnp.asarray
        else:
            raise ValueError(f"unknown shard mode {shard!r}")
        self.eval_fn = make_eval_step3d(self.cfg, self.tc)
        self.history: Dict[str, List[float]] = {
            "train_loss": [], "train_acc": [],
            "val_loss": [], "val_acc": [], "val_dice": [],
        }

    def _batches(self, x, y, rng):
        """Generator of full (static-shape) batches in a fresh permutation
        — one batch of copies live at a time."""
        idx = rng.permutation(len(x))
        b = self.tc.batch_size
        for i in range(0, len(x) - b + 1, b):
            yield x[idx[i:i+b]], y[idx[i:i+b]]

    def run(self, epochs: Optional[int] = None, log=print) -> TrainState:
        cfg, tc = self.cfg, self.tc
        epochs = epochs if epochs is not None else tc.epochs
        # transfer init (e.g. a 2-D checkpoint inflated via
        # `models.inflate_params3d`) takes precedence over random init;
        # a resumed checkpoint still overwrites either below. Copy the
        # caller's tree: the jitted step DONATES its state, which would
        # silently delete the caller's arrays
        params = (
            jax.tree.map(jnp.array, self.initial_params)
            if self.initial_params is not None
            else init_params3d(jax.random.PRNGKey(tc.seed), cfg)
        )
        state, _ = create_train_state(params, tc)
        start = 0
        if tc.continue_training:
            latest = ckpt.latest_epoch(self.out_dir)
            if latest is not None:
                state = ckpt.restore_state(self.out_dir, latest, state)
                start = latest + 1
        rng = np.random.default_rng(tc.seed)
        y_c = self.y_crop
        t0 = time.perf_counter()
        # async writer + divergence rollback — the same failure-recovery
        # contract as the 2-D Trainer (checkpoints stream to disk while
        # the next epoch trains; a non-finite epoch rolls back to the
        # last good checkpoint instead of corrupting the run)
        writer = ckpt.AsyncEpochCheckpointer(self.out_dir)
        try:
            state = self._run_epochs(
                state, start, epochs, rng, y_c, t0, writer, log
            )
            writer.wait()
        finally:
            writer.close()
        return self._finish(state, log)

    def _run_epochs(self, state, start, epochs, rng, y_c, t0, writer, log):
        tc = self.tc
        last_good: Optional[int] = None
        for epoch in range(start, epochs):
            losses, accs = [], []
            xs: List[np.ndarray] = []
            ys: List[np.ndarray] = []
            for xb, yb in self._batches(self.x, y_c, rng):
                if self.k_steps > 1:
                    xs.append(xb)
                    ys.append(yb)
                    if len(xs) < self.k_steps:
                        continue
                    state, ms = self.step_fn(
                        state, self._put(np.stack(xs)),
                        self._put(np.stack(ys)),
                    )
                    xs, ys = [], []
                    losses += np.asarray(ms.loss).tolist()
                    accs += np.asarray(ms.accuracy).tolist()
                    continue
                state, m = self.step_fn(
                    state, self._put(xb), self._put(yb)
                )
                losses.append(float(m.loss))
                accs.append(float(m.accuracy))
            for xb, yb in zip(xs, ys):
                # trailing batches below the chunk run single-step so no
                # data is dropped (same math; proven equal in the tests)
                if self._single_step is None:
                    self._single_step = make_train_step3d(self.cfg, self.tc)
                state, m = self._single_step(
                    state, self._put(xb), self._put(yb)
                )
                losses.append(float(m.loss))
                accs.append(float(m.accuracy))
            self.history["train_loss"].append(float(np.mean(losses)))
            self.history["train_acc"].append(float(np.mean(accs)))
            vols_s = len(losses) * tc.batch_size / max(
                time.perf_counter() - t0, 1e-9
            )
            log(
                f"epoch {epoch}: loss={self.history['train_loss'][-1]:.4f} "
                f"acc={self.history['train_acc'][-1]:.4f} "
                f"({vols_s:.2f} vols/s cum)"
            )
            if not np.isfinite(self.history["train_loss"][-1]):
                if last_good is None:
                    raise FloatingPointError(
                        f"non-finite loss in epoch {epoch} and no "
                        "checkpoint to roll back to"
                    )
                log(
                    f"epoch {epoch}: non-finite loss - rolling back to "
                    f"epoch {last_good} checkpoint"
                )
                writer.wait()  # the rollback target may still be in flight
                state = ckpt.restore_state(
                    self.out_dir, last_good, jax.device_get(state)
                )
                t0 = time.perf_counter()
                continue
            if self.x_val is not None:
                self._validate(state, epoch, log)
            if (epoch + 1) % tc.checkpoint_every == 0:
                writer.save(epoch, jax.device_get(state))
                last_good = epoch
            t0 = time.perf_counter()
        return state

    def _finish(self, state, log):
        tc = self.tc
        if jax.process_count() > 1:
            # same scope as the 2-D Trainer: checkpoints are the multi-host
            # product; every process writing the curve PNGs/pickle into the
            # shared out_dir would race — generate reports afterwards
            log("multi-host run done; skipping single-host report surface")
            return state
        from supernet_tpu import reports

        reports.save_training_curves(self.out_dir, self.history)
        reports.save_history_pickle(self.out_dir, self.history)
        if self.x_val is not None and len(self.x_val) >= tc.batch_size:
            self._save_val_report(state)
        return state

    def _save_val_report(self, state) -> None:
        """Center-slice uncertainty artifacts + pkl from the first
        validation batch (the 3-D analog of the 2-D artifact set)."""
        from supernet_tpu import reports

        cfg, b = self.cfg, self.tc.batch_size
        xb = self.x_val[:b]
        probs, sigma = forward3d(
            jax.device_get(state).params, jnp.asarray(xb), cfg
        )
        o = cfg.out_size
        shape = (b, o, o, o, cfg.n_classes)
        reports.save_uncertainty_slices3d(
            self.out_dir,
            np.asarray(probs).reshape(shape),
            np.asarray(sigma).reshape(shape),
            xb,
            self.y_val_crop[:b],
            n_classes=cfg.n_classes,
        )

    def _validate(self, state, epoch, log):
        cfg, tc = self.cfg, self.tc
        y_c = self.y_val_crop
        losses, accs, dices = [], [], []
        b = tc.batch_size
        for i in range(0, len(self.x_val) - b + 1, b):
            xb = jnp.asarray(self.x_val[i:i+b])
            yb = jnp.asarray(y_c[i:i+b])
            loss, acc, pred = self.eval_fn(state.params, xb, yb)
            losses.append(float(loss))
            accs.append(float(acc))
            pred_vol = np.asarray(pred).reshape(
                b, cfg.out_size, cfg.out_size, cfg.out_size
            )
            dices.append(_dice_foreground(np.asarray(y_c[i:i+b]), pred_vol))
        if losses:
            self.history["val_loss"].append(float(np.mean(losses)))
            self.history["val_acc"].append(float(np.mean(accs)))
            self.history["val_dice"].append(float(np.nanmean(dices)))
            log(
                f"epoch {epoch} val: "
                f"loss={self.history['val_loss'][-1]:.4f} "
                f"acc={self.history['val_acc'][-1]:.4f} "
                f"dice={self.history['val_dice'][-1]:.4f}"
            )


def _trace_out_side3d(cfg: ModelConfig) -> int:
    params = jax.eval_shape(
        lambda k: init_params3d(k, cfg), jax.random.PRNGKey(0)
    )
    s = cfg.image_size
    out = jax.eval_shape(
        lambda p, x: forward3d(p, x, cfg),
        params,
        jax.ShapeDtypeStruct((1, s, s, s, cfg.in_channels), jnp.float32),
    )
    side = round(out[0].shape[1] ** (1.0 / 3.0))
    if side**3 != out[0].shape[1] or side <= 0:
        raise ValueError(
            f"non-cubic traced output ({out[0].shape[1]} voxels)"
        )
    return side


def derive_out_size3d(cfg: ModelConfig) -> int:
    """Output cube side for an input of cfg.image_size, traced shape-only
    (the VALID geometry is config-dependent; no FLOPs).

    A cube side that is too small for the config's depth makes the VALID
    conv/pool chain collapse (an encoder skip ends up SMALLER than the
    decoder tensor it must be cropped to), which surfaces as an opaque
    concatenate shape error deep inside tracing — catch that here and
    report the smallest side that works instead."""
    try:
        return _trace_out_side3d(cfg)
    except ValueError:
        raise
    except Exception as e:
        for side in range(cfg.image_size + 1, cfg.image_size + 65):
            probe = dataclasses.replace(cfg, image_size=side)
            try:
                _trace_out_side3d(probe)
            except Exception:
                continue
            raise ValueError(
                f"cube size {cfg.image_size} is not a valid geometry for "
                f"a depth-{cfg.depth} volumetric U-Net (the VALID "
                f"conv/pool chain collapses); the smallest valid side is "
                f"{side}"
            ) from e
        raise ValueError(
            f"cube size {cfg.image_size} is not a valid geometry for a "
            f"depth-{cfg.depth} volumetric U-Net, and no valid side was "
            f"found up to {cfg.image_size + 64}"
        ) from e
