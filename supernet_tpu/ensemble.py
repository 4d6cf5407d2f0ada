"""One-compiled-program deep-ensemble training.

Round 3 trained ``--ensemble K`` as K sequential full trainings — K jit
compiles, K epoch loops (`cli.py`), while the serving side already vmapped
the member axis into one program (`serving.EnsembleSession`). This module
is the training twin: the K member states are stacked along a leading axis
and every update is ONE vmapped XLA program (`train.make_ensemble_train_step`),
so the model compiles once and the members' convs batch together.

Semantics match the sequential path exactly (tested in
tests/test_ensemble_train.py):

- member k's params init from ``PRNGKey(seed + k)``;
- member k's epoch shuffle is seeded ``seed + k`` — each member sees ITS
  OWN data order, fed as stacked ``[K, B, ...]`` batches;
- member k's on-device augmentation is keyed by ``seed + k`` (the vmapped
  step takes a per-member seed vector);
- per-member ``epoch_{N}`` checkpoints in ``member_{k}/`` dirs — the same
  layout `cli eval --checkpoint dir0,dir1,...` and `EnsembleSession`
  consume;
- per-member validation curves / history pickles / hyperparameter dumps.

The reference has no ensemble support at all; deep ensembles are a net-new
uncertainty baseline (ensemble disagreement complements the VDP variance).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from supernet_tpu import checkpoint as ckpt
from supernet_tpu import metrics as M
from supernet_tpu import reports
from supernet_tpu.configs import ExperimentConfig
from supernet_tpu.data import PickleDataset
from supernet_tpu.models import init_params
from supernet_tpu.train import (
    TrainState,
    create_train_state,
    index_tree,
    make_ensemble_eval_step,
    make_ensemble_train_step,
    stack_trees,
)
from supernet_tpu.trainer import _prep_batch

# Measured by chip_smoke.py's compile phase on one NVIDIA H100 80GB HBM3
# (power limit 400 W), library defaults (f32, precision "highest"),
# Hippocampus at batch 20: one member's train step 9.121 ms and its cold
# compile 23.0 s; the K=4 unrolled program steps in 36.363 ms = 0.997 x
# four sequential member steps (no per-step tax) and compiles in 56.1 s.
# The 3-D family (64^3 cubes, batch 4) steps in 224.4 ms. The ratio of the
# 3-D one-program step is assumed equal to the 2-D one (same lowering
# structure). Override per deployment via the
# SUPERNET_ENSEMBLE_{COMPILE_S,STEP_S,STEP_RATIO} env knobs.
ONE_PROGRAM_STEP_RATIO = 0.997
SEQUENTIAL_STEP_S = 0.009121
SEQUENTIAL_STEP3D_S = 0.2244
COMPILE_S = 23.0


def choose_ensemble_mode(
    n_members: int,
    total_steps: Optional[int],
    mesh=None,
    compile_s: Optional[float] = None,
    step_s: Optional[float] = None,
    step_ratio: Optional[float] = None,
):
    """Pick the wall-clock-winning lowering for ``--ensemble-mode auto``.

    One-program saves (K-1) jit compiles once but may pay a per-step tax
    forever, in which case a long run loses. The crossover, with
    per-member step time ``t``,
    per-step ratio ``r`` and compile cost ``c``:

        sequential:   K·c + K·total_steps·t
        one-program:  1·c + K·total_steps·t·r

    so one-program wins iff ``(K-1)·c > K·total_steps·t·(r-1)``.

    Returns ``(mode, reason)``. On a mesh the answer is always ``vmap``
    (members run device-parallel; sequential runs can't use the member
    axis at all). ``total_steps`` is the per-member step count for the
    whole run (epochs x steps/epoch); pass None for unsized streams —
    the compile-amortizing one-program mode is kept then. The
    SUPERNET_ENSEMBLE_MODE env var short-circuits the model entirely."""
    forced = os.environ.get("SUPERNET_ENSEMBLE_MODE")
    if forced:
        return forced, f"SUPERNET_ENSEMBLE_MODE={forced}"
    if mesh is not None:
        return "vmap", "mesh-sharded members run device-parallel"
    if total_steps is None:
        return "unroll", "unsized stream; keeping the one-compile mode"
    c = compile_s if compile_s is not None else float(
        os.environ.get("SUPERNET_ENSEMBLE_COMPILE_S", COMPILE_S)
    )
    t = step_s if step_s is not None else float(
        os.environ.get("SUPERNET_ENSEMBLE_STEP_S", SEQUENTIAL_STEP_S)
    )
    r = step_ratio if step_ratio is not None else float(
        os.environ.get("SUPERNET_ENSEMBLE_STEP_RATIO",
                       ONE_PROGRAM_STEP_RATIO)
    )
    compile_saved_s = (n_members - 1) * c
    step_tax_s = n_members * total_steps * t * (r - 1.0)
    why = (
        f"K={n_members}, {total_steps} steps/member: one-program saves "
        f"{compile_saved_s:.0f}s of compiles, costs {step_tax_s:.0f}s of "
        f"per-step tax (x{r:.2f} on {t * 1e3:.1f}ms steps)"
    )
    if compile_saved_s > step_tax_s:
        return "unroll", why
    return "sequential", why


class EnsembleTrainer3D:
    """One-compiled-program deep-ensemble training for the volumetric
    family — the 3-D twin of `EnsembleTrainer`, with `train3d.Trainer3D`'s
    data semantics (in-memory cube arrays, full batches from a per-member
    permutation stream).

    Sequential parity (tested in tests/test_ensemble_train3d.py): member
    k's params init from ``PRNGKey(seed + k)`` (or a SHARED
    ``initial_params`` tree, e.g. an inflated 2-D checkpoint — diversity
    then comes from the shuffle alone), its epoch permutations come from
    ``np.random.default_rng(seed + k)`` advanced across epochs, its
    augmentation is keyed ``seed + k``, and per-member ``epoch_{N}``
    checkpoints land in ``member_{k}/`` dirs that `cli eval3d/predict3d
    --checkpoint a,b,c` and `EnsembleSession` consume.

    ``member_mode``: unroll (single-device default) / scan / vmap
    (required on a member-axis ``mesh``) — the same trade-off as 2-D."""

    def __init__(
        self,
        exp: ExperimentConfig,
        n_members: int,
        x: np.ndarray,
        y: np.ndarray,
        x_val: Optional[np.ndarray] = None,
        y_val: Optional[np.ndarray] = None,
        out_dir: Optional[str] = None,
        mesh=None,
        member_mode: Optional[str] = None,
        initial_params=None,
    ):
        from supernet_tpu.train3d import (
            _crop_center_vol,
            make_ensemble_eval_step3d,
            make_ensemble_train_step3d,
        )

        if n_members < 2:
            raise ValueError("EnsembleTrainer3D needs n_members >= 2")
        self.exp, self.cfg, self.tc = exp, exp.model, exp.train
        self.n_members = n_members
        self.x = np.asarray(x, np.float32)
        self.y = np.asarray(y, np.int32)
        self.x_val = None if x_val is None else np.asarray(x_val, np.float32)
        self.y_val = None if y_val is None else np.asarray(y_val, np.int32)
        if len(self.x) < self.tc.batch_size:
            raise ValueError(
                f"{len(self.x)} training volumes < batch_size "
                f"{self.tc.batch_size}: every epoch would run zero steps"
            )
        self.y_crop = _crop_center_vol(self.y, self.cfg.out_size)
        self.y_val_crop = (
            None
            if self.y_val is None
            else _crop_center_vol(self.y_val, self.cfg.out_size)
        )
        self.base_dir = out_dir or os.path.join(
            exp.out_dir, exp.name + "_3d", "ensemble"
        )
        self.member_dirs = [
            os.path.join(self.base_dir, f"member_{k}")
            for k in range(n_members)
        ]
        self.mesh = mesh
        # non-dividing K: pad the member axis to the mesh (see
        # EnsembleTrainer) — pad members train throwaway replicas
        self.n_pad = 0
        if mesh is not None:
            n_dev = int(np.prod(mesh.devices.shape))
            self.n_pad = (-n_members) % n_dev
            if self.n_pad:
                print(
                    f"note: padding the member axis {n_members} -> "
                    f"{n_members + self.n_pad} so it divides the {n_dev}-"
                    "device mesh (pad members are trained and discarded)"
                )
        self.n_train = n_members + self.n_pad
        if member_mode is None:
            member_mode = os.environ.get(
                "SUPERNET_ENSEMBLE_MODE",
                "vmap" if mesh is not None else "unroll",
            )
        self.member_mode = member_mode
        self.initial_params = initial_params
        self.step_fn = make_ensemble_train_step3d(
            self.cfg, self.tc, mesh=mesh, member_mode=member_mode
        )
        self.eval_fn = make_ensemble_eval_step3d(self.cfg, self.tc)
        self.seeds = np.arange(self.n_train, dtype=np.int32) + self.tc.seed
        self.histories: List[Dict[str, List[float]]] = [
            {
                "train_loss": [],
                "train_acc": [],
                "val_loss": [],
                "val_acc": [],
                "val_dice": [],
            }
            for _ in range(n_members)
        ]

    def init_state(self) -> TrainState:
        from supernet_tpu.models import init_params3d

        members = []
        for k in range(self.n_train):
            params = (
                jax.tree_util.tree_map(np.asarray, self.initial_params)
                if self.initial_params is not None
                else init_params3d(
                    jax.random.PRNGKey(self.tc.seed + k), self.cfg
                )
            )
            state, _ = create_train_state(params, self.tc)
            members.append(state)
        self.start_epoch = 0
        if self.tc.continue_training:
            latest = [ckpt.latest_epoch(d) for d in self.member_dirs]
            if all(e is not None for e in latest):
                epoch = min(latest)  # type: ignore[type-var]
                members = [
                    ckpt.restore_state(d, epoch, s)
                    for d, s in zip(self.member_dirs, members)
                ] + members[self.n_members:]
                self.start_epoch = epoch + 1
            elif any(e is not None for e in latest):
                raise FileNotFoundError(
                    "continue_training: only some member dirs have "
                    f"checkpoints ({latest}); refusing a mixed resume"
                )
        return stack_trees(members)

    def _member_batches(self, rngs):
        """Zip K per-member permutation streams into stacked [K, B, ...]
        batches. `Trainer3D._batches` yields only full batches, so every
        member's stream has the same length — the stack is rectangular."""
        b = self.tc.batch_size
        perms = [rng.permutation(len(self.x)) for rng in rngs]
        for i in range(0, len(self.x) - b + 1, b):
            xs = np.stack([self.x[p[i:i + b]] for p in perms])
            ys = np.stack([self.y_crop[p[i:i + b]] for p in perms])
            yield xs, ys

    def run(self, epochs: Optional[int] = None, log=print) -> TrainState:
        state = self.init_state()
        epochs = epochs if epochs is not None else self.tc.epochs
        # one rng per member, advanced across epochs — member k's epoch
        # permutations match a sequential Trainer3D seeded tc.seed + k
        # (including on resume: Trainer3D restarts its rng from the seed,
        # so epoch `start` gets the rng's FIRST permutation)
        rngs = [
            np.random.default_rng(self.tc.seed + k)
            for k in range(self.n_train)
        ]
        writers = [
            ckpt.AsyncEpochCheckpointer(d) for d in self.member_dirs
        ]
        t_start = time.perf_counter()
        last_good: Optional[int] = None
        seeds = self.seeds
        try:
            for epoch in range(self.start_epoch, epochs):
                losses = [[] for _ in range(self.n_members)]
                accs = [[] for _ in range(self.n_members)]
                t0 = time.perf_counter()
                n_steps = 0
                for xk, yk in self._member_batches(rngs):
                    state, m = self.step_fn(state, xk, yk, seeds)
                    loss_k = np.asarray(m.loss)
                    acc_k = np.asarray(m.accuracy)
                    for k in range(self.n_members):
                        losses[k].append(float(loss_k[k]))
                        accs[k].append(float(acc_k[k]))
                    n_steps += 1
                for k, h in enumerate(self.histories):
                    h["train_loss"].append(float(np.mean(losses[k])))
                    h["train_acc"].append(float(np.mean(accs[k])))
                mean_loss = float(
                    np.mean([h["train_loss"][-1] for h in self.histories])
                )
                vols = n_steps * self.tc.batch_size
                secs = time.perf_counter() - t0
                log(
                    f"epoch {epoch}: mean member loss={mean_loss:.4f} "
                    f"({vols / max(secs, 1e-9):.2f} vols/s/member, "
                    f"{secs:.2f}s)"
                )
                bad = [
                    k
                    for k, h in enumerate(self.histories)
                    if not np.isfinite(h["train_loss"][-1])
                ]
                if bad:
                    if last_good is None:
                        raise FloatingPointError(
                            f"non-finite loss in members {bad} at epoch "
                            f"{epoch} and no checkpoint to roll back to"
                        )
                    log(
                        f"epoch {epoch}: non-finite loss in members {bad} "
                        f"- rolling back ALL members to epoch {last_good}"
                    )
                    for w in writers:
                        w.wait()
                    host = jax.device_get(state)
                    members = [
                        ckpt.restore_state(d, last_good, index_tree(host, k))
                        for k, d in enumerate(self.member_dirs)
                    ] + [
                        index_tree(host, k)  # pad members roll on as-is
                        for k in range(self.n_members, self.n_train)
                    ]
                    state = stack_trees(members)
                    continue
                if self.x_val is not None:
                    self._validate(state, epoch, log)
                if (epoch + 1) % self.tc.checkpoint_every == 0:
                    host = jax.device_get(state)
                    for k, w in enumerate(writers):
                        w.save(epoch, index_tree(host, k))
                    last_good = epoch
            for w in writers:
                w.wait()
        finally:
            for w in writers:
                w.close()
        self.total_time = time.perf_counter() - t_start
        self._finalize(state)
        return state

    def _validate(self, state, epoch, log):
        from supernet_tpu.train3d import _dice_foreground

        cfg, b = self.cfg, self.tc.batch_size
        losses = [[] for _ in range(self.n_members)]
        accs = [[] for _ in range(self.n_members)]
        dices = [[] for _ in range(self.n_members)]
        for i in range(0, len(self.x_val) - b + 1, b):
            xb = self.x_val[i:i + b]
            yb = self.y_val_crop[i:i + b]
            loss, acc, pred = self.eval_fn(state.params, xb, yb)
            loss = np.asarray(loss)
            acc = np.asarray(acc)
            preds = np.asarray(pred)  # [K, B, o^3]
            for k in range(self.n_members):
                losses[k].append(float(loss[k]))
                accs[k].append(float(acc[k]))
                pred_vol = preds[k].reshape(
                    b, cfg.out_size, cfg.out_size, cfg.out_size
                )
                dices[k].append(_dice_foreground(yb, pred_vol))
        if not losses[0]:
            return
        for k, h in enumerate(self.histories):
            h["val_loss"].append(float(np.mean(losses[k])))
            h["val_acc"].append(float(np.mean(accs[k])))
            h["val_dice"].append(float(np.nanmean(dices[k])))
        log(
            f"epoch {epoch} val: mean member "
            f"loss={np.mean([h['val_loss'][-1] for h in self.histories]):.4f} "
            f"dice={np.mean([h['val_dice'][-1] for h in self.histories]):.4f}"
        )

    def _finalize(self, state):
        """Per-member curve PNGs + history pickles (+ the center-slice
        uncertainty artifact set from the first validation batch, matching
        `Trainer3D._save_val_report`)."""
        from supernet_tpu.models import forward3d

        host = jax.device_get(state)
        cfg, b = self.cfg, self.tc.batch_size
        for k, (d, h) in enumerate(zip(self.member_dirs, self.histories)):
            reports.save_training_curves(d, h)
            reports.save_history_pickle(d, h)
            if self.x_val is not None and len(self.x_val) >= b:
                xb = self.x_val[:b]
                probs, sigma = forward3d(
                    index_tree(host, k).params, jnp.asarray(xb), cfg
                )
                o = cfg.out_size
                shape = (b, o, o, o, cfg.n_classes)
                reports.save_uncertainty_slices3d(
                    d,
                    np.asarray(probs).reshape(shape),
                    np.asarray(sigma).reshape(shape),
                    xb,
                    self.y_val_crop[:b],
                    n_classes=cfg.n_classes,
                )


class EnsembleTrainer:
    """Epoch driver for the vmapped K-member ensemble.

    ``mesh``: optional member-axis sharding (one device trains a block of
    members; K must divide over the mesh — shrink it with
    ``parallel.make_mesh_for_batch(K)``).
    """

    def __init__(
        self,
        exp: ExperimentConfig,
        n_members: int,
        train_ds: PickleDataset,
        val_ds: Optional[PickleDataset] = None,
        out_dir: Optional[str] = None,
        mesh=None,
        track_curves: bool = True,
        member_mode: Optional[str] = None,
    ):
        if n_members < 2:
            raise ValueError("EnsembleTrainer needs n_members >= 2")
        self.exp = exp
        self.cfg = exp.model
        self.tc = exp.train
        self.n_members = n_members
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.base_dir = out_dir or os.path.join(
            exp.out_dir, exp.name, "ensemble"
        )
        self.member_dirs = [
            os.path.join(self.base_dir, f"member_{k}")
            for k in range(n_members)
        ]
        self.mesh = mesh
        # When K does not divide the mesh, pad the member axis with extra
        # throwaway members (seeded seed+K..) so any K trains on the FULL
        # mesh — the training twin of serving's zero-weight member padding
        # (`serving.py` EnsembleSession) instead of the round-4 hard refusal.
        # Pad members train real replicas but get no dirs/histories/
        # checkpoints; they cannot influence the K real members (the
        # member axis carries no cross-member reduction anywhere).
        self.n_pad = 0
        if mesh is not None:
            n_dev = int(np.prod(mesh.devices.shape))
            self.n_pad = (-n_members) % n_dev
            if self.n_pad:
                print(
                    f"note: padding the member axis {n_members} -> "
                    f"{n_members + self.n_pad} so it divides the {n_dev}-"
                    "device mesh (pad members are trained and discarded)"
                )
        self.n_train = n_members + self.n_pad
        self.structures = M.dataset_structures(exp.name)
        # per-structure train curves need a per-step [K, B, H*W] pred fetch
        # + K x host metrics; same trade-off as Trainer.track_curves. Same
        # forced-off rule for augmentation (the step's pred is of the
        # augmented batch while the host holds unaugmented labels).
        self.track_curves = track_curves
        self.track_train_curves = track_curves and exp.train.augment is None
        # member-axis lowering: scan (single-device default — the member
        # body lowers like the plain single-model step, full per-step rate)
        # vs vmap (required on a mesh: members run device-parallel).
        # SUPERNET_ENSEMBLE_MODE overrides; bench.py ensemble_train
        # measures the lowerings against each other.
        if member_mode is None:
            member_mode = os.environ.get(
                "SUPERNET_ENSEMBLE_MODE", "vmap" if mesh is not None else "unroll"
            )
        self.member_mode = member_mode
        self.step_fn = make_ensemble_train_step(
            self.cfg,
            self.tc,
            with_pred=self.track_train_curves,
            mesh=mesh,
            member_mode=member_mode,
        )
        self.eval_fn = make_ensemble_eval_step(self.cfg, self.tc)
        self.seeds = np.arange(self.n_train, dtype=np.int32) + self.tc.seed
        # one history dict per member, same keys as Trainer.history
        self.histories: List[Dict[str, List[float]]] = [
            {
                "train_loss": [],
                "train_acc": [],
                "val_loss": [],
                "val_acc": [],
                "val_dice": [],
            }
            for _ in range(n_members)
        ]

    # -- state ---------------------------------------------------------

    def init_state(self) -> TrainState:
        members = []
        for k in range(self.n_train):
            params = init_params(
                jax.random.PRNGKey(self.tc.seed + k), self.cfg
            )
            state, _ = create_train_state(params, self.tc)
            members.append(state)
        self.start_epoch = 0
        if self.tc.continue_training:
            latest = [ckpt.latest_epoch(d) for d in self.member_dirs]
            if all(e is not None for e in latest):
                # resume from the newest epoch EVERY member has (an async
                # writer can be one epoch ahead for some members); pad
                # members (never checkpointed) restart from their init
                epoch = min(latest)  # type: ignore[type-var]
                members = [
                    ckpt.restore_state(d, epoch, s)
                    for d, s in zip(self.member_dirs, members)
                ] + members[self.n_members:]
                self.start_epoch = epoch + 1
            elif any(e is not None for e in latest):
                raise FileNotFoundError(
                    "continue_training: only some member dirs have "
                    f"checkpoints ({latest}); refusing a mixed resume"
                )
        return stack_trees(members)

    # -- epoch loop ----------------------------------------------------

    def run(self, epochs: Optional[int] = None, log=print) -> TrainState:
        state = self.init_state()
        epochs = epochs if epochs is not None else self.tc.epochs
        writers = [
            ckpt.AsyncEpochCheckpointer(d) for d in self.member_dirs
        ]
        t_start = time.perf_counter()
        last_good: Optional[int] = None
        try:
            for epoch in range(self.start_epoch, epochs):
                state = self._train_epoch(state, epoch, log)
                bad = [
                    k
                    for k, h in enumerate(self.histories)
                    if not np.isfinite(h["train_loss"][-1])
                ]
                if bad:
                    # one shared program: a diverged member poisons its own
                    # slice only, but the rollback restores ALL members to
                    # the last good epoch so the stacked state stays aligned
                    if last_good is None:
                        raise FloatingPointError(
                            f"non-finite loss in members {bad} at epoch "
                            f"{epoch} and no checkpoint to roll back to"
                        )
                    log(
                        f"epoch {epoch}: non-finite loss in members {bad} "
                        f"- rolling back ALL members to epoch {last_good}"
                    )
                    for w in writers:
                        w.wait()
                    host = jax.device_get(state)
                    members = [
                        ckpt.restore_state(d, last_good, index_tree(host, k))
                        for k, d in enumerate(self.member_dirs)
                    ] + [
                        index_tree(host, k)  # pad members roll on as-is
                        for k in range(self.n_members, self.n_train)
                    ]
                    state = stack_trees(members)
                    continue
                if self.val_ds is not None:
                    self._validate(state, epoch, log)
                if (epoch + 1) % self.tc.checkpoint_every == 0:
                    host = jax.device_get(state)
                    for k, w in enumerate(writers):
                        w.save(epoch, index_tree(host, k))
                    last_good = epoch
            for w in writers:
                w.wait()
        finally:
            for w in writers:
                w.close()
        self.total_time = time.perf_counter() - t_start
        self._finalize()
        return state

    def _member_batches(self, epoch: int):
        """Zip the K per-member shuffles into stacked [K, B, ...] batches.
        drop_remainder=True keeps every member's stream the same length
        and shape, so the stack is always rectangular."""
        iters = [
            self.train_ds.batches(
                self.tc.batch_size,
                shuffle=True,
                seed=self.tc.seed + k,
                epoch=epoch,
            )
            for k in range(self.n_train)
        ]
        for group in zip(*iters):
            xs, ys = [], []
            for x, y in group:
                x, y_c = _prep_batch(
                    x, y, self.cfg.out_size, self.cfg.n_classes
                )
                xs.append(x)
                ys.append(np.ascontiguousarray(y_c, np.int32))
            yield np.stack(xs), np.stack(ys)

    def _train_epoch(self, state, epoch, log):
        from supernet_tpu.profiling import StepTimer

        losses = [[] for _ in range(self.n_members)]
        accs = [[] for _ in range(self.n_members)]
        t_dice = [
            {s: [] for s in self.structures} for _ in range(self.n_members)
        ]
        t_haus = [
            {s: [] for s in self.structures} for _ in range(self.n_members)
        ]
        timer = StepTimer()
        tick_imgs: List[int] = []
        tick_host: List[float] = []
        seeds = self.seeds
        step = 0
        timer.tick()
        for xk, yk in self._member_batches(epoch):
            host_s = 0.0
            if self.track_train_curves:
                state, m, pred = self.step_fn(state, xk, yk, seeds)
                preds = np.asarray(pred)  # [K, B, H*W]; fetch = sync
                t0 = time.perf_counter()
                for k in range(self.n_members):
                    pred_img = preds[k].reshape(yk[k].shape)
                    for s in self.structures:
                        tm = M.binarize(yk[k], s, self.exp.name)
                        pm = M.binarize(pred_img, s, self.exp.name)
                        d, _ = M.dice(tm, pm)
                        t_dice[k][s].append(d)
                        t_haus[k][s].append(M.compute_H(tm, pm))
                host_s = time.perf_counter() - t0
            else:
                state, m = self.step_fn(state, xk, yk, seeds)
            loss_k = np.asarray(m.loss)  # [K]
            acc_k = np.asarray(m.accuracy)
            for k in range(self.n_members):
                losses[k].append(float(loss_k[k]))
                accs[k].append(float(acc_k[k]))
            if step % self.tc.log_every == 0:
                log(
                    f"epoch {epoch} step {step}: "
                    f"loss={np.array2string(loss_k[:self.n_members], precision=4)} "
                    f"acc={np.array2string(acc_k[:self.n_members], precision=4)}"
                )
            step += 1
            timer.tick()
            tick_imgs.append(int(xk.shape[1]))  # per-member images
            tick_host.append(host_s)
        for k in range(self.n_members):
            h = self.histories[k]
            h["train_loss"].append(float(np.mean(losses[k])))
            h["train_acc"].append(float(np.mean(accs[k])))
            if self.track_train_curves:
                for s in self.structures:
                    h.setdefault(f"train_dice_{s}", []).append(
                        float(np.nanmean(t_dice[k][s]))
                    )
                    h.setdefault(f"train_haus_{s}", []).append(
                        float(np.nanmean(t_haus[k][s]))
                    )
        timer.sync(state.params)
        n_ticks = len(tick_imgs)
        skip = 1 if n_ticks > 1 else 0
        secs = timer.times[-1] - timer.times[skip] if n_ticks > skip else 0.0
        secs -= sum(tick_host[skip:])
        imgs = sum(tick_imgs[skip:])
        # per-member rate, directly comparable with the sequential path's
        # images/sec; the whole-ensemble rate is K x this
        ips = imgs / secs if secs > 0 else 0.0
        for h in self.histories:
            h.setdefault("images_per_sec", []).append(ips)
            h.setdefault("ensemble_images_per_sec", []).append(
                ips * self.n_members
            )
        log(
            f"epoch {epoch}: {ips:.4g} images/sec/member "
            f"({ips * self.n_members:.4g} ensemble-wide, "
            f"{timer.total_seconds():.2f}s)"
        )
        return state

    def _validate(self, state, epoch, log):
        losses = [[] for _ in range(self.n_members)]
        accs = [[] for _ in range(self.n_members)]
        dices = [[] for _ in range(self.n_members)]
        v_dice = [
            {s: [] for s in self.structures} for _ in range(self.n_members)
        ]
        v_haus = [
            {s: [] for s in self.structures} for _ in range(self.n_members)
        ]
        for x, y in self.val_ds.batches(
            self.tc.batch_size, drop_remainder=False
        ):
            x, y_c = _prep_batch(x, y, self.cfg.out_size, self.cfg.n_classes)
            _, _, pred, loss, acc = self.eval_fn(
                state.params,
                np.asarray(x, np.float32),
                np.ascontiguousarray(y_c, np.int32),
            )
            loss = np.asarray(loss)
            acc = np.asarray(acc)
            preds = np.asarray(pred)  # [K, B, H*W]
            for k in range(self.n_members):
                losses[k].append(float(loss[k]))
                accs[k].append(float(acc[k]))
                pred_img = preds[k].reshape(
                    len(x), self.cfg.out_size, self.cfg.out_size
                )
                for s in self.structures:
                    tm = M.binarize(y_c, s, self.exp.name)
                    pm = M.binarize(pred_img, s, self.exp.name)
                    d, _ = M.dice(tm, pm)
                    dices[k].append(d)
                    v_dice[k][s].append(d)
                    if self.track_curves:
                        v_haus[k][s].append(M.compute_H(tm, pm))
        for k in range(self.n_members):
            h = self.histories[k]
            h["val_loss"].append(float(np.mean(losses[k])))
            h["val_acc"].append(float(np.mean(accs[k])))
            h["val_dice"].append(float(np.nanmean(dices[k])))
            for s in self.structures:
                h.setdefault(f"val_dice_{s}", []).append(
                    float(np.nanmean(v_dice[k][s]))
                )
                if self.track_curves:
                    h.setdefault(f"val_haus_{s}", []).append(
                        float(np.nanmean(v_haus[k][s]))
                    )
        mean_loss = float(np.mean([h["val_loss"][-1] for h in self.histories]))
        mean_dice = float(
            np.mean([h["val_dice"][-1] for h in self.histories])
        )
        log(
            f"epoch {epoch} val: mean member loss={mean_loss:.4f} "
            f"dice={mean_dice:.4f}"
        )

    def _finalize(self):
        for k, (d, h) in enumerate(zip(self.member_dirs, self.histories)):
            reports.save_training_curves(d, h)
            reports.save_history_pickle(d, h)
            reports.save_reference_training_curves(d, h, self.structures)
            summary = {}
            for s in self.structures:
                for key in (
                    f"train_dice_{s}",
                    f"val_dice_{s}",
                    f"train_haus_{s}",
                    f"val_haus_{s}",
                ):
                    if h.get(key):
                        summary[f"final_{key}"] = h[key][-1]
            reports.write_hyperparameters(
                d,
                "Related_hyperparameters.txt",
                {
                    **dataclasses.asdict(self.tc),
                    **dataclasses.asdict(self.cfg),
                    "ensemble_member": k,
                    "ensemble_size": self.n_members,
                    "total_training_time_s": getattr(self, "total_time", 0.0),
                    **summary,
                },
            )
