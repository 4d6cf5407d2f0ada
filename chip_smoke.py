"""Chip smoke test: drive the system's main path once on one GPU.

    python3 chip_smoke.py           # one GPU: every phase below
    python3 chip_smoke.py --multi   # four GPUs: the mesh paths only
                                    # (phase 7), each against its
                                    # single-device twin

Phases (each prints one ``[phase] ...`` line; any failure exits non-zero):

1. device   — refuses anything but a GPU; names the card, its power limit,
              the JAX version, XLA_FLAGS and the optional packages present.
2. train    — ``cli train`` on the full-width Hippocampus model (64x64x1,
              depth 3, 32 base kernels, batch 20) for two epochs on
              synthetic data at the library defaults, then ``cli eval``
              from the checkpoint it wrote.
3. reference— the ``xla`` backend's forward (probs, sigma) and one train
              step's gradients against the plain reference (the
              reference's patch-matmul algorithm, ``set_backend("naive")``,
              float32 at ``highest`` precision) at Hippocampus batch 20
              (the weights phase 2 trained) and BraTS batch 2 (seeded
              random weights at unit gain), in the library default mode
              and the bench mode.
4. compile  — compile seconds and ``memory_analysis()`` of the BraTS
              batch-20 step, the 3-D 64^3 batch-4 step and the K=4
              ensemble step (unroll and sequential), with a few steps each.
5. serve    — an ``InferenceSession`` answers requests of uneven batch
              size exactly as ``forward`` does; ``export_stablehlo`` writes
              a bundle.
6. profile  — ``cli profile --by-layer`` joins the device trace to the HLO.
7. multi    — (``--multi`` only) data-parallel, H-sharded spatial, 2x2
              hybrid and member-sharded ensemble training, and
              ``EnsembleSession(mesh=...)``, on four GPUs.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
One process drives every phase: a second JAX process on the card would
find its memory taken.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances against the plain reference, per mode. Errors are
#   probs:  max |p - p_ref|  (probabilities live on [0, 1]);
#   sigma:  ||s - s_ref||_2 / ||s_ref||_2 over the whole batch;
#   grads:  the same relative L2 error of all parameter gradients,
#           concatenated (the direction and size of the update);
#   argmax: share of confident pixels (reference top-two probability
#           margin > ARGMAX_MARGIN) whose label matches the reference.
#
# "default" — f32 activations at matmul precision "highest", the library
#   default. Both sides compute in true float32 and differ only in the
#   order of summation and in cuDNN's choice of algorithm (FFT, Winograd
#   or implicit GEMM against the reference's patch matmul), which moves
#   results by 1e-7..1e-5 of their scale; 1e-3 bounds that with headroom
#   while any wrong term in the moment algebra shows as O(1).
# "bench" — bf16 activations at matmul precision "default" (SUPERNET_
#   ACT_DTYPE=bfloat16, SUPERNET_PRECISION=default; f32 operands may run
#   as TF32). bf16 keeps 8 mantissa bits (3.9e-3 per rounding) and every
#   layer boundary rounds, ~20 roundings deep on the BraTS path, so a few
#   per cent in the L2 sense is expected. Rounding also creates ties in
#   the 2x2 max-pool, which move sigma at that pixel by the whole gap
#   between two taps, so sigma has no useful max-norm bound in this mode
#   and the gradients of the variance parameters (w_sigma) alone can be
#   off by tens of per cent; the L2 bounds over the whole tensor and the
#   label agreement carry the check.
TOLERANCES = {
    "default": {"probs": 1e-3, "sigma": 1e-3, "grads": 1e-3},
    "bench": {"probs": 5e-2, "sigma": 1e-1, "grads": 1e-1,
              "argmax_min": 0.99},
}
ARGMAX_MARGIN = 0.1


class PhaseFailed(RuntimeError):
    pass


def within(errors: dict, tol: dict) -> list:
    """The names of the measured ``errors`` outside ``tol`` (``*_min``
    entries are lower bounds, the rest upper bounds)."""
    bad = []
    for k, v in errors.items():
        if k + "_min" in tol:
            if not v >= tol[k + "_min"]:
                bad.append(k)
        elif k in tol and not v <= tol[k]:
            bad.append(k)
    return bad


def rel_l2(a, ref) -> float:
    """||a - ref||_2 / ||ref||_2."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-300))


def ok_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _cli(argv) -> str:
    """Run one ``cli`` command in this process; its standard output."""
    from supernet_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if rc not in (0, None):
        raise PhaseFailed(f"cli {argv[0]} exited {rc}")
    return buf.getvalue()


def _last_json(text: str) -> dict:
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise PhaseFailed("no JSON line in the command's output")


@contextlib.contextmanager
def numeric_mode(backend: str, act_dtype: str, precision: str):
    """Set the ops-module knobs for the duration of a block."""
    import jax
    import jax.numpy as jnp

    from supernet_tpu import ops

    prev = (ops.get_backend(), ops.get_act_dtype(), ops.get_mxu_precision())
    ops.set_backend(backend)
    ops.set_act_dtype(act_dtype)
    ops.set_mxu_precision(precision)
    try:
        with jax.default_matmul_precision(precision):
            yield
    finally:
        ops.set_backend(prev[0])
        ops.set_act_dtype("bfloat16" if prev[1] == jnp.bfloat16
                          else "float32")
        ops.set_mxu_precision(prev[2])


# ------------------------------------------------------------------ phases


def phase_device():
    import jax

    from supernet_tpu.profiling import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()
    pkgs = {m: importlib.util.find_spec(m) is not None
            for m in ("orbax", "matplotlib", "h5py")}
    say("device", f"kind={dev.device_kind!r} count={jax.device_count()} "
        f"nvidia-smi={gpu_name_and_power_limit()!r} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r} importable={pkgs}")
    return dev


def phase_train(work: str, n_synthetic: int = 200):
    import pickle

    from supernet_tpu import checkpoint as ckpt

    out = os.path.join(work, "train")
    t0 = time.perf_counter()
    _cli(["train", "--config", "hippocampus", "--synthetic",
          str(n_synthetic), "--epochs", "2", "--batch-size", "20",
          "--out-dir", out])
    train_s = time.perf_counter() - t0
    with open(os.path.join(out, "history.pkl"), "rb") as f:
        hist = pickle.load(f)
    losses = [float(v) for v in hist["train_loss"]]
    if len(losses) != 2 or not np.all(np.isfinite(losses)):
        raise PhaseFailed(f"train losses {losses}")
    if not losses[1] < losses[0]:
        raise PhaseFailed(f"train loss did not fall: {losses}")
    if ckpt.latest_epoch(out) != 1:
        raise PhaseFailed(f"no epoch_1 checkpoint under {out}")
    t0 = time.perf_counter()
    res = _last_json(_cli([
        "eval", "--config", "hippocampus", "--synthetic", "100",
        "--batch-size", "20", "--checkpoint", out, "--images-n", "0",
        "--out-dir", os.path.join(work, "eval")]))
    eval_s = time.perf_counter() - t0
    say("train", f"epoch losses {losses} in {train_s:.1f}s; epoch_1 "
        f"checkpoint written; eval from it in {eval_s:.1f}s: "
        f"{json.dumps(res)[:300]}")
    return out


def _grads_fn(cfg, tc):
    import jax

    from supernet_tpu.train import loss_fn

    def g(p, x, y):
        return jax.grad(lambda q: loss_fn(q, x, y, cfg, tc)[0])(p)

    return jax.jit(g)


def _compare(cfg, tc, params, x, y, mode: str) -> dict:
    """Errors of the ``xla`` backend in ``mode`` against the reference."""
    import jax

    from supernet_tpu.models import forward

    def run(backend, act, prec):
        with numeric_mode(backend, act, prec):
            # fresh jit objects: the ops knobs are read at trace time
            fwd = jax.jit(functools.partial(forward, cfg=cfg))
            probs, sigma = fwd(params, x)
            grads = _grads_fn(cfg, tc)(params, x, y)
            return jax.device_get((probs, sigma, grads))

    p_ref, s_ref, g_ref = run("naive", "float32", "highest")
    if mode == "default":
        p, s, g = run("xla", "float32", "highest")
    else:
        p, s, g = run("xla", "bfloat16", "default")
    p, s = np.asarray(p, np.float64), np.asarray(s, np.float64)
    p_ref, s_ref = np.asarray(p_ref, np.float64), np.asarray(s_ref, np.float64)
    for name, a in (("probs", p), ("sigma", s)):
        if not np.all(np.isfinite(a)):
            raise PhaseFailed(f"{mode}: non-finite {name}")

    def flat(tree):
        return np.concatenate([np.ravel(np.asarray(a, np.float64))
                               for a in jax.tree_util.tree_leaves(tree)])

    top2 = np.sort(p_ref, axis=-1)[..., -2:]
    confident = (top2[..., 1] - top2[..., 0]) > ARGMAX_MARGIN
    agree = np.argmax(p, -1) == np.argmax(p_ref, -1)
    return {
        "probs": float(np.max(np.abs(p - p_ref))),
        "sigma": rel_l2(s, s_ref),
        "grads": rel_l2(flat(g), flat(g_ref)),
        "argmax": float(np.mean(agree[confident])) if confident.any() else 1.0,
        "confident_share": float(np.mean(confident)),
    }


def _unit_gain(params, cfg):
    """Rescale each layer's w_mu to unit gain (std sqrt(2 / (k^2 C_in))).

    The library init draws every w_mu with the same std (cfg.mean_sigma);
    through BraTS's depth-5, up-to-512-channel encoder that saturates the
    softmax on most pixels and drives sigma to ~1e10. There the gradient
    is set by f32 cancellation (1 - p rounds to 0 next to sigma ~1e10) in
    the reference and in the ``xla`` path alike, and two correct programs
    disagree by O(1); a comparison must be made where the result is
    determined. Same widths, same seed, only the scale changes."""
    out = {}
    for name, w in params.items():
        k, _, cin, _ = w["w_mu"].shape
        gain = np.sqrt(2.0 / (k * k * cin)) / cfg.mean_sigma
        out[name] = dict(w, w_mu=w["w_mu"] * gain)
    return out


def phase_reference(train_dir: str):
    import jax

    from supernet_tpu import checkpoint as ckpt
    from supernet_tpu.configs import BRATS, HIPPOCAMPUS
    from supernet_tpu.data.synthetic import synthetic_dataset
    from supernet_tpu.models import init_params
    from supernet_tpu.train import create_train_state

    cases = []
    # Hippocampus: the weights phase 2 trained. BraTS: seeded random
    # weights at unit gain per layer (see _unit_gain).
    h = HIPPOCAMPUS
    state, _ = create_train_state(
        init_params(jax.random.PRNGKey(0), h.model), h.train)
    h_params = ckpt.restore_state(train_dir, 1, state).params
    cases.append(("hippocampus", h, h_params, 20))
    b = BRATS
    cases.append(("brats", b, _unit_gain(
        init_params(jax.random.PRNGKey(0), b.model), b.model), 2))
    failures = []
    for name, exp, params, batch in cases:
        cfg, tc = exp.model, exp.train
        x, y = synthetic_dataset(cfg, batch, seed=1)
        o, s = cfg.out_size, cfg.image_size
        off = (s - o) // 2
        y = y[:, off:off + o, off:off + o]
        for mode in ("default", "bench"):
            err = _compare(cfg, tc, params, np.asarray(x), np.asarray(y), mode)
            bad = within(err, TOLERANCES[mode])
            say("reference", f"{name} batch {batch} mode {mode}: " + ", ".join(
                f"{k}={v:.3e}" for k, v in err.items())
                + f" | tolerance {TOLERANCES[mode]}"
                + (f" | OUTSIDE: {bad}" if bad else " | within"))
            if bad:
                failures.append(f"{name}/{mode}: {bad}")
    if failures:
        raise PhaseFailed(f"outside tolerance: {failures}")


def _timed_steps(step, state, args, n: int):
    """(state, per-step seconds) over ``n`` steps after one warm step."""
    import jax

    state, m = step(state, *args)
    jax.block_until_ready(m)
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, *args)
    jax.block_until_ready(m)
    loss = np.asarray(m.loss)
    if not np.all(np.isfinite(loss)):
        raise PhaseFailed(f"non-finite loss {loss}")
    return state, (time.perf_counter() - t0) / n


def _compile(step, *args):
    """Compile with the persistent compilation cache off. XLA:GPU's
    autotuning results can still come from the cache directory, so a
    repeat run on a machine that keeps that directory compiles several
    times faster; the first run's seconds are the cold ones."""
    import jax

    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        t0 = time.perf_counter()
        compiled = step.lower(*args).compile()
        return compiled, time.perf_counter() - t0
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)


def _mem(compiled) -> str:
    ma = compiled.memory_analysis()
    return (f"args {ma.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {ma.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temp {ma.temp_size_in_bytes / 2**20:.1f} MiB, "
            f"code {ma.generated_code_size_in_bytes / 2**20:.2f} MiB")


def phase_compile():
    import jax
    import jax.numpy as jnp

    from supernet_tpu.configs import BRATS, HIPPOCAMPUS
    from supernet_tpu.models import init_params, init_params3d
    from supernet_tpu.train import (
        create_train_state,
        make_ensemble_train_step,
        make_train_step,
        stack_trees,
    )
    from supernet_tpu.train3d import derive_out_size3d, make_train_step3d

    rng = np.random.default_rng(0)

    def batch2d(cfg, b, lead=()):
        s, o = cfg.image_size, cfg.out_size
        x = rng.normal(0, 1, lead + (b, s, s, cfg.in_channels))
        y = rng.integers(0, cfg.n_classes, lead + (b, o, o))
        return jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.int32)

    measured = {}
    # BraTS at the parity batch
    cfg, tc = BRATS.model, BRATS.train
    state, _ = create_train_state(init_params(jax.random.PRNGKey(0), cfg), tc)
    x, y = batch2d(cfg, 20)
    step, c_s = _compile(make_train_step(cfg, tc), state, x, y)
    _, dt = _timed_steps(step, state, (x, y), 5)
    say("compile", f"brats batch 20 train step: compile {c_s:.1f}s, "
        f"{dt * 1e3:.2f} ms/step; {_mem(step)}")
    # 3-D: Hippocampus-config cubes (64^3 -> 54^3), batch 4
    cfg, tc = HIPPOCAMPUS.model, HIPPOCAMPUS.train
    s3, o3 = cfg.image_size, derive_out_size3d(cfg)
    state, _ = create_train_state(init_params3d(jax.random.PRNGKey(0), cfg), tc)
    x3 = jnp.asarray(rng.normal(0, 1, (4, s3, s3, s3, 1)), jnp.float32)
    y3 = jnp.asarray(rng.integers(0, cfg.n_classes, (4, o3, o3, o3)), jnp.int32)
    step, c_s = _compile(make_train_step3d(cfg, tc), state, x3, y3)
    _, dt = _timed_steps(step, state, (x3, y3), 5)
    measured["step3d_s"] = dt
    say("compile", f"3-D {s3}^3 batch 4 train step: compile {c_s:.1f}s, "
        f"{dt * 1e3:.2f} ms/step; {_mem(step)}")
    # K=4 Hippocampus ensemble: one unrolled program vs K sequential steps
    k = 4
    members = [create_train_state(
        init_params(jax.random.PRNGKey(i), cfg), tc)[0] for i in range(k)]
    stacked = stack_trees(members)  # a copy: the single step donates
    x, y = batch2d(cfg, 20)
    step, c_s = _compile(make_train_step(cfg, tc), members[0], x, y)
    _, dt_one = _timed_steps(step, members[0], (x, y), 20)
    measured.update(compile_s=c_s, sequential_step_s=dt_one)
    say("compile", f"hippocampus batch 20 train step (one member): compile "
        f"{c_s:.1f}s, {dt_one * 1e3:.3f} ms/step; {_mem(step)}")
    xs, ys = batch2d(cfg, 20, lead=(k,))
    seeds = jnp.arange(k, dtype=jnp.int32)
    step, c_s = _compile(
        make_ensemble_train_step(cfg, tc, member_mode="unroll"),
        stacked, xs, ys, seeds)
    _, dt_k = _timed_steps(step, stacked, (xs, ys, seeds), 20)
    measured.update(unroll_compile_s=c_s, unroll_step_s=dt_k,
                    step_ratio=dt_k / (k * dt_one))
    say("compile", f"ensemble K={k} unroll step: compile {c_s:.1f}s, "
        f"{dt_k * 1e3:.3f} ms/step = {measured['step_ratio']:.3f} x "
        f"{k} sequential member steps ({k * dt_one * 1e3:.3f} ms); "
        f"{_mem(step)}")
    say("compile", "ensemble constants measured: " + json.dumps(
        {k_: round(v, 6) for k_, v in measured.items()}))


def phase_serve(work: str):
    import jax

    from supernet_tpu.configs import HIPPOCAMPUS
    from supernet_tpu.models import forward_images, init_params
    from supernet_tpu.serving import InferenceSession, export_stablehlo

    cfg = HIPPOCAMPUS.model
    params = init_params(jax.random.PRNGKey(3), cfg)
    sess = InferenceSession(params, cfg, batch_size=8).warmup()
    fwd = jax.jit(functools.partial(forward_images, cfg=cfg))
    rng = np.random.default_rng(5)
    sizes = (1, 8, 13, 3)
    worst = 0.0
    for n in sizes:
        x = rng.normal(0, 1, (n, cfg.image_size, cfg.image_size,
                              cfg.in_channels)).astype(np.float32)
        p, s = sess.predict(x)
        # the reference call runs at the session's compiled batch, so both
        # sides execute the same program on the same rows
        pad = (-n) % 8
        xp = np.concatenate([x, np.repeat(x[-1:], pad, 0)]) if pad else x
        p_ref, s_ref = [], []
        for i in range(0, len(xp), 8):
            a, b = fwd(params, xp[i:i + 8])
            p_ref.append(np.asarray(a))
            s_ref.append(np.asarray(b))
        p_ref = np.concatenate(p_ref)[:n]
        s_ref = np.concatenate(s_ref)[:n]
        if p.shape != p_ref.shape or s.shape != s_ref.shape:
            raise PhaseFailed(f"request of {n}: shapes {p.shape} vs {p_ref.shape}")
        worst = max(worst, float(np.max(np.abs(p - p_ref))),
                    float(np.max(np.abs(s - s_ref))))
    if worst != 0.0:
        raise PhaseFailed(f"session differs from forward by {worst:.3e}")
    path = os.path.join(work, "export", "model.stablehlo.mlir")
    text = export_stablehlo(params, cfg, batch_size=8, path=path)
    if not (os.path.getsize(path) > 0 and "stablehlo" in text):
        raise PhaseFailed("export_stablehlo wrote no StableHLO module")
    say("serve", f"InferenceSession answered requests of {list(sizes)} "
        f"images, identical to forward; StableHLO bundle "
        f"{os.path.getsize(path) / 1024:.0f} KiB written")


def phase_profile(work: str):
    out = os.path.join(work, "profile")
    _cli(["profile", "--config", "hippocampus", "--batch", "20",
          "--by-layer", "--iters", "5", "--out-dir", out])
    with open(os.path.join(out, "exact_join.json")) as f:
        res = json.load(f)
    if not res.get("joined_events"):
        raise PhaseFailed("profile joined no device events to the HLO")
    top = ", ".join(f"{c['class']} {c['ms_per_step']:.3f}"
                    for c in res["classes"][:4])
    say("profile", f"{res['joined_events']} kernel events joined; device "
        f"busy {res['device_busy_ms_per_step']:.3f} ms/step; top classes "
        f"(ms/step): {top}")


# ------------------------------------------------------------- four GPUs

# A mesh path against its single-device twin, both f32 at "highest". The
# two are different programs: per-shard shapes differ, so cuDNN may pick
# other algorithms, and reductions run in another order — the same
# sources of error as the reference comparison, so the same bound, 1e-3,
# on: forward probs (max-abs) and sigma (relative L2); the losses of two
# successive train steps (relative; the second sees the first update);
# and Adam's moments after the first step (relative L2 over mu and nu,
# which are 0.1 g and 0.001 g^2 of the clipped gradient g) — the
# gradient itself, compared through the step users call. The weights
# are not compared directly: Adam's first step moves each weight by
# about lr whatever its gradient's size, so a weight whose gradient is
# within rounding of 0 may move either way on the two sides. Weights are
# seeded random at unit gain (see _unit_gain).
MESH_TOL = {"forward": 1e-3, "loss_rel": 1e-3, "grad_rel": 1e-3}
MESH_STEPS = 2


def _spans(arr, n: int, what: str) -> None:
    got = len(arr.sharding.device_set)
    if got != n:
        raise PhaseFailed(f"{what} spans {got} devices, expected {n}")


def _moments(state):
    """Adam's first and second moments, flattened (the float leaves of
    the optimizer state; the step counts are integers)."""
    import jax

    leaves = jax.tree_util.tree_leaves(jax.device_get(state.opt_state))
    return np.concatenate([np.ravel(np.asarray(a, np.float64))
                           for a in leaves
                           if np.issubdtype(np.asarray(a).dtype, np.floating)])


def _run_steps(step, state, *args):
    """(optimizer moments after the first step, per-step losses)."""
    losses, moments = [], None
    for i in range(MESH_STEPS):
        state, m = step(state, *args)
        losses.append(np.asarray(m.loss, np.float64))
        if i == 0:
            moments = _moments(state)
    return moments, losses


def _check_steps(name: str, run, run_ref, failed: list) -> None:
    (mom, losses), (mom_ref, losses_ref) = run, run_ref
    loss_rel = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
                   for a, b in zip(losses, losses_ref))
    grad_rel = rel_l2(mom, mom_ref)
    bad = not (loss_rel <= MESH_TOL["loss_rel"]
               and grad_rel <= MESH_TOL["grad_rel"])
    say("multi", f"{name}: {MESH_STEPS} steps, loss rel {loss_rel:.2e}, "
        f"Adam moments after step 1 rel L2 {grad_rel:.2e}"
        + (" | OUTSIDE" if bad else " | within"))
    if bad:
        failed.append(name)


def _check_forward(name: str, p, s, p_ref, s_ref, failed: list) -> None:
    e_p = float(np.max(np.abs(np.asarray(p) - np.asarray(p_ref))))
    e_s = rel_l2(s, s_ref)
    bad = not (e_p <= MESH_TOL["forward"] and e_s <= MESH_TOL["forward"])
    say("multi", f"{name}: probs max-abs {e_p:.2e}, sigma rel L2 {e_s:.2e}"
        + (" | OUTSIDE" if bad else " | within"))
    if bad:
        failed.append(name)


def phase_multi(n: int = 4):
    """The mesh paths users depend on, each against its single-device twin,
    Hippocampus at full width. Every check runs; the phase fails at the
    end if any of them did."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from supernet_tpu.configs import HIPPOCAMPUS
    from supernet_tpu.models import forward, init_params
    from supernet_tpu.parallel import (
        make_mesh,
        make_sharded_train_step,
        make_spatial_forward,
        make_spatial_train_step,
        replicate,
        shard_batch,
    )
    from supernet_tpu.parallel.hybrid import make_hybrid_train_step, make_mesh2d
    from supernet_tpu.serving import EnsembleSession
    from supernet_tpu.train import (
        create_train_state,
        make_ensemble_train_step,
        make_train_step,
        stack_trees,
    )

    if jax.device_count() < n:
        raise PhaseFailed(f"--multi needs {n} devices, found "
                          f"{jax.device_count()}")
    cfg, tc = HIPPOCAMPUS.model, HIPPOCAMPUS.train
    rng = np.random.default_rng(0)
    s, o = cfg.image_size, cfg.out_size

    def batch(b):
        x = rng.normal(0, 1, (b, s, s, cfg.in_channels)).astype(np.float32)
        y = rng.integers(0, cfg.n_classes, (b, o, o)).astype(np.int32)
        return x, y

    def params(seed=0):
        return _unit_gain(init_params(jax.random.PRNGKey(seed), cfg), cfg)

    def fresh(seed=0):
        return create_train_state(params(seed), tc)[0]

    def single(x, y):
        return _run_steps(make_train_step(cfg, tc), fresh(),
                          jnp.asarray(x), jnp.asarray(y))

    failed: list = []
    with numeric_mode("xla", "float32", "highest"):
        # data parallel: batch over the 4 devices, params replicated
        mesh = make_mesh(n)
        x, y = batch(20)
        xs, ys = shard_batch(mesh, jnp.asarray(x), jnp.asarray(y))
        _spans(xs, n, "data-parallel batch")
        _check_steps("data-parallel train step (batch 20)", _run_steps(
            make_sharded_train_step(cfg, tc, mesh),
            replicate(mesh, fresh()), xs, ys), single(x, y), failed)

        # spatial: the image H axis over the 4 devices
        x, y = batch(2)
        xh = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "data")))
        _spans(xh, n, "H-sharded input")
        p0 = params()
        _check_forward("H-sharded forward (batch 2)",
                       *make_spatial_forward(cfg, mesh)(p0, xh),
                       *jax.jit(lambda p, v: forward(p, v, cfg))(
                           p0, jnp.asarray(x)), failed)
        step = make_spatial_train_step(cfg, tc, mesh)
        hlo = step.lower(fresh(), xh, jnp.asarray(y)).compile().as_text()
        if "collective-permute" not in hlo and "all-to-all" not in hlo:
            raise PhaseFailed("H-sharded step has no halo exchange")
        _check_steps("H-sharded train step (batch 2)", _run_steps(
            step, fresh(), xh, jnp.asarray(y)), single(x, y), failed)

        # hybrid: 2 (batch) x 2 (H) mesh
        mesh2 = make_mesh2d(2, n // 2)
        x, y = batch(20)
        on_data = NamedSharding(mesh2, P("data"))
        xb = jax.device_put(jnp.asarray(x), on_data)
        _spans(xb, n, "hybrid batch")
        _check_steps(f"2x{n // 2} hybrid train step (batch 20)", _run_steps(
            make_hybrid_train_step(cfg, tc, mesh2),
            replicate(mesh2, fresh()), xb,
            jax.device_put(jnp.asarray(y), on_data)), single(x, y), failed)

        # ensemble: K=4 members, one per device
        k = n
        xk = np.stack([batch(20)[0] for _ in range(k)])
        yk = np.stack([batch(20)[1] for _ in range(k)])
        seeds = jnp.arange(k, dtype=jnp.int32)
        member = NamedSharding(mesh, P("data"))
        xk_s = jax.device_put(jnp.asarray(xk), member)
        _spans(xk_s, n, "member-sharded batches")
        _check_steps(
            f"member-sharded ensemble step (K={k}, batch 20)",
            _run_steps(make_ensemble_train_step(cfg, tc, mesh=mesh),
                       jax.device_put(stack_trees(
                           [fresh(i) for i in range(k)]), member),
                       xk_s, jax.device_put(jnp.asarray(yk), member),
                       jax.device_put(seeds, member)),
            _run_steps(make_ensemble_train_step(cfg, tc),
                       stack_trees([fresh(i) for i in range(k)]),
                       jnp.asarray(xk), jnp.asarray(yk), seeds), failed)

        plist = [params(10 + i) for i in range(k)]
        xq = batch(13)[0]
        ens = EnsembleSession(plist, cfg, batch_size=8, mesh=mesh)
        _spans(ens._params["conv_input"]["w_mu"], n, "session members")
        _check_forward(f"EnsembleSession(mesh) K={k}, 13 images",
                       *ens.predict(xq),
                       *EnsembleSession(plist, cfg, batch_size=8).predict(xq),
                       failed)
    if failed:
        raise PhaseFailed(f"differ from their single-device twins: {failed}")


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh paths")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if importlib.util.find_spec("supernet_tpu") is None:
        print("chip_smoke: the supernet_tpu package is not next to this "
              "script", file=sys.stderr)
        return 2
    from supernet_tpu.utils import use_compile_cache

    use_compile_cache()
    import jax

    from supernet_tpu.profiling import NotOnGpu, gpu_name_and_power_limit

    try:
        dev = phase_device()
    except NotOnGpu as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        try:
            if args.multi:
                phase_multi()
            else:
                train_dir = phase_train(work)
                phase_reference(train_dir)
                phase_compile()
                phase_serve(work)
                phase_profile(work)
        except PhaseFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
    print(gpu_name_and_power_limit(), flush=True)
    print(ok_line(dev.platform, dev.device_kind, jax.device_count()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
