"""Exact-join per-op profiling: trace a train step and attribute every
device event against the HLO text of the SAME compiled executable.

Bucketing trace events by name alone ("fusion.N" -> elementwise)
misattributes convolutions that XLA wraps in fusions or hands to cuDNN
as custom-calls, so every GPU kernel event is joined, through its
``hlo_op`` / ``hlo_module`` trace stats, to its instruction in
``step.lower(...).compile().as_text()`` and classified from there.

Usage (on the GPU; ``tools/exact_join.py`` is a compat wrapper):

    python -m supernet_tpu.cli profile --config hippocampus --batch 20
    python -m supernet_tpu.cli profile --config unet3d --batch 16 --by-layer

Prints one class table (ms/step, %) with every kernel event joined to its
compiled-module instruction, plus the device's busy time (the union of its
kernel intervals); ``--by-layer`` adds per-layer conv attribution via the
models' ``jax.named_scope`` layer scopes; unjoined time is reported, not
silently folded into a class. The JSON twin of the tables is written to
``<out_dir>/exact_join.json``.
"""

from __future__ import annotations

import collections
import json
import os
import re

import numpy as np

# --------------------------------------------------------------------------
# HLO text -> instruction classification
# --------------------------------------------------------------------------

# name = everything before " = "; the opcode is the first bare
# lowercase word followed by "(" after the result type.  (A naive
# "type opcode(" regex fails on tuple-typed instructions — copy-start,
# while — whose types contain nested parens from tile specs T(8,128).)
_NAME_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_OPCODE_RE = re.compile(r"(?:^|[\s)])([a-z][a-z0-9\-]*)\(")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_METADATA_RE = re.compile(r'metadata=\{[^}]*op_name="([^"]*)"')
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
_TARGET_RE = re.compile(r'custom_call_target="([^"]*)"')
_MODULE_RE = re.compile(r"^HloModule\s+([\w.\-]+)")


def _custom_call_opcode(line: str) -> str:
    """The GPU compiler lowers convolutions to cuDNN and some matmuls to
    cuBLAS as custom-calls; name them by the operation they run so the
    classes below do not depend on the backend's lowering."""
    m = _TARGET_RE.search(line)
    target = m.group(1) if m else ""
    if target.startswith("__cudnn$conv"):
        return "convolution"
    if "gemm" in target or "matmul" in target.lower():
        return "dot"
    return "custom-call"


def parse_hlo(text: str):
    """{instr_name: (opcode, op_name_metadata, inner)} for every
    instruction of EVERY computation (instruction names are unique
    module-wide, and with a lax.scan dispatch the hot ops live in the
    while-body computation, not ENTRY); fusions carry the opcode +
    metadata list of their fused computation."""
    comps = {}  # comp_name -> [(instr, opcode, meta, calls)]
    cur = None
    for line in text.splitlines():
        stripped = line.rstrip()
        # computation headers end with "{" and never contain a spaced
        # " = " (instructions always do; "=" alone also appears inside
        # /*index=N*/ comments and window={...} attrs)
        if stripped.endswith("{") and " = " not in stripped:
            m = _COMP_RE.match(stripped.strip())
            if m:
                cur = comps.setdefault(m.group(1), [])
            continue
        if stripped.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        if " = " not in line:
            continue
        m = _NAME_RE.match(line)
        if not m:
            continue
        instr, rest = m.group(1), m.group(2)
        om = _OPCODE_RE.search(rest)
        if not om:
            continue
        opcode = om.group(1)
        if opcode == "custom-call":
            opcode = _custom_call_opcode(line)
        meta = _METADATA_RE.search(line)
        calls = _CALLS_RE.search(line) if opcode == "fusion" else None
        cur.append(
            (instr, opcode, meta.group(1) if meta else "",
             calls.group(1) if calls else None)
        )
    table = {}
    for cname, instrs in comps.items():
        for instr, opcode, meta, calls in instrs:
            inner = []
            if calls and calls in comps:
                inner = [(op, mt) for _, op, mt, _ in comps[calls]]
            table[instr] = (opcode, meta, inner)
    return table


# the scope can be a bare path component ("/conv1/") or wrapped by AD
# transforms ("jvp(conv1)/", "transpose(jvp(conv1))/"); match the layer
# token word-bounded anywhere in the op_name path
_LAYER_RE = re.compile(
    r"(?<![\w])(conv_input|up\d+_conv(?:2x2|\d)|conv\d+|conv_final)(?![\w])"
)


def layer_of(meta: str, inner) -> str:
    """Layer attribution from the jax.named_scope path embedded in the HLO
    metadata op_name (models/unet{,3d}.py wrap every conv layer in its
    parameter name). A fusion containing ops from several layers is
    labeled 'mixed'."""
    names = set()
    for mt in [meta] + [m for _, m in inner]:
        m = _LAYER_RE.search(mt)
        if m:
            names.add(m.group(1))
    if not names:
        return "(unscoped)"
    if len(names) > 1:
        return "mixed:" + "+".join(sorted(names))
    return names.pop()


def classify(opcode: str, meta: str, inner) -> str:
    """One class per instruction, matmul work first. Backward convs are
    recognized by the jax AD path markers in the metadata op_name."""
    ops = [opcode] + [op for op, _ in inner]
    metas = [meta] + [mt for _, mt in inner]

    def is_bwd(mt: str) -> bool:
        return "transpose(" in mt or "/vjp" in mt or "grad" in mt

    if "convolution" in ops:
        conv_metas = [
            mt for op, mt in ([(opcode, meta)] + list(inner))
            if op == "convolution"
        ]
        bwd = any(is_bwd(mt) for mt in conv_metas)
        fwd = any(not is_bwd(mt) for mt in conv_metas)
        if bwd and not fwd:
            return "conv.bwd"
        if fwd and not bwd:
            return "conv.fwd"
        return "conv.mixed"
    if "dot" in ops:
        return "dot"
    if "custom-call" in ops:
        return "custom-call"
    if "reduce-window" in ops or "select-and-scatter" in ops:
        return "reduce-window"
    if "scatter" in ops or "gather" in ops:
        return "scatter/gather"
    if any(op in ("all-reduce", "all-gather", "reduce-scatter",
                  "collective-permute") for op in ops):
        return "collective"
    if "reduce" in ops:
        return "reduce"
    if opcode in ("copy-start", "copy-done", "slice-start", "slice-done",
                  "dynamic-slice-start", "dynamic-slice-done",
                  "dynamic-update-slice-start", "dynamic-update-slice-done"):
        # asynchronous copies overlap compute, so their ms/step is copy
        # occupancy, not critical path
        return "async copy"
    if opcode in ("copy", "transpose", "bitcast", "reshape"):
        return "layout/copy"
    if opcode in ("while", "conditional", "call"):
        return "control"
    return "elementwise"


# --------------------------------------------------------------------------
# build step -> compile -> trace -> join
# --------------------------------------------------------------------------


def build_step(model: str, batch: int):
    """The bench's production path: K-step lax.scan dispatch (K from
    SUPERNET_BENCH_DISPATCH, default 8), bf16 activations (the bench
    default; SUPERNET_ACT_DTYPE overrides) — same program bench.py
    times."""
    import jax
    import jax.numpy as jnp

    from supernet_tpu.ops import apply_env_overrides, set_act_dtype

    set_act_dtype(os.environ.get("SUPERNET_ACT_DTYPE", "bfloat16"))
    apply_env_overrides()

    from supernet_tpu.models import init_params
    from supernet_tpu.train import (
        create_train_state,
        make_multi_train_step,
        make_train_step,
        one_hot_flatten,
    )

    k_steps = int(os.environ.get("SUPERNET_BENCH_DISPATCH", "8"))
    rng = np.random.default_rng(0)
    if model == "unet3d":
        from supernet_tpu.configs import get_config
        from supernet_tpu.models import init_params3d
        from supernet_tpu.train3d import (
            derive_out_size3d,
            make_multi_train_step3d,
            make_train_step3d,
        )
        import dataclasses

        exp = get_config("hippocampus")
        cfg = dataclasses.replace(exp.model)
        cfg = dataclasses.replace(cfg, out_size=derive_out_size3d(cfg))
        tc = exp.train
        s = cfg.image_size
        x = jnp.asarray(rng.normal(
            0, 1, (batch, s, s, s, cfg.in_channels)).astype(np.float32))
        y = jnp.asarray(rng.integers(
            0, cfg.n_classes,
            (batch, cfg.out_size, cfg.out_size, cfg.out_size)
        ).astype(np.int32))
        params = init_params3d(jax.random.PRNGKey(0), cfg)
        state, _ = create_train_state(params, tc)
        if k_steps > 1:
            x = jnp.broadcast_to(x[None], (k_steps,) + x.shape)
            y = jnp.broadcast_to(y[None], (k_steps,) + y.shape)
            step = make_multi_train_step3d(cfg, tc, k_steps)
        else:
            step = make_train_step3d(cfg, tc)
        return step, state, x, y, k_steps

    from supernet_tpu.configs import get_config

    exp = get_config(model)
    cfg, tc = exp.model, exp.train
    x = jnp.asarray(rng.normal(
        0, 1, (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    ).astype(np.float32))
    y_img = jnp.asarray(rng.integers(
        0, cfg.n_classes, (batch, cfg.out_size, cfg.out_size)
    ).astype(np.int32))
    y = one_hot_flatten(y_img, cfg.n_classes)
    params = init_params(jax.random.PRNGKey(0), cfg)
    state, _ = create_train_state(params, tc)
    if k_steps > 1:
        x = jnp.broadcast_to(x[None], (k_steps,) + x.shape)
        y = jnp.broadcast_to(y[None], (k_steps,) + y.shape)
        step = make_multi_train_step(cfg, tc, k_steps)
    else:
        step = make_train_step(cfg, tc)
    return step, state, x, y, k_steps


def module_name(hlo_text: str) -> str:
    """``jit_step`` from the ``HloModule jit_step, ...`` header."""
    m = _MODULE_RE.match(hlo_text.lstrip())
    return m.group(1) if m else ""


def _union_ps(intervals) -> int:
    """Total length of the union of [start, end) intervals."""
    busy, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def join_events(space, table, module: str, by_layer: bool = False):
    """Join every kernel event of the GPU device planes of a parsed trace
    (``xplane.parse_xspace``) to its instruction in ``table``
    (``parse_hlo``) through the event's ``hlo_op`` stat; only events whose
    ``hlo_module`` is ``module`` count. Returns a dict of per-class and,
    with ``by_layer``, per-(layer, class) ``[ps, events]``, the unmatched
    ``[ps, events]`` per name stem, the number of joined events and the
    device busy time (union of all kernel intervals, per plane, summed).

    Raises ValueError when no event joined: a trace without GPU device
    planes, or one whose kernels belong to another program."""
    from supernet_tpu.xplane import is_gpu_device_plane

    agg = collections.defaultdict(lambda: [0, 0])
    lagg = collections.defaultdict(lambda: [0, 0])
    unmatched = collections.defaultdict(lambda: [0, 0])
    busy_ps, joined = 0, 0
    for pname, lines in space.items():
        if not is_gpu_device_plane(pname):
            continue
        spans = []
        for evs in lines.values():
            for ev in evs:
                if ev.stats.get("hlo_module") != module:
                    continue
                spans.append((ev.start_ps, ev.start_ps + ev.duration_ps))
                name = ev.stats.get("hlo_op", "")
                hit = table.get(name)
                if hit is None:
                    stem = name.split(".")[0] or ev.name.split("(")[0]
                    unmatched[stem][0] += ev.duration_ps
                    unmatched[stem][1] += 1
                    continue
                joined += 1
                cls = classify(*hit)
                agg[cls][0] += ev.duration_ps
                agg[cls][1] += 1
                if by_layer:
                    lay = layer_of(hit[1], hit[2])
                    lagg[(lay, cls)][0] += ev.duration_ps
                    lagg[(lay, cls)][1] += 1
        busy_ps += _union_ps(spans)
    if not joined:
        raise ValueError(
            f"no GPU kernel event of module {module!r} joined to the HLO "
            f"(device planes: "
            f"{[p for p in space if is_gpu_device_plane(p)]})"
        )
    return {"classes": agg, "layers": lagg, "unmatched": unmatched,
            "joined": joined, "busy_ps": busy_ps}


def run(model: str, batch: int, trace_dir: str, n_iters: int = 20,
        by_layer: bool = False):
    import jax

    from supernet_tpu.profiling import trace
    from supernet_tpu.xplane import newest_xplane, parse_xspace

    step, state, x, y, k_steps = build_step(model, batch)
    # Execute the SAME object whose HLO we join against: calling
    # ``step(...)`` and separately ``step.lower(...).compile()`` yields two
    # executables whose instruction numbering can differ (donation
    # flags) — so lower once, take the text, and run the compiled object.
    compiled = step.lower(state, x, y).compile()
    hlo = compiled.as_text()
    table = parse_hlo(hlo)
    # warmup (first call of this executable)
    state, metrics = compiled(state, x, y)
    jax.block_until_ready(metrics)

    import time

    t0 = time.perf_counter()
    with trace(trace_dir):
        for _ in range(n_iters):
            state, metrics = compiled(state, x, y)
        jax.block_until_ready(metrics)
    wall_ms_step = (time.perf_counter() - t0) * 1e3 / (n_iters * k_steps)

    j = join_events(parse_xspace(newest_xplane(trace_dir)), table,
                    module_name(hlo), by_layer)
    agg, lagg, unmatched = j["classes"], j["layers"], j["unmatched"]
    # "control" (while/call wrappers) spans its own body — counting it
    # would double every op inside the scan loop; report it separately.
    control_ps = agg.pop("control", [0, 0])[0]
    total = sum(ps for ps, _ in agg.values()) + sum(
        ps for ps, _ in unmatched.values()
    )
    steps = n_iters * k_steps
    busy_ms = j["busy_ps"] / 1e9 / steps
    print(f"\n== {model} batch {batch} (K={k_steps} scan, {n_iters} "
          f"dispatches = {steps} steps, {j['joined']} kernel events "
          f"joined) ==")
    print(f"device busy: {busy_ms:.3f} ms/step | wall (incl. trace "
          f"overhead): {wall_ms_step:.3f} | control-op span "
          f"{control_ps / 1e9 / steps:.3f}")
    print(f"{'class':28} {'ms/step':>9} {'events':>8} {'%':>6}")
    rows = []
    for name, (ps, n) in sorted(agg.items(), key=lambda kv: -kv[1][0]):
        ms = ps / 1e9 / steps
        pct = 100 * ps / max(total, 1)
        print(f"{name:28} {ms:9.3f} {n:8d} {pct:6.1f}")
        rows.append({"class": name, "ms_per_step": round(ms, 4),
                     "events": n, "pct": round(pct, 2)})
    un_ps = sum(ps for ps, _ in unmatched.values())
    if un_ps:
        print(f"{'UNMATCHED':28} {un_ps / 1e9 / steps:9.3f} "
              f"{sum(n for _, n in unmatched.values()):8d} "
              f"{100 * un_ps / max(total, 1):6.1f}")
        for name, (ps, n) in sorted(
                unmatched.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"  ? {name:24} {ps / 1e9 / steps:9.3f} {n:8d}")
    print(f"{'TOTAL':28} {total / 1e9 / steps:9.3f}")
    layer_rows = []
    if by_layer and lagg:
        per_layer = collections.defaultdict(lambda: [0, 0])
        for (lay, cls), (ps, n) in lagg.items():
            if cls.startswith("conv") or cls == "dot" or by_layer == "all":
                per_layer[lay][0] += ps
                per_layer[lay][1] += n
        print("\n-- per-layer conv time (named_scope attribution) --")
        print(f"{'layer':18} {'ms/step':>9} {'events':>8} {'% of step':>9}")
        for lay, (ps, n) in sorted(per_layer.items(), key=lambda kv: -kv[1][0]):
            ms = ps / 1e9 / steps
            pct = 100 * ps / max(total, 1)
            print(f"{lay:18} {ms:9.3f} {n:8d} {pct:9.1f}")
            layer_rows.append({"layer": lay, "ms_per_step": round(ms, 4),
                               "events": n, "pct": round(pct, 2)})
    out = {
        "model": model, "batch": batch, "k_steps": k_steps,
        "n_iters": n_iters, "wall_ms_per_step": round(wall_ms_step, 4),
        "device_busy_ms_per_step": round(busy_ms, 4),
        "joined_events": j["joined"],
        "control_ms_per_step": round(control_ps / 1e9 / steps, 4),
        "classes": rows,
        "unmatched_ms_per_step": round(un_ps / 1e9 / steps, 4),
        "total_ms_per_step": round(total / 1e9 / steps, 4),
    }
    if layer_rows:
        out["layers_conv"] = layer_rows
    with open(os.path.join(trace_dir, "exact_join.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(raw_args=None) -> int:
    import sys

    raw = list(sys.argv[1:] if raw_args is None else raw_args)
    by_layer = "--by-layer" in raw
    argv = [a for a in raw if a != "--by-layer"]
    model = argv[0] if len(argv) > 0 else "hippocampus"
    batch = int(argv[1]) if len(argv) > 1 else 20
    trace_dir = (argv[2] if len(argv) > 2
                 else os.path.join("runs", f"profile_{model}_{batch}"))
    os.makedirs(trace_dir, exist_ok=True)
    run(model, batch, trace_dir, by_layer=by_layer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
