"""Parse a jax.profiler device trace (``*.xplane.pb``) without TensorFlow.

The hosted image ships no ``xplane_pb2`` (tensorboard_plugin_profile has
only the downstream protos), so this is a minimal protobuf wire-format
decoder for the stable XSpace schema subset the perf studies need:

    XSpace.planes[]            (field 1)
    XPlane.name                (2), .lines[] (3),
           .event_metadata{}   (4, map id -> XEventMetadata),
           .stat_metadata{}    (5, map id -> XStatMetadata)
    XLine.name                 (2), .timestamp_ns (3), .events[] (4)
    XEventMetadata.name        (2), .stats[] (5)
    XEvent.metadata_id         (1), .offset_ps (2), .duration_ps (3),
          .stats[]             (4)
    XStat.metadata_id          (1), .uint64_value (3), .int64_value (4),
         .str_value            (5), .ref_value (7)

On a GPU trace each device plane (``/device:GPU:N``) has one line per
CUDA stream; every kernel event carries ``hlo_op`` (the HLO instruction
it runs) and ``hlo_module`` stats.

Usage (per-op buckets of the GPU kernels):

    python tools/xplane.py runs/trace3d   # dir passed to profiling.trace
"""

from __future__ import annotations

import collections
import glob
import os
import sys
from typing import Dict, Iterator, List, Tuple


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    r = s = 0
    while True:
        b = buf[i]
        r |= (b & 0x7F) << s
        i += 1
        if not b & 0x80:
            return r, i
        s += 7


def fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_no, wire_type, value) over one message's wire bytes."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        else:  # groups (3/4) never appear in xplane
            raise ValueError(f"wire type {wt}")
        yield fno, wt, v


def _map_entry(buf: bytes) -> Tuple[int, bytes]:
    key, val = 0, b""
    for fno, _, v in fields(buf):
        if fno == 1:
            key = v  # type: ignore[assignment]
        elif fno == 2:
            val = v  # type: ignore[assignment]
    return int(key), bytes(val)


def _name(buf: bytes) -> str:
    for fno, wt, v in fields(buf):
        if fno == 2 and wt == 2:
            return bytes(v).decode("utf-8", "replace")
    return ""


class Event:
    __slots__ = ("name", "start_ps", "duration_ps", "stats")

    def __init__(self, name: str, duration_ps: int, stats: Dict[str, str],
                 start_ps: int = 0):
        self.name, self.duration_ps, self.stats = name, duration_ps, stats
        self.start_ps = start_ps


def _stats(buf_list, smeta: Dict[int, str]) -> Dict[str, str]:
    """XStat messages -> {stat name: value as str}. String stats carry
    ``str_value`` (5); interned strings (the GPU tracer's ``hlo_op`` /
    ``hlo_module``) carry ``ref_value`` (7), an id into the plane's stat
    metadata; numbers carry uint64 (3) / int64 (4)."""
    out: Dict[str, str] = {}
    for raw in buf_list:
        sid, sval = 0, None
        for f5, w5, sv in fields(raw):
            if f5 == 1 and w5 == 0:
                sid = sv
            elif f5 == 5 and w5 == 2:
                sval = bytes(sv).decode("utf-8", "replace")
            elif f5 == 7 and w5 == 0:
                sval = smeta.get(int(sv), str(sv))
            elif f5 in (3, 4) and w5 == 0:
                sval = str(sv)
        if int(sid) in smeta and sval is not None:
            out[smeta[int(sid)]] = sval
    return out


def _event_metadata(buf: bytes):
    """XEventMetadata -> (name, raw stat messages)."""
    name, stats = "", []
    for fno, wt, v in fields(buf):
        if fno == 2 and wt == 2:
            name = bytes(v).decode("utf-8", "replace")
        elif fno == 5 and wt == 2:
            stats.append(bytes(v))
    return name, stats


def parse_xspace(path: str) -> Dict[str, Dict[str, List[Event]]]:
    """{plane_name: {line_name: [Event, ...]}} for every plane/line. An
    event's stats merge its metadata's stats with its own (the event's
    win); ``start_ps`` is the line's timestamp plus the event offset."""
    with open(path, "rb") as f:
        raw = f.read()
    out: Dict[str, Dict[str, List[Event]]] = {}
    for fno, wt, plane in fields(raw):
        if fno != 1 or wt != 2:
            continue
        pname, lines, emeta_raw, smeta = "", [], {}, {}
        for f2, w2, v in fields(bytes(plane)):
            if f2 == 2 and w2 == 2:
                pname = bytes(v).decode("utf-8", "replace")
            elif f2 == 3 and w2 == 2:
                lines.append(bytes(v))
            elif f2 == 4 and w2 == 2:
                k, mv = _map_entry(bytes(v))
                emeta_raw[k] = mv
            elif f2 == 5 and w2 == 2:
                k, mv = _map_entry(bytes(v))
                smeta[k] = _name(mv)
        emeta = {}
        for k, mv in emeta_raw.items():
            name, mstats = _event_metadata(mv)
            emeta[k] = (name, _stats(mstats, smeta))
        plane_d: Dict[str, List[Event]] = {}
        for line in lines:
            lname, evs, t0_ns = "", [], 0
            for f3, w3, v in fields(line):
                if f3 == 2 and w3 == 2:
                    lname = bytes(v).decode("utf-8", "replace")
                elif f3 == 3 and w3 == 0:
                    t0_ns = int(v)  # type: ignore[arg-type]
                elif f3 == 4 and w3 == 2:
                    mid = dur = off = 0
                    ev_stats = []
                    for f4, w4, ev in fields(bytes(v)):
                        if f4 == 1 and w4 == 0:
                            mid = ev  # type: ignore[assignment]
                        elif f4 == 2 and w4 == 0:
                            off = ev  # type: ignore[assignment]
                        elif f4 == 3 and w4 == 0:
                            dur = ev  # type: ignore[assignment]
                        elif f4 == 4 and w4 == 2:
                            ev_stats.append(bytes(ev))
                    name, mstats = emeta.get(int(mid), (str(mid), {}))
                    stats = dict(mstats)
                    stats.update(_stats(ev_stats, smeta))
                    evs.append(Event(name, int(dur), stats,
                                     t0_ns * 1000 + int(off)))
            plane_d[lname] = evs
        out[pname] = plane_d
    return out


def is_gpu_device_plane(name: str) -> bool:
    """GPU device planes are named ``/device:GPU:<ordinal>``; host threads,
    metadata and the task environment have planes of their own."""
    return name.startswith("/device:GPU:")


def _bucket(ev: Event) -> str:
    """Bucket a kernel by its HLO instruction's name stem (``hlo_op``
    ``loop_add_fusion.19`` -> ``loop_add_fusion``), else by the kernel name."""
    op = ev.stats.get("hlo_op") or ev.name
    return op.lstrip("%").split(".")[0].split("(")[0]


def newest_xplane(trace_dir: str) -> str:
    """The newest ``*.xplane.pb`` under a ``profiling.trace`` directory."""
    pbs = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime)
    if not pbs:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return pbs[-1]


def op_buckets(trace_dir: str, line_filter: str = "Stream"):
    """Aggregate (total_ps, events) per bucket over every GPU device
    plane's lines whose name contains ``line_filter``, in the newest
    xplane.pb under ``trace_dir``."""
    space = parse_xspace(newest_xplane(trace_dir))
    agg: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    for pname, lines in space.items():
        if not is_gpu_device_plane(pname):
            continue
        for lname, evs in lines.items():
            if line_filter not in lname:
                continue
            for ev in evs:
                b = agg[_bucket(ev)]
                b[0] += ev.duration_ps
                b[1] += 1
    return {k: (v[0], v[1]) for k, v in agg.items()}


def main(argv: List[str]) -> int:
    buckets = op_buckets(argv[1], argv[2] if len(argv) > 2 else "Stream")
    total = sum(ps for ps, _ in buckets.values())
    print(f"{'bucket':32} {'ms':>10} {'events':>8} {'%':>6}")
    for name, (ps, n) in sorted(
            buckets.items(), key=lambda kv: -kv[1][0]):
        print(f"{name:32} {ps / 1e9:10.3f} {n:8d} "
              f"{100 * ps / max(total, 1):6.1f}")
    print(f"{'TOTAL':32} {total / 1e9:10.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
