"""Tracing / profiling hooks (SURVEY.md §5).

The reference's only instrumentation is wall-clock ``timeit`` around training
and around one inference batch (`Hippocampus.py:563,726,952-954`). Here:

- ``trace(dir)`` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of device execution (XLA ops, fusion, HBM);
- ``StepTimer`` — rolling per-step wall-clock with device sync on demand,
  used by the Trainer for steps/sec and by bench.py;
- ``device_memory_stats()`` — live device-memory usage per device where
  the backend exposes it (the GPU does);
- ``require_gpu()`` / ``gpu_name_and_power_limit()`` — the device checks
  every measurement path runs first: a number taken anywhere but on the
  GPU is refused, and each result names the card and its power limit.
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import time
from typing import Dict, Iterator, List, Optional


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``with profiling.trace("runs/trace"):`` — wraps jax.profiler's
    start/stop; view with TensorBoard's profile plugin."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Rolling throughput meter.

    ``tick()`` marks a step boundary; ``rate(window)`` is steps/sec over the
    last ``window`` steps. Call ``sync(x)`` with a live array before reading
    rates in async-dispatch code (blocks until the device caught up).
    """

    def __init__(self) -> None:
        self.times: List[float] = []

    def tick(self) -> None:
        self.times.append(time.perf_counter())

    @staticmethod
    def sync(x) -> None:
        """Block until the device has finished everything ``x`` depends
        on."""
        import jax

        jax.block_until_ready(x)

    def rate(self, window: int = 50) -> float:
        t = self.times[-window:]
        if len(t) < 2:
            return 0.0
        return (len(t) - 1) / (t[-1] - t[0])

    def total_seconds(self) -> float:
        if len(self.times) < 2:
            return 0.0
        return self.times[-1] - self.times[0]


def device_memory_stats() -> Dict[str, Optional[int]]:
    """{device: bytes_in_use} where the backend reports it (the GPU
    does; the CPU does not)."""
    import jax

    out: Dict[str, Optional[int]] = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
            out[str(d)] = stats.get("bytes_in_use") if stats else None
        except Exception:
            out[str(d)] = None
    return out


def enable_nan_debugging() -> None:
    """The analog of the reference's inline NaN scrubbing
    (`Hippocampus.py:314-315`) for debugging: makes any NaN produced under
    jit raise with the offending jaxpr (jax_debug_nans)."""
    import jax

    jax.config.update("jax_debug_nans", True)


class NotOnGpu(RuntimeError):
    """A measurement path found no GPU; it refuses rather than fall back."""


def require_gpu():
    """The first JAX device, if it is a GPU; else raise ``NotOnGpu``. JAX
    falls back to the CPU with only a warning when CUDA fails to start, so
    the platform is checked explicitly."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NotOnGpu(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({getattr(dev, 'device_kind', '?')})"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the cards, one line
    per card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``. Runs nvidia-smi as a
    child that never imports JAX; "not available" when it is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available (no nvidia-smi)"
    r = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip() or f"not available (rc={r.returncode})"
