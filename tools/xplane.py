"""Thin wrapper: the no-TF xplane decoder moved into the package
(supernet_tpu.xplane) so the profiling surface (cli profile,
supernet_tpu.profiling) can use it; this keeps the historical
``python tools/xplane.py <trace_dir>`` invocation working."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from supernet_tpu.xplane import (  # noqa: E402,F401
    Event,
    fields,
    is_gpu_device_plane,
    main,
    newest_xplane,
    op_buckets,
    parse_xspace,
)

if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
