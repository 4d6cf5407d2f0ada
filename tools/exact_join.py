"""Thin wrapper: the exact-join profiler moved into the package
(supernet_tpu.hlo_profile; `python -m supernet_tpu.cli profile` is the
front door). This keeps the historical

    python tools/exact_join.py <model> <batch> <trace_dir> [--by-layer]

invocation and the `from exact_join import ...` test imports working.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from supernet_tpu.hlo_profile import (  # noqa: E402,F401
    build_step,
    classify,
    join_events,
    layer_of,
    main,
    module_name,
    parse_hlo,
    run,
)

if __name__ == "__main__":
    raise SystemExit(main())
