"""Run one cell of the benchmark of velocity_tpu_torch once, on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Renders the cell's clip pool on the card, warms the program up at the
cell's shapes, drives it for ``--seconds`` in a closed loop with one client
through the pool in an order drawn from the seed, judges every clip against
the plain reference, and prints one JSON line as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace
0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from the window's clips and two more clips traced after it),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which also end standard error. Exits non-zero, printing no result, without a card, or
where JAX or the JAX package was loaded.

Build and kernel caches stay under ``build/`` in the checkout.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    wl = harness.cell(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
