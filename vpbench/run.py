"""Run one cell of the port's benchmark once, on the card this machine holds.

    python3 vpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell's jobs from the seed, warms
up every shape the cell uses, drives ``repro_torch``'s entry point for
``--seconds`` (the window closes at the first job finished after that),
checks the finished jobs against the benchmark's plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics read from a profiled stretch after the
window), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each number compared beside its limit (also the last lines on standard
error).  Without a CUDA card, or with fewer cards than the cell asks for,
it exits 2 and prints no result.  Build caches stay inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "vpbench_cache"  # fixed, inside the checkout


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from vpbench import harness

    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"vpbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    for name, c in out["checks"].items():
        limit = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"check {name} {c['value']} {limit}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
