"""The control of each cell's check: the plain reference put in the
program's place with each accumulated sum rounded to bfloat16
(``reference``'s ``precision="bf16"``), judged as a run judges the
program's answers.  The check has to call it wrong: it prints, for each
cell and seed, how many of the jobs a run would check come out wrong
(every job of the run's pool, each once).

    python3 vpbench/control.py --seeds 1 2 3 [--workload CELL ...]

It runs no kernel and needs no card; its numbers are what ``PERF.md``
sets each cell's limit from, beside the program's own readings."""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_wrong(config, traffic, seed):
    """(jobs checked, jobs the control gets wrong) for one seed."""
    kind = importlib.import_module(f"vpbench.kinds.{config['kind']}")
    jobs = kind.make_jobs(config, traffic, seed)
    want = kind.expected(jobs)
    got = kind.expected(jobs, "bf16")
    return len(jobs), sum(kind.differs(g, w) for g, w in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workload", nargs="*")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from vpbench import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        if args.workload and cell["name"] not in args.workload:
            continue
        _, _, config, traffic = harness.load_cell(ROOT, cell["name"])
        for seed in args.seeds:
            n, wrong = control_wrong(config, traffic, seed)
            print(json.dumps({"workload": cell["name"], "seed": seed, "checked": n,
                              "wrong": wrong}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
