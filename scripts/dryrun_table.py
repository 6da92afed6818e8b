"""The dry run's sweep as a markdown table: one row per (arch, shape) cell,
each figure given for the (16, 16) and the (2, 16, 16) mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 7]
    python scripts/dryrun_table.py [--tag baseline]

Reads ``artifacts/dryrun_torch/<tag>/``.  Per device: arguments and temp
(the live bytes' peak beyond them) in GiB, TFLOP, the issued collectives'
operand bytes in GiB by axes (groups under 0.05 GiB left out), the three
roofline terms in ms (H100 SXM peaks at 700 W, NVLink within a node,
InfiniBand across: ``analysis/roofline.py``) and the bottleneck.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

ART = Path(__file__).resolve().parents[1] / "artifacts" / "dryrun_torch"
GIB = 2**30


def cell(rec):
    m, r = rec["memory"], rec["roofline"]
    axes = ", ".join(f"{a} {b / GIB:.1f}" for a, b in sorted(
        r["coll_detail"]["by_axes"].items(), key=lambda kv: -kv[1]) if b >= 0.05 * GIB)
    return (f"{m['argument_bytes'] / GIB:.2f} / {m['temp_bytes'] / GIB:.2f}",
            f"{r['flops_per_chip'] / 1e12:.2f}", axes or "-",
            f"{1e3 * r['t_compute_s']:.1f} / {1e3 * r['t_memory_s']:.1f} / "
            f"{1e3 * r['t_collective_s']:.1f}", r["bottleneck"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args()
    recs = {}
    for path in sorted((ART / args.tag).glob("*.json")):
        rec = json.loads(path.read_text())
        if "skipped" not in rec:
            recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    print("| Cell | Args / temp GiB | TFLOP | Collective GiB by axes | Compute / memory / "
          "collective ms | Bottleneck |")
    print("| --- | --- | --- | --- | --- | --- |")
    for arch, shape in sorted({k[:2] for k in recs}, key=lambda k: (k[0], k[1])):
        one, two = (cell(recs[(arch, shape, mk)]) if recs[(arch, shape, mk)]["ok"]
                    else ("failed",) * 5 for mk in ("single", "multi"))
        print(f"| {arch} x {shape} | " + " | ".join(
            a if a == b else f"{a} ; {b}" for a, b in zip(one, two)) + " |")


if __name__ == "__main__":
    main()
