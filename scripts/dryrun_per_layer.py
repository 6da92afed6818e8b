"""One layer's collectives in a cell of the port's dry run: the cell traced
at two depths (``repro_torch.launch.dryrun.run_mesh`` as rank 0 of a fake
world), the difference being one layer's.

    PYTHONPATH=src python scripts/dryrun_per_layer.py [--arch qwen3-1.7b] [--shape train_4k] [--mesh single] [--remat none]

Prints, for the layer, each (name, axes) of issued collectives with its
kind, calls and operand bytes, and the bytes in units of 4·B·S·d, where B·S is
the tokens the rank's step runs through the layer (its rows times the
sequence, all microbatches) and d the model width: a float32 activation
of the rank's tokens.  Needs neither a GPU nor JAX; qwen3-1.7b's
train_4k cell takes seconds at these depths.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun as D


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--remat", choices=["full", "none"], help="the config's unless given")
    args = ap.parse_args()
    cell = SHAPES[args.shape]
    multi = args.mesh == "multi"
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else ((16, 16),
                                                                           ("data", "model"))
    base = D.cell_config(args.arch, cell)
    if args.remat:
        base = dataclasses.replace(base, remat=args.remat)
    calls = []
    for depth in (1, 2):
        rec = D.run_mesh(dataclasses.replace(base, n_layers=depth), cell, shape, axes)
        calls.append({(c["op"], c["kind"], tuple(c["axes"])): (c["count"], c["bytes"])
                      for c in rec["roofline"]["coll_detail"]["calls"] if not c["skipped"]})
    rows = cell.global_batch // (shape[0] * (shape[1] if multi else 1))
    tokens = rows * (cell.seq_len if cell.kind != "decode" else 1)
    unit = 4 * tokens * base.d_model
    print(f"{args.arch} x {args.shape} x {args.mesh} (remat {base.remat}): one layer's "
          f"issued collectives (rank's tokens B·S = {tokens}, d = {base.d_model}, "
          f"4·B·S·d = {unit} bytes)")
    total = 0
    for key in sorted(set(calls[0]) | set(calls[1])):
        n0, b0 = calls[0].get(key, (0, 0))
        n1, b1 = calls[1].get(key, (0, 0))
        if (n1, b1) != (n0, b0):
            total += b1 - b0
            print(f"  {key[0]} ({key[1]}) over {'+'.join(key[2])}: {n1 - n0} calls, "
                  f"{b1 - b0} bytes = {(b1 - b0) / unit:.4f} x 4·B·S·d")
    print(f"  in all {total} bytes = {total / unit:.4f} x 4·B·S·d")


if __name__ == "__main__":
    main()
