"""Multi-pod dry run: every (arch x shape x mesh) cell traced as one rank of
a fake world (counterpart of ``repro/launch/dryrun.py``).

The reference lowers each cell's step onto 512 placeholder devices and
reads the compiled module's memory, cost and collectives.  The port's steps
are explicit SPMD, so the dry run runs the port's own step, as one rank
runs it, on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage) that hold rank 0's blocks, in a ``torch.distributed`` world of 256
or 512 ranks on the ``fake`` backend (no peer exists; a collective returns
at once) laid out by ``launch.mesh.make_production_mesh``.  Rank 0 stands
for every rank: ``common.shard`` splits every dim evenly or refuses, so
every rank holds blocks of the same shapes and issues the same ops.  The
steps are the ones the gloo and NCCL worlds run:

- train: ``make_train_step(model, oc, accum_steps, mesh=)`` on the state in
  ``state_shardings``' layout;
- prefill: ``Model.prefill(mesh=)``, its cache then laid out as
  ``cache_specs`` lays it out (``serve_step._pad_seq``);
- decode: ``Model.decode_step(layout=decode_layout(...))`` on a cache in
  that layout, writing position 0 (rank 0's block of a split sequence, so
  the traced rank is one that writes).

Each step is counted by ``analysis.roofline.from_trace``: FLOPs, bytes
accessed, the collectives' operand bytes by kind and by axes, the
arguments' bytes and the peak of the live bytes beyond them.  The record
has the reference's keys, with ``trace_s`` in place of ``lower_s`` and
``compile_s``.  It needs neither a GPU nor JAX.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all    # every cell, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 7   # 7 cells at once
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as T
from repro_torch.analysis import roofline as RL
from repro_torch.common import P, ShapeDtype, filter_pspec, named
from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, get_config, skipped_cells
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as M

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


class fake_world:
    """A ``torch.distributed`` world of ``world_size`` ranks on the ``fake``
    backend, this process rank 0, for as long as it is open.  Refuses to
    start where a process group exists; destroys the world (and the mesh
    groups made in it) on every exit, errors included."""

    def __init__(self, world_size: int):
        self.world_size = world_size

    def __enter__(self):
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("dry run: a process group already exists in this process")
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=self.world_size)
        return self

    def __exit__(self, *exc):
        M._GROUPS.clear()
        dist.destroy_process_group()


def cell_config(arch: str, shape: ShapeConfig, opt: bool = False,
                base: ModelConfig | None = None) -> ModelConfig:
    """The reference's changes to a cell's config (``base``, or the arch's
    full config): bf16 weights for serving cells; with ``opt``, bf16 norms
    and flash train attention."""
    cfg = get_config(arch) if base is None else base
    if shape.kind in ("prefill", "decode"):
        cfg = dataclasses.replace(cfg, params_dtype=torch.bfloat16)
    if opt:
        over = {"fast_norm": True}
        if cfg.n_heads:
            over["attn_impl"] = "flash"
        cfg = dataclasses.replace(cfg, **over)
    return cfg


def block_shape(shape, pspec, mesh) -> tuple[int, ...]:
    """This rank's block of a global ``shape`` under ``pspec`` over ``mesh``.
    Raises where a dim does not divide, as ``common.shard`` does."""
    from repro_torch.common import _dims, check_divisible

    sh = named(mesh, pspec)
    check_divisible(tuple(shape), sh)
    out = list(shape)
    for dim, axes in _dims(len(out), sh.spec):
        out[dim] //= M.axis_size(mesh, axes)
    return tuple(out)


def _sds(specs):
    """A spec tree's leaves as ``ShapeDtype``."""
    from repro_torch.common import spec_map

    return spec_map(lambda s: ShapeDtype(tuple(s.shape), s.dtype), specs)


def cell_step(cfg: ModelConfig, cell: ShapeConfig, mesh):
    """(step, arguments): the function a rank of ``mesh`` runs for ``cell``'s
    step of ``cfg`` (built at tp = the mesh's 'model' size), and for each of
    its positional arguments a (``ShapeDtype`` tree, pspec tree) pair: the
    global shapes and the layout the rank holds its blocks in.

    The inputs are ``input_specs``', laid out as the port holds them: a
    serving batch as each rank's rows over the batch axes wherever they
    divide it (``greedy_generate(mesh=)``; ``input_specs`` keeps a batch
    under 16 whole), else whole on every rank (long_500k's single
    sequence); a decode cache in ``decode_layout``'s layout, an ssm state
    as the rank's rows where the batch is split (ROADMAP F12); serving
    weights in ``run_pspecs``' layout, FSDP's 'data' split gathered (F14)."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import (attn_cache_keys, build, cache_specs, decode_layout,
                                          input_specs, run_pspecs)
    from repro_torch.serve.serve_step import _pad_seq
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    tp = M.axis_size(mesh, "model")
    model = build(cfg, tp=tp)
    inputs, in_ps = input_specs(cfg, cell)
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        oc = OptConfig(moments_dtype=cfg.moments_dtype)
        held = T.tree_map(lambda sh: sh.spec, TS.state_shardings(model, oc, mesh))
        step = TS.make_train_step(model, oc, accum_steps=cell.accum_steps, mesh=mesh)
        return step, [(_sds(TS.state_specs(model, oc)), held), (inputs, in_ps)]
    params = (_sds(model.specs), run_pspecs(model, mesh))
    rows = L.row_axes(mesh)
    by_rows = b % M.axis_size(mesh, rows) == 0
    if by_rows:  # the port serves each rank its rows, a batch under 16 too
        in_ps = {k: P(None, rows) if k == "mrope_pos" else P(rows) for k in inputs}
    if cell.kind == "prefill":
        length = inputs["tokens"].shape[1]
        frames = inputs["enc_feats"].shape[1] if "enc_feats" in inputs else None
        layout = decode_layout(model, mesh, b, length, cross_length=frames, rows=by_rows)

        def prefill(params, batch):
            cache, lg = model.prefill(params, batch, mesh=mesh)
            return _pad_seq(cfg, cache, length, batch["tokens"].shape[0], None, mesh=mesh,
                            layout=layout), lg

        return prefill, [params, (inputs, in_ps)]
    layout = decode_layout(model, mesh, b, s, rows=by_rows)
    csds, _ = cache_specs(cfg, cell, tp=tp)
    if cfg.family == "encdec":  # decode_layout's cross memory: the config's frames
        csds["cross"] = cache_specs(cfg, ShapeConfig("x", cfg.n_audio_frames, b, "decode"),
                                    tp=tp)[0]["cross"]
    held = {k: ps for k, ps in layout.items() if k != "batch"}  # the cache's leaves
    if by_rows:  # an ssm state is the rank's rows, as its prefill leaves it
        _, wide = cache_specs(cfg, ShapeConfig("x", s, 16 * b, "decode"), tp=tp)
        attn = {"/".join(("",) + keys) for keys in attn_cache_keys(cfg)}
        wide = dict(T.leaves(wide))
        held = T.map_with_path(lambda path, ps: ps if any(path.startswith(a + "/") for a in attn)
                               else filter_pspec(wide[path], mesh), held)

    def decode(params, cache, batch):
        return model.decode_step(params, cache, batch, 0, mesh=mesh, layout=layout)

    return decode, [params, (csds, held), (inputs, in_ps)]


def trace_step(cfg: ModelConfig, cell: ShapeConfig, mesh):
    """Run ``cell``'s step of ``cfg`` as this rank of ``mesh`` on fake
    tensors of its blocks (``cell_step``), counted by
    ``roofline.from_trace``: returns (``MeshRoofline``, memory)."""
    step, arguments = cell_step(cfg, cell, mesh)
    with FakeTensorMode():
        args = [T.tree_map(lambda sd, ps: torch.empty(block_shape(sd.shape, ps, mesh),
                                                      dtype=sd.dtype), sds, lay)
                for sds, lay in arguments]
        rl, memory, _ = RL.from_trace(step, *args, mesh=mesh)
    return rl, memory


def trace_cell(arch: str, shape_name: str, mesh, opt: bool = False):
    """One cell's step traced over ``mesh`` (the counterpart of the
    reference's ``lower_cell``): (``MeshRoofline``, memory)."""
    shape = SHAPES[shape_name]
    return trace_step(cell_config(arch, shape, opt), shape, mesh)


def record(cfg, cell, mesh, keys=None) -> dict:
    """``cell``'s step of ``cfg`` traced over ``mesh``, as a record with the
    reference's artifact keys (``keys`` first)."""
    t0 = time.perf_counter()
    rl, memory = trace_step(cfg, cell, mesh)
    trace_s = time.perf_counter() - t0
    chips = M.chips(mesh)
    mf = RL.model_flops(cfg, cell, cell.kind)
    return {
        **(keys or {}),
        "chips": chips,
        "ok": True,
        "trace_s": round(trace_s, 2),
        "memory": {**memory,
                   "peak_state_bytes_per_chip": memory["argument_bytes"] + memory["temp_bytes"]},
        "roofline": rl.to_dict(),
        "model_flops_global": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flop_ratio": (mf / chips) / max(rl.flops, 1.0),
    }


def run_mesh(cfg, cell: ShapeConfig, mesh_shape, axes, keys=None) -> dict:
    """``cell``'s step of ``cfg`` traced as rank 0 of a fake world of the
    mesh ``mesh_shape`` (axes ``axes``), as a record."""
    import math

    with fake_world(math.prod(mesh_shape)):
        return record(cfg, cell, M.make_mesh(mesh_shape, axes, device="cpu"), keys)


def run_cell(arch: str, shape_name: str, mesh_kind: str, verbose: bool = True,
             opt: bool = False) -> dict:
    """One cell on a production mesh ("single": (16, 16), "multi": (2, 16,
    16)) as rank 0 of a fake world of 256 or 512: its record."""
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        rec = record(cell_config(arch, shape, opt), shape,
                     M.make_production_mesh(multi_pod=multi, device="cpu"),
                     {"arch": arch, "shape": shape_name, "mesh": mesh_kind})
    if verbose:
        mem, rl = rec["memory"], rec["roofline"]
        print(f"[{arch} x {shape_name} x {mesh_kind}] trace {rec['trace_s']:.1f}s  "
              f"args/chip {mem['argument_bytes'] / 2**30:.2f} GiB  "
              f"temp/chip {mem['temp_bytes'] / 2**30:.2f} GiB  "
              f"bottleneck {rl['bottleneck']}  "
              f"t={1e3 * max(rl['t_compute_s'], rl['t_memory_s'], rl['t_collective_s']):.2f} ms"
              f"  useful-flop-ratio {rec['useful_flop_ratio']:.2f}", flush=True)
    return rec


def _sweep_cell(cell) -> bool:
    """Trace one cell of a sweep and write its record (``ok: false`` with
    its error where it raised); True where it traced."""
    arch, shape_name, mesh_kind, opt, path = cell
    try:
        rec = run_cell(arch, shape_name, mesh_kind, opt=opt)
    except Exception as e:  # record the failure; the sweep continues
        traceback.print_exc()
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "ok": False,
               "error": repr(e)[:2000]}
    Path(path).write_text(json.dumps(rec, indent=1))
    return rec["ok"]


def artifact_path(arch, shape_name, mesh_kind, tag="baseline"):
    return ART_DIR / tag / f"{arch}__{shape_name}__{mesh_kind}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true", help="sweep all cells x meshes")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--opt", action="store_true", help="bf16 norms and flash train attention")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced at once, a process each")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s, mk) for a, s in all_cells() for mk in ("single", "multi")]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape, args.mesh)]

    t_start = time.perf_counter()
    cells = []
    for a, s, mk in todo:
        path = artifact_path(a, s, mk, args.tag)
        if path.exists() and not args.force:
            print(f"[skip cached] {a} x {s} x {mk}")
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            cells.append((a, s, mk, args.opt, str(path)))
    if args.jobs > 1:  # each worker process its own fake world, a cell at a time
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        cells.sort(key=lambda c: c[1] != "train_4k")  # the longest traces first
        with ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn")) as pool:
            oks = list(pool.map(_sweep_cell, cells))
    else:
        oks = [_sweep_cell(c) for c in cells]
    failures = [c[:3] for c, ok in zip(cells, oks) if not ok]
    for a, s, reason in skipped_cells():
        path = artifact_path(a, s, "skip", args.tag)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"arch": a, "shape": s, "ok": True, "skipped": reason}))
    print(f"dry run: {len(cells)} cells traced in {time.perf_counter() - t_start:.1f} s "
          f"({args.jobs} process{'es' if args.jobs > 1 else ''})")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
