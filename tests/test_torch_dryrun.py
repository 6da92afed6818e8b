"""The port's dry run (``repro_torch.launch.dryrun``) held to what it
stands for: smoke configs of three families (qwen3-1.7b dense,
llama4-scout MoE through ``ep_moe``, falcon-mamba-7b through the Mamba-1
scan) on (data, model) = (2, 2) at tp 2, for a prefill, a split-KV decode
(a batch of 4: its cache holds every row, as ``cache_specs`` keeps a batch
under 16, and its sequence over 'data'; each rank steps its rows), one
train step (two microbatches) and a decode of one sequence, stepped whole
on every rank.

- Against a real gloo world of 4 (``torch_parity.run_torch_world``): the
  dry run of rank 0 on fake tensors issues the collectives rank 0 really
  issues (kind, axes, count, bytes), counts the FLOPs and bytes
  ``roofline.from_step`` counts of the real call, and its argument,
  output and alias bytes are the real call's.  The decodes, in float32
  compute, give the single-device logits.
- Against the JAX package (``conftest.run_with_devices``, 4 fake devices,
  each cell jitted as its ``launch/dryrun.py`` jits one): argument bytes
  equal ``memory_analysis().argument_size_in_bytes`` less the decode
  step's int32 position (an argument of the reference's jitted step, a
  host int of the port's), the model FLOPs are equal, and the port's
  per-device FLOPs are within ``FLOP_TOL`` of ``hlo_cost``'s for prefill
  and decode (the train step's ratio is recorded, not held: the
  reference recomputes its forward under remat).
- The fake world is gone after a cell, also after one that raised; the
  artifact has the reference's keys.

The JAX side and the gloo world run as subprocesses, so no process group
lives in the test worker but the dry run's own, for as long as a cell.
"""
import json
import math

import pytest
import torch.distributed as dist

from conftest import run_with_devices
from torch_parity import run_torch_world, single_torch_thread

from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M

pytestmark = pytest.mark.usefixtures(single_torch_thread.__name__)

ARCHS = ("qwen3-1.7b", "llama4-scout-17b-a16e", "falcon-mamba-7b")
CELLS = {"prefill": ("prefill", 32, 16, "prefill", 1),
         "decode": ("decode", 64, 4, "decode", 1),
         "train": ("train", 32, 16, "train", 2),
         "long": ("long", 64, 1, "decode", 1)}
CASES = [(a, k) for a in ARCHS for k in ("prefill", "decode", "train")]
CASES += [("qwen3-1.7b", "long"), ("falcon-mamba-7b", "long")]
MESH = ((2, 2), ("data", "model"))
PARAMS = {"cases": CASES, "cells": CELLS}  # the subprocesses' cases
# The port's per-device FLOPs against hlo_cost's, prefill and decode: equal
# for the attention families; falcon-mamba-7b's are short by the Mamba-1
# scan's contraction with C (y_t = sum_n h_t c_t, 2 B S D N a layer), which
# the reference's HLO holds as a dot and the port counts as its kernel, an
# elementwise op of 0 FLOPs (ROADMAP F13): 3.39% at this prefill
# (0.966102), 2.22% at this decode.  With that contraction added back the
# two are held equal.

WORLD = '''
import dataclasses, json, os
import numpy as np
import torch
from repro_torch import tree as T
from repro_torch.analysis import roofline as RL
from repro_torch.common import DTypePolicy, named, shard
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D, mesh as M
from repro_torch.models.model import build, decode_layout

torch.set_num_threads(1)
CASES, CELLS = %(cases)r, %(cells)r
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
M.init_world(os.environ["INIT_METHOD"], rank, world, device="cpu")
mesh = M.make_test_mesh(2, 2, device="cpu")

def global_tree(sds, seed, vocab):
    rng = np.random.default_rng(seed)
    def leaf(sd):
        if sd.dtype.is_floating_point:
            x = torch.from_numpy(rng.standard_normal(sd.shape, dtype=np.float32) * 0.05)
            return x.to(sd.dtype)
        if sd.dtype == torch.int8:
            return torch.from_numpy(rng.integers(-8, 8, sd.shape).astype(np.int8))
        return torch.from_numpy(rng.integers(0, 16, sd.shape).astype(np.int32)).to(sd.dtype)
    return T.tree_map(leaf, sds)

out = {}
for arch, kind in CASES:
    cell = ShapeConfig(*CELLS[kind])
    cfg = D.cell_config(arch, cell, base=get_smoke_config(arch))
    step, arguments = D.cell_step(cfg, cell, mesh)
    glob = [global_tree(sds, i, cfg.vocab_size) for i, (sds, _) in enumerate(arguments)]
    place = lambda: [T.tree_map(lambda x, ps: shard(x, named(mesh, ps)), g, lay)
                     for g, (_, lay) in zip(glob, arguments)]
    args = place()
    nbytes = sum(x.nbytes for a in args for _, x in T.leaves(a))
    rl, memory, _ = RL.from_trace(step, *args, mesh=mesh)
    plain = RL.from_step(step, *place())
    got = {"flops": rl.flops, "bytes": rl.bytes_accessed, "calls": rl.coll_detail["calls"],
           "memory": memory, "nbytes": nbytes, "step_flops": plain.flops,
           "step_bytes": plain.bytes_accessed}
    if cell.kind == "decode" and cfg.family != "ssm":  # float32 compute
        m = build(cfg, tp=2)
        m.policy = DTypePolicy(params=cfg.params_dtype, compute=torch.float32)
        glob[1] = T.tree_map(lambda x: x.float(), glob[1])  # the cache in float32 too
        layout = decode_layout(m, mesh, cell.global_batch, cell.seq_len,
                               rows=cell.global_batch %% 2 == 0)  # as cell_step lays it out
        lg, _ = m.decode_step(*place(), 0, mesh=mesh, layout=layout)
        want, _ = m.decode_step(*glob, 0)
        n, v = lg.shape[0], lg.shape[-1]
        if n != want.shape[0]:  # the rank's rows
            want = want.narrow(0, M.axis_index(mesh, ("data",)) * n, n)
        want = want[..., M.axis_index(mesh, "model") * v:][..., :v]
        got["f32_logit_gap"] = float((lg.float() - want.float()).abs().max())
    out[f"{arch}/{kind}"] = got
if rank == 0:
    with open(os.path.join(os.environ["OUT"], "world.json"), "w") as f:
        json.dump(out, f)
'''

JAX = '''
import dataclasses, json
import jax, jax.numpy as jnp
from repro import compat
from repro.analysis import hlo_cost, roofline as RL
from repro.common import named, shape_dtypes, shardings
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.models.model import build, cache_specs, input_specs
from repro.train.optimizer import OptConfig
from repro.train.train_step import make_train_step, state_specs

CASES, CELLS = %(cases)r, %(cells)r
mesh = compat.make_mesh((2, 2), ("data", "model"))
pspec = lambda tree, sds: jax.tree.map(lambda ps, _: named(mesh, ps), tree, sds)
out = {}
for arch, kind in CASES:
    shape = ShapeConfig(*CELLS[kind])
    cfg = get_smoke_config(arch)
    if kind != "train":
        cfg = dataclasses.replace(cfg, params_dtype=jnp.bfloat16)
    model = build(cfg, tp=2)
    inputs, in_ps = input_specs(cfg, shape)
    in_shard = pspec(in_ps, inputs)
    with compat.set_mesh(mesh):  # as launch/dryrun.py's lower_cell
        if kind == "train":
            oc = OptConfig(moments_dtype=cfg.moments_dtype)
            sspecs = state_specs(model, oc)
            state_shard = shardings(sspecs, mesh)
            fn = jax.jit(make_train_step(model, oc, accum_steps=shape.accum_steps, mesh=mesh),
                         in_shardings=(state_shard, in_shard), out_shardings=(state_shard, None),
                         donate_argnums=(0,))
            lowered = fn.lower(shape_dtypes(sspecs), inputs)
        else:
            csds, cps = cache_specs(cfg, shape, tp=2)
            cache_shard = pspec(cps, csds)
            if kind == "prefill":
                fn = jax.jit(lambda p, b: model.prefill(p, b, mesh=mesh),
                             in_shardings=(shardings(model.specs, mesh), in_shard),
                             out_shardings=(cache_shard, None))
                lowered = fn.lower(shape_dtypes(model.specs), inputs)
            else:
                fn = jax.jit(lambda p, c, b, pos: model.decode_step(p, c, b, pos, mesh=mesh),
                             in_shardings=(shardings(model.specs, mesh), cache_shard, in_shard,
                                           None),
                             out_shardings=(None, cache_shard), donate_argnums=(1,))
                lowered = fn.lower(shape_dtypes(model.specs), csds, inputs,
                                   jax.ShapeDtypeStruct((), jnp.int32))
        compiled = lowered.compile()
    mem = compiled.memory_analysis()
    out[f"{arch}/{kind}"] = {"argument_bytes": mem.argument_size_in_bytes,
                             "flops": hlo_cost.analyze(compiled.as_text()).flops,
                             "model_flops": RL.model_flops(cfg, shape, kind)}
print("JAX " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def dry():
    """The dry run of every case in this process: {"arch/kind": record}."""
    out = {}
    for arch, kind in CASES:
        cell = ShapeConfig(*CELLS[kind])
        cfg = D.cell_config(arch, cell, base=get_smoke_config(arch))
        out[f"{arch}/{kind}"] = D.run_mesh(cfg, cell, *MESH, {"arch": arch, "shape": kind})
        assert not dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun_world")
    run_torch_world(WORLD % PARAMS, 4, work, timeout=300)
    return json.loads((work / "world.json").read_text())


@pytest.fixture(scope="module")
def jax_side():
    out = run_with_devices(JAX % PARAMS, n_devices=4, timeout=600)
    return json.loads(out.split("JAX ", 1)[1])


@pytest.mark.parametrize("case", [f"{a}/{k}" for a, k in CASES])
def test_collectives_match_a_real_world(dry, world, case):
    """Rank 0's collectives in the dry run (name, kind, axes, count,
    operand bytes; issued and skipped) are those it issues in a gloo world
    of 4."""
    assert dry[case]["roofline"]["coll_detail"]["calls"] == world[case]["calls"]
    assert any(not c["skipped"] for c in world[case]["calls"])


@pytest.mark.parametrize("case", [f"{a}/{k}" for a, k in CASES])
def test_flops_bytes_and_arguments_match_a_real_world(dry, world, case):
    """FLOPs and bytes accessed equal ``from_step`` of the real rank-0
    call; argument bytes equal the bytes of rank 0's real blocks, and the
    output and alias bytes the real call's.  The temp peak is not held
    here: it counts a storage until Python frees it, and gloo's objects
    keep tensors in reference cycles the fake backend's do not (phase 17
    holds it against the card's allocator)."""
    rl, w = dry[case]["roofline"], world[case]
    assert rl["flops_per_chip"] == w["step_flops"] == w["flops"] > 0
    assert rl["bytes_per_chip"] == w["step_bytes"] == w["bytes"] > 0
    mem, real = dry[case]["memory"], w["memory"]
    assert mem["peak_state_bytes_per_chip"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] == w["nbytes"] == real["argument_bytes"]
    assert (mem["output_bytes"], mem["alias_bytes"]) == (real["output_bytes"],
                                                         real["alias_bytes"])
    assert mem["temp_bytes"] > 0 and real["temp_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama4-scout-17b-a16e"])
def test_whole_batch_split_kv_decode_is_the_single_device_decode(world, arch):
    """A decode batch under 16, its cache holding every row
    (``cache_specs`` keeps the batch whole) and its sequence split over
    'data', each rank stepping its rows: in float32 compute the rank's
    logits block is the single-device decode's."""
    assert world[f"{arch}/decode"]["f32_logit_gap"] < 1e-5


def test_split_kv_decode_of_a_batch_whole_on_every_rank(world):
    """A batch of one sequence, which the batch axes do not divide, stepped
    whole on every rank (the decode layout's "batch" entry says so): in
    float32 compute the rank's logits block is the single-device
    decode's."""
    assert world["qwen3-1.7b/long"]["f32_logit_gap"] < 1e-5


def _held_apart(arch, kind):
    """Bytes the reference's step holds beyond the port's: its int32
    position (a decode step's argument there, a host int here; XLA prunes
    it from a step that does not read it), and where
    the port serves each rank its rows of a batch ``input_specs`` keeps
    whole (here the decode batch of 4), the rest of those rows: the
    inputs' and, as an ssm state is held as the rank's rows, the state's
    (each leaf's block under the reference's pspec less its block under
    the port's): ROADMAP F12."""
    from repro_torch.models.model import cache_specs, input_specs
    from torch_parity import StandInMesh

    cell = ShapeConfig(*CELLS[kind])
    if cell.kind == "train":
        return 0
    cfg = D.cell_config(arch, cell, base=get_smoke_config(arch))
    mesh = StandInMesh(*MESH)
    _, arguments = D.cell_step(cfg, cell, mesh)
    ref = [input_specs(cfg, cell)]
    if cell.kind == "decode":
        ref.insert(0, (arguments[1][0], cache_specs(cfg, cell, tp=2)[1]))
    port = arguments[-len(ref):]
    size = lambda sd, ps: math.prod(D.block_shape(sd.shape, ps, mesh)) * sd.dtype.itemsize
    apart = 4 if cell.kind == "decode" and cfg.family != "ssm" else 0  # Mamba reads no pos
    for (sds, ref_ps), (_, port_ps) in zip(ref, port):
        for (path, sd), (_, a), (_, b) in zip(T.leaves(sds), T.leaves(ref_ps),
                                             T.leaves(port_ps)):
            apart += size(sd, a) - size(sd, b)
    return apart


@pytest.mark.parametrize("case", [f"{a}/{k}" for a, k in CASES])
def test_argument_bytes_match_the_jax_package(dry, jax_side, case):
    """The per-device argument bytes of the reference's jitted step, less
    what it holds apart (``_held_apart``)."""
    apart = _held_apart(*case.split("/"))
    assert dry[case]["memory"]["argument_bytes"] == jax_side[case]["argument_bytes"] - apart
    if case.endswith("/decode"):
        assert apart > 4  # the batch of 4 is split here, whole there


@pytest.mark.parametrize("case", [f"{a}/{k}" for a, k in CASES])
def test_model_flops_match_the_jax_package(dry, jax_side, case):
    rec = dry[case]
    assert rec["model_flops_global"] == jax_side[case]["model_flops"]
    assert rec["model_flops_per_chip"] == jax_side[case]["model_flops"] / 4
    assert rec["chips"] == 4


def _scan_contraction(arch, kind):
    """The FLOPs of the Mamba-1 scan's contraction with C on one rank:
    2 B S D N a layer (its rows, its channels over 'model')."""
    cfg = get_smoke_config(arch)
    if cfg.family != "ssm":
        return 0
    _, seq, batch, _, _ = CELLS[kind]
    rows = batch // MESH[0][0] if batch % MESH[0][0] == 0 else batch
    d_inner = cfg.ssm.expand * cfg.d_model // MESH[0][1]
    return 2 * rows * (1 if CELLS[kind][3] == "decode" else seq) * d_inner * cfg.ssm.d_state * \
        cfg.n_layers


@pytest.mark.parametrize("case", [f"{a}/{k}" for a, k in CASES])
def test_flops_match_hlo_cost(dry, jax_side, case, record_property):
    """Per-device FLOPs against ``hlo_cost.analyze`` of the compiled step:
    for prefill and decode equal once the scan's contraction is added (the
    comment at the top), the train step's ratio recorded."""
    port, ref = dry[case]["roofline"]["flops_per_chip"], jax_side[case]["flops"]
    record_property("port_over_hlo_cost", port / ref)
    print(f"{case}: port {port:.6g} FLOPs, hlo_cost {ref:.6g}, ratio {port / ref:.6f}")
    if not case.endswith("/train"):
        assert port + _scan_contraction(*case.split("/")) == ref


def test_fake_world_is_gone_after_a_cell_that_raised():
    """A batch of 17 rows cannot be split over 'data': the cell raises as
    ``common.shard`` would, and the world and its groups are gone; the
    next cell starts a new one."""
    cfg = D.cell_config("qwen3-1.7b", ShapeConfig(*CELLS["prefill"]),
                        base=get_smoke_config("qwen3-1.7b"))
    with pytest.raises(ValueError, match="divisible by 2"):
        D.run_mesh(cfg, ShapeConfig("prefill", 32, 17, "prefill"), *MESH)
    assert not dist.is_initialized() and not M._GROUPS
    rec = D.run_mesh(cfg, ShapeConfig("prefill", 16, 16, "prefill"), *MESH)
    assert rec["ok"] and not dist.is_initialized() and not M._GROUPS


def test_fake_world_refuses_an_existing_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            with D.fake_world(4):
                pass
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_artifact_has_the_reference_keys(tmp_path, monkeypatch):
    """``main`` writes a cell's record and the skipped cells with the
    reference's keys (``trace_s`` for ``lower_s``/``compile_s``), on a
    smoke config in place of the arch's full one."""
    monkeypatch.setattr(D, "ART_DIR", tmp_path)
    real = D.cell_config
    monkeypatch.setattr(D, "cell_config", lambda arch, shape, opt=False: real(
        arch, shape, opt, base=get_smoke_config(arch)))
    D.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--mesh", "single"])
    rec = json.loads(D.artifact_path("qwen3-1.7b", "decode_32k", "single").read_text())
    assert set(rec) == {"arch", "shape", "mesh", "chips", "ok", "trace_s", "memory",
                        "roofline", "model_flops_global", "model_flops_per_chip",
                        "useful_flop_ratio"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "peak_state_bytes_per_chip"}
    assert set(rec["roofline"]) == {"flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
                                    "t_compute_s", "t_memory_s", "t_collective_s",
                                    "bottleneck", "coll_detail"}
    assert rec["ok"] and rec["chips"] == 256 and rec["mesh"] == "single"
    assert {"by_kind", "by_axes"} <= set(rec["roofline"]["coll_detail"])
    skipped = json.loads(D.artifact_path("granite-34b", "long_500k", "skip").read_text())
    assert skipped["ok"] and "quadratic" in skipped["skipped"]
    assert not dist.is_initialized()


def test_link_bandwidth_and_the_collective_term():
    """A group within one 8-GPU node runs at NVLink's rate, any other at
    InfiniBand's; the collective term sums each group's bytes over its
    link, beside the two one-card terms."""
    from repro_torch.analysis import roofline as RL

    assert RL.link_bw(range(8)) == RL.NVLINK_BW == 450e9
    assert RL.link_bw([8, 15]) == RL.NVLINK_BW
    assert RL.link_bw([0, 8]) == RL.link_bw(range(0, 256, 16)) == RL.IB_BW == 50e9
    r = RL.MeshRoofline(flops=989e12, bytes_accessed=3.35e12,
                        coll_by_axes={"model": 100e9, "data": 450e9},
                        bw_by_axes={"model": RL.IB_BW, "data": RL.NVLINK_BW})
    assert r.coll_bytes == 550e9 and abs(r.t_collective - 3.0) < 1e-12
    assert r.bottleneck == "collective" and abs(r.t_bound - 3.0) < 1e-12
    assert set(r.to_dict()) == set(RL.Roofline(1.0, 1.0).to_dict())


def test_live_bytes_peak_beyond_the_arguments():
    """Each new storage counted once (a view adds nothing) and subtracted
    when freed; the arguments' storages never; in-place outputs alias
    them."""
    import torch

    from repro_torch.analysis.comm_cost import LiveBytes

    x = torch.zeros(256)  # 1 KiB argument

    def step(x):
        a = x * 2  # +1 KiB
        b = a.view(16, 16)  # a view: nothing
        c = torch.ones(512)  # +2 KiB: peak 3 KiB
        del a, b, c
        d = torch.ones(128)  # 0.5 KiB after the frees
        x.add_(1)
        return x, d

    live = LiveBytes((x,))
    with live:
        out = step(x)
    assert live.argument_bytes == 1024 and live.peak == 3072 and live.live == 512
    assert live.output_bytes(out) == (1024 + 512, 1024)


@pytest.mark.parametrize("seq,chunk,heads_major", [(64, 16, False), (48, 16, False),
                                                   (16, 512, False), (96, 16, True)])
def test_flash_prefill_op_is_the_loop(seq, chunk, heads_major):
    """The chunked prefill attention's custom op returns the loop's output
    bit for bit, at its strides; its FLOP formula counts what
    ``FlopCounterMode`` counts of the loop and its byte formula what
    ``roofline``'s byte counter counts of it (1, 3, 4 and 6 query chunks;
    q, k, v contiguous or (B, H, S, Dh) transposed); under fake tensors it
    is one op of the same shape and strides."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import roofline as RL
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(seq)
    shape = (2, 4, seq, 8) if heads_major else (2, seq, 4, 8)
    q, k, v = (torch.randn(shape, generator=g).bfloat16() for _ in range(3))
    if heads_major:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    c = min(chunk, seq)
    want = L._flash_fwd_core(q, k, v, c, c)[0].transpose(1, 2).to(q.dtype)
    loop = RL.from_step(L._flash_prefill_run, q, k, v, c, c)
    op = RL.from_step(L.flash_prefill_attention, q, k, v, chunk_q=chunk, chunk_k=chunk)
    assert op.coll_detail["aten_ops"] == 1 < loop.coll_detail["aten_ops"]
    assert op.flops == loop.flops > 0
    assert op.bytes_accessed == loop.bytes_accessed > 0
    with RL._ByteCounter():  # a mode on: through the op
        got = L.flash_prefill_attention(q, k, v, chunk_q=chunk, chunk_k=chunk)
    assert torch.equal(got, want) and got.stride() == want.stride()
    with FakeTensorMode() as mode:
        fake = L.flash_prefill_attention(*(mode.from_tensor(t) for t in (q, k, v)),
                                         chunk_q=chunk, chunk_k=chunk)
    assert fake.shape == want.shape and fake.stride() == want.stride()


def test_custom_ops_are_off_the_main_path(monkeypatch):
    """With no dispatch mode on, the scan, its backward and the prefill
    attention run their code directly, as the main paths call them: their
    custom ops, made to raise, are not reached, and the results are those
    the ops give under a mode."""
    import torch

    from repro_torch.analysis import roofline as RL
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(5)
    b, s, d, n = 2, 24, 8, 4
    args = (torch.rand(b, s, d, generator=g) * 0.1, torch.randn(b, s, d, generator=g),
            torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g),
            -torch.rand(d, n, generator=g), None, torch.randn(d, generator=g))
    dy = torch.randn(b, s, d, generator=g)
    q, k, v = (torch.randn(1, 32, 2, 8, generator=g) for _ in range(3))
    calls = lambda: (ops.selective_scan_fused(*args, chunk=8),
                     ops.selective_scan_fused_bwd(*args, dy, None, chunk=8),
                     L.flash_prefill_attention(q, k, v, chunk_q=16, chunk_k=16))
    with RL._ByteCounter() as moved:
        want = calls()
    assert moved.ops == 3

    def refuse(*a, **kw):
        raise AssertionError("a custom op reached with no dispatch mode on")

    for mod, name in ((ops, "_fused_op"), (ops, "_fused_bwd_op"), (L, "_flash_prefill")):
        monkeypatch.setattr(mod, name, refuse)
    got = calls()
    flat = lambda t: [x for part in t for x in (part if isinstance(part, tuple) else (part,))]
    assert len(flat(got)) == len(flat(want)) == 10
    for x, y in zip(flat(got), flat(want)):
        assert (x is None and y is None) or torch.equal(x, y)


def test_collectives_are_counted_once_by_name_and_mesh_ordered_axes():
    """``launch.mesh`` notes each collective in the open counters under its
    name and its axes in the mesh's order, however the caller orders them;
    over axes of size 1 it is skipped and moves no bytes."""
    import torch

    from repro_torch.analysis.comm_cost import CollectiveCounter
    from torch_parity import StandInMesh

    mesh = StandInMesh((1, 1), ("data", "model"))
    x = torch.ones(8)
    with CollectiveCounter() as c:
        M.psum(x, mesh, ("model", "data"))
        M.all_reduce(x, mesh, ("data", "model"))
        M.pmax(x, mesh, "model")
        M.argmax(x[None], mesh, "model", 0)
    assert c.records() == [
        {"op": "all_reduce", "kind": "all-reduce", "axes": ["data", "model"], "skipped": True,
         "count": 2, "bytes": 0},
        {"op": "all_reduce_max", "kind": "all-reduce", "axes": ["model"], "skipped": True,
         "count": 1, "bytes": 0},
        {"op": "argmax", "kind": "all-gather", "axes": ["model"], "skipped": True,
         "count": 1, "bytes": 0}]
    assert c.counts(skipped=True) == {"all-reduce over data+model": 2,
                                      "all-reduce over model": 1, "all-gather over model": 1}
    assert not c.bytes_by("axes") and not M._TALLIES


def test_scan_is_one_op_of_its_inputs_and_outputs():
    """The Mamba-1 scan and its backward reach the dispatcher as one op
    each: 0 FLOPs, each input read and each output written once; under
    fake tensors they give the outputs' shapes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import roofline as RL
    from repro_torch.kernels.ssm_scan import ops

    g = torch.Generator().manual_seed(3)
    b, s, d, n = 2, 40, 8, 4
    dt = torch.rand(b, s, d, generator=g) * 0.1
    x = torch.randn(b, s, d, generator=g)
    bc = torch.randn(b, s, 2 * n, generator=g)
    a, h0, skip = -torch.rand(d, n, generator=g), torch.randn(b, d, n, generator=g), \
        torch.randn(d, generator=g)
    args = (dt, x, bc[..., :n], bc[..., n:], a, h0, skip)
    r = RL.from_step(ops.selective_scan_fused, *args, chunk=16)
    inputs = sum(t.numel() for t in args) * 4
    assert r.flops == 0 and r.coll_detail["aten_ops"] == 1
    assert r.bytes_accessed == inputs + (b * s * d + b * d * n) * 4
    dy = torch.randn(b, s, d, generator=g)
    r = RL.from_step(ops.selective_scan_fused_bwd, *args, dy, None, chunk=16)
    assert r.coll_detail["aten_ops"] == 1
    with FakeTensorMode() as mode:
        y, h = ops.selective_scan_fused(*(mode.from_tensor(t) for t in args), chunk=16)
        grads = ops.selective_scan_fused_bwd(*(mode.from_tensor(t) for t in args),
                                             mode.from_tensor(dy), None, chunk=16)
    assert (tuple(y.shape), tuple(h.shape)) == ((b, s, d), (b, d, n))
    assert [tuple(t.shape) for t in grads] == [(b, s, d), (b, s, d), (b, s, n), (b, s, n),
                                              (d, n), (b, d, n), (d,)]
