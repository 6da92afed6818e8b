"""The port's RISC-V ISS, memory timing model, assembler and dense workloads
against the JAX package, bit for bit: known encodings, hypothesis-drawn
instruction words and register files through decode/execute/writeback,
cache and DRAM timing, and the benchmark programs and images word for
word."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import segmentation as jsg
from repro.vp import assembler as jasm
from repro.vp import isa as jisa
from repro.vp import memory as jmem
from repro.vp import riscv as jriscv
from repro.vp import workloads as jwl
from repro_torch.core import segmentation as sg
from repro_torch.vp import assembler, isa, memory, riscv
from repro_torch.vp import workloads as wl

OPCODES = [jisa.OP_LUI, jisa.OP_AUIPC, jisa.OP_JAL, jisa.OP_JALR, jisa.OP_BRANCH,
           jisa.OP_LOAD, jisa.OP_STORE, jisa.OP_IMM, jisa.OP_REG]


def test_isa_constants_match_jax():
    names = [n for n in dir(jisa) if n.isupper()]
    assert names and all(getattr(isa, n) == getattr(jisa, n) for n in names)
    assert isa.pack_spike(300, 17) == jisa.pack_spike(300, 17)
    assert isa.pack_mode(1, 40, 3, 2) == jisa.pack_mode(1, 40, 3, 2)
    for name in ("zero", "ra", "sp", "t0", "t6", "s0", "s11", "a7"):
        assert isa.reg(name) == jisa.reg(name)


def test_encodings_known_words():
    # the riscv-tests reference encodings of tests/test_riscv.py
    assert assembler.assemble("addi t0, zero, 5")[0] == 0x00500293
    assert assembler.assemble("add t1, t0, t0")[0] == 0x00528333
    assert assembler.assemble("mul t1, t0, t0")[0] == 0x02528333
    assert assembler.assemble("lw t0, 8(sp)")[0] == 0x00812283
    assert assembler.assemble("sw t0, 12(sp)")[0] == 0x00512623
    words = dict(imm=(2047, -2048, 0x7FF, -1), big=(0x40002000, -12345678, 1 << 31))
    for imm in words["imm"]:
        for enc in ("enc_i", "enc_s", "enc_b", "enc_j"):
            args = (0b0010011, 5, 0, 6, imm) if enc == "enc_i" else (
                (0b0100011, 2, 6, 7, imm) if enc in ("enc_s", "enc_b") else (0b1101111, 1, imm))
            assert getattr(isa, enc)(*args) == getattr(jisa, enc)(*args)
    for imm in words["big"]:
        assert isa.enc_u(0b0110111, 5, imm) == jisa.enc_u(0b0110111, 5, imm)


def _cpu(regs, pc, halted, waiting, instret):
    return {"present": np.ones(len(pc), bool), "pc": pc, "regs": regs,
            "halted": halted, "waiting": waiting, "instret": instret}


def _draw(seed, n):
    """Instruction words (half with a valid opcode) and register files."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ops = np.asarray(OPCODES, np.uint32)[rng.integers(0, len(OPCODES), n)]
    valid = rng.random(n) < 0.5
    words = np.where(valid, (words & ~np.uint32(0x7F)) | ops, words).astype(np.uint32)
    regs = rng.integers(-2**31, 2**31, (n, 32), dtype=np.int64).astype(np.int32)
    regs[rng.random(n) < 0.5, 0] = 0  # x0 is 0 in every state the VP makes
    pc = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    cpu = _cpu(regs, pc, rng.random(n) < 0.1, rng.random(n) < 0.1,
               rng.integers(0, 2**31, n).astype(np.int32))
    return words, cpu


def _assert_dict_equal(want, got, what):
    assert sorted(want) == sorted(got), what
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert w.dtype == g.dtype, (what, k, w.dtype, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_decode_execute_match_jax(seed):
    words, cpu = _draw(seed, 256)
    jcpu = jax.tree.map(jnp.asarray, cpu)
    tcpu = {k: torch.from_numpy(v) for k, v in cpu.items()}
    _assert_dict_equal(jax.vmap(jriscv.decode)(jnp.asarray(words)),
                       riscv.decode(torch.from_numpy(words)), "decode")
    want_cpu, want_mem = jax.vmap(jriscv.execute)(jcpu, jnp.asarray(words))
    got_cpu, got_mem = riscv.execute(tcpu, torch.from_numpy(words))
    _assert_dict_equal(want_cpu, got_cpu, "cpu")
    _assert_dict_equal(want_mem, got_mem, "mem")


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_writeback_matches_jax(seed):
    _, cpu = _draw(seed, 64)
    rng = np.random.default_rng(seed)
    rd = rng.integers(0, 32, 64).astype(np.int32)
    val = rng.integers(-2**31, 2**31, 64, dtype=np.int64).astype(np.int32)
    want = jax.vmap(jriscv.writeback)(jax.tree.map(jnp.asarray, cpu),
                                      jnp.asarray(rd), jnp.asarray(val))
    got = riscv.writeback({k: torch.from_numpy(v) for k, v in cpu.items()},
                          torch.from_numpy(rd), torch.from_numpy(val))
    _assert_dict_equal(want, got, "writeback")


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_cache_and_dram_timing_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 16
    t = memory.Timing()
    assert dataclasses.asdict(t) == dataclasses.asdict(jmem.Timing())
    tags = rng.integers(-1, 4096, (n, 1024)).astype(np.int32)
    addr = rng.integers(0, 1 << 20, n).astype(np.int32)
    pred = rng.random(n) < 0.7
    cache = {"tags": tags, "hits": rng.integers(0, 99, n).astype(np.int32),
             "misses": rng.integers(0, 99, n).astype(np.int32)}
    want = jax.vmap(lambda c, a, p: jmem.cache_lookup(c, a, jmem.Timing(), p))(
        jax.tree.map(jnp.asarray, cache), jnp.asarray(addr), jnp.asarray(pred))
    got = memory.cache_lookup({k: torch.from_numpy(v) for k, v in cache.items()},
                              torch.from_numpy(addr), t, torch.from_numpy(pred))
    _assert_dict_equal(want[0], got[0], "cache")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    dram = {"last_row": rng.integers(-1, 4, n).astype(np.int32),
            "last_write": rng.random(n) < 0.5,
            "reads": rng.integers(0, 99, n).astype(np.int32),
            "writes": rng.integers(0, 99, n).astype(np.int32)}
    addr = rng.integers(0, 4 << 9, n).astype(np.int32)
    is_write = rng.random(n) < 0.5
    want = jax.vmap(lambda d, a, w, p: jmem.dram_cost(d, a, w, jmem.Timing(), p))(
        jax.tree.map(jnp.asarray, dram), jnp.asarray(addr), jnp.asarray(is_write),
        jnp.asarray(pred))
    got = memory.dram_cost({k: torch.from_numpy(v) for k, v in dram.items()},
                           torch.from_numpy(addr), torch.from_numpy(is_write), t,
                           torch.from_numpy(pred))
    _assert_dict_equal(want[0], got[0], "dram")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


LAYERS = [wl.Layer(*dataclasses.astuple(x)) for x in jwl.TABLE_III] + [
    wl.Layer("x", "t", 6, 6, 2), wl.Layer("x", "t", 8, 8, 2), wl.Layer("x", "t", 4, 4, 2)]


def test_table_iii_and_layers_match_jax():
    assert [dataclasses.astuple(x) for x in wl.TABLE_III] == \
        [dataclasses.astuple(x) for x in jwl.TABLE_III]
    assert wl.A_BASE_W == jwl.A_BASE_W
    assert sg.B_STAGE == jsg.B_STAGE and (sg.FLAG0, sg.FLAG1, sg.OUT0, sg.OUT1) == \
        (jsg.FLAG0, jsg.FLAG1, jsg.OUT0, jsg.OUT1)
    assert LAYERS[0].scaled(8) == wl.Layer(*dataclasses.astuple(jwl.TABLE_III[0].scaled(8)))


@pytest.mark.parametrize("layer", LAYERS, ids=lambda x: f"{x.name}-{x.h}x{x.w}x{x.p}")
def test_programs_and_images_match_jax(layer):
    jlayer = jwl.Layer(*dataclasses.astuple(layer))
    want, got = jwl.riscv_workload(jlayer), wl.riscv_workload(layer)
    assert got["programs"] == want["programs"] and got["o_word"] == want["o_word"]
    for k in ("dram", "expected"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(assembler.assemble(got["programs"][0]),
                                  jasm.assemble(want["programs"][0]))
    prog = (layer.h, layer.w, layer.p, 0x4000_1000, 4096, 8192)
    assert assembler.vmm_cim_program(*prog) == jasm.vmm_cim_program(*prog)
    np.testing.assert_array_equal(assembler.assemble(assembler.vmm_cim_program(*prog)),
                                  jasm.assemble(jasm.vmm_cim_program(*prog)))
    for strategy, mgrs, ids in (("uniform", [0, 1], {0: (0, 1), 1: (2, 3)}),
                                ("load_oriented", [1], {1: (0, 2)})):
        descs = getattr(sg, strategy)()
        jdescs = getattr(jsg, strategy)()
        assert sg.mailbox_ordinals(descs) == jsg.mailbox_ordinals(jdescs)
        want = jwl.cim_workload(jlayer, mgrs, ids, ordinals=jsg.mailbox_ordinals(jdescs))
        got = wl.cim_workload(layer, mgrs, ids, ordinals=sg.mailbox_ordinals(descs))
        assert got["programs"] == want["programs"]
        for m, src in got["programs"].items():
            np.testing.assert_array_equal(assembler.assemble(src),
                                          jasm.assemble(want["programs"][m]))
        for k in ("crossbars", "scratch"):
            assert got[k].keys() == want[k].keys()
        for g in got["crossbars"]:
            np.testing.assert_array_equal(got["crossbars"][g], want["crossbars"][g])
        for m in got["scratch"]:
            for off in got["scratch"][m]:
                np.testing.assert_array_equal(got["scratch"][m][off], want["scratch"][m][off])
        np.testing.assert_array_equal(got["dram"], want["dram"])


def test_auto_segmentation_matches_jax():
    costs = {"cpu0": 5.0, "cpu1": 2.0, "dram": 1.5, "cim0": 3.0, "cim1": 1.0,
             "cim2": 2.5, "cim3": 0.5}
    for n in (2, 3, 4):
        want = [dataclasses.asdict(d) for d in jsg.auto_segmentation(costs, n)]
        assert [dataclasses.asdict(d) for d in sg.auto_segmentation(costs, n)] == want
    assert sg.cim_global_base(3) == jsg.cim_global_base(3)
