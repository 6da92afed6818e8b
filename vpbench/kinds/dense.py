"""Dense jobs: one of the paper's Table III layers as a VMM ``O = A @ B``
on the VP's 2-segment platform (``core.segmentation.uniform(2, 2)``),
built by the port's ``core.segmentation.build``: the nested-loop VMM runs
on the DRAM segment's RISC-V CPU.

A configuration of this kind gives the layer (``network``, ``layer``,
``h``, ``w``, ``p``) and ``channel_latency``; its traffic gives ``pool``.
A job's answer is O read back from the final DRAM; the reference is
``reference.vmm``."""
from __future__ import annotations

import dataclasses

import numpy as np

from vpbench import gen, reference


@dataclasses.dataclass
class DenseJob:
    layer: gen.Layer
    a: np.ndarray
    b: np.ndarray


def make_jobs(config, traffic, seed):
    layer = gen.Layer(config["network"], config["layer"], int(config["h"]),
                      int(config["w"]), int(config["p"]))
    jobs = []
    for i in range(int(traffic.get("pool", 1))):
        a, b, _ = gen.layer_data(layer, gen.seed_of(seed, i))
        jobs.append(DenseJob(layer, a, b))
    return jobs


def build(config, job, device):
    """The job as a platform: ``(cfg, states, pending, meta)``."""
    from repro_torch.core import segmentation as sg
    from repro_torch.vp.assembler import vmm_riscv_program

    layer = job.layer
    words, a_b, b_b, o_b, o_w = gen.dram_image(layer, job.a, job.b)
    programs = {0: vmm_riscv_program(layer.h, layer.w, layer.p, a_b, b_b, o_b)}
    cfg, states, pending = sg.build(sg.uniform(2, 2), programs=programs, dram_words=words,
                                    channel_latency=int(config["channel_latency"]),
                                    device=device)
    return cfg, states, pending, {"o_word": o_w, "h": layer.h, "p": layer.p,
                                  "dram_segment": cfg.dram_segment}


def answer(states, meta):
    """O as the final DRAM holds it, on the host."""
    o, n = meta["o_word"], meta["h"] * meta["p"]
    words = states["dram"]["data"][meta["dram_segment"], o:o + n]
    return words.cpu().numpy().astype(np.int64).reshape(meta["h"], meta["p"])


def expected(jobs, precision="exact"):
    return [reference.vmm(j.a, j.b, precision) for j in jobs]


def differs(got, want) -> bool:
    return not np.array_equal(got, want)


def instructions(states) -> int:
    """Simulated instructions retired, over all segments (on the host)."""
    return int(states["stats"]["instrs"].sum())


def bound_s(job):
    """No whole-step bound: the simulator's work is the instruction
    stream, not the matrix product it computes."""
    return None
