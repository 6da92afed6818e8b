"""Shared pieces of the benchmark's CPU tests: the repository on the import
path, and each cell cut to a size the CPU runs in seconds (the harness's
code paths, short of the card check)."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# every cell of BENCHMARK.json at a CPU size: the overrides of its
# configuration and traffic
SMALL = {
    "snn_fullwidth.fleet64": {"config": {"layer_sizes": [16, 12, 8], "in_cap": 1024},
                              "traffic": {"pool": 8, "clients": 4, "bucket_size": 4,
                                          "t_steps": 5, "trace_buckets": 1,
                                          "sample_share": 0.5}},
    "snn_fullwidth.fleet8": {"config": {"layer_sizes": [16, 12, 8], "in_cap": 1024},
                             "traffic": {"pool": 6, "clients": 2, "bucket_size": 2,
                                         "t_steps": 5, "trace_buckets": 2,
                                         "sample_share": 0.5}},
    "googlenet_conv1.riscv": {"config": {"h": 4, "w": 4, "p": 2, "quantum": 200,
                                         "channel_latency": 200},
                              "traffic": {}},
}


def run_small(workload, seed=2**31 + 7, seconds=0.5, trace=False, root=ROOT):
    """One rehearsal run of ``workload`` at its CPU size; the result line's
    object."""
    import torch

    from vpbench import harness

    torch.set_num_threads(2)
    return harness.run_cell(root, workload, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), SMALL[workload])


@pytest.fixture
def small_run():
    return run_small
