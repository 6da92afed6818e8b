"""Each cell once on the card through ``vpbench/run.py``, untraced and
traced, with a short window: the last line parses, the run is correct and
every metric the cell lists is there.  Skips where no CUDA card is present
(the check is made inside the test)."""
import json
import subprocess
import sys

import pytest
from conftest import ROOT, SMALL

from vpbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs on the card only")
    out = subprocess.run([sys.executable, "vpbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 40 + trace), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_of(spec, w, bool(trace))}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
