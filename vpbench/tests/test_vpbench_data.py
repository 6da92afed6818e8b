"""The harness is driven by data: in a copy of the benchmark, a new
per-layer metric (a reader file and its entry in BENCHMARK.json) and a new
cell (a traffic file and its entry) are run and reported without an edit
to any file the benchmark already has."""
import json
import shutil
import subprocess
import sys

from conftest import ROOT, SMALL

METRIC = '''"""A throwaway metric: the jobs the window finished."""


def read(rec):
    return float(rec.attempted)
'''

PROBE = r"""
import json, sys, time
sys.path[:0] = [COPY + "/vpbench/tests", SRC, COPY]
import torch
from vpbench import harness
from conftest import SMALL
torch.set_num_threads(2)
assert harness.HERE == __import__("pathlib").Path(COPY) / "vpbench"
out = {}
for cell, trace in (("snn_fullwidth.fleet2", False), ("snn_fullwidth.fleet2", True),
                    ("googlenet_conv1.riscv", True)):
    ov = NEW_SMALL if cell == "snn_fullwidth.fleet2" else SMALL[cell]
    out[f"{cell}/{trace}"] = harness.run_cell(__import__("pathlib").Path(COPY), cell, 3, 0.3,
                                              trace, torch.device("cpu"), time.perf_counter(), ov)
print(json.dumps(out))
"""


def test_a_metric_and_a_cell_are_added_as_files(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(ROOT / "vpbench", copy / "vpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (copy / "vpbench").rglob("*") if p.is_file()}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # new files only: a reader, a traffic mix, and their entries
    (copy / "vpbench" / "metrics" / "jobs_finished.py").write_text(METRIC)
    traffic = json.loads((ROOT / "vpbench" / "traffic" / "fleet8.json").read_text())
    (copy / "vpbench" / "traffic" / "fleet2.json").write_text(
        json.dumps({**traffic, "clients": 2, "bucket_size": 2}))
    spec["workloads"].append({"name": "snn_fullwidth.fleet2", "config": "snn_fullwidth",
                              "traffic": "fleet2", "chips": 1, "why": "a test's cell"})
    for m in spec["per_layer"]:
        if "snn_fullwidth.fleet8" in m.get("workloads", []):
            m["workloads"].append("snn_fullwidth.fleet2")
    for m in spec["end_to_end"]:
        if "snn_fullwidth.fleet8" in m.get("workloads", []):
            m["workloads"].append("snn_fullwidth.fleet2")
    spec["per_layer"].append({"name": "jobs_finished", "unit": "jobs", "better": "higher",
                              "source": "host_clock", "layer": "serving",
                              "moves": "jobs_per_s.serve",
                              "workloads": ["snn_fullwidth.fleet2"]})
    spec["per_layer"].append({"name": "jobs_finished.sim", "unit": "jobs", "better": "higher",
                              "source": "host_clock", "layer": "controller and dispatch",
                              "moves": "jobs_per_s.sim", "workloads": ["googlenet_conv1.riscv"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    new_small = {"config": SMALL["snn_fullwidth.fleet8"]["config"],
                 "traffic": {**SMALL["snn_fullwidth.fleet8"]["traffic"], "clients": 2,
                             "bucket_size": 2}}
    code = (f"COPY = {str(copy)!r}\nSRC = {str(ROOT / 'src')!r}\n"
            f"NEW_SMALL = {new_small!r}\n" + PROBE)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=copy)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert all(o["correct"] for o in out.values())
    assert set(out["snn_fullwidth.fleet2/False"]["metrics"]) == {"jobs_per_s.serve",
                                                                 "job_p95_ms", "setup_s"}
    for key, name in (("snn_fullwidth.fleet2/True", "jobs_finished"),
                      ("googlenet_conv1.riscv/True", "jobs_finished.sim")):
        assert out[key]["metrics"][name]["value"] == out[key]["attempted"]
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file the benchmark had was edited
