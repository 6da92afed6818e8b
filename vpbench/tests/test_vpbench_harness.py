"""Every cell rehearsed on the CPU through the harness's code paths, short
of the card check: the result line parses and carries the cell's metrics
and checks; the run loads no module of JAX or of the JAX package (whole
top-level names); the window and percentile arithmetic; and what a run
writes."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from conftest import ROOT, SMALL

from vpbench import devtrace, harness

CELLS = sorted(SMALL)


def _metric_names(cell, trace):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    return {m["name"] for m in harness.metrics_of(spec, w, trace)}


def test_every_cell_is_rehearsed():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert sorted(w["name"] for w in spec["workloads"]) == CELLS


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_rehearsal_prints_a_correct_result_line(cell, trace, small_run):
    out = json.loads(json.dumps(small_run(cell, trace=trace)))
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["checked"]["value"] >= 1
    got = set(out["metrics"])
    want = _metric_names(cell, trace)
    if trace:
        # the device's metrics read the card's trace: off the card only the
        # host's are there
        assert got <= want and any(m.startswith("round_us") for m in got)
        assert out["device"]["window_s"] > 0
    else:
        assert got == want
    for m in out["metrics"].values():
        assert np.isfinite(m["value"]) and m["unit"]


PROBE = r"""
import importlib.abc, json, sys, time
REFUSED = {"jax", "jaxlib", "flax", "repro"}
refused = []
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            refused.append(name)
            raise ImportError(name)
sys.meta_path.insert(0, Refuse())
sys.path[:0] = [ROOT + "/vpbench/tests", ROOT + "/src", ROOT]
from conftest import run_small
outs = [run_small(c, trace=t) for c in CELLS for t in (False, True)]
loaded = sorted({m.split(".")[0] for m in sys.modules} & REFUSED)
print(json.dumps({"correct": [o["correct"] for o in outs], "refused": refused, "loaded": loaded}))
"""


def _subprocess(code, env=None, cwd=ROOT):
    full = f"ROOT = {str(ROOT)!r}\nCELLS = {CELLS!r}\n" + code
    out = subprocess.run([sys.executable, "-c", full], capture_output=True, text=True,
                         timeout=600, cwd=cwd, env=env or dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    got = _subprocess(PROBE)
    assert all(got["correct"])
    assert got["refused"] == [] and got["loaded"] == []


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_window_closes_at_the_first_job_done_after_the_deadline(monkeypatch):
    from vpbench.entries import controller

    clock = {"t": 100.0}
    monkeypatch.setattr(controller.time, "perf_counter", lambda: clock["t"])
    session = controller.Session(None, {}, {"clients": 1}, 0, None)
    session.answers = []
    session.jobs = []

    def job():
        clock["t"] += 0.3
        return 0, True, None, 10, 1000, 0.01

    session._job = job
    session.kind = type("K", (), {"bound_s": staticmethod(lambda j: None)})
    session.jobs = [None]
    rec = harness.Record()
    session.window(1.0, rec)
    # jobs end at 0.3, 0.6, 0.9 and 1.2 s: the window closes at 1.2 s
    assert rec.attempted == 4 and rec.window_s == pytest.approx(1.2)
    assert harness.reader("jobs_per_s.sim")(rec) == pytest.approx(4 / 1.2)
    assert harness.reader("round_us.sim")(rec) == pytest.approx(1.2 / 40 * 1e6)
    assert harness.reader("round_ns_per_instr")(rec) == pytest.approx(1.2 / 4000 * 1e9)
    assert harness.reader("capture_ms")(rec) == pytest.approx(10.0)


def test_percentile_and_idle_arithmetic():
    rng = np.random.default_rng(3)
    lat = list(rng.exponential(0.05, 997))
    rec = harness.Record(latencies=lat, window_s=2.0, attempted=997, syncs=10, served=640)
    assert harness.reader("job_p95_ms")(rec) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert harness.reader("syncs_per_job")(rec) == pytest.approx(10 / 640)
    ops = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 2.5), ("d", 2.1, 2.2), ("e", 3.0, 3.5)]
    assert devtrace.union_s(ops) == pytest.approx(2.5)
    assert devtrace.gaps(ops) == [(1.5, 2.0), (2.5, 3.0)]
    rec.trace = devtrace.Trace(ops, [("vpbench.flush", 0.0, 4.0), ("aten::clone", 2.6, 2.9)], 4.0)
    rec.trace_rounds = 5
    assert harness.reader("device_idle_pct.serve")(rec) == pytest.approx(100 * (1 - 2.5 / 4.0))
    assert harness.reader("device_ops_per_round.serve")(rec) == pytest.approx(1.0)
    b = devtrace.breakdown(rec.trace)
    assert b["device_ops"][0] == ["a", 1.0]
    assert [g[0] for g in b["idle_gaps"]] == ["vpbench.flush", "aten::clone"]


WRITES = r"""
import json, os, sys
sys.path[:0] = [ROOT + "/vpbench/tests", ROOT + "/src", ROOT]
from conftest import run_small
outs = [run_small(c, trace=t) for c in CELLS for t in (False, True)]
print(json.dumps([o["correct"] for o in outs]))
"""


def _listing(path, skip=()):
    out = set()
    for dirpath, dirnames, files in os.walk(path):
        dirnames[:] = [d for d in dirnames if d not in skip]
        out.update(os.path.join(dirpath, f) for f in files)
    return out


def test_a_run_writes_only_where_it_may(tmp_path):
    """A rehearsal of every cell, traced and not, with a HOME, XDG_CACHE_HOME
    and TMPDIR of its own: nothing new in /dev/shm or at the top of /tmp,
    and nothing new in the checkout (its ignored build directory and
    bytecode caches aside)."""
    env = dict(os.environ)
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        (tmp_path / var).mkdir()
        env[var] = str(tmp_path / var)
    skip = {"build", "__pycache__", ".git", "chiprun_out", "scratch_chip", ".pytest_cache"}
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    top = set(os.listdir("/tmp"))
    tree = _listing(ROOT, skip)
    assert all(_subprocess(WRITES, env=env))
    assert (set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()) <= shm
    assert set(os.listdir("/tmp")) <= top
    assert _listing(ROOT, skip) <= tree


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "vpbench/run.py", "--workload",
                          "snn_fullwidth.fleet8", "--seed", str(2**31 + 9), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.returncode == 2 and out.stdout == ""


def test_run_needs_more_than_the_benchmark_files(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the command fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vpbench", tmp_path / "vpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "vpbench/run.py", "--workload",
                          "snn_fullwidth.fleet8", "--seed", "5", "--seconds", "1", "--trace",
                          "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


STUBBED = r"""
import json, pathlib, sys, time
sys.path[:0] = [STUB, COPY + "/vpbench/tests", SRC, COPY]
import torch
from conftest import SMALL
from vpbench import harness
torch.set_num_threads(2)
out = harness.run_cell(pathlib.Path(COPY), "googlenet_conv1.riscv", 3, 0.2, True,
                       torch.device("cpu"), time.perf_counter(), SMALL["googlenet_conv1.riscv"])
print(json.dumps(out))
"""


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """A metric reader, a file that a later cell adds, that imports a module
    named ``jax`` (a stub here): the run raises once the readers have run
    and prints no result."""
    import shutil

    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "vpbench", copy / "vpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    (copy / "vpbench" / "metrics" / "jax_probe.py").write_text(
        "def read(rec):\n    import jax  # noqa: F401\n    return 1.0\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "jax_probe", "unit": "count", "better": "lower",
                              "source": "host_clock", "layer": "device",
                              "moves": "jobs_per_s.sim", "workloads": ["googlenet_conv1.riscv"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (f"STUB = {str(tmp_path / 'stub')!r}\nCOPY = {str(copy)!r}\n"
            f"SRC = {str(ROOT / 'src')!r}\n" + STUBBED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=copy)
    assert out.returncode != 0 and out.stdout == ""
    assert "modules of JAX or the JAX package are loaded: jax" in out.stderr
