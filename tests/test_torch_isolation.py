"""The port imports nothing of JAX or of the JAX package: in a fresh
interpreter whose import system refuses ``jax``, ``jaxlib`` and ``repro``
(but not ``repro_torch``), every module of ``repro_torch`` and
``chip_smoke.py`` import, and nothing was refused along the way (a refusal
swallowed by a ``try`` still counts)."""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys

REFUSED_TOPS = {"jax", "jaxlib", "repro"}
refused = []


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED_TOPS:
            refused.append(name)
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import repro_torch

imported = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    imported.append(info.name)
if WITH_SMOKE:
    sys.path.insert(0, REPO)
    import chip_smoke  # noqa: F401
    imported.append("chip_smoke")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED_TOPS)
print(json.dumps({"imported": imported, "refused": refused, "leaked": leaked}))
"""


def _probe(with_smoke):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = f"REPO = {str(REPO)!r}\nWITH_SMOKE = {with_smoke}\n" + PROBE
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_modules_import_no_jax_and_no_reference():
    got = _probe(with_smoke=False)
    assert got["refused"] == [] and got["leaked"] == []
    names = set(got["imported"])
    # the walk reached every slice, the LM stack and every kernel wrapper
    for m in ("repro_torch.core.controller", "repro_torch.faults",
              "repro_torch.models.ssm", "repro_torch.models.moe", "repro_torch.models.encdec",
              "repro_torch.serve.serve_step",
              "repro_torch.launch.serve", "repro_torch.configs.falcon_mamba_7b",
              "repro_torch.configs.qwen3_1_7b", "repro_torch.configs.granite_34b",
              "repro_torch.kernels.ssm_scan.ops", "repro_torch.kernels.slot_scan.ops",
              "repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.obs.export",
              "repro_torch.serve.snn_serve", "repro_torch.train.optimizer",
              "repro_torch.train.train_step", "repro_torch.train.data",
              "repro_torch.train.checkpoint", "repro_torch.train.compression",
              "repro_torch.train.decoupled", "repro_torch.launch.train"):
        assert m in names, m


def test_chip_smoke_imports_no_jax_and_no_reference():
    got = _probe(with_smoke=True)
    assert got["refused"] == [] and got["leaked"] == []
    assert "chip_smoke" in got["imported"]
