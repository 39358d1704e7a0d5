"""The PyTorch port (`repro_torch`) stands alone: importing it, and every one
of its modules, loads neither JAX nor the JAX package, and builds or loads
no CUDA kernel (kernels build at their first launch on a GPU)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, subprocess, sys

calls = []
_popen = subprocess.Popen


class _NoBuild(_popen):
    def __init__(self, args, *a, **kw):
        calls.append(str(args))
        super().__init__(args, *a, **kw)


subprocess.Popen = _NoBuild
import repro_torch
mods = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch."))
for m in mods:
    importlib.import_module(m)
for name in ("compile", "Deployment", "BackendOptions", "Server"):
    getattr(repro_torch, name)
from repro_torch.kernels import _lib
print(json.dumps({
    "mods": mods,
    "foreign": sorted(k for k in sys.modules
                      if k.split(".")[0] in ("jax", "jaxlib", "repro")),
    "libs": sorted(_lib._LIBS),
    "popen": calls,
}))
"""


def test_port_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["foreign"] == []
    assert info["libs"] == [] and info["popen"] == []
    for m in ("repro_torch.hw", "repro_torch.core.compiled",
              "repro_torch.core.megakernel", "repro_torch.kernels.gemm_int8",
              "repro_torch.kernels.conv2d_im2col", "repro_torch.analysis",
              "repro_torch.compiler.backends", "repro_torch.serve.runtime",
              "repro_torch.configs", "repro_torch.configs.zamba2_1p2b",
              "repro_torch.core.lmgraph", "repro_torch.kernels.ops",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.ssm_scan", "repro_torch.models",
              "repro_torch.models.config", "repro_torch.models.layers",
              "repro_torch.models.rope", "repro_torch.models.attention",
              "repro_torch.models.ssm", "repro_torch.models.transformer",
              "repro_torch.models.serve", "repro_torch.serve.engine",
              "repro_torch.serve.continuous", "repro_torch.cluster",
              "repro_torch.cluster.mesh", "repro_torch.cluster.fleet",
              "repro_torch.cluster.router", "repro_torch.launch.mesh",
              "repro_torch.kernels.tiled_int8"):
        assert m in info["mods"]


def test_port_sources_name_no_jax_or_repro_import():
    """No line of the port or of chip_smoke.py imports jax or the JAX
    package (the grep the acceptance criteria name)."""
    pat = re.compile(r"import jax|from repro\b|import repro\b")
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []
