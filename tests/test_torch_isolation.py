"""The port stands alone: no module of mlc_llm_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package."""

import os
import pkgutil
import re
import subprocess
import sys

import mlc_llm_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(mlc_llm_tpu_torch.__file__)

_BANNED = [
    re.compile(r"^\s*(import|from)\s+jax\b", re.M),
    re.compile(r"^\s*(import|from)\s+mlc_llm_tpu\b(?!_)", re.M),
    re.compile(r"\bmlc_llm_tpu\.[A-Za-z_]"),  # a dotted module path
    re.compile(r"import_module\(\s*['\"](jax|mlc_llm_tpu)['\".]"),
]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "mlc_llm_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    new = {"mlc_llm_tpu_torch.models.paged_cache", "mlc_llm_tpu_torch.ops.paged_attention",
           "mlc_llm_tpu_torch.engine.scheduler", "mlc_llm_tpu_torch.parallel.wire",
           "mlc_llm_tpu_torch.serve"}
    assert "mlc_llm_tpu_torch.ops.dequant_matmul" in mods and new <= set(mods)
    assert len(mods) >= 26
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mlc_llm_tpu' or m.startswith('mlc_llm_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_name_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 28
    for path in files:
        src = open(path).read()
        for pat in _BANNED:
            assert not pat.search(src), f"{path}: {pat.pattern}"
