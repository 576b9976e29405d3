"""The port stands alone: no module of mlc_llm_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package; importing
the port's modules loads neither transformers (its loaders import it
inside the function that needs it) nor safetensors or ml_dtypes; and no
file of the port names a path into this repo's cpp/ tree, the JAX
package's host library (the port builds its own copy, csrc/host/)."""

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
           "mlc_llm_tpu_torch.serve", "mlc_llm_tpu_torch.version",
           "mlc_llm_tpu_torch.utils.checkpoint", "mlc_llm_tpu_torch.models.hf_loader",
           "mlc_llm_tpu_torch.build", "mlc_llm_tpu_torch.ppl", "mlc_llm_tpu_torch.evaluate",
           "mlc_llm_tpu_torch.debug.compare", "mlc_llm_tpu_torch.debug.dump",
           "mlc_llm_tpu_torch.native", "mlc_llm_tpu_torch.tune",
           "mlc_llm_tpu_torch.parallel.coordinator", "mlc_llm_tpu_torch.parallel.multihost",
           "mlc_llm_tpu_torch.parallel.sharding"}
    assert "mlc_llm_tpu_torch.ops.dequant_matmul" in mods and new <= set(mods)
    assert len(mods) >= 40
    banned = ("jax", "mlc_llm_tpu", "transformers", "safetensors", "ml_dtypes")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {banned!r})\n"
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


def test_no_port_file_names_the_jax_cpp_tree():
    # the JAX package's host library lives under cpp/mlc_host/, built into
    # cpp/build/; the port's own copy is csrc/host/, built into csrc/build/
    # (native.py). Citations of the upstream reference's cpp/llm_chat.cc
    # name no path of this repo.
    cpp = re.compile(r"cpp/(build|mlc_host)\b|\bmlc_host/|[\"']cpp[\"']")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        if os.path.basename(d) == "build":
            continue
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cc", ".h"))]
    assert any(f.endswith(os.path.join("host", "ckpt_loader.cc")) for f in files)
    for path in files:
        text = open(path, errors="replace").read()
        hit = cpp.search(text)
        assert hit is None, f"{path}: names {text[hit.start():hit.start() + 40]!r}"
    from mlc_llm_tpu_torch import native

    assert native.HOST_SRC.startswith(PKG) and native.LIB_PATH.startswith(PKG)
