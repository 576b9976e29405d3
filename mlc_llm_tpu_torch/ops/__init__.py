"""Compute ops: quantized matmul, attention, sampling; device helpers and
the loader of the hand-written CUDA kernels.

There is no kernel mode. A kernel wrapper picks its path from the
device of the tensors it is given: on CPU tensors it runs its plain
PyTorch version, on CUDA tensors it launches the kernel or raises.

Kernels live in ``csrc/<name>.cu`` with a plain C interface (the int4
kernels share ``csrc/int4_common.cuh``; the wgmma GEMMs and the
tensor-core GEMVs share the Hopper mainloop ``csrc/dequant_wgmma.cuh``).
Each is compiled at first use
by ``nvcc`` into ``csrc/build/<name>.so`` (rebuilt when the source or a
header is newer) and loaded with ``ctypes``. A failed build raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# every source under csrc/: the kernels of the port's paths
KERNELS = ("dequant_gemv_qs", "dequant_gemm_qs", "dequant_gemv_gp", "dequant_gemm_pairs",
           "dequant_gemv_gp3", "dequant_gemm_plane", "paged_flash_decode")

_LIBS: Dict[str, ctypes.CDLL] = {}


def resolve_device(device) -> torch.device:
    """Validate a device request. "cuda" without a visible GPU raises:
    the caller asks for the CPU explicitly, nothing picks it for them."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}.so")


def _stale(name: str) -> bool:
    srcs = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    out = _lib_path(name)
    return not os.path.exists(out) or os.path.getmtime(out) < max(map(os.path.getmtime, srcs))


def build_kernels(names: Iterable[str], extra_flags=(),
                  force: Iterable[str] = ()) -> Dict[str, str]:
    """Compile the named sources that are missing or stale, and those in
    `force` in any case, one nvcc process per source, all started
    together. Returns nvcc's output of each source it built (warnings;
    ptxas's report under -Xptxas -v). Raises on any failure."""
    force = set(force)
    todo = [n for n in names if n in force or _stale(n)]
    logs: Dict[str, str] = {}
    if not todo:
        return logs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            logs[name] = out
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load_kernel(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use; argtypes
    maps each C entry to its argument types (c_void_p for every pointer
    and the stream, or ctypes would cut them to 32-bit ints)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(_lib_path(name))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise when a kernel entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
