"""Compute ops: quantized matmul, attention, sampling; device helpers and
the loader of the hand-written CUDA kernels.

There is no kernel mode. A kernel wrapper picks its path from the
device of the tensors it is given: on CPU tensors it runs its plain
PyTorch version, on CUDA tensors it launches the kernel or raises.

Kernels live in ``csrc/<name>.cu`` with a plain C interface (the int4
kernels share ``csrc/int4_common.cuh``; the wgmma GEMMs and the
tensor-core GEMVs share the Hopper mainloop ``csrc/dequant_wgmma.cuh``;
the m = 1 GEMVs the weight-streaming mainloop ``csrc/gemv_stream.cuh``).
Each is compiled at first use
by ``nvcc`` into ``csrc/build/<name>.so`` (rebuilt when the source or a
header is newer) and loaded with ``ctypes``. A failed build raises;
nothing falls back.
"""

from __future__ import annotations

import contextlib
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
           "dequant_gemv_gp3", "dequant_gemm_plane", "paged_flash_decode", "flash_prefill")

_LIBS: Dict[str, ctypes.CDLL] = {}
# a kernel library that load_kernel takes in place of csrc/build/<name>.so
# (debug/dump.py's re-injection of an edited source, for one call)
_INJECTED: Dict[str, str] = {}
# the kernels' ticket buffers, by device and stream: see zeroed_tickets;
# a buffer that a larger one replaced stays alive in _RETIRED, since a
# captured graph may still point at it
_TICKETS: Dict[tuple, torch.Tensor] = {}
_RETIRED: list = []


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
        path = _INJECTED.get(name)
        if path is None:
            build_kernels([name])
            path = _lib_path(name)
        lib = ctypes.CDLL(path)
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def build_library(src: str, out: str, extra_flags=()) -> str:
    """Compile one kernel source (any path; its includes resolve against
    csrc/ too) with NVCC_FLAGS into the shared library `out`. Returns
    nvcc's output; raises on failure."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra_flags, "-I", CSRC, "-o", out, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    return proc.stdout


@contextlib.contextmanager
def injected_kernel(name: str, so_path: str):
    """Inside the context the wrappers of kernel `name` launch from the
    library at so_path (loaded at their next call, argument types and
    all); after it, from the library they used before. A CUDA graph
    captured earlier keeps the function it captured: run eagerly."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {list(KERNELS)}")
    saved = _LIBS.pop(name, None)
    _INJECTED[name] = so_path
    try:
        yield
    finally:
        del _INJECTED[name]
        _LIBS.pop(name, None)
        if saved is not None:
            _LIBS[name] = saved


def check_launch(err: int, name: str) -> None:
    """Raise when a kernel entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def zeroed_tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed int32 tickets for launches on `stream` (a CUDA
    stream handle) of `device`, one cached buffer each. A kernel that
    combines its split parts in the same launch (kernel 7, the streaming
    GEMVs) takes one ticket per output tile and puts it back to 0, so the
    buffer is zero between launches; launches on one stream run one at a
    time, so they share it, and a launch on another stream gets another
    buffer. It is allocated (zeroed) anew only when a call needs more
    tickets."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a buffer allocated here would come from the graph's pool
            raise RuntimeError(
                f"zeroed_tickets: stream {stream:#x} has no buffer of {n} tickets; an eager "
                "warm-up on the capture stream must create it before capture")
        if t is not None:
            _RETIRED.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port, in the order of KERNELS (wrapper i
    launches the kernels of csrc/KERNELS[i].cu). Each keeps a plain integer
    ``launches`` that its wrapper adds one to where it launches its
    kernel, and nowhere else (``engine/programs.py`` adds a captured
    graph's launches at each replay)."""
    from . import dequant_matmul as dm
    from .attention import flash_prefill
    from .paged_attention import paged_flash_decode

    return (dm.gemv_qs, dm.gemm_qs, dm.gemv_gp, dm.gemm_pairs, dm.gemv_gp3, dm.gemm_plane,
            paged_flash_decode, flash_prefill)
