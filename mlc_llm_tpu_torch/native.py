"""ctypes bindings for the port's C++ host library, the counterpart of
``mlc_llm_tpu/native.py``.

The sources are the port's own copies, ``csrc/host/conversation.cc``
(conversation templating, the UTF-8 and stop-string guards of token
streaming) and ``csrc/host/ckpt_loader.cc`` (the multithreaded
checkpoint reader). They are compiled at first use with ``g++ -O2
-std=c++17 -shared -fPIC -pthread`` into ``csrc/build/libmlc_host.so``,
rebuilt when a source is newer: the compiler writes a temporary file,
which then replaces the library in one ``os.replace``, so a process that
loads the library while another builds it gets the old or the new file
whole. A failed build raises; nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence

HOST_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "host")
LIB_PATH = os.path.join(os.path.dirname(HOST_SRC), "build", "libmlc_host.so")
SOURCES = ("conversation.cc", "ckpt_loader.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_STYLE_IDS = {"single": 0, "two": 1, "dolly": 2, "oasst": 3, "moss": 4}
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    newest = max(os.path.getmtime(os.path.join(HOST_SRC, s)) for s in SOURCES)
    return os.path.getmtime(lib_path) < newest


def build(lib_path: str = LIB_PATH) -> str:
    """Compile the host library into lib_path (a temporary file in its
    directory, then os.replace). Raises RuntimeError with g++'s output
    when the build fails."""
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(os.path.join(HOST_SRC, s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {lib_path} failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {lib_path} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I32, I64, S = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p
    sigs = {
        "mlc_conv_create": (P, [S, S, S, I32, S, S]),
        "mlc_conv_destroy": (None, [P]),
        "mlc_conv_append": (None, [P, I32, S]),
        "mlc_conv_update_last": (None, [P, S]),
        "mlc_conv_set_offset": (None, [P, I32]),
        "mlc_conv_reset": (None, [P]),
        "mlc_conv_get_prompt": (S, [P]),
        "mlc_conv_get_prompt_unprocessed": (S, [P]),
        "mlc_utf8_safe_prefix": (I64, [S, I64]),
        "mlc_find_stop": (I64, [S, I64, S, ctypes.POINTER(I64)]),
        "mlc_load_file": (I64, [S, P, I64]),
        "mlc_load_ranges": (I64, [ctypes.POINTER(S), ctypes.POINTER(I64), ctypes.POINTER(P),
                                  ctypes.POINTER(I64), I64, I64]),
        "mlc_load_files": (I64, [ctypes.POINTER(S), ctypes.POINTER(P), ctypes.POINTER(I64),
                                 I64, I64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built first when missing or stale.
    Raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale(LIB_PATH):
                build(LIB_PATH)
            _lib = _bind(ctypes.CDLL(LIB_PATH))
        return _lib


def available() -> bool:
    """Whether the host library builds and loads here (a query: the
    callers that need the library call get_lib, which raises)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeConversation:
    """C++-backed conversation engine with the Python Conversation's
    rendering contract (``conversation.py``), byte for byte."""

    def __init__(self, system: str, roles, style: str, sep: str, sep2: Optional[str],
                 offset: int = 0):
        lib = get_lib()
        self._lib = lib
        self._h = lib.mlc_conv_create(system.encode(), roles[0].encode(), roles[1].encode(),
                                      _STYLE_IDS[style], sep.encode(), (sep2 or "").encode())
        lib.mlc_conv_set_offset(self._h, offset)
        self._roles = tuple(roles)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.mlc_conv_destroy(h)

    def append(self, role: str, message: Optional[str]) -> None:
        self._lib.mlc_conv_append(self._h, self._roles.index(role),
                                  None if message is None else message.encode())

    def update_last(self, message: str) -> None:
        self._lib.mlc_conv_update_last(self._h, message.encode())

    def reset(self) -> None:
        self._lib.mlc_conv_reset(self._h)

    def get_prompt(self) -> str:
        return self._lib.mlc_conv_get_prompt(self._h).decode()

    def get_prompt_unprocessed(self) -> str:
        return self._lib.mlc_conv_get_prompt_unprocessed(self._h).decode()


def utf8_safe_prefix(data: bytes) -> int:
    """Length of the longest prefix of data that is whole UTF-8."""
    return get_lib().mlc_utf8_safe_prefix(data, len(data))


def find_stop(text: bytes, stop: bytes):
    """Returns (position of stop in text or -1, bytes to hold back: the
    longest tail of text that could begin stop)."""
    hold = ctypes.c_int64(0)
    pos = get_lib().mlc_find_stop(text, len(text), stop, ctypes.byref(hold))
    return pos, hold.value


def _address(buf) -> tuple:
    """(address, bytes) of a writable host buffer: a contiguous CPU torch
    tensor (its view's own first element: data_ptr counts the storage
    offset), a NumPy array or a ctypes buffer."""
    if hasattr(buf, "data_ptr"):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("load_files_parallel: a tensor buffer must be contiguous on the CPU")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if hasattr(buf, "ctypes"):
        if not buf.flags["C_CONTIGUOUS"] or not buf.flags["WRITEABLE"]:
            raise ValueError("load_files_parallel: an array buffer must be contiguous and "
                             "writable")
        return buf.ctypes.data, buf.nbytes
    return ctypes.addressof(buf), ctypes.sizeof(buf)


def load_files_parallel(paths: List[str], buffers, num_threads: int = 8,
                        offsets: Optional[Sequence[int]] = None) -> None:
    """Fill each buffer (its whole length) from its file, starting at
    byte offsets[i] (default 0), with up to num_threads reader threads.
    The GIL is released while the threads read. Raises IOError naming the
    first file that could not be read whole."""
    n = len(paths)
    if len(buffers) != n or (offsets is not None and len(offsets) != n):
        raise ValueError("load_files_parallel: one buffer (and offset) per path")
    if n == 0:
        return
    addrs, sizes = zip(*(_address(b) for b in buffers))
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    c_offs = (ctypes.c_int64 * n)(*(offsets or [0] * n))
    c_dsts = (ctypes.c_void_p * n)(*addrs)
    c_sizes = (ctypes.c_int64 * n)(*sizes)
    rc = get_lib().mlc_load_ranges(c_paths, c_offs, c_dsts, c_sizes, n, num_threads)
    if rc != 0:
        raise IOError(f"failed loading {paths[rc - 1]!r} (bytes {c_offs[rc - 1]} to "
                      f"{c_offs[rc - 1] + c_sizes[rc - 1]})")
