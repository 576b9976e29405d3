"""Engine program dumps and kernel re-injection, the counterpart of
``mlc_llm_tpu/debug/dump.py`` (the reference's bisection surface:
--debug-dump-script, --debug-load-script, --debug-dump-shader).

JAX dumps each jitted engine program at three stages (jaxpr, StableHLO,
optimized HLO) and re-runs an edited StableHLO module. The port's
programs are Python functions over the engine's fixed buffers, captured
as CUDA graphs on the card (``engine/programs.py``), so a dump writes,
per program:

  <name>.ops.txt      the aten op sequence with shapes and dtypes, recorded
                      under a TorchDispatchMode while the program runs once
                      (any device; the jaxpr's analog)
  <name>.kernels.txt  the device kernels of one replay of the program's
                      graph (torch.profiler, CUDA activity), each kernel of
                      csrc/ named by its source, and per kernel wrapper the
                      replay's launch counter beside its main kernels'
                      launches in the trace (the card only; the analog of
                      the optimized HLO: what actually runs)
  <name>.graph.dot    torch.cuda.CUDAGraph.debug_dump of that graph, captured
                      for the dump in debug mode (the card only)

and once per dump, for each csrc/ kernel source the programs launched,
``<source>.sass`` (cuobjdump -sass of csrc/build/<source>.so) and
``<source>.ptx`` (nvcc -ptx at NVCC_FLAGS' arch: the libraries are built
for sm_90a alone and hold no PTX).

Re-injection, the analog of --debug-load-script: ``reinject_engine_program``
compiles an edited copy of a kernel source into a temporary directory,
makes the wrappers launch from it for one eager run of a program on the
dump's arguments (a graph captured earlier holds the old kernel's
function, so nothing replays), and restores the built library after.

Programs are named as JAX names them where JAX has the program
(``prefill``, ``decode_w<N>``, ``prefill_slot``), every other one by its
key in ``engine.programs`` (``program_name``): the first-token samplers,
grouped admissions, K-step blocks once ``precompile(multi_step=)`` ran,
the verify pass of a speculative engine, and any other key the engine has
run. Dumps and re-injection run on a copy of the engine's cache and
restore its fixed input buffers and every launch counter, so the engine's
cache, stats, counters and programs are the same after them.

Used via ``--debug-dump-dir`` and ``--debug-load-kernel`` on the CLI.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import os
import re
import subprocess
import tempfile
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import ops
from ..engine.programs import StepPrograms

# the kernels a wrapper call launches once (the rest are prologues and
# split-K reductions): the wgmma mainloop, the streaming GEMVs, kernels 7
# and 8
MAIN_KERNELS = ("gemm_kernel", "stream_kernel", "paged_flash_decode_kernel",
                "flash_prefill_wg", "flash_prefill_tf32")
TRACES = 3  # profiled replays a program's kernels.txt may take (see dump_engine_programs)


def program_name(key: tuple) -> str:
    """A program key as a file name: its fields joined by '_'."""
    return re.sub(r"[^A-Za-z0-9]+", "_", repr(key)).strip("_")


def _zero_args(engine, key: tuple) -> tuple:
    """Example inputs of program `key`, one per buffer of
    engine.program_inputs(key): zero tokens and logits; a block's rows
    target slots 0..G-1 from position 0 over the whole bucket; a decode
    step's rows all active at seed 0, step 0, temperature and top-p 1."""
    dev, kind, i64 = engine.device, key[0], torch.int64
    if kind in ("prefill", "prefill_slots"):
        G, S = key[1], key[2]
        rows = torch.stack([torch.arange(G), torch.zeros(G, dtype=i64), torch.full((G,), S)])
        return torch.zeros((G, S), dtype=i64, device=dev), rows.to(dev)
    if kind == "sample":
        G = key[1]
        return (torch.zeros((G, engine.cfg.vocab_size), dtype=torch.float32, device=dev),
                torch.zeros((2, G), dtype=i64, device=dev),
                torch.ones((2, G), dtype=torch.float32, device=dev))
    if kind == "verify":
        return (torch.zeros((key[1], key[2]), dtype=i64, device=dev),)
    B = engine.max_batch
    rows = torch.stack([torch.ones(B, dtype=i64), torch.zeros(B, dtype=i64),
                        torch.zeros(B, dtype=i64)])
    return (torch.zeros((B, 1), dtype=i64, device=dev), rows.to(dev),
            torch.ones((2, B), dtype=torch.float32, device=dev))


def _program(engine, key: tuple):
    """program(*args): stage args into the program's fixed buffers and
    run it once eagerly; returns its outputs (a tuple)."""
    def program(*args):
        for buf, a in zip(engine.program_inputs(key), args):
            buf.copy_(a)
        return engine._program(key)[1]()

    return program


def engine_program_keys(engine, prefill_bucket: int = 128) -> Dict[str, tuple]:
    """{name: program key} of every program a dump covers: JAX's three at
    `prefill_bucket` (its bucket; the decode window of one token past
    it), the first-token samplers of 1 and max_batch rows, then every key
    the engine has run or captured, named by program_name."""
    B, slot = engine.max_batch, engine.kv_layout == "slot"
    bucket = engine.bucket_for(prefill_bucket)
    window = engine.decode_window(bucket)
    decode = engine.decode_window(bucket + 1)
    keys = {"prefill": ("prefill", B, bucket, window, slot),
            f"decode_w{decode}": ("decode", B, decode),
            "prefill_slot": ("prefill_slots", 1, bucket, window, slot)}
    for key in [("sample", g) for g in sorted({1, B})] + sorted(engine.programs.keys, key=repr):
        if key not in keys.values():
            keys[program_name(key)] = key
    return keys


def engine_program_args(engine, prefill_bucket: int = 128) -> Dict[str, tuple]:
    """{name: (program, example args, key)}: the dump's programs (see
    engine_program_keys). program(*args) runs program `key` eagerly on
    the engine's state; args are made of zeros as JAX's are. The key holds
    a program's static arguments (kind, rows, bucket, window, flash)."""
    return {name: (_program(engine, key), _zero_args(engine, key), key)
            for name, key in engine_program_keys(engine, prefill_bucket).items()}


def _cache_tensors(cache) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)}


@contextlib.contextmanager
def _on_cache_copy(engine, keys):
    """Run programs on a copy of the engine's cache (yields a function
    that resets the copy to the engine's state); afterwards restore the
    cache, the fixed input buffers of `keys` and every launch counter."""
    saved = engine.cache
    inputs = [(b, b.clone()) for key in keys for b in engine.program_inputs(key)]
    counts = [(w, w.launches) for w in ops.kernel_wrappers()]
    copy = dataclasses.replace(saved, **{k: t.clone() for k, t in _cache_tensors(saved).items()})
    engine.cache = copy

    def reset():
        src = _cache_tensors(saved)
        for k, t in _cache_tensors(copy).items():
            t.copy_(src[k])

    try:
        yield reset
    finally:
        engine.cache = saved
        for buf, was in inputs:
            buf.copy_(was)
        for w, n in counts:
            w.launches = n
        ops.synchronize(engine.device)


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype).split('.')[-1]}{list(x.shape)}"
    if isinstance(x, (list, tuple)):
        inner = ", ".join(_describe(v) for v in x)
        return f"[{inner}]" if isinstance(x, list) else f"({inner})"
    text = repr(x)
    return text if len(text) <= 40 else text[:37] + "..."


class _OpLog(TorchDispatchMode):
    """Records every aten op run under it: op, argument shapes and dtypes,
    output shapes and dtypes."""

    def __init__(self):
        super().__init__()
        self.lines: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kw = "".join(f", {k}={_describe(v)}" for k, v in kwargs.items())
        self.lines.append(f"{func}({', '.join(_describe(a) for a in args)}{kw}) -> "
                          f"{_describe(out)}")
        return out


def _write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


@functools.lru_cache(maxsize=None)
def _cxa_demangle():
    fn = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    free = ctypes.CDLL("libc.so.6").free
    free.argtypes = [ctypes.c_void_p]
    return fn, free


def _demangle(name: str) -> str:
    """A C++ symbol as the profiler names a kernel (libstdc++'s
    __cxa_demangle, which the profiler's demangler calls); the name itself
    when it is not a mangled one."""
    fn, free = _cxa_demangle()
    status = ctypes.c_int(0)
    ptr = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not ptr:
        return name
    text = ctypes.string_at(ptr).decode()
    free(ptr)
    return text


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")


def _sass(source: str) -> str:
    return subprocess.run([_cuobjdump(), "-sass", os.path.join(ops.BUILD_DIR, f"{source}.so")],
                          capture_output=True, text=True, check=True).stdout


def _symbols(sass: str) -> set:
    """The kernel functions of a cuobjdump -sass listing, mangled and
    demangled, spaces taken out."""
    out = set()
    for name in re.findall(r"Function : (\S+)", sass):
        out |= {name, _demangle(name).replace(" ", "")}
    return out


def _base_name(kernel: str) -> str:
    """A demangled kernel name's function: void ns::f<...>(...) -> f."""
    head = re.sub(r"<.*", "", kernel.replace("(anonymous namespace)::", "").split("(")[0])
    return head.split()[-1].split("::")[-1] if head.split() else head


def _replay_kernels(progs: StepPrograms, key, fn, warm_up):
    """Capture program `key` in progs and profile one replay: (device
    event names, {wrapper name: launches the replay counted})."""
    from torch.profiler import ProfilerActivity, profile

    progs.capture(key, fn, warm_up)
    wrappers = ops.kernel_wrappers()
    # a trace that holds no device activity at all measured nothing: it is
    # taken again, up to 3 times
    for _ in range(3):
        before = [w.launches for w in wrappers]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            progs.run(key, fn, warm_up)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    counted = {w.__name__: w.launches - n for w, n in zip(wrappers, before)}
    return names, counted


def _kernels_text(name: str, key, names, counted, symbols, trace: int) -> tuple:
    """The kernels.txt of one program and {source: main launches}."""
    launched = {src for src, w in zip(ops.KERNELS, ops.kernel_wrappers()) if counted[w.__name__]}
    by_name = collections.Counter(names)
    main = collections.Counter()
    lines = [f"# program {name}, key {key!r}: the device kernels of one graph replay "
             f"(torch.profiler, CUDA activity; trace {trace} of at most {TRACES})",
             "# launches  source  kernel"]
    for kernel, n in sorted(by_name.items(), key=lambda kv: (-kv[1], kv[0])):
        kernel = _demangle(kernel) if kernel.startswith("_Z") else kernel
        flat = kernel.replace(" ", "")
        srcs = [s for s in sorted(symbols) if flat in symbols[s]]
        if len(srcs) > 1:  # the same function in several libraries
            srcs = [s for s in srcs if s in launched] or srcs
        src = srcs[0] if len(srcs) == 1 else ("|".join(srcs) if srcs else "-")
        if len(srcs) == 1 and _base_name(kernel) in MAIN_KERNELS:
            main[src] += n
        lines.append(f"{n:8d}  {src}  {kernel}")
    lines.append("# per kernel wrapper: the replay's launch counter and its source's main "
                 "kernel launches in the trace")
    for src, w in zip(ops.KERNELS, ops.kernel_wrappers()):
        if counted[w.__name__] or main[src]:
            lines.append(f"launches {w.__name__} {src} counter={counted[w.__name__]} "
                         f"main_kernels={main[src]}")
    return "\n".join(lines) + "\n", main


def _nvcc_ptx(source: str, out: str) -> subprocess.Popen:
    arch = next(re.search(r"arch=(compute_\w+)", f).group(1) for f in ops.NVCC_FLAGS
                if "arch=compute_" in f)
    cmd = [ops._nvcc(), "-ptx", f"-arch={arch}", "-std=c++17", "-O3", "-I", ops.CSRC, "-o", out,
           os.path.join(ops.CSRC, f"{source}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dump_engine_programs(engine, outdir: str, prefill_bucket: int = 128) -> List[str]:
    """Dump every program of engine_program_keys (see the module doc) into
    outdir. Returns the sorted basenames written."""
    os.makedirs(outdir, exist_ok=True)
    keys = engine_program_keys(engine, prefill_bucket)
    cuda = engine.device.type == "cuda"
    written = []
    symbols: Dict[str, set] = {}
    sass: Dict[str, str] = {}
    used = set()
    with _on_cache_copy(engine, keys.values()) as reset:
        if cuda:
            ops.build_kernels(ops.KERNELS)
            for src in ops.KERNELS:
                sass[src] = _sass(src)
                symbols[src] = _symbols(sass[src])
        for name, key in keys.items():
            args = _zero_args(engine, key)
            reset()
            with _OpLog() as log:
                _program(engine, key)(*args)
            ops.synchronize(engine.device)
            _write(os.path.join(outdir, f"{name}.ops.txt"),
                   f"# program {name}, key {key!r}: aten ops of one eager run\n"
                   + "\n".join(log.lines) + "\n")
            written.append(f"{name}.ops.txt")
            if not cuda:
                continue
            reset()
            for buf, a in zip(engine.program_inputs(key), args):
                buf.copy_(a)
            progs = StepPrograms(engine.device, debug=True)
            _, fn, warm_up = engine._program(key)
            # a trace whose main kernels of a source differ in number from
            # its wrapper's counter is taken again: the profiler can drop a
            # record, a replay does not drop a launch. The trace that
            # misses fewest is kept.
            best = None
            for trace in range(1, TRACES + 1):
                names, counted = _replay_kernels(progs, key, fn, warm_up)
                text, main = _kernels_text(name, key, names, counted, symbols, trace)
                miss = sum(abs(main[src] - counted[w.__name__])
                           for src, w in zip(ops.KERNELS, ops.kernel_wrappers()))
                if best is None or miss < best[0]:
                    best = (miss, text, counted)
                if not miss:
                    break
            _, text, counted = best
            used |= {src for src, w in zip(ops.KERNELS, ops.kernel_wrappers())
                     if counted[w.__name__]}
            _write(os.path.join(outdir, f"{name}.kernels.txt"), text)
            dot = os.path.join(outdir, f"{name}.graph.dot")
            progs.capture(key, fn, warm_up).graph.debug_dump(dot)
            if not os.path.exists(dot):
                raise RuntimeError(f"CUDAGraph.debug_dump wrote no {dot}")
            written += [f"{name}.kernels.txt", f"{name}.graph.dot"]
            del progs
        procs = [(src, _nvcc_ptx(src, os.path.join(outdir, f"{src}.ptx"))) for src in sorted(used)]
        for src in sorted(used):
            _write(os.path.join(outdir, f"{src}.sass"), sass[src])
            written.append(f"{src}.sass")
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -ptx failed for {src}.cu:\n{out}")
            written.append(f"{src}.ptx")
    return sorted(written)


def _source(kernel: str) -> str:
    """A kernel source's name (KERNELS) from itself or its wrapper's name."""
    if kernel in ops.KERNELS:
        return kernel
    for src, w in zip(ops.KERNELS, ops.kernel_wrappers()):
        if w.__name__ == kernel:
            return src
    raise KeyError(f"unknown kernel {kernel!r}; have {list(ops.KERNELS)} or their wrappers")


def run_engine_program(engine, name: str, prefill_bucket: int = 128) -> list:
    """Program `name` of engine_program_args, run once eagerly on its
    example args and a copy of the engine's cache: its outputs, copied."""
    programs = engine_program_args(engine, prefill_bucket)
    if name not in programs:
        raise KeyError(f"unknown engine program {name!r}; have {sorted(programs)}")
    program, args, key = programs[name]
    with _on_cache_copy(engine, [key]):
        return [o.clone() for o in program(*args)]


def reinject_engine_program(engine, name: str, kernel: str, path: str,
                            prefill_bucket: int = 128) -> list:
    """Run program `name` of engine_program_args eagerly on its example
    args (and a copy of the engine's cache) with kernel `kernel` (a csrc/
    source name, or its wrapper's) launched from `path`, an edited copy
    of its source, compiled with NVCC_FLAGS into a temporary directory.
    The built library is restored after the call. Returns the program's
    outputs. Needs a CUDA card: the kernels run only there."""
    if engine.device.type != "cuda":
        raise RuntimeError("reinject_engine_program needs an engine on a CUDA card: a "
                           "kernel runs only there")
    source = _source(kernel)
    programs = engine_program_args(engine, prefill_bucket)
    if name not in programs:
        raise KeyError(f"unknown engine program {name!r}; have {sorted(programs)}")
    program, args, key = programs[name]
    with tempfile.TemporaryDirectory(prefix="mlc_reinject_") as tmp:
        so = os.path.join(tmp, f"{source}.so")
        ops.build_library(path, so)
        with _on_cache_copy(engine, [key]), ops.injected_kernel(source, so):
            return [o.clone() for o in program(*args)]
