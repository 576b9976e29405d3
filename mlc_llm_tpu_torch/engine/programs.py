"""Step programs: one captured CUDA graph per program key.

The counterpart of the JAX engine's jitted programs
(``mlc_llm_tpu/engine/engine.py``: ``_prefill``, ``_prefill_slot``,
``_prefill_slots``, ``_sample_perslot``, ``_decode_sample``,
``_decode_sample_k`` and ``precompile``): JAX compiles one device
program per shape and static argument; the port captures one CUDA graph
per key (the engine's programs: kind, batch or group, bucket, window,
block width) and replays it, so a prefill, a decode step or a K-step
block costs one graph launch on the host instead of one launch per
kernel.

A program is a function of fixed buffers: it reads its inputs from
tensors that the caller fills before each run, writes the state it
changes in place (the KV cache, the device lengths) and returns a tuple
of outputs. On a CUDA device, the first run of a key (or ``capture``)
runs a warm-up step eagerly on the capture stream, which makes the
kernels' first-use host calls (``cudaFuncSetAttribute``, the streaming
GEMVs' occupancy query) and the capture stream's zeroed ticket buffer
(``ops.zeroed_tickets``); then it captures the function into a graph.
Every run replays the graph and returns the graph's static outputs. A
capture or a replay that fails raises; nothing runs eagerly instead. On
the CPU the function runs eagerly at every run.

The shared pool. All of an engine's graphs take their workspaces and
outputs from one memory pool (they replay one at a time, on one
stream), and a capture may be handed memory that another graph freed as
scratch. So a replay of ANY program may overwrite another program's
static outputs, not only a replay of the same one. The rule: copy out
every output you keep before the next run of any program (the engine
returns clones; a program that reads another's result, as the
first-token sampler reads a prefill's logits, takes a copy into its own
fixed input buffer).

While the engine's trace (``engine/trace.py``) is on, every run is a
``replay`` span carrying its key, between two CUDA events on the card.

Launch counters stay exact: a graph's launches per kernel wrapper are
recorded at capture and added at each replay; the warm-up's and the
capture's own are taken back out.

Tensor-parallel engines (``InferenceEngine(..., mesh=)``) make
collectives inside their programs. Under NCCL those are captured with
the rest, and a replay runs them. Gloo collectives stage through the host
and cannot be captured, so an engine whose mesh runs on gloo (the CPU, or
several ranks on one card) builds its programs with ``eager=True``: every
run calls the function on the CUDA device too, and nothing is captured.
The engine fixes that at construction from the tp group's backend; it is
not a fallback taken when a capture fails (a failed capture still raises).

Capture runs with ``capture_error_mode="thread_local"``: a CUDA call of
another thread (the server's network thread) cannot break it, so graphs
may be captured lazily while a server runs. Python's garbage collector is
off during a capture (``torch.cuda.graph`` collects once before it
begins): a graph of another engine destroyed by a collection inside the
capture would end it in ``cudaErrorStreamCaptureInvalidated``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, Optional, Set

import torch

from ..ops import kernel_wrappers
from .trace import Trace


@dataclasses.dataclass
class _Program:
    graph: Any              # torch.cuda.CUDAGraph
    outputs: Any            # the graph's static outputs
    launches: Dict[Callable, int]  # kernel launches a replay makes, by wrapper
    seconds: float          # warm-up and capture, host wall


class StepPrograms:
    """The captured step programs of one engine, by key."""

    def __init__(self, device: torch.device, debug: bool = False, eager: bool = False,
                 trace: Optional[Trace] = None):
        """debug: capture every graph in debug mode keeping its
        cudaGraph_t (``keep_graph``), so that ``graph.debug_dump(path)``
        writes it (``debug/dump.py``'s graphs; the engine's own keep
        neither). eager: run every program's function on a CUDA device as
        on the CPU, capturing nothing (gloo collectives, see the module
        doc). trace: the engine's ``Trace``, which times every run as a
        ``replay`` span (and a capture as a ``capture`` span) while it is
        on; default, one of its own."""
        self.device = device
        self.debug = debug
        self.eager = eager
        self.trace = trace if trace is not None else Trace(device)
        self.keys: Set[Hashable] = set()  # every key asked for, on any device
        self.runs = collections.Counter()  # runs by key, on any device
        self.replays = 0  # graph replays (CUDA): every run there
        self._programs: Dict[Hashable, _Program] = {}
        self._pool = None
        self._stream = None

    @property
    def count(self) -> int:
        """Graphs captured."""
        return len(self._programs)

    def capture_seconds(self) -> Dict[Hashable, float]:
        return {k: p.seconds for k, p in self._programs.items()}

    def runs_by_kind(self) -> Dict[str, int]:
        """Runs by program kind (the key's first field)."""
        out = collections.Counter()
        for key, n in self.runs.items():
            out[key[0]] += n
        return dict(out)

    def pool_bytes(self) -> int:
        """Bytes the shared graph pool holds on the device (its segments
        in the allocator's snapshot)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

    def run(self, key: Hashable, fn: Callable[[], Any], warm_up: Callable[[], None]):
        """Run program `key`: fn() computes it from the fixed input
        buffers and returns its outputs. CUDA: capture at the first run
        (after warm_up(), which must leave the state as it found it), then
        replay; returns the static outputs. CPU or eager: returns fn()."""
        self.keys.add(key)
        self.runs[key] += 1
        if self.device.type != "cuda" or self.eager:
            with self.trace.replay(key):
                return fn()
        prog = self._programs.get(key) or self.capture(key, fn, warm_up)
        with self.trace.replay(key):
            prog.graph.replay()
        self.replays += 1
        for wrapper, n in prog.launches.items():
            wrapper.launches += n
        return prog.outputs

    def capture(self, key: Hashable, fn: Callable[[], Any],
                warm_up: Callable[[], None]) -> _Program:
        """Capture program `key` without running it (a CUDA device only):
        warm_up() eagerly on the capture stream, then fn() into a graph."""
        self.keys.add(key)
        if key in self._programs:
            return self._programs[key]
        with self.trace.capture(key):
            return self._capture(key, fn, warm_up)

    def _capture(self, key: Hashable, fn: Callable[[], Any],
                 warm_up: Callable[[], None]) -> _Program:
        wrappers = kernel_wrappers()
        before = [w.launches for w in wrappers]
        t0 = time.perf_counter()
        try:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                warm_up()
            current.wait_stream(self._stream)
            warmed = [w.launches for w in wrappers]
            graph = torch.cuda.CUDAGraph(keep_graph=self.debug)
            if self.debug:
                graph.enable_debug_mode()
            collecting = gc.isenabled()
            gc.disable()  # torch.cuda.graph collects once before it begins
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    outputs = fn()
            finally:
                if collecting:
                    gc.enable()
            if self.debug:  # a kept graph is instantiated here, not at capture's end
                graph.instantiate()
            launches = {w: w.launches - n for w, n in zip(wrappers, warmed) if w.launches != n}
        finally:
            for w, n in zip(wrappers, before):
                w.launches = n
        prog = _Program(graph, outputs, launches, time.perf_counter() - t0)
        self._programs[key] = prog
        return prog
