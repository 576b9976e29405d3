"""Step programs: one captured CUDA graph per program key.

The counterpart of the JAX engine's jitted step programs
(``mlc_llm_tpu/engine/engine.py`` ``_decode_sample``, ``_decode_sample_k``
and ``precompile``): JAX compiles one device program per shape and
static argument; the port captures one CUDA graph per key (the engine's
decode step: batch and attention window) and replays it, so a step costs
one graph launch on the host instead of one launch per kernel.

A program is a function of fixed buffers: it reads its inputs from
tensors that the caller fills before each run, writes the state it
changes in place (the KV cache, the device lengths) and returns its
outputs. On a CUDA device, the first run of a key (or ``capture``) runs
a warm-up step eagerly on the capture stream, which makes the kernels'
first-use host calls (``cudaFuncSetAttribute``, the streaming GEMVs'
occupancy query) and the capture stream's zeroed ticket buffer
(``ops.zeroed_tickets``); then it captures the function into a graph
whose workspaces and outputs come from one memory pool that all the
engine's graphs share (they replay one at a time, on one stream). Every
run replays the graph and returns the graph's static outputs, which the
next replay overwrites: the caller copies what it keeps. A capture or a
replay that fails raises; nothing runs eagerly instead. On the CPU the
function runs eagerly at every run.

Launch counters stay exact: a graph's launches per kernel wrapper are
recorded at capture and added at each replay; the warm-up's and the
capture's own are taken back out.

Capture runs with ``capture_error_mode="thread_local"``: a CUDA call of
another thread (the server's network thread) cannot break it, so graphs
may be captured lazily while a server runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, Set

import torch

from ..ops import kernel_wrappers


@dataclasses.dataclass
class _Program:
    graph: Any              # torch.cuda.CUDAGraph
    outputs: Any            # the graph's static outputs
    launches: Dict[Callable, int]  # kernel launches a replay makes, by wrapper
    seconds: float          # warm-up and capture, host wall


class StepPrograms:
    """The captured step programs of one engine, by key."""

    def __init__(self, device: torch.device):
        self.device = device
        self.keys: Set[Hashable] = set()  # every key asked for, on any device
        self.replays = 0
        self._programs: Dict[Hashable, _Program] = {}
        self._pool = None
        self._stream = None

    @property
    def count(self) -> int:
        """Graphs captured."""
        return len(self._programs)

    def capture_seconds(self) -> Dict[Hashable, float]:
        return {k: p.seconds for k, p in self._programs.items()}

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
        replay; returns the static outputs. CPU: returns fn()."""
        self.keys.add(key)
        if self.device.type != "cuda":
            return fn()
        prog = self._programs.get(key) or self.capture(key, fn, warm_up)
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
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                outputs = fn()
            launches = {w: w.launches - n for w, n in zip(wrappers, warmed) if w.launches != n}
        finally:
            for w, n in zip(wrappers, before):
                w.launches = n
        prog = _Program(graph, outputs, launches, time.perf_counter() - t0)
        self._programs[key] = prog
        return prog
