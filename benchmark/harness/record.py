"""What a run records: requests, tokens, and (traced) each program run.

In a traced run the harness wraps, on the engine and scheduler objects it
built (never in the program's code), the calls into each layer:

- every step-program run (``engine.programs.run``): its key, host span,
  CUDA events before and after it on the stream (the replay's device
  time), a profiler range ``bench/prog/<i>`` so that its kernels can be
  told apart, and the work it was handed (the rows' cached context and new
  tokens, taken from the host arguments of the staging call before it);
- host spans named for the layer the host is in: ``admit``, ``sample``,
  ``dispatch``, ``drain``, and around them the loop's ``scheduler`` /
  ``generator`` and ``wait``, as profiler ranges ``bench/<name>``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

now = time.perf_counter


@dataclasses.dataclass
class ProgramRun:
    index: int
    key: tuple
    t0: float
    t1: float
    rows: List[Tuple[int, int]]   # (cached context, new tokens) of each real row
    steps: int                    # forwards in the run (K for a K-step block)
    head_rows: int                # rows the lm head runs on, each forward
    ev: Optional[tuple] = None    # CUDA events before and after
    device_s: Optional[float] = None

    @property
    def kind(self) -> str:
        return self.key[0]


class Recorder:
    """Spans and program runs of a traced run (a no-op when off)."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.cuda = device.type == "cuda"
        self.runs: List[ProgramRun] = []
        self.span_s: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        self._work: Optional[tuple] = None

    # ------------------------------------------------------------ spans
    def span(self, name: str):
        return _Span(self, name) if self.on else _NULL

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time obj.attr as span `name` (an instance attribute wrapper)."""
        if not self.on:
            return
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(obj, attr, wrapped)

    def total(self, name: str, start: float, end: float) -> float:
        """Seconds of span `name` that lie in [start, end)."""
        return sum(max(0.0, min(b, end) - max(a, start)) for a, b in self.span_s.get(name, ()))

    # ------------------------------------------------------------ programs
    def instrument(self, engine) -> None:
        """Record every program run of engine, with its work."""
        if not self.on:
            return
        programs = engine.programs
        run = programs.run
        run_block, stage = engine._run_block, engine._stage_decode

        def staged_block(kind, tokens, slots, starts, seq_lens, window, flash):
            G = tokens.shape[0]
            st = np.broadcast_to(np.asarray(starts, np.int64), (G,)).tolist()
            sl = np.broadcast_to(np.asarray(seq_lens, np.int64), (G,)).tolist()
            self._work = ([(st[g], sl[g]) for g in range(G) if sl[g] > 0], 1, G)
            return run_block(kind, tokens, slots, starts, seq_lens, window, flash)

        def staged_decode(tokens, active, *a, **kw):
            ctx = engine.cache.lengths.numpy()
            self._work = ([(int(ctx[b]), 1) for b in range(len(active)) if active[b]], None,
                          int(active.sum()))
            return stage(tokens, active, *a, **kw)

        def recorded(key, fn, warm_up):
            i = len(self.runs)
            work, self._work = self._work, None
            rows, steps, head = work if work and key[0] != "sample" else ([], 1, 0)
            if key[0] == "decode_k":
                steps = key[2]
            steps = steps or 1
            ev = None
            if self.cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = now()
            with torch.profiler.record_function(f"bench/prog/{i}"):
                out = run(key, fn, warm_up)
            if ev is not None:
                ev[1].record()
            self.runs.append(ProgramRun(i, key, t0, now(), rows, steps, head, ev))
            return out

        engine._run_block = staged_block
        engine._stage_decode = staged_decode
        programs.run = recorded

    def settle(self) -> None:
        """Read the device time of every recorded run (after a sync)."""
        if not self.cuda:
            return
        torch.cuda.synchronize()
        for r in self.runs:
            if r.ev is not None:
                r.device_s = r.ev[0].elapsed_time(r.ev[1]) / 1e3
                r.ev = None

    def verify(self, need: dict) -> None:
        """In a traced run: raise unless every wrapped host span in
        need["spans"] fired and, for each group of kinds in need["runs"],
        a program run of that group was recorded with its work staged."""
        if not self.on:
            return
        missing = [n for n in need["spans"] if not self.span_s.get(n)]
        missing += ["/".join(g) + " runs with work" for g in need["runs"]
                    if not any(r.kind in g and r.rows for r in self.runs)]
        if missing:
            raise RuntimeError("the harness's hooks recorded nothing for: " + ", ".join(missing)
                               + "; the program no longer calls what harness/record.py wraps")

    def runs_in(self, start: float, end: float, kinds) -> List[ProgramRun]:
        return [r for r in self.runs if r.kind in kinds and start <= r.t0 < end]


class _Span:
    __slots__ = ("rec", "name", "t0", "rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(f"bench/{self.name}")
        self.rf.__enter__()
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        self.rec.span_s[self.name].append((self.t0, now()))
        self.rf.__exit__(*exc)
        return False


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
