"""The engine's own spans: where the host's time goes, and the device's.

One ``Trace`` per engine (``engine.trace``); the engine, its step
programs and every scheduler over the engine record into it. Until
``start()`` it is off: each span site is one attribute check that hands
back a shared no-op, and nothing is allocated. ``start()`` clears the
trace and turns it on; ``stop()`` turns it off and resolves the device
times.

A span is kept in memory (``Trace.spans``, in the order the spans began)
with its name, its start and end on ``time.perf_counter`` (the clock a
caller's own timestamps use), the index of its parent span (the
innermost span open when it began, -1 for none) and the request or
turn id it serves, which a span inherits from its parent when it names
none. While a ``torch.profiler`` session records, each span is also a
``record_function("mlc/<name>")`` range, so a profiler trace shows the
spans above the kernels they launched.

The spans, at the layer boundaries (``engine.py``, ``scheduler.py``,
``programs.py``):

- ``generate_stream``: ``turn`` ⊃ ``prefill`` ⊃ (``stage``, ``replay``),
  ``sample`` ⊃ (``stage``, ``replay``); then each decode step ``step`` ⊃
  ``stage``, ``replay``, ``readback`` (the host reading the last token
  back) and ``client`` (from a ``yield`` to the generator's resumption:
  the caller's time, seen from the program);
- ``ContinuousBatchingScheduler.step``: ``step`` ⊃ ``admit`` (one per
  request, carrying its id; a grouped admission carries none) ⊃
  ``prefill`` ⊃ (``stage``, ``replay``), ``sample``; ``dispatch`` ⊃
  ``stage``, ``replay``; ``drain`` ⊃ ``readback`` (only while the host
  waits on a copy that has not landed), ``emit`` (the clients'
  callbacks);
- ``StepPrograms.run``: ``replay``, carrying the program key; a capture
  while the trace is on is a ``capture`` span, counted in ``captures``.

Device time. While the trace is on, every replay records a CUDA event
before and after it on the stream (the events come from a pool that
``stop()`` refills). ``start()`` records one event, waits for it and
reads the host clock, which ties the device's clock to the host's; so
``stop()`` places each replay's device start and end on the host clock
(``Span.device``). From that: the device seconds of each program key
(``device_seconds``), and the device's gaps between consecutive replays
(``gaps``), each split among the innermost spans the host was in over
that interval (``gap_split``), ``outside`` where it was in none. The
fixed-buffer uploads between two replays (``stage``) are device work too,
but no replay: they count as gap. On the CPU nothing runs on a device:
the replay spans carry no device times and there are no gaps.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

OUTSIDE = "outside"
Interval = Tuple[float, float]


class Span:
    """One span of a trace (and the context that times it)."""

    __slots__ = ("name", "start", "end", "index", "parent", "rid", "key", "device", "_trace",
                 "_rf", "_events")

    def __init__(self, trace: "Trace", name: str, rid, key):
        self._trace = trace
        self.name, self.rid, self.key = name, rid, key
        self.start = 0.0
        self.end: Optional[float] = None  # None while open
        self.index = self.parent = -1
        self.device: Optional[Interval] = None  # a replay's, on the host clock
        self._rf = self._events = None

    def __enter__(self):
        tr = self._trace
        stack = tr._stack
        if stack:
            up = stack[-1]
            self.parent = up.index
            if self.rid is None:
                self.rid = up.rid
        self.index = len(tr.spans)
        stack.append(self)
        tr.spans.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function("mlc/" + self.name)
            self._rf.__enter__()
        self.start = tr.clock()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        tr = self._trace
        self.end = tr.clock()
        stack = tr._stack
        if stack and stack[-1] is self:  # not a span left open across start()
            stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class _Null:
    """The span an off trace hands back."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Trace:
    """The spans of one engine (off until ``start()``)."""

    def __init__(self, device=None, clock: Callable[[], float] = time.perf_counter):
        """device: where the engine's programs run (CUDA: replays are
        timed by events); clock: the host clock (tests pass a fake one)."""
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.clock = clock
        self.on = False
        self.spans: List[Span] = []
        self.captures = 0
        self._stack: List[Span] = []  # the open spans, innermost last
        self._replays: List[Span] = []
        self._pool: List[torch.cuda.Event] = []
        self._origin: Optional[tuple] = None  # (event, host time) tying the clocks
        self._ids = itertools.count()

    # ------------------------------------------------------------ on / off
    def start(self) -> None:
        """Clear the trace and turn it on (ties the device's clock to the
        host's on CUDA: one event recorded and waited for)."""
        self._release()
        self.spans, self._stack, self._replays = [], [], []
        self.captures = 0
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            self._origin = (ev, self.clock())
        self.on = True

    def stop(self) -> None:
        """Turn the trace off and place every replay's device start and
        end on the host clock (waits for the device)."""
        self.on = False
        if self._origin is None:
            return
        origin, t0 = self._origin
        torch.cuda.synchronize(self.device)
        for sp in self._replays:
            a, b = sp._events
            sp.device = (t0 + origin.elapsed_time(a) / 1e3, t0 + origin.elapsed_time(b) / 1e3)
        self._release()

    def _release(self) -> None:
        """Return the replays' events to the pool."""
        for sp in self._replays:
            if sp._events is not None:
                self._pool.extend(sp._events)
                sp._events = None
        self._origin = None

    # ---------------------------------------------------------------- sites
    def span(self, name: str, rid=None, key: Hashable = None):
        """A span named `name` (a context manager); the shared no-op when
        the trace is off."""
        if not self.on:
            return _NULL
        return Span(self, name, rid, key)

    def replay(self, key: Hashable):
        """The ``replay`` span of program `key`, with CUDA events before
        and after it when the engine runs on the card."""
        if not self.on:
            return _NULL
        sp = Span(self, "replay", None, key)
        if self._origin is not None:
            pool = self._pool
            sp._events = (pool.pop() if pool else torch.cuda.Event(enable_timing=True),
                          pool.pop() if pool else torch.cuda.Event(enable_timing=True))
            self._replays.append(sp)
        return sp

    def capture(self, key: Hashable):
        """The ``capture`` span of program `key` (counted)."""
        if not self.on:
            return _NULL
        self.captures += 1
        return Span(self, "capture", None, key)

    def turn(self):
        """The ``turn`` span of one ``generate_stream`` call, under a fresh
        id."""
        if not self.on:
            return _NULL
        return Span(self, "turn", next(self._ids), None)

    # -------------------------------------------------------------- readings
    def named(self, name: str, start: float = float("-inf"),
              end: float = float("inf")) -> List[Span]:
        """The closed spans called `name` that began in [start, end)."""
        return [s for s in self.spans
                if s.name == name and start <= s.start < end and s.end is not None]

    def self_times(self, start: float = float("-inf"),
                   end: float = float("inf")) -> Dict[str, float]:
        """Seconds of each span name's self time (its duration less the
        part its children cover) that lie in [start, end)."""
        out: Dict[str, float] = collections.Counter()
        for a, b, name in self_segments(self.spans):
            out[name] += max(0.0, min(b, end) - max(a, start))
        return dict(out)

    def device_seconds(self, start: float = float("-inf"),
                       end: float = float("inf")) -> Dict[Hashable, Tuple[int, float]]:
        """(replays, device seconds) of each program key, over the replays
        that began on the host in [start, end)."""
        out: Dict[Hashable, list] = {}
        for sp in self.spans:
            if sp.device is not None and start <= sp.start < end:
                n = out.setdefault(sp.key, [0, 0.0])
                n[0] += 1
                n[1] += sp.device[1] - sp.device[0]
        return {k: (n, s) for k, (n, s) in out.items()}

    def gaps(self, start: float = float("-inf"),
             end: float = float("inf")) -> List[Interval]:
        """The device's idle intervals between consecutive replays (on
        the host clock), clipped to [start, end)."""
        dev = sorted(sp.device for sp in self.spans if sp.device is not None)
        return replay_gaps(dev, start, end)

    def gap_split(self, start: float = float("-inf"),
                  end: float = float("inf")) -> Dict[str, float]:
        """Seconds of the device's gaps between replays in [start, end),
        each gap split among the innermost spans the host was in."""
        return split_intervals(self.gaps(start, end), self_segments(self.spans))


def replay_gaps(device: Sequence[Interval], start: float = float("-inf"),
                end: float = float("inf")) -> List[Interval]:
    """The holes between consecutive device intervals (sorted by start),
    clipped to [start, end)."""
    out: List[Interval] = []
    reach = None
    for a, b in device:
        if reach is not None and a > reach:
            lo, hi = max(reach, start), min(a, end)
            if hi > lo:
                out.append((lo, hi))
        reach = b if reach is None else max(reach, b)
    return out


def self_segments(spans: Sequence[Span]) -> List[Tuple[float, float, str]]:
    """(start, end, name) pieces of host time, each the self time of the
    innermost span open over it, in order; they tile the closed spans'
    union. spans: in the order they began, parents before children."""
    kids: Dict[int, List[int]] = collections.defaultdict(list)
    for i, sp in enumerate(spans):
        if sp.end is not None:
            kids[sp.parent].append(i)
    out: List[Tuple[float, float, str]] = []

    def walk(i: int) -> None:
        sp = spans[i]
        t = sp.start
        for c in kids.get(i, ()):
            ch = spans[c]
            if ch.start > t:
                out.append((t, min(ch.start, sp.end), sp.name))
            walk(c)
            t = max(t, ch.end)
        if sp.end > t:
            out.append((t, sp.end, sp.name))

    for root in kids.get(-1, ()):
        walk(root)
    out.sort()
    return out


def split_intervals(intervals: Sequence[Interval],
                    segments: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of each interval, split by the named segments that overlap
    it (disjoint, sorted by start); what none covers is ``outside``."""
    starts = [s[0] for s in segments]
    out: Dict[str, float] = collections.Counter()
    for a, b in intervals:
        covered = 0.0
        j = max(0, bisect.bisect_right(starts, a) - 1)
        while j < len(segments) and segments[j][0] < b:
            s0, s1, name = segments[j]
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                out[name] += ov
                covered += ov
            j += 1
        if b - a - covered > 0:
            out[OUTSIDE] += b - a - covered
    return dict(out)
