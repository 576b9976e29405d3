"""The device trace of a steady stretch of a traced run.

``torch.profiler`` (CPU and CUDA activity) runs over the last stretch of
the window, started between steps after a synchronize and stopped once
the window has closed (an open loop's stretch runs on past the close
until it has seen enough admissions), so that reading the trace (seconds
of host work) falls after the window. The host-timed readers leave the
stretch out. From the trace:

- busy seconds: the union of the intervals in which any device activity
  (kernel, copy, set) ran, so overlapping work counts once, against the
  stretch's length from its first device activity to its last;
- each kernel's program run: the kernel's correlation id leads to the
  runtime call that launched it (a graph launch for a replay), and that
  call lies inside one ``bench/prog/<i>`` range of the recorder;
- idle gaps: the holes in the union, each named by the innermost
  ``bench/<span>`` range the host was in when the device went idle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import List, Optional, Tuple

import torch

from harness.record import now

_PROG = re.compile(r"^bench/prog/(\d+)$")


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, Optional[int]]]   # (name, seconds, program run index)
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    runs_seen: set

    def kernel_s(self, runs: set, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for n, s, r in self.kernels if r in runs and rx.search(n))


class Tracer:
    """Profiles from start_at for at least min_s, until `min_runs` program
    runs of kinds `need_kinds` were seen (at most max_s)."""

    def __init__(self, on: bool, min_s: float, max_s: float, need_kinds=(), min_runs=0):
        self.on = on
        self.min_s, self.max_s = min_s, max_s
        self.need_kinds, self.min_runs = set(need_kinds), min_runs
        self.prof = None
        self.t0 = self.t1 = None
        self.start_at = None
        self.done = False

    def prime(self) -> None:
        """Pay the profiler's first start (CUPTI) in set-up."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def tick(self, t: float, recorder) -> None:
        if not self.on or self.done or self.start_at is None:
            return
        if self.prof is None:
            if t >= self.start_at:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.start()
                self.t0 = now()
                self.first_run = len(recorder.runs)
            return
        el = t - self.t0
        seen = sum(1 for r in recorder.runs[self.first_run:] if r.kind in self.need_kinds)
        if el >= self.max_s or (el >= self.min_s and seen >= self.min_runs):
            self.stop()

    @property
    def running(self) -> bool:
        return self.prof is not None and not self.done

    @property
    def quiet_end(self) -> float:
        """Where the host-timed readings stop: the stretch's start."""
        return self.t0 if self.t0 is not None else float("inf")

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            torch.cuda.synchronize()
            self.t1 = now()
            self.prof.stop()
            self.done = True

    def summary(self) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        self.stop()
        return summarize(self.prof.profiler.kineto_results.events(), self.t1 - self.t0)


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events, window_s: float) -> TraceSummary:
    gpu, launches, progs, spans = [], {}, [], []
    for e in events:
        dev = str(e.device_type())
        name = e.name()
        if dev.endswith("CUDA"):
            if name.startswith("bench/") or e.is_user_annotation():
                continue  # the host ranges' shadows on the device timeline
            gpu.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
            continue
        if name.startswith("cuda") or name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
        m = _PROG.match(name)
        if m:
            progs.append((e.start_ns(), e.end_ns(), int(m.group(1))))
        elif name.startswith("bench/"):
            spans.append((e.start_ns(), e.end_ns(), name[len("bench/"):]))
    progs.sort()
    starts = [p[0] for p in progs]

    def run_of(corr) -> Optional[int]:
        t = launches.get(corr)
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and progs[i][0] <= t <= progs[i][1]:
            return progs[i][2]
        return None

    kernels, by_name = [], collections.Counter()
    for a, b, name, corr in gpu:
        s = (b - a) / 1e9
        kernels.append((name, s, run_of(corr)))
        by_name[short_name(name)] += s
    merged = _merge([(a, b) for a, b, _, _ in gpu])
    busy = sum(b - a for a, b in merged) / 1e9
    if merged:
        # the stretch on the device's timeline, from its first activity to
        # its last: the host's wait to stop the profiler is no idle time
        window_s = (merged[-1][1] - merged[0][0]) / 1e9
    gaps = collections.Counter()
    spans.sort()
    stack: List[tuple] = []
    j = 0
    for (_, b0), (a1, _) in zip(merged, merged[1:]):
        if a1 <= b0:
            continue
        # the innermost host range open when the device went idle (the
        # ranges of one thread nest)
        while j < len(spans) and spans[j][0] <= b0:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < b0:
            stack.pop()
        gaps[stack[-1][2] if stack else "harness"] += (a1 - b0) / 1e9
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=kernels,
                        device_ops=by_name.most_common(10), idle_gaps=gaps.most_common(10),
                        runs_seen={r for _, _, r in kernels if r is not None})
