"""What the metric readers (``metrics/<name>.py``) share.

A reader gets the run's Context and returns a number, or None when the
run holds nothing for it to read (the metric is then left out). Shares
are in percent. Device numbers come only from a run on the card: on any
other device the device readers return None. While the metrics are read
the program is still in reach (``engine``, ``scheduler``: its always-on
counters); it is freed right after.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional

from harness import roofline, stats


@dataclasses.dataclass
class Context:
    cell: object            # harness.spec.Cell
    window: object          # harness.loops.Window
    seconds: float
    setup_s: float
    rec: object             # harness.record.Recorder
    trace: object           # harness.trace.TraceSummary or None
    shapes: object          # the architecture's work count (arch/<name>.py, its work)
    batch: int              # rows a decode forward computes
    on_card: bool
    quiet_end: float = float("inf")   # where the traced stretch begins
    engine: object = None   # the program's engine, while the metrics are read
    scheduler: object = None  # and its scheduler (open loop), or None

    @property
    def host_end(self) -> float:
        """The end of what the host-timed readers of a traced run read: the
        window, less the profiled stretch at its end."""
        return min(self.window.end, self.quiet_end)


def measured(ctx: Context):
    return [s for s in ctx.window.served if s.measured]


def token_times(ctx: Context) -> List[float]:
    return [t for s in ctx.window.served for t in s.times]


def out_tok_s(ctx: Context) -> float:
    return stats.rate(token_times(ctx), ctx.window.start, ctx.window.end)


def _ended_before(ctx: Context, before: Optional[float]):
    """The measured requests; with `before`, those that failed or whose
    last token came before it."""
    ms = measured(ctx)
    if before is None:
        return ms
    return [s for s in ms if s.error is not None or (s.done and s.times and s.times[-1] < before)]


def ttft_s(ctx: Context, before: Optional[float] = None) -> List[float]:
    """From each measured request's due time to its first token; inf for
    one that failed or never answered."""
    return [s.first - s.due if s.first is not None and s.error is None else math.inf
            for s in _ended_before(ctx, before)]


def tpot_s(ctx: Context, before: Optional[float] = None) -> List[float]:
    """(last - first) / (tokens - 1) of each measured request; inf for one
    that did not finish."""
    out = []
    for s in _ended_before(ctx, before):
        if not s.done:
            out.append(math.inf)
        elif len(s.times) >= 2:
            out.append((s.times[-1] - s.times[0]) / (len(s.times) - 1))
    return out


def runs(ctx: Context, kinds: Iterable[str]):
    """The program runs of these kinds started in the (unprofiled) window."""
    return ctx.rec.runs_in(ctx.window.start, ctx.host_end, set(kinds))


def least_s(ctx: Context, run) -> float:
    """Least seconds of a program run's real work: each forward's rows
    (a K-step block's rows one position further each step)."""
    s = ctx.shapes
    total = 0.0
    for i in range(run.steps):
        rows = [(c + i * n, n) for c, n in run.rows]
        if rows:
            total += s.step_least_s(rows, len(rows))
    return total


def mfu(ctx: Context, kinds: Iterable[str]) -> Optional[float]:
    """Percent: the runs' least time over their device time (CUDA events
    around each replay) in the window."""
    if not ctx.on_card:
        return None
    rs = [r for r in runs(ctx, kinds) if r.device_s is not None and r.rows]
    if not rs:
        return None
    share = roofline.share(sum(least_s(ctx, r) for r in rs), sum(r.device_s for r in rs))
    return None if share is None else 100.0 * share


def kernel_roofline(ctx: Context, kinds: Iterable[str], pattern: str,
                    bound_s: Callable[[object], float]) -> Optional[float]:
    """Percent: the bound of the traced runs' products over the device time
    of their kernels whose names match `pattern`."""
    tr = ctx.trace
    if tr is None:
        return None
    kinds = set(kinds)
    rs = [r for r in ctx.rec.runs if r.kind in kinds and r.index in tr.runs_seen]
    t = tr.kernel_s({r.index for r in rs}, pattern)
    if not rs or t <= 0:
        return None
    return 100.0 * sum(bound_s(r) for r in rs) / t


def idle_share(ctx: Context) -> Optional[float]:
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def device_ms_mean(ctx: Context, kinds: Iterable[str]) -> Optional[float]:
    if not ctx.on_card:
        return None
    rs = [r.device_s for r in runs(ctx, kinds) if r.device_s is not None]
    return 1e3 * sum(rs) / len(rs) if rs else None
