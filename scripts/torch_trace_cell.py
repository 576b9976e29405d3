#!/usr/bin/env python3
"""Run one cell of the benchmark with the engine's own trace on, and read it.

    python scripts/torch_trace_cell.py --workload <cell> --seed <n> \\
        [--seconds 51] [--trace 0|1] [--program-trace 0|1] [--out FILE]

from the root of a checkout, on a CUDA card. The cell runs as
``benchmark/run.py`` runs it (the same set-up, window, metrics and check:
``harness.cell.run_cell``). With ``--program-trace 1`` the engine's trace
(``mlc_llm_tpu_torch/engine/trace.py``) is started once set-up is done and
stopped when the window (and, with ``--trace 1``, the profiler's stretch)
has closed; ``--program-trace 0`` runs the cell as the benchmark does, so
the two give the trace's cost on ``out_tok_s``. Prints the run's result
line (JSON) with, under ``program_trace``, what the trace reads over the
window the host-timed readers read (its start to the profiled stretch):

- chat: per decode step, the mean ms in ``stage`` + ``replay``,
  ``readback`` and ``client`` (a step's children) and of the step itself;
  the device's idle time before each decode replay, its mean;
- serve: per decode dispatch, the mean ms in ``stage`` + ``replay``; the
  device's idle time before the decode replays, per decode forward; the
  mean device ms of a first-token ``("sample", 1)`` replay; the share of
  the dispatched decode rows that a client received;
- both: each span name's self time, the gaps split by span (over the
  window and over the profiled stretch, with the stretch's gap share
  beside the profiler's ``idle_share``), device seconds by program kind,
  and the readbacks that landed or blocked.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import weakref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def _ms(x):
    return None if x is None else 1e3 * x


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


class _Tree:
    """The trace's spans by parent, and each replay's preceding device gap."""

    def __init__(self, tr):
        self.tr = tr
        self.kids = collections.defaultdict(list)
        for s in tr.spans:
            if s.end is not None:
                self.kids[s.parent].append(s)
        self.gap_before = {}
        reach = None
        for s in sorted((s for s in tr.spans if s.device is not None), key=lambda s: s.device):
            if reach is not None:
                self.gap_before[s.index] = max(0.0, s.device[0] - reach)
            reach = s.device[1] if reach is None else max(reach, s.device[1])

    def child_s(self, span, names):
        return sum(c.end - c.start for c in self.kids[span.index] if c.name in names)

    def replay_of(self, span):
        return next((c for c in self.kids[span.index] if c.name == "replay"), None)


def chat_readings(tree, start, end):
    tr = tree.tr
    steps = [s for s in tr.named("step", start, end) if tr.spans[s.parent].name == "turn"]
    decode = [s for s in steps if tree.replay_of(s) is not None]
    per = {name: _ms(_mean([tree.child_s(s, names) for s in decode]))
           for name, names in (("stage_replay", ("stage", "replay")),
                               ("readback", ("readback",)), ("client", ("client",)))}
    per["tiled"] = sum(v for v in per.values() if v is not None)
    per["step"] = _ms(_mean([s.end - s.start for s in decode]))
    per["step_self"] = per["step"] - per["tiled"] if decode else None
    gaps = [tree.gap_before.get(tree.replay_of(s).index, 0.0) for s in decode]
    return {"decode_steps": len(decode), "per_step_ms": per,
            "gap_ms_per_step": _ms(_mean(gaps))}


def serve_readings(tree, start, end, rows):
    tr = tree.tr
    dispatch = tr.named("dispatch", start, end)
    replays = [s for s in tr.named("replay", start, end) if s.key[0] in ("decode", "decode_k")]
    forwards = sum(s.key[2] if s.key[0] == "decode_k" else 1 for s in replays)
    gap = sum(tree.gap_before.get(s.index, 0.0) for s in replays)
    sample = [s.device[1] - s.device[0] for s in tr.named("replay", start, end)
              if s.key[:2] == ("sample", 1) and s.device is not None]
    out = {"dispatches": len(dispatch), "decode_forwards": forwards,
           "stage_ms_per_dispatch": _ms(_mean([tree.child_s(s, ("stage", "replay"))
                                               for s in dispatch])),
           "gap_ms_per_forward": _ms(gap / forwards) if forwards else None,
           "sample_ms": _ms(_mean(sample)), "first_token_samples": len(sample)}
    if rows is not None and rows["rows_dispatched"]:
        out["decode_row_yield_pct"] = 100.0 * rows["rows_emitted"] / rows["rows_dispatched"]
    return out


def run(cell, seed: int, seconds: float, trace: bool, program_trace: bool, device,
        t_start: float) -> dict:
    """One run of `cell` (``harness.cell.run_cell``), the engine's trace on
    through its window if `program_trace`; the result line with the
    trace's readings under "program_trace"."""
    from harness import cell as cell_mod
    from harness import program, spec
    from harness import trace as harness_trace

    keep = {}

    def counts(engine, sched):
        c = {"readbacks_landed": engine.readbacks_landed,
             "readbacks_blocked": engine.readbacks_blocked}
        if sched is not None:
            c.update({k: getattr(sched, k) for k in ("rows_dispatched", "rows_active",
                                                     "rows_emitted", "rows_dropped")})
        return c

    def after_setup(engine, sched):
        keep["engine"] = weakref.ref(engine)
        keep["sched"] = weakref.ref(sched) if sched is not None else None
        keep["counts0"] = counts(engine, sched)
        if program_trace:
            engine.trace.start()
            keep["trace"] = engine.trace

    no_capture = program.no_capture_in_window
    tracer_stop = harness_trace.Tracer.stop
    read_metrics = spec.read_metrics

    def closed(engine, captured):  # right after the profiler's stop
        if program_trace:
            engine.trace.stop()
        return no_capture(engine, captured)

    def stop(self):
        tracer_stop(self)
        if self.t0 is not None and self.t1 is not None:
            keep["stretch"] = (self.t0, self.t1)

    def read(metrics, ctx, bench_dir=spec.HERE):
        got = read_metrics(metrics, ctx, bench_dir)
        eng, sched = keep["engine"](), keep["sched"]() if keep["sched"] else None
        now = counts(eng, sched)
        keep["report"] = report(cell, ctx, keep.get("trace"), keep.get("stretch"),
                                {k: v - keep["counts0"][k] for k, v in now.items()})
        if ctx.trace is not None:
            keep["report"]["inside_replays"] = inside_replays(ctx)
        return got

    program.no_capture_in_window = closed
    harness_trace.Tracer.stop = stop
    spec.read_metrics = read
    try:
        out = cell_mod.run_cell(cell, seed, seconds, trace, device, t_start,
                                after_setup=after_setup)
    finally:
        program.no_capture_in_window = no_capture
        harness_trace.Tracer.stop = tracer_stop
        spec.read_metrics = read_metrics
    out["program_trace"] = dict(keep.get("report", {}), on=bool(program_trace))
    return out


def inside_replays(ctx) -> dict:
    """The profiled stretch's replays: their device time (CUDA events, the
    harness's) against the time of their kernels (the profiler's): what is
    left is the device idle inside a replay, which the profiler's idle
    share counts and the gaps between replays do not."""
    dev = {r.index: r.device_s for r in ctx.rec.runs
           if r.index in ctx.trace.runs_seen and r.device_s is not None}
    ker = collections.Counter()
    for _, sec, run in ctx.trace.kernels:
        if run in dev:
            ker[run] += sec
    d, k = sum(dev.values()), sum(ker.values())
    return {"replays": len(dev), "device_s": d, "kernel_s": k, "idle_s": d - k,
            "idle_share_pct": 100.0 * (d - k) / ctx.trace.window_s if ctx.trace.window_s else None}


def report(cell, ctx, tr, stretch, counts) -> dict:
    out = {"counts": counts}
    if tr is None:
        return out
    start, end = ctx.window.start, ctx.host_end
    out["window_s"] = end - start
    tree = _Tree(tr)
    if cell.mix["loop"] == "chat":
        out.update(chat_readings(tree, start, end))
    else:
        out.update(serve_readings(tree, start, end,
                                  counts if "rows_dispatched" in counts else None))
    out["self_ms"] = {k: _ms(v) for k, v in sorted(tr.self_times(start, end).items())}
    out["gap_ms"] = {k: _ms(v) for k, v in sorted(tr.gap_split(start, end).items())}
    kinds = {}
    for key, (n, s) in tr.device_seconds(start, end).items():
        k = kinds.setdefault(key[0], [0, 0.0])
        k[0] += n
        k[1] += s
    out["device_ms_by_kind"] = {k: {"replays": n, "mean_ms": _ms(s / n)}
                                for k, (n, s) in sorted(kinds.items())}
    if stretch is not None:
        a, b = stretch
        dev = [s.device for s in tr.spans
               if s.device is not None and s.device[1] > a and s.device[0] < b]
        if dev:
            # the stretch on the device's timeline, first replay to last, as
            # the profiler's idle share takes it
            lo, hi = max(a, min(d[0] for d in dev)), min(b, max(d[1] for d in dev))
            gap = sum(y - x for x, y in tr.gaps(lo, hi))
            out["stretch"] = {
                "seconds": hi - lo, "gap_share_pct": 100.0 * gap / (hi - lo),
                "gap_ms": {k: _ms(v) for k, v in sorted(tr.gap_split(lo, hi).items())},
                "self_ms": {k: _ms(v) for k, v in sorted(tr.self_times(lo, hi).items())}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None, help="also append the line to this file")
    args = ap.parse_args(argv)
    for p in (ROOT, BENCH):
        if p not in sys.path:
            sys.path.insert(1, p)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    import torch

    t_start = time.perf_counter()
    from harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no result: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    out = run(cell, args.seed, args.seconds, bool(args.trace), bool(args.program_trace),
              "cuda:0", t_start)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
