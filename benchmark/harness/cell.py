"""One run of one cell: set-up, the measured window, the metrics, the check.

``run_cell`` takes the device it is given: ``run.py`` hands it the card
after its look for one; the CPU tests hand it the CPU with a tiny
configuration to drive the same path through the plain versions of the
kernels.
"""

from __future__ import annotations

import gc
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from harness import check, guard, loops, program, readers, spec, traffic
from harness.record import Recorder, now
from harness.trace import Tracer


def card_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(device.index or 0)], capture_output=True, text=True,
                             timeout=20)
        info["power_limit"] = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             process_start: float, sample_count: Optional[int] = None,
             after_setup: Optional[Callable] = None, controls: Sequence[str] = ()) -> Dict:
    """The run's result line (a dict) and its compared numbers, each with
    its limit, under "checks" (last). after_setup(engine, sched), if given,
    runs once set-up is done: the tests plant faults there. controls: also
    read the reference in each of these lower precisions ("fp8", the
    control; "bf16") at the same positions, into notes (calibrate.py; the
    benchmark's runs do not)."""
    device = torch.device(device)
    mix, dep, model = cell.mix, cell.deployment, cell.model
    on_card = device.type == "cuda"
    phases = {"harness_and_card": now() - process_start}

    # ---- set-up: weights from the seed, the engine, its programs, a warm request
    t = now()
    engine = program.build_engine(cell.arch, model, dep, seed, device)
    sched = program.build_scheduler(engine, dep, seed) if mix["loop"] == "open" else None
    t = _phase(phases, "weights_engine", t, on_card)
    program.warm_up(engine, program.warm_keys(engine, mix, dep))
    t = _phase(phases, "capture", t, on_card)
    _warm_request(engine, sched, mix)
    t = _phase(phases, "warm_request", t, on_card)
    tracer = Tracer(trace and on_card, min_s=mix.get("trace_min_s", 1.0),
                    max_s=mix.get("trace_max_s", 4.0),
                    need_kinds=mix.get("trace_kinds", ()), min_runs=mix.get("trace_runs", 0))
    tracer.prime()
    rec = Recorder(trace, device)
    rec.instrument(engine)
    if after_setup is not None:
        after_setup(engine, sched)
    if mix["loop"] == "chat":
        work = traffic.chat_schedule(mix, seed, model["vocab_size"])
    else:
        work = traffic.open_schedule(mix, seed, seconds, model["vocab_size"])
    if on_card:
        torch.cuda.synchronize()
    _phase(phases, "trace_and_schedule", t, on_card)
    setup_s = now() - process_start
    captured = engine.programs.count

    # ---- the window
    if mix["loop"] == "chat":
        win = loops.run_chat(engine, mix, work, seconds, rec, tracer)
    else:
        win = loops.run_open(engine, sched, mix, work, seconds, rec, tracer)
    tracer.stop()
    program.no_capture_in_window(engine, captured)
    rec.settle()
    rec.verify(loops.SPANS[mix["loop"]])
    summary = tracer.summary()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    dev_info = card_info(device)

    ctx = readers.Context(cell=cell, window=win, seconds=seconds, setup_s=setup_s, rec=rec,
                          trace=summary, shapes=cell.arch.work(model, dep),
                          batch=engine.max_batch, on_card=on_card,
                          quiet_end=tracer.quiet_end, engine=engine, scheduler=sched)
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end, ctx,
                                cell.bench_dir)
    meas = readers.measured(ctx)
    failed = sum(1 for s in meas if not s.done)
    errors = [s.error for s in win.served if s.error]

    # ---- free the program, then the reference over a sample of what it served
    picked = check.sample(win, seed, sample_count or cell.config["correct"]["sample"])
    segs, wanted, tokens = check.segments_of(win, picked)
    ctx.engine = ctx.scheduler = None
    del engine, sched, rec.runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    Reference = cell.arch.Reference

    t_ref = now()
    ref = Reference(model, dep, seed, device)
    ref_logits = ref.logits(segs, wanted) if segs else []
    got = check.readings(ref_logits, tokens)
    ref_s = now() - t_ref
    extra = {}
    for prec in controls if segs else ():
        ctrl_logits = Reference(model, dep, seed, device, precision=prec).logits(segs, wanted)
        ctl = check.readings(ref_logits, check.control_tokens(ctrl_logits))
        extra.update({f"{prec}_{k}": v for k, v in ctl.items()})
        extra.update({f"{prec}_{k}": v
                      for k, v in check.diagnose(ref_logits, ctrl_logits, tokens).items()})
        del ctrl_logits
    del ref_logits
    limits = cell.config["correct"]
    checks = {}
    for name, limit in limits["limits"].items():
        if limit is not None:
            checks[name] = {"value": got[name], "limit": limit}
    checks["served_compared"] = {"value": check.served_count(tokens),
                                 "limit": limits.get("min_compared", 1)}
    checks["errors"] = {"value": len(errors), "limit": 0}
    correct = (all(c["value"] is not None and c["value"] <= c["limit"]
                   for n, c in checks.items() if n not in ("served_compared", "errors"))
               and checks["served_compared"]["value"] >= checks["served_compared"]["limit"]
               and not errors)
    dev = dict(dev_info, memory_peak_bytes=int(peak))
    if trace and summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    out = {"correct": bool(correct), "attempted": len(meas), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and summary is not None:
        out["breakdown"] = {"device_ops": [[n, s] for n, s in summary.device_ops],
                            "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    out["notes"] = {"reference_s": ref_s, "late_s": win.late_s, "sampled": len(picked),
                    "errors": errors[:3], "closed_s": win.closed_at - win.start,
                    "setup_phases_s": phases, "programs": captured,
                    "readings": got, **extra}
    out["checks"] = checks
    return out


def _phase(phases: dict, name: str, t0: float, on_card: bool) -> float:
    """Close set-up phase `name` begun at t0 (after the card's queue has
    drained); returns the time it ended."""
    if on_card:
        torch.cuda.synchronize()
    t = now()
    phases[name] = t - t0
    return t


def _warm_request(engine, sched, mix: dict) -> None:
    """One short request down the window's path, so that its first-use
    host costs (pinned buffers, readback events) fall in set-up."""
    lo = mix["prompt_tokens"]["min"] if mix["loop"] == "open" else mix["first_turn_tokens"]["min"]
    gen = program.generation(4, 0.0, 1.0, 0)
    prompt = list(range(1, lo + 1))
    if sched is None:
        for _ in engine.generate_stream([prompt], gen, reset=True):
            pass
        engine.reset()
    else:
        sched.submit(prompt, gen)
        sched.run()


def result_lines(out: Dict) -> List[str]:
    """The compared numbers beside their limits, one a line."""
    return [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in out["checks"].items()]


def forbidden_or_exit() -> None:
    bad = guard.forbidden_modules()
    if bad:
        print(f"refusing to report: loaded {', '.join(bad)}", file=sys.stderr)
        sys.exit(4)
