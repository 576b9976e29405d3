#!/usr/bin/env python3
"""The knee of an open-loop cell: the highest rate it sustains, on the card.

    python3 benchmark/sweep.py --workload <cell> --rates 3,4,5,6 --seconds 30 [--seeds N,M]

Set-up once (the cell's weights, engine and step programs), then for each
rate and each seed a fresh scheduler on the same engine under the cell's
mix at that rate for --seconds. Per rate and seed, one JSON line: offered and completed
requests a second, tokens a second, TTFT p50/p90 and TPOT p90 from due
time, the requests still unfinished 20 s after the window's end, and TTFT
p90 of the window's first and last thirds (a backlog that grows shows as
the last third running away from the first). The cell's rate is then fixed in its
traffic file; the benchmark's runs never search for one.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seeds", default=str(2**31 + 4242), help="comma-separated seeds")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(1, ROOT)
    import torch

    from harness import loops, program, spec, stats, traffic
    from harness.record import Recorder
    from harness.trace import Tracer

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    torch.set_num_threads(1)
    seeds = [int(x) for x in args.seeds.split(",")]
    engine = program.build_engine(cell.arch, cell.model, cell.deployment, seeds[0], dev)
    program.warm_up(engine, program.warm_keys(engine, cell.mix, cell.deployment))
    for r, seed in [(r, s) for r in args.rates.split(",") for s in seeds]:
        mix = copy.deepcopy(cell.mix)
        mix["rate_rps"] = float(r)
        mix["grace_s"] = 20.0
        sched = program.build_scheduler(engine, cell.deployment, seed)
        reqs = traffic.open_schedule(mix, seed, args.seconds, cell.model["vocab_size"])
        win = loops.run_open(engine, sched, mix, reqs, args.seconds, Recorder(False, dev),
                             Tracer(False, 1, 1))
        meas = [s for s in win.served if s.measured]
        ttft = [s.first - s.due if s.first is not None else float("inf") for s in meas]
        third = len(meas) // 3
        tpot = [(s.times[-1] - s.times[0]) / (len(s.times) - 1) for s in meas
                if s.done and len(s.times) > 1]
        toks = [t for s in win.served for t in s.times]
        line = {"workload": args.workload, "rate_rps": float(r), "seed": seed,
                "requests": len(meas),
                "completed_rps": sum(1 for s in meas if s.done) / args.seconds,
                "out_tok_s": stats.rate(toks, win.start, win.end),
                "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
                "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90),
                "ttft_p90_first_third_ms": 1e3 * stats.percentile(ttft[:third], 90),
                "ttft_p90_last_third_ms": 1e3 * stats.percentile(ttft[-third:], 90),
                "tpot_p90_ms": 1e3 * stats.percentile(tpot, 90) if tpot else None,
                "unfinished": sum(1 for s in meas if not s.done), "late_s": win.late_s,
                "card": torch.cuda.get_device_name(dev)}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del sched
        time.sleep(1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
