#!/usr/bin/env python3
"""Readings that set a cell's correctness limit, on the card, one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 20 [--out FILE]

For each seed: a run of the cell at its own load for --seconds (long
enough to finish the mix's longest requests), the program's readings over
the sampled served tokens, and those of the reference in each precision
of --controls read at the same positions (fp8: the control; bf16: the
16-bit sibling of an f16 configuration). One JSON line a seed, on
standard output and appended to --out. The benchmark's own runs never
run a control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--controls", default="fp8", help="comma-separated: fp8, bf16 (or none)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(1, ROOT)
    from harness import cell as cell_mod
    from harness import spec
    import torch

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    controls = [c for c in args.controls.split(",") if c and c != "none"]
    for s in args.seeds.split(","):
        seed = int(s)
        out = cell_mod.run_cell(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(),
                                controls=controls)
        line = {"workload": args.workload, "seed": seed, "correct": out["correct"],
                "checks": out["checks"], "metrics": out["metrics"], "notes": out["notes"],
                "attempted": out["attempted"], "failed": out["failed"],
                "device": out["device"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
