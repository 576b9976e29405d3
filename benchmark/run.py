#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name from BENCHMARK.json. With --trace 0 the
run reports the cell's end-to-end metrics, with --trace 1 its per-layer
metrics and the device trace. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers that
decided `correct`, each beside its limit. Without a CUDA card (or with
fewer than the cell asks for) it prints no result and exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    # every cache a library of the program could write stays in the checkout,
    # at a fixed path; transformers, if anything loads it, must not load JAX
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    # set-up starts once PyTorch is imported: its import (5-6.5 s on the
    # H100 machine, spread by its file system) is no work of the program's,
    # and every later step, the program's own import included, is counted
    import torch

    t_start = time.perf_counter()

    from harness import cell as cell_mod
    from harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    want = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"no result: the cell needs {want} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # the host drives the card from one thread: no intra-op pool spinning
    # beside it
    torch.set_num_threads(1)
    try:
        out = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                                t_start)
    except Exception:  # noqa: BLE001 - no result line for a run that broke
        traceback.print_exc()
        return 1
    cell_mod.forbidden_or_exit()
    for line in cell_mod.result_lines(out):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
