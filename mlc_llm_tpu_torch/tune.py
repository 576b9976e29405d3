"""Launch-plan tuner of the dequant matmul kernels, the counterpart of
``mlc_llm_tpu/tune.py`` (the reference's MetaSchedule database).

The kernels' launch plans (``ops/dequant_matmul.py``: the m tile, split-K
parts and stages a part of the wgmma GEMMs and tensor-core GEMVs; the
columns, parts and stages a part of the m = 1 streaming GEMVs) come from
time models fitted by hand. This tool sweeps them on the current card:
for each shape of a model and each m, the kernel that ``route`` picks is
run under every distinct plan, each held against its plain version
(1e-2; f32 atol 1e-4, rtol 1e-3) and timed with CUDA events, the L2
flushed before each launch. It writes ``ops/tuned_plans.json``, which
``launch_plan`` reads before the models, on the card it names only.

  python -m mlc_llm_tpu_torch.tune --model vicuna-v1-7b [--quant q4bf16] \\
      [--m 1 --m 8 --m 128 --m 2048] [-o TABLE]

The table's header names the card, its power limit, torch and CUDA; each
entry holds the fastest plan (``plan``, ``us``), whether a second timing
of it came within 10% (``validated``), the runner-up and the time
models' own pick with its time. Kernel 7 (``split_pages``) and kernel 8
(tiles fixed in its source) are not tuned, as JAX tunes the dequant
matmuls only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .ops import dequant_matmul as dm
from .ops import resolve_device

TABLE_PATH = dm.TUNED_PLANS
VALIDATE_SPREAD = 0.10  # a second timing of the winner within 10%


def model_shapes(cfg):
    """The (k, n) of a model's quantized matmuls: wqkv, wo, w_in, w_out
    and the lm head (JAX's ``model_shapes``)."""
    H, F = cfg.hidden_size, cfg.intermediate_size
    d, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    gated = cfg.act == "silu_gated"
    return sorted({
        (H, (nh + 2 * nkv) * d),
        (nh * d, H),
        (H, 2 * F if gated else F),
        (F, H),
        (H, cfg.vocab_size),
    })


def time_ms(fn: Callable[[], object], flush: torch.Tensor, reps: int) -> float:
    """Mean device time of fn over reps launches (CUDA events). Before
    each launch a pass over `flush` evicts the 50 MB L2, and a ~1 ms device
    spin keeps the device busy while the host enqueues fn, so the events
    hold no host time. The flush READS the buffer: a write would leave the
    L2 full of dirty lines whose write-back slows the timed kernel."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.sum()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def plan_candidates(kernel: str, fmt: str, dtype: torch.dtype, m: int, K: int) -> List[tuple]:
    """Every distinct launch plan the kernel's body takes at m rows over
    stored K. Streaming GEMVs: (columns, parts, stages a part) for every
    split count stream_plan weighs. Tiled bodies: (m tile, parts, stages a
    part) for every split count up to MAX_SPLITS, at each compiled m tile
    that holds m or is at least half of it (and the widest)."""
    how, steps, widths, _ = dm.plan_geometry(kernel, fmt, dtype, m, K)
    out = []
    if how == "stream":
        for s in range(-(-steps // dm.STREAM_MAX_PER), min(steps, dm.STREAM_MAX_PARTS) + 1):
            per = -(-steps // s)
            plan = (dm.STREAM_COLS, -(-steps // per), per)
            if plan not in out:
                out.append(plan)
        return out
    for mt in widths:
        if mt < m and mt != widths[-1] and 2 * mt < m:
            continue
        for s in range(1, min(steps, dm.MAX_SPLITS) + 1):
            per = -(-steps // s)
            plan = (mt, -(-steps // per), per)
            if plan not in out:
                out.append(plan)
    return out


@contextlib.contextmanager
def forced_plan(plan: tuple):
    """Every wrapper launches under `plan` inside the context (the
    launch_plan of ops/dequant_matmul.py replaced for its duration)."""
    saved = dm.launch_plan
    dm.launch_plan = lambda *a, **kw: tuple(plan)
    try:
        yield
    finally:
        dm.launch_plan = saved


class Case:
    """One kernel call of a sweep: a stack of two random quantized copies
    of a (k, n) weight on the card (read at layer 1, at a pointer offset as
    the layer-stacked path reads it), x [m, stored K] from the same
    generator, and the plain version's output on the same inputs."""

    def __init__(self, spec, k: int, n: int, m: int, gen: torch.Generator):
        from .quant import pad_quantized_groups, quantize
        from .quant.groupwise import torch_dtype

        qts = [pad_quantized_groups(quantize(
            torch.randn((k, n), generator=gen, device="cuda") * 0.02, spec)) for _ in range(2)]
        one = qts[-1]
        self.spec, self.m = spec, m
        self.kernel = dm.route(spec, one.n_groups, m)
        self.fmt = dm.plan_format(self.kernel, spec)
        rows, self.N = one.data.shape
        self.K = rows if spec.storage == "i8" else rows * spec.elems_per_word
        self.dtype = torch_dtype(spec.dtype)
        self.data = torch.stack([q.data for q in qts])
        self.scale = torch.stack([q.scale for q in qts])
        self.zero = None if one.zero is None else torch.stack([q.zero for q in qts])
        self.x = torch.zeros((m, self.K), dtype=self.dtype, device="cuda")
        self.x[:, :k] = torch.randn((m, k), generator=gen, device="cuda").to(self.dtype)
        self.extra = ((spec,) if self.kernel == "gemm_plane"
                      else (spec.layout,) if self.kernel in ("gemm_pairs", "gemv_gp") else ())
        if self.kernel != "dense":
            zone = () if self.kernel == "gemv_gp3" else (one.zero,)
            self.want = getattr(dm, self.kernel + "_plain")(
                self.x, one.data, one.scale, *zone, *self.extra, self.dtype)

    def key(self) -> str:
        return dm.plan_key(self.kernel, self.fmt, self.dtype, self.m, self.K, self.N)

    def run(self):
        zarg = () if self.kernel == "gemv_gp3" else (self.zero,)
        return getattr(dm, self.kernel)(self.x, self.data, self.scale, *zarg, *self.extra,
                                        layer=1, out_dtype=self.dtype)

    def check(self) -> bool:
        """The call against the plain version: 1e-2, f32 atol 1e-4 rtol 1e-3."""
        tol = (dict(atol=1e-4, rtol=1e-3) if self.dtype == torch.float32
               else dict(atol=1e-2, rtol=1e-2))
        return torch.allclose(self.run().float(), self.want.float(), **tol)


def sweep_case(case: Case, flush: torch.Tensor, reps: int,
               log: Optional[Callable[[dict], None]] = None) -> List[dict]:
    """Every candidate plan of one case, checked and timed: one row each
    (plan, ms, ok, whether the time models pick it)."""
    pick = dm.model_plan(case.kernel, case.fmt, case.dtype, case.m, case.K, case.N)
    plans = plan_candidates(case.kernel, case.fmt, case.dtype, case.m, case.K)
    rows = []
    for plan in plans + ([pick] if pick not in plans else []):
        with forced_plan(plan):
            ok = case.check()
            ms = time_ms(case.run, flush, reps)
        row = dict(kernel=case.kernel, format=case.fmt, dtype=str(case.dtype).split(".")[-1],
                   k=case.K, n=case.N, m=case.m, mt=plan[0], parts=plan[1], per=plan[2],
                   ms=ms, ok=ok, picked=plan == pick)
        rows.append(row)
        if log is not None:
            log(row)
    return rows


def table_entry(case: Case, rows: List[dict], flush: torch.Tensor, reps: int) -> Optional[dict]:
    """The table entry of a swept case: the fastest plan that agrees with
    the plain version, timed again (validated when the two timings are
    within VALIDATE_SPREAD), the runner-up, and the time models' pick with
    its time. None when no plan agreed."""
    good = sorted((r for r in rows if r["ok"]), key=lambda r: r["ms"])
    if not good:
        return None
    best = good[0]
    plan = (best["mt"], best["parts"], best["per"])
    with forced_plan(plan):
        again = time_ms(case.run, flush, reps)
    picked = next(r for r in rows if r["picked"])
    runner = good[1] if len(good) > 1 else None
    return {
        "plan": list(plan),
        "us": 1e3 * min(best["ms"], again),
        "validated": abs(again - best["ms"]) <= VALIDATE_SPREAD * min(again, best["ms"]),
        "runner_up": None if runner is None else [runner["mt"], runner["parts"], runner["per"]],
        "runner_up_us": None if runner is None else 1e3 * runner["ms"],
        "model_plan": [picked["mt"], picked["parts"], picked["per"]],
        "model_us": 1e3 * picked["ms"],
        "model_ok": picked["ok"],
    }


def card_header() -> dict:
    """The card a table is written on: name and power limit (nvidia-smi),
    torch and CUDA versions."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    return {"card": torch.cuda.get_device_name(), "power_limit": smi.split(",")[-1].strip(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def write_table(path: str, header: dict, plans: Dict[str, dict]) -> None:
    """Merge plans into the table at path (entries of a table written on
    another card are dropped), written to a temporary file and moved."""
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
        if table["header"].get("card") == header["card"]:
            old = table["plans"]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"header": header, "plans": {**old, **plans}}, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def tune_shapes(shapes: Sequence[tuple], quant: str = "q4bf16", ms: Sequence[int] = (1,),
                reps: int = 20, out: Optional[str] = None,
                log: Optional[Callable[[dict], None]] = None) -> Dict[str, dict]:
    """Sweep every (k, n) of `shapes` at every m of `ms` in preset `quant`
    on the card: returns {plan key: entry} and, with `out`, merges the
    entries into that table after each case. Cases the JAX dispatch sends
    to the dense product have no plan and are skipped. Raises without a
    card."""
    from .quant import resolve_spec

    resolve_device("cuda")
    spec = resolve_spec(quant)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    header = card_header() if out else None
    table = {}
    for k, n in shapes:
        for m in ms:
            case = Case(spec, k, n, m, gen)
            if case.kernel == "dense":
                continue
            entry = table_entry(case, sweep_case(case, flush, reps, log), flush, reps)
            if entry is not None:
                table[case.key()] = entry
                if out:
                    write_table(out, header, {case.key(): entry})
            del case
            torch.cuda.empty_cache()
    return table


def main(argv=None):
    ap = argparse.ArgumentParser("mlc_llm_tpu_torch.tune")
    ap.add_argument("--model", default="vicuna-v1-7b")
    ap.add_argument("--quant", "--quantization", dest="quant", default="q4bf16")
    ap.add_argument("--m", type=int, action="append", default=None,
                    help="rows to tune at (repeat; default 1)")
    ap.add_argument("--reps", type=int, default=20, help="timed launches of each plan")
    ap.add_argument("-o", "--out", default=TABLE_PATH)
    args = ap.parse_args(argv)

    from .models import get_config

    cfg = get_config(args.model)
    table = tune_shapes(model_shapes(cfg), args.quant, tuple(args.m or (1,)), args.reps,
                        out=args.out, log=lambda r: print(json.dumps(r), flush=True))
    for key, e in sorted(table.items()):
        print(json.dumps(dict(key=key, **e)))
    print(f"wrote {len(table)} entries to {args.out}", file=sys.stderr)
    return table


if __name__ == "__main__":
    main()
