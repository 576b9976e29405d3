"""Speculative against plain greedy decode on the port, batch 1.

The counterpart of scripts/spec_bench.py. Vicuna-7B q4bf16 at full
width and depth on random weights (seed 0), bf16 slot KV, max_seq_len
512: the repetitive motif prompt of spec_bench.py (or an arbitrary one)
through generate_speculative at K = 8, and through the plain
generate, whose every decode step replays one CUDA graph, then the best
case: a drafter that replays the speculative stream, so every draft the
verify pass agrees with is accepted. Each path runs once to capture its
graphs, then once timed. Prints one JSON line: the wall tok/s of each
(prefill included), passes, accepted drafts, tokens a pass, the wall of a verify
pass and of a plain step, the device ms of a pass and of a step split
into the quantized matmuls and the rest, with the idle share of each
(torch.profiler over a third run), the match length against the plain
stream, the host round trip that the RTT gate times beside its
threshold, and the card's name and power limit.

  python scripts/torch_spec_bench.py                       # on the GPU
  python scripts/torch_spec_bench.py --prompt arbitrary
  python scripts/torch_spec_bench.py --cpu                 # 2 layers, CPU
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine  # noqa: E402
from mlc_llm_tpu_torch.engine import speculative  # noqa: E402
from mlc_llm_tpu_torch.engine.speculative import generate_speculative  # noqa: E402
from mlc_llm_tpu_torch.models import get_config, init_random_params  # noqa: E402

MOTIF = [311, 42, 87, 1009, 55, 7, 66, 23]


class ReplayDrafter(speculative.NgramDrafter):
    """Proposes the next tokens of a recorded stream of the same prompt:
    the best case, every draft the verify pass agrees with accepted."""

    prompt_len, ref = 0, []

    def propose(self, k):
        n = len(self.history) - self.prompt_len
        return list(self.ref[n:n + k])


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# the hand-written quantized matmuls: the wgmma mainloop, the m = 1
# streaming GEMV and the split-K reduce
MATMUL_KERNELS = ("gemm_kernel", "stream_kernel", "reduce_kernel")


def device_split(fn, passes: int) -> dict:
    """fn's CUDA kernel self times under torch.profiler, a pass (or step)
    each: all of them, the quantized matmuls', the rest's, and the five
    other kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0), e.count)
            for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    mm = sum(us for key, us, _ in rows if any(k in key for k in MATMUL_KERNELS))
    total = sum(us for _, us, _ in rows)
    other = sorted((r for r in rows if not any(k in r[0] for k in MATMUL_KERNELS)),
                   key=lambda r: -r[1])
    return {"device_ms": total / 1e3 / passes, "matmul_ms": mm / 1e3 / passes,
            "other_ms": (total - mm) / 1e3 / passes,
            "launches": sum(n for _, _, n in rows) / passes,
            "top_other": [[key[:60], us / 1e3 / passes] for key, us, _ in other[:5]]}


def rtt_ms(device) -> float:
    """The host round trip rtt_gate_ok measures: a trivial op on the
    device and its readback, the mean of three after one untimed."""
    x = torch.zeros((), dtype=torch.float32, device=device)
    (x + 1).item()
    t0 = time.perf_counter()
    for i in range(3):
        (x + i).item()
    return (time.perf_counter() - t0) / 3 * 1e3


def timed(eng, fn, sync):
    """(fn's result, its wall s, the engine's decode clock s: the wall
    after the prefill)."""
    eng.stats.reset()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0, eng.stats.decode_time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vicuna-v1-7b")
    ap.add_argument("--quant", default="q4bf16")
    ap.add_argument("--new-tokens", type=int, default=128)
    ap.add_argument("--draft-k", type=int, default=8)
    ap.add_argument("--prompt", choices=("motif", "arbitrary"), default="motif")
    ap.add_argument("--cpu", action="store_true", help="2 layers on the CPU")
    args = ap.parse_args()

    # the bench measures the speculative path whatever the RTT gate says
    os.environ.setdefault("MLC_SPEC_FORCE", "1")
    device = "cpu" if args.cpu else "cuda"
    cfg = get_config(args.model)
    if args.cpu:
        cfg = cfg.replace(num_layers=2)
    params = init_random_params(cfg, args.quant, seed=0, device=device)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq_len=min(cfg.max_seq_len, 512),
                          device=device)
    eng.cfg = cfg.replace(stop_tokens=())  # decode the full count
    if args.prompt == "motif":
        prompt = (MOTIF * 8)[:64]
    else:
        prompt = [int(t) for t in np.random.default_rng(1).integers(3, cfg.vocab_size, 64)]
    gen = GenerationConfig(max_new_tokens=args.new_tokens, temperature=0.0)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def plain_run():
        return eng.generate([prompt], gen)[0]

    stats = {}

    def spec_run():
        return generate_speculative(eng, prompt, max_new_tokens=args.new_tokens,
                                    draft_k=args.draft_k, stats=stats)

    plain_run(), spec_run()  # capture every graph of both paths
    plain, t_plain, d_plain = timed(eng, plain_run, sync)
    verify0 = eng.verify_forwards
    spec, t_spec, d_spec = timed(eng, spec_run, sync)
    passes = eng.verify_forwards - verify0
    res = {
        "metric": "speculative_greedy_b1", "model": cfg.name, "quant": args.quant,
        "layers": cfg.num_layers, "device": device, "card": card(), "prompt": args.prompt,
        "draft_k": args.draft_k, "tokens": len(spec),
        "plain_tok_s": len(plain) / t_plain, "spec_tok_s": len(spec) / t_spec,
        "speedup": t_plain / t_spec,
        "passes": stats["passes"], "verify_runs": passes,
        "accepted_drafts": stats["accepted_drafts"],
        "tokens_per_pass": (len(spec) - 1) / max(stats["passes"], 1),
        "verify_pass_ms": d_spec / max(passes, 1) * 1e3,
        "plain_step_ms": d_plain / max(len(plain) - 1, 1) * 1e3,
        "greedy_match": spec == plain,
        "match_prefix_tokens": next((i for i, (a, b) in enumerate(zip(spec, plain)) if a != b),
                                    min(len(spec), len(plain))),
        "graphs": eng.programs.count, "replays": eng.programs.replays,
        "rtt_ms": rtt_ms(eng.device),
        "rtt_gate_ms": float(os.environ.get("MLC_SPEC_RTT_GATE_MS", "2.0")),
    }
    # the best case: a drafter that replays the speculative stream
    ReplayDrafter.prompt_len, ReplayDrafter.ref = len(prompt), spec
    speculative.NgramDrafter, lookup = ReplayDrafter, speculative.NgramDrafter
    try:
        rstats = {}
        generate_speculative(eng, prompt, max_new_tokens=args.new_tokens, draft_k=args.draft_k)
        replay, t_replay, d_replay = timed(eng, lambda: generate_speculative(
            eng, prompt, max_new_tokens=args.new_tokens, draft_k=args.draft_k, stats=rstats),
            sync)
    finally:
        speculative.NgramDrafter = lookup
    res.update(replay_tok_s=len(replay) / t_replay, replay_passes=rstats["passes"],
               replay_tokens_per_pass=(len(replay) - 1) / max(rstats["passes"], 1),
               replay_pass_ms=d_replay / max(rstats["passes"], 1) * 1e3,
               replay_match_spec=replay == spec)
    if device == "cuda":
        # a decode step or a verify pass each (the prefill's kernels, one
        # a run, ride along in both)
        steps = max(len(plain) - 1, 1)
        res["plain_step_device"] = device_split(plain_run, steps)
        res["spec_pass_device"] = device_split(spec_run, max(passes, 1))
        res["plain_idle_share"] = 1 - res["plain_step_device"]["device_ms"] * steps / (
            t_plain * 1e3)
        res["spec_idle_share"] = 1 - res["spec_pass_device"]["device_ms"] * max(passes, 1) / (
            t_spec * 1e3)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
