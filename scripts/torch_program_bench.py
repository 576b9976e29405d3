"""Times of the engine's programs on one GPU: admissions, sampled steps,
K-step blocks, serving and precompile, graph against eager.

    python scripts/torch_program_bench.py [--tree DIR] [--label NAME] [--layers 32]
        [--quant q4bf16] [--prefill-tokens 1000,1500]
        [--only admission,slot_prefill,b1_step,k_block,serve,kernel8] [--out FILE]

Imports ``mlc_llm_tpu_torch`` from --tree (default: this checkout), so
that one call can time two commits in turns (``git archive`` the other
into a gitignored directory). Full-width Vicuna-7B on random weights
(seed 0) in --quant (q4bf16; q4f32 computes in f32, so kernel 8 runs its
f32 body; --layers cuts the depth). Sections, each where the tree has
what it needs:

- admission: a 1000-token prompt (bucket 1024, window 1024) admitted
  into slot 0 of a paged b8 engine (``_prefill_slot``, the server's
  admission), and the same prompt through ``prefill`` on a b1 slot engine
  (the chat's), each as a graph (the tree's runner) and eagerly (the
  program runner swapped for a direct call) where the tree has programs:
  host wall (median of 5, synchronized), device kernel time (torch.profiler
  over 3 runs) and the device idle share, 1 - device / wall; and the
  graph admission's costliest kernels;
- slot_prefill: a prompt of each --prefill-tokens length (1000 and 1500:
  buckets 1024 and 2048, the reset prefill's flash buckets on trees with
  kernel 8) through
  ``prefill`` on a fresh b1 slot engine (max_seq_len 2048) each, as a
  graph: host wall, device time, idle share, the graph pool's bytes (the
  one prefill graph's) and the costliest kernels;
- b1_step: a 64-token prompt, then 64 new tokens at T 0.7, top-p 0.95,
  seed 0 and greedy, on a b1 slot engine: the decode step's wall (a
  second run), device time a step and idle share;
- k_block: (trees with the K-step program) 8 active slots of a paged b8
  engine at about 1024 tokens: one K-step block (K = 2, 4) against K
  single steps, wall and device time a decode forward, sampled rows
  included;
- kernel8: the reset prefill's flash attention (``ops.attention.
  flash_prefill``) at chip_smoke.py's FLASH_CASES shapes, bf16, f16 and
  f32 (q, k and v the
  strided views of one [B, S, (hq + 2 hkv) D] projection), beside causal
  scaled_dot_product_attention on the same views (the yardstick; the port
  never calls it): CUDA-event mean ms with the L2 flushed before each
  launch, as chip_smoke.py times kernels, and TFLOP/s of the causal half;
  no weights needed;
- serve: 16 requests (prompts of 16-1500 tokens from seed 2, 32 new
  tokens, every fourth at T 0.7) through the in-process scheduler on a
  paged b8 engine, precompiled first (its seconds, graphs and pool bytes),
  the second run timed: wall, aggregate tok/s, step wall, prefill seconds,
  TTFT p50/p99, then a third under torch.profiler for the idle share.

Prints one JSON line (the card's name and power limit in it), also
written to --out when given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernels(fn):
    """fn's CUDA kernels under torch.profiler: [(device us, count, name)]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0),
             e.count, e.key) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def _device_ms(fn) -> float:
    """Device time of fn's CUDA kernels: the sum of their self times."""
    return sum(us for us, _, _ in _kernels(fn)) / 1e3


def _top(fn, n=12):
    """fn's n costliest kernels: [ms, launches, name]."""
    return [[us / 1e3, c, k[:80]] for us, c, k in sorted(_kernels(fn), reverse=True)[:n]]


def _wall_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _eager(engine):
    engine.programs.run = lambda key, fn, warm_up: fn()


def _timed(fn, reps=5, prof_reps=3):
    fn()  # capture / first use
    wall = _wall_ms(fn, reps)
    dev = _device_ms(lambda: [fn() for _ in range(prof_reps)]) / prof_reps
    return dict(wall_ms=wall, device_ms=dev, idle_share=1 - dev / wall)


def admission(cfg, params, Engine, has_programs):
    out = {}
    prompt = [int(t) for t in np.random.default_rng(0).integers(3, cfg.vocab_size, 1000)]
    toks = np.zeros((1, 1024), np.int64)
    toks[0, :1000] = prompt
    modes = ("graph", "eager") if has_programs else ("eager",)
    for mode in modes:
        eng = Engine(cfg, params, max_batch=8, max_seq_len=2048, kv_layout="paged",
                     page_size=128, device="cuda")
        if mode == "eager" and has_programs:
            _eager(eng)
        eng.assign_pages(0, eng.pages_needed(0, 1000 + 33))
        admit = lambda: eng._prefill_slot(toks, 1000, 0, False, attn_window=1024)  # noqa: E731
        out[f"paged_b8_{mode}"] = _timed(admit)
        if mode == "graph":
            out["paged_b8_graph"].update(pool_bytes=eng.programs.pool_bytes(),
                                         top_kernels=_top(admit))
        del eng
        eng = Engine(cfg, params, max_batch=1, max_seq_len=1536, device="cuda")
        if mode == "eager" and has_programs:
            _eager(eng)
        out[f"slot_b1_{mode}"] = _timed(lambda: eng.prefill([prompt]))
        del eng
        torch.cuda.empty_cache()
    return out


def slot_prefill(cfg, params, Engine, lengths):
    out = {}
    for n in lengths:
        prompt = [int(t) for t in np.random.default_rng(n).integers(3, cfg.vocab_size, n)]
        eng = Engine(cfg, params, max_batch=1, max_seq_len=2048, device="cuda")
        run = lambda: eng.prefill([prompt])  # noqa: E731
        out[f"tokens_{n}"] = dict(_timed(run), pool_bytes=eng.programs.pool_bytes(),
                                  top_kernels=_top(run))
        del eng
        torch.cuda.empty_cache()
    return out


def b1_step(cfg, params, Engine, GenerationConfig):
    out = {}
    prompt = [[cfg.bos_token_id] + [3 + i for i in range(63)]]
    for name, temp in (("sampled", 0.7), ("greedy", 0.0)):
        eng = Engine(cfg, params, max_batch=1, max_seq_len=1536, device="cuda")
        eng.cfg = cfg.replace(stop_tokens=())  # decode the full count
        gen = GenerationConfig(max_new_tokens=64, temperature=temp, top_p=0.95, seed=0)
        eng.generate(prompt, gen)  # capture
        eng.stats.reset()
        eng.generate(prompt, gen)
        steps = eng.stats.decode_tokens
        wall = eng.stats.decode_time / steps * 1e3
        pre = _device_ms(lambda: eng.prefill(prompt))
        both = _device_ms(lambda: eng.generate(prompt, gen))
        dev = (both - pre) / steps
        out[name] = dict(step_wall_ms=wall, step_device_ms=dev, idle_share=1 - dev / wall,
                         steps=steps)
        del eng
        torch.cuda.empty_cache()
    return out


def k_block(cfg, params, Engine):
    eng = Engine(cfg, params, max_batch=8, max_seq_len=2048, kv_layout="paged", page_size=128,
                 device="cuda")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, 1000 + 3 * b)] for b in range(8)]
    eng.prefill(prompts, reserve_tokens=64)
    active = np.ones(8, bool)
    seeds = np.arange(8) + 100
    temps = np.where(np.arange(8) % 4 == 3, 0.7, 0.0).astype(np.float32)
    tok = torch.full((8, 1), 5, dtype=torch.int64, device="cuda")
    window = 2048
    lengths = eng.cache.lengths.clone()
    out = {}

    def rewind():  # every run decodes from the same lengths
        eng.cache.lengths.copy_(lengths)

    def single(k):
        rewind()
        cur = tok
        for i in range(k):
            cur = eng._decode_sample(cur, active, seeds, np.full(8, i), temps, 0.95,
                                     attn_window=window)[:, None]

    def block(k):
        rewind()
        eng._decode_sample_k(tok, active, seeds, np.zeros(8, np.int64), temps, 0.95,
                             attn_window=window, k_steps=k)

    for k in (2, 4):
        for name, fn in ((f"block_k{k}", lambda k=k: block(k)),
                         (f"single_x{k}", lambda k=k: single(k))):
            t = _timed(fn)
            out[name] = dict(t, wall_ms_per_forward=t["wall_ms"] / k,
                             device_ms_per_forward=t["device_ms"] / k)
    out["pool_bytes"] = eng.programs.pool_bytes()
    return out


def _event_ms(fn, flush, reps=20) -> float:
    """Mean device ms of fn over reps launches (CUDA events), each after a
    read of `flush` (evicts the 50 MB L2) and a ~1 ms device spin that keeps
    the enqueue off the clock."""
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


def kernel8(get_config):
    from mlc_llm_tpu_torch.ops import attention as att

    moss = get_config("moss-moon-003-sft")
    # chip_smoke.py's FLASH_CASES: (label, B, query heads, kv-heads, S, D, dtype)
    cases = [("vicuna", 1, 32, 32, 1024, 128, torch.bfloat16),
             ("vicuna", 1, 32, 32, 2048, 128, torch.bfloat16),
             ("vicuna G=2", 2, 32, 32, 1024, 128, torch.bfloat16),
             ("vicuna", 1, 32, 32, 1024, 128, torch.float16),
             ("moss", 1, moss.num_heads, moss.num_kv_heads, 1024, moss.head_dim, torch.bfloat16),
             ("vicuna", 1, 32, 32, 1024, 128, torch.float32),
             ("vicuna", 1, 32, 32, 2048, 128, torch.float32),
             ("vicuna G=2", 2, 32, 32, 1024, 128, torch.float32),
             ("moss", 1, moss.num_heads, moss.num_kv_heads, 1024, moss.head_dim, torch.float32)]
    torch.backends.cuda.matmul.allow_tf32 = False  # SDPA in f32 as chip_smoke.py times it
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for label, B, hq, hkv, S, D, dt in cases:
        qkv = torch.randn((B, S, (hq + 2 * hkv) * D), generator=gen, device="cuda").to(dt)
        q, k, v = (t.reshape(B, S, -1, D).transpose(1, 2)
                   for t in qkv.split([hq * D, hkv * D, hkv * D], dim=-1))
        ms = _event_ms(lambda: att.flash_prefill(q, k, v), flush)
        sdpa = _event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), flush)
        out.append(dict(case=f"{label} b{B} S{S} D{D} {str(dt).replace('torch.', '')}", ms=ms,
                        sdpa_ms=sdpa, tflops=2 * B * hq * S * S * D / (ms * 1e-3) / 1e12,
                        vs_sdpa=ms / sdpa))
        del qkv, q, k, v
    return out


def serve(cfg, params, Engine, GenerationConfig, Scheduler, has_programs):
    rng = np.random.default_rng(2)
    work = []
    for i in range(16):
        k = int(rng.integers(16, 1501))
        work.append(([int(t) for t in rng.integers(3, cfg.vocab_size, k)],
                     GenerationConfig(max_new_tokens=32, temperature=0.7 if i % 4 == 3 else 0.0,
                                      top_p=0.95, seed=i)))
    eng = Engine(cfg, params, max_batch=8, max_seq_len=2048, kv_layout="paged", page_size=128,
                 device="cuda")
    t0 = time.perf_counter()
    n = eng.precompile(multi_step=(2, 4)) if has_programs else eng.precompile()
    out = dict(precompile_s=time.perf_counter() - t0, precompiled=n,
               precompile_pool_bytes=eng.programs.pool_bytes())

    def run():
        sched = Scheduler(eng, seed=0)
        t_sub = time.perf_counter()
        reqs = [sched.submit(p, g) for p, g in work]
        sched.run()
        return reqs, t_sub

    run()  # the first run: kernels' first use, any graph not precompiled
    count = eng.programs.count
    eng.stats.reset()
    t0 = time.perf_counter()
    reqs, t_sub = run()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in reqs)
    ttft = sorted((r.first_token_at - t_sub) * 1e3 for r in reqs)
    st = eng.stats
    dev = _device_ms(run)
    out.update(wall_s=wall, tokens=tokens, aggregate_tok_s=tokens / wall,
               decode_tok_s=st.decode_tokens / st.decode_time,
               prefill_s=st.prefill_time, ttft_p50_ms=float(np.percentile(ttft, 50)),
               ttft_p99_ms=float(np.percentile(ttft, 99)), device_ms=dev,
               idle_share=1 - dev / (wall * 1e3), graphs_after_warm_run=count,
               graphs_captured_in_timed_runs=eng.programs.count - count)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="change")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--quant", default="q4bf16")
    ap.add_argument("--prefill-tokens", default="1000,1500",
                    help="slot_prefill's prompt lengths, comma-separated")
    ap.add_argument("--only", default="admission,slot_prefill,b1_step,k_block,serve")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
    from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
    from mlc_llm_tpu_torch.models import get_config, init_random_params

    has_programs = hasattr(InferenceEngine, "precompile_keys")
    cfg = get_config("vicuna-v1-7b").replace(num_layers=args.layers)
    only = args.only.split(",")
    params = (init_random_params(cfg, args.quant, seed=0, device="cuda")
              if set(only) - {"kernel8"} else None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    res = dict(label=args.label, card=card, layers=args.layers, quant=args.quant,
               programs=has_programs)
    for name in only:
        t0 = time.perf_counter()
        if name == "kernel8":
            res[name] = kernel8(get_config)
        elif name == "admission":
            res[name] = admission(cfg, params, InferenceEngine, has_programs)
        elif name == "slot_prefill" and has_programs:
            res[name] = slot_prefill(cfg, params, InferenceEngine,
                                     [int(n) for n in args.prefill_tokens.split(",")])
        elif name == "b1_step":
            res[name] = b1_step(cfg, params, InferenceEngine, GenerationConfig)
        elif name == "k_block" and has_programs:
            res[name] = k_block(cfg, params, InferenceEngine)
        elif name == "serve":
            res[name] = serve(cfg, params, InferenceEngine, GenerationConfig,
                              ContinuousBatchingScheduler, has_programs)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
