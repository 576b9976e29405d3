"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python scripts/torch_decode_profile.py [--model vicuna-v1-7b] [--layers 32]
        [--tokens 16] [--batch 1] [--prompt-len 64] [--kv-layout slot|paged]
        [--kv-dtype bf16|int8] [--quantization q4bf16|q3bf16_s16|q4f32|q4f16_hs|...]

Builds --model (default Vicuna-7B; e.g. RedPajama-INCITE-Chat-3B-v1 with
q4f32, dolly-v2-3b with q4f16_hs) on random weights (full width; --layers
cuts the depth) in the --quantization preset (default q4bf16), prefills --batch prompts
of --prompt-len tokens, then runs greedy decode under torch.profiler and
prints: host wall ms per decode step (profiler off), device kernel ms per
step (the sum of CUDA kernel self times, the prefill's own profile
subtracted), the device idle share, kernel launches per step beside the
decode graph's replays per step (each decode step replays one captured
CUDA graph; the kernels it launches are counted as the profiler reports
them), the graphs captured with their capture seconds and the graph
pool's bytes, the kernels ranked by device time, and the decode step's
own split by kernel. A step yields --batch tokens. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine  # noqa: E402
from mlc_llm_tpu_torch.models import get_config, init_random_params  # noqa: E402


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vicuna-v1-7b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--kv-layout", default="slot", choices=("slot", "paged"))
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"))
    ap.add_argument("--quantization", default="q4bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cfg = get_config(args.model).replace(num_layers=args.layers)
    params = init_random_params(cfg, args.quantization, seed=0, device="cuda")
    engine = InferenceEngine(cfg, params, max_batch=args.batch,
                             max_seq_len=max(1536, args.prompt_len + args.tokens + 1),
                             kv_layout=args.kv_layout,
                             cache_dtype=torch.int8 if args.kv_dtype == "int8" else torch.bfloat16,
                             device="cuda")
    prompt = [[cfg.bos_token_id] + [3 + (b + i) % 30000 for i in range(args.prompt_len - 1)]
              for b in range(args.batch)]
    gen = GenerationConfig(max_new_tokens=args.tokens, temperature=0.0, stop_tokens=())
    cfg_stops = engine.cfg.stop_tokens
    engine.cfg = cfg.replace(stop_tokens=())  # decode the full count
    engine.generate(prompt, gen)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    engine.stats.reset()
    engine.generate(prompt, gen)
    plain_wall = engine.stats.decode_time * 1e3 / (engine.stats.decode_tokens / args.batch)

    def profiled(fn):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages() if _device_us(e) > 0
                and str(getattr(e, "device_type", "")).endswith("CUDA")]

    pre = profiled(lambda: engine.prefill(prompt, reserve_tokens=args.tokens))
    engine.stats.reset()
    replays = engine.programs.replays
    both = profiled(lambda: engine.generate(prompt, gen))
    replays = engine.programs.replays - replays
    engine.cfg = engine.cfg.replace(stop_tokens=cfg_stops)
    steps = engine.stats.decode_tokens // args.batch
    pre_ms = sum(_device_us(e) for e in pre) / 1e3
    dec_ms = (sum(_device_us(e) for e in both) / 1e3 - pre_ms) / steps
    dec_launches = (sum(e.count for e in both) - sum(e.count for e in pre)) / steps
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(f"{args.model} {args.quantization}, batch {args.batch}, {args.kv_layout} {args.kv_dtype} KV, "
          f"prompt {args.prompt_len}")
    print(f"decode without the profiler: {plain_wall:.3f} ms/step "
          f"({1e3 * args.batch / plain_wall:.2f} tok/s)")
    print(f"decode device kernel time: {dec_ms:.3f} ms/step, {dec_launches:.1f} "
          f"launches/step, {replays / steps:.2f} graph replays/step -> device idle share "
          f"{1 - dec_ms / plain_wall:.4f}")
    secs = engine.programs.capture_seconds()
    print(f"decode graphs: {engine.programs.count} captured "
          f"({', '.join(f'window {k[2]}: {v:.3f} s' for k, v in sorted(secs.items()))}), "
          f"graph pool {engine.programs.pool_bytes()} bytes")
    print(f"prefill ({args.batch} x {args.prompt_len} tokens) device kernel time: "
          f"{pre_ms:.3f} ms")
    print("kernels by device time, prefill + decode window (ms total, count):")
    for e in sorted(both, key=_device_us, reverse=True)[:15]:
        print(f"  {_device_us(e) / 1e3:9.3f}  {e.count:6d}  {e.key[:90]}")
    # the decode window alone: the prefill's profile subtracted per kernel
    pre_by = {e.key: (_device_us(e), e.count) for e in pre}
    per_step = sorted(((_device_us(e) - pre_by.get(e.key, (0, 0))[0]) / 1e3 / steps,
                       (e.count - pre_by.get(e.key, (0, 0))[1]) / steps, e.key) for e in both)
    print("decode kernels by device time (ms/step, launches/step):")
    for ms, n, key in per_step[::-1][:10]:
        print(f"  {ms:9.4f}  {n:7.1f}  {key[:90]}")


if __name__ == "__main__":
    main()
