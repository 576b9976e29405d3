"""Performance evaluation and per-op profile, the counterpart of
``mlc_llm_tpu/evaluate.py``.

One prefill of ``--prompt-len`` tokens and ``--gen-len`` sampled decode
steps (T 0.7, top-p 0.95) at batch 1 on the slot cache, and with
``--profile`` a table of the decode path's hot ops: the four layer
matmuls of layer 0 at m = 1, the lm head, one layer's decode attention
at ``--prompt-len`` and top-p sampling. GB/s is the op's stored weight
(or K/V) bytes over its time.

On the card every time comes from CUDA events after a warm-up; each
profiled op is timed with the 50 MB L2 flushed before each launch (a
256 MB read) and a device spin while the host enqueues it, so its events
hold no host time. The prefill and decode times hold whatever the host
adds between launches (the decode loop samples on the device and never
waits for it). On the CPU the times are the host clock's.

Usage:
  python -m mlc_llm_tpu_torch.evaluate --model vicuna-v1-7b --random --profile
  python -m mlc_llm_tpu_torch.evaluate --model vicuna-v1-7b --weights dist/v7b --profile
  python -m mlc_llm_tpu_torch.evaluate --model tiny-llama --random --device cpu \\
      --prompt-len 16 --gen-len 4 --max-seq-len 64 --profile
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Tuple

import numpy as np
import torch


class Timer:
    """Milliseconds of a callable's work on one device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.flush = None
        if device.type == "cuda":
            self.flush = torch.ones(64 * 2**20, dtype=torch.float32, device=device)

    def span(self, fn: Callable[[], object]):
        """(ms, result) of one call of fn, start to end (CUDA events, or
        the host clock on the CPU); nothing flushed."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t0) * 1e3, out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end), out

    def op(self, fn: Callable[[], object], reps: int) -> float:
        """Mean ms of fn over reps launches after one warm-up; on the card
        the L2 is flushed and the device kept busy before each launch."""
        fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize(self.device)
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
        for start, end in ev:
            self.flush.sum()
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(self.device)
        return sum(s.elapsed_time(e) for s, e in ev) / reps


def _compute_dtype(w, fallback):
    from .quant.groupwise import QuantizedTensor, torch_dtype

    return torch_dtype(w.spec.dtype) if isinstance(w, QuantizedTensor) else fallback


def profile_ops(cfg, params, max_len: int, ctx_len: int, timer: Timer,
                reps: int = 20) -> List[Tuple[str, float, float]]:
    """Per-op (name, ms, GB/s) rows of the decode path's hot ops (params
    group-padded, as the engine holds them)."""
    from .models.transformer import init_kv_cache, param_bytes
    from .ops.attention import attend_cache
    from .ops.matmul import qmatmul
    from .ops.sampling import sample_token
    from .quant.groupwise import QuantizedTensor

    dev = timer.device
    act = params["final_ln"]["w"].dtype
    rows = []
    for name in ("wqkv", "wo", "w_in", "w_out"):
        w = params["layers"].get(name)
        if w is None:
            continue
        w = w.map(lambda t: t[0]) if isinstance(w, QuantizedTensor) else w[0]
        x = torch.full((1, w.shape[0]), 0.01, dtype=_compute_dtype(w, act), device=dev)
        ms = timer.op(lambda w=w, x=x: qmatmul(x, w), reps)
        rows.append((f"dequant_matmul[{name}]", ms, param_bytes(w) / ms / 1e6))

    lm = params["lm_head"]["w"]
    head_dtype = torch.float32 if cfg.fp32_lm_head else act
    xl = torch.full((1, cfg.hidden_size), 0.01, dtype=_compute_dtype(lm, head_dtype), device=dev)
    ms = timer.op(lambda: qmatmul(xl, lm, out_dtype=torch.float32), reps)
    rows.append(("lm_head", ms, param_bytes(lm) / ms / 1e6))

    cache = init_kv_cache(cfg, 1, max_len, device=dev)
    kc, vc = cache.k[0], cache.v[0]
    q0 = torch.ones((1, cfg.num_kv_heads, 1, cfg.head_dim), dtype=kc.dtype, device=dev)
    q_pos = torch.full((1,), ctx_len - 1, dtype=torch.int64, device=dev)
    ms = timer.op(lambda: attend_cache(q0, kc, vc, None, None, q_pos), reps)
    attn_bytes = 2 * cfg.num_kv_heads * ctx_len * cfg.head_dim * kc.element_size()
    rows.append((f"decode_attention[L={ctx_len}]x1layer", ms, attn_bytes / ms / 1e6))

    logits = torch.ones((1, cfg.vocab_size), dtype=torch.float32, device=dev)
    ms = timer.op(lambda: sample_token(logits, 0, 0, 0.7, 0.95), reps)
    rows.append(("sample_top_p", ms, 0.0))
    return rows


def print_table(rows: List[Tuple[str, float, float]]) -> None:
    total = sum(ms for _, ms, _ in rows)
    print(f"{'op':<36} {'ms':>9} {'GB/s':>8} {'%':>6}")
    for name, ms, gbs in rows:
        pct = 100 * ms / total if total else 0
        print(f"{name:<36} {ms:>9.4f} {gbs:>8.1f} {pct:>5.1f}%")


def main(argv=None):
    ap = argparse.ArgumentParser("mlc_llm_tpu_torch.evaluate")
    ap.add_argument("--model", default="vicuna-v1-7b")
    ap.add_argument("--quantization", default="q4bf16")
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--fabricate", action="store_true")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .models import forward, get_config, init_kv_cache, init_random_params
    from .models.transformer import pad_params
    from .ops import resolve_device
    from .ops.sampling import sample_token

    dev = resolve_device(args.device)
    cfg = get_config(args.model)
    max_len = min(cfg.max_seq_len, args.max_seq_len)
    warm = 2  # decode steps before the timed ones
    if args.prompt_len + warm + args.gen_len > max_len:
        raise SystemExit(f"--prompt-len {args.prompt_len} + --gen-len {args.gen_len} "
                         f"(+ {warm} warm-up steps) must fit in max_seq_len {max_len}")
    if args.weights:
        from .utils.checkpoint import load_model_params

        params, _ = load_model_params(args.weights, cfg.name, device=dev)
    else:
        params = init_random_params(cfg, args.quantization, seed=0, fabricate=args.fabricate,
                                    device=dev)
    params = pad_params(params)
    timer = Timer(dev)

    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        10, min(1000, cfg.vocab_size - 1), size=(1, args.prompt_len))).to(dev)

    def prefill():
        c = init_kv_cache(cfg, 1, max_len, device=dev)
        return forward(params, cfg, prompt, c, seq_lens=[args.prompt_len])

    prefill()  # warm-up: kernels built and loaded
    prefill_ms, (logits, cache) = timer.span(prefill)
    print(f"prefill[{args.prompt_len}]: {prefill_ms:.1f} ms "
          f"({args.prompt_len / prefill_ms * 1e3:.1f} tok/s)")

    def decode(tok, n):
        for step in range(n):
            lg, _ = forward(params, cfg, tok, cache)
            tok = sample_token(lg, 0, step, 0.7, 0.95)[:, None]
        return tok

    tok = decode(torch.argmax(logits, -1)[:, None], warm)
    ms, _ = timer.span(lambda: decode(tok, args.gen_len))
    per = ms / args.gen_len
    print(f"decode: {per:.2f} ms/tok ({1e3 / per:.1f} tok/s)")

    if args.profile:
        print()
        print_table(profile_ops(cfg, params, max_len, args.prompt_len, timer))


if __name__ == "__main__":
    main()
