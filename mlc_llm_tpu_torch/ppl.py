"""Perplexity evaluation, the counterpart of ``mlc_llm_tpu/ppl.py``.

Token-level NLL and perplexity over a token stream with a sliding
window, for any quantization preset, so formats can be compared. Each
window runs ``forward(..., last_only=False)`` on a fresh cache, so the
lm head runs at m = window (on the card: the flat ``gemm_qs``).

  python -m mlc_llm_tpu_torch.ppl --model tiny-llama --random --device cpu \\
      --tokens-file toks.npy
  python -m mlc_llm_tpu_torch.ppl --weights dist/vicuna-q4 --model vicuna-v1-7b \\
      --text-file wiki.txt --tokenizer /path/to/tok
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def perplexity(params, cfg, tokens: np.ndarray, *, window: int = 512, stride: int = 256,
               cache_dtype=torch.bfloat16) -> dict:
    """Sliding-window NLL over a 1-D token array, on the params' device.
    Each window after the first scores only the tokens whose full left
    context (window - stride tokens) lies inside it."""
    from .models.transformer import forward, init_kv_cache, pad_params

    tokens = np.asarray(tokens, np.int64)
    if tokens.ndim != 1 or len(tokens) < 2:
        raise ValueError("perplexity needs a 1-D stream of at least 2 tokens")
    params = pad_params(params)
    dev = params["final_ln"]["w"].device

    def window_nll(toks):
        cache = init_kv_cache(cfg, 1, window, cache_dtype, device=dev)
        logits, _ = forward(params, cfg, toks[None, :], cache, last_only=False)
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        return -logp[:-1].gather(-1, toks[1:, None])[:, 0]  # [window - 1]

    total_nll, total_cnt, pos = 0.0, 0, 0
    while pos + 2 <= len(tokens):
        chunk = tokens[pos:pos + window]
        if len(chunk) < window:
            chunk = np.pad(chunk, (0, window - len(chunk)))
        nll = window_nll(torch.from_numpy(chunk).to(dev))
        start_score = 0 if pos == 0 else window - stride - 1
        end_score = min(window, len(tokens) - pos) - 1
        if end_score > start_score:
            total_nll += float(nll[start_score:end_score].double().sum())
            total_cnt += end_score - start_score
        pos += stride
    mean_nll = total_nll / max(total_cnt, 1)
    return {"tokens_scored": total_cnt, "nll": mean_nll, "perplexity": float(np.exp(mean_nll))}


def main(argv=None):
    ap = argparse.ArgumentParser("mlc_llm_tpu_torch.ppl")
    ap.add_argument("--model", required=True)
    ap.add_argument("--quantization", default="q4bf16")
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--tokens-file", default=None, help=".npy int token array")
    ap.add_argument("--text-file", default=None)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--stride", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .models import get_config, init_random_params

    cfg = get_config(args.model)
    if args.weights:
        from .utils.checkpoint import load_model_params

        params, _ = load_model_params(args.weights, cfg.name, device=args.device)
    else:
        params = init_random_params(cfg, args.quantization, seed=0, device=args.device)

    if args.tokens_file:
        toks = np.load(args.tokens_file)
    elif args.text_file:
        from .tokenizer import load_tokenizer

        with open(args.text_file) as f:
            toks = np.asarray(load_tokenizer(args.tokenizer).encode(f.read()), np.int64)
    else:
        # a deterministic synthetic stream (structure-free; for smoke runs)
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=2048, dtype=np.int32)

    window = min(args.window, cfg.max_seq_len)
    res = perplexity(params, cfg, toks, window=window, stride=min(args.stride, window // 2))
    res["model"] = cfg.name
    res["quantization"] = args.quantization if not args.weights else "from-checkpoint"
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
