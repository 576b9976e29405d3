"""Cross-device differential comparison, the counterpart of
``mlc_llm_tpu/debug/compare.py``.

The JAX tool runs a forward under its jnp path and its Pallas path and
diffs them. The port has no kernel mode, on purpose: a wrapper runs its
kernel on CUDA tensors and its plain PyTorch version on CPU tensors. So
the reference side here is the same params and inputs moved to the CPU,
and the other side is the params' own device. Rows: layer 0's quantized
matmul of each quantized layer weight on random activations (2 rows),
then the end-to-end logits of a prefill; a row passes under
``numpy.allclose(atol, rtol)`` with the JAX tool's defaults.

The matmul rows compare f32 outputs: a bf16 output of values near 4 is
rounded to steps of 2^-5, and f32 sums in another order tip that rounding
either way, so a rounded output would differ by 0.03 where the two
products agree to 1e-6.

  python -m mlc_llm_tpu_torch.debug.compare --model tiny-llama --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _cpu(params):
    from ..models.transformer import tree_map
    from ..quant.groupwise import QuantizedTensor

    return tree_map(lambda x: x.map(lambda t: t.cpu()) if isinstance(x, QuantizedTensor)
                    else x.cpu(), params)


def compare_paths(cfg, params, tokens, max_len=None, atol=1e-2, rtol=1e-3):
    """[(name, max |diff|, ok)] of the params' device against the CPU.
    params are group-padded first, as the engine pads them, so every
    matmul routes to its kernel."""
    from ..models.transformer import forward, init_kv_cache, pad_params
    from ..ops.matmul import qmatmul
    from ..quant.groupwise import QuantizedTensor, torch_dtype

    max_len = max_len or min(cfg.max_seq_len, 256)
    params = pad_params(params)
    dev = params["final_ln"]["w"].device
    sides = {"ref": _cpu(params), "dev": params}
    rows = []

    gen = torch.Generator().manual_seed(0)
    for name in sorted(params["layers"]):
        w = params["layers"][name]
        if not isinstance(w, QuantizedTensor):
            continue
        x = torch.randn((2, w.shape[0]), generator=gen).to(torch_dtype(w.spec.dtype))
        a, b = (qmatmul(x.to(d), sides[s]["layers"][name].map(lambda t: t[0]),
                        out_dtype=torch.float32).cpu().numpy()
                for s, d in (("ref", "cpu"), ("dev", dev)))
        rows.append((f"qmatmul[{name}]", float(np.abs(a - b).max()),
                     bool(np.allclose(a, b, atol=atol, rtol=rtol))))

    tokens = torch.as_tensor(tokens, dtype=torch.int64)
    outs = []
    for s, d in (("ref", torch.device("cpu")), ("dev", dev)):
        cache = init_kv_cache(cfg, tokens.shape[0], max_len, device=d)
        logits, _ = forward(sides[s], cfg, tokens.to(d), cache, last_only=True)
        outs.append(logits.float().cpu().numpy())
    rows.append(("forward logits", float(np.abs(outs[0] - outs[1]).max()),
                 bool(np.allclose(*outs, atol=atol, rtol=rtol))))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser("mlc_llm_tpu_torch.debug.compare")
    ap.add_argument("--model", default="tiny-llama")
    ap.add_argument("--quantization", default="q4bf16")
    ap.add_argument("--atol", type=float, default=1e-2)
    ap.add_argument("--rtol", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..models import get_config, init_random_params

    cfg = get_config(args.model)
    params = init_random_params(cfg, args.quantization, seed=0, device=args.device)
    rows = compare_paths(cfg, params, [[1, 2, 3, 4, 5, 6, 7, 8]], atol=args.atol,
                         rtol=args.rtol)
    worst = 0.0
    for name, max_abs, ok in rows:
        print(f"{'OK ' if ok else 'DIFF'} {name:<28} max|Δ| = {max_abs:.3e}")
        worst = max(worst, max_abs)
    print(f"worst: {worst:.3e}")
    return 0 if all(ok for _, _, ok in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
