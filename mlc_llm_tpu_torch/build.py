"""Offline build driver: HF checkpoint (or random weights) -> quantized
param checkpoint, the counterpart of ``mlc_llm_tpu/build.py``.

It loads the HF weights, group-quantizes every matmul weight into the
packed layout on ``--device`` (default ``cuda``), and writes the
checkpoint (``utils/checkpoint.py``) that the CLI, the server and the
tools load with ``--weights``, plus ``build_config.json``. ``--random``
draws ``init_random_params(cfg, spec, seed=0)`` on the device: the params
the entry points' ``--random-weights`` draw.

Usage:
  python -m mlc_llm_tpu_torch.build --model dolly-v2-3b \\
      --hf-path /path/to/dolly-v2-3b --quantization q4f16_hs -o dist/dolly-v2-3b-q4f16_hs
  python -m mlc_llm_tpu_torch.build --model tiny-llama --random -o /tmp/ck --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _hf_model(family: str, path: str):
    try:
        import transformers
    except ImportError:
        raise SystemExit("--hf-path needs the transformers package (not installed)") from None
    auto = {
        "llama": transformers.LlamaForCausalLM,
        "gpt_neox": transformers.GPTNeoXForCausalLM,
        "moss": transformers.AutoModelForCausalLM,
    }[family]
    return auto.from_pretrained(path, trust_remote_code=True)


def main(argv=None):
    ap = argparse.ArgumentParser("mlc_llm_tpu_torch.build")
    ap.add_argument("--model", required=True, help="model name from the registry")
    ap.add_argument("--hf-path", default=None, help="HF checkpoint directory")
    ap.add_argument("--random", action="store_true", help="random weights (testing)")
    ap.add_argument("--quantization", default="q4bf16")
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("-o", "--out", required=True, help="output checkpoint dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device the weights are quantized on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .models import get_config, init_random_params
    from .models.transformer import param_bytes
    from .ops import resolve_device, synchronize
    from .quant import resolve_spec
    from .utils.checkpoint import save_params

    cfg = get_config(args.model)
    if args.max_seq_len:
        cfg = cfg.replace(max_seq_len=args.max_seq_len)
    spec = resolve_spec(args.quantization)

    t0 = time.time()
    if args.random:
        params = init_random_params(cfg, spec, seed=0, device=args.device)
    else:
        if not args.hf_path:
            raise SystemExit("need --hf-path (or --random)")
        from .models.hf_loader import params_from_hf

        print(f"loading HF weights from {args.hf_path} ...")
        hf = _hf_model(cfg.family, args.hf_path)
        print(f"group-quantizing to {args.quantization} on {args.device} ...")
        params = params_from_hf(hf, cfg, spec, device=args.device)
        del hf

    synchronize(resolve_device(args.device))
    t_params = time.time() - t0
    meta = {
        "model": cfg.name,
        "quantization": args.quantization,
        "max_seq_len": cfg.max_seq_len,
        "built_with": "mlc_llm_tpu_torch.build",
    }
    t1 = time.time()
    save_params(params, args.out, meta=meta)
    with open(os.path.join(args.out, "build_config.json"), "w") as f:
        json.dump(meta, f, indent=1)
    t_write = time.time() - t1
    nbytes = param_bytes(params)
    print(f"wrote {args.out} ({nbytes / 1e6:.1f} MB) in {t_params + t_write:.1f}s "
          f"(params {t_params:.1f}s, write {t_write:.1f}s)")
    return {"bytes": nbytes, "params_s": t_params, "write_s": t_write}


if __name__ == "__main__":
    main()
