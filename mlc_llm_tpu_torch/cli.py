"""Streaming chat CLI, the counterpart of ``mlc_llm_tpu/cli.py``.

REPL with /help, /exit, /stats, /reset and streamed token output. The
weights come from a checkpoint directory (``--weights``, written by
``python -m mlc_llm_tpu_torch.build`` or the JAX package's build; without
it the CLI searches ``dist/<model>*``) or are random
(``--random-weights``). ``--device`` replaces the JAX CLI's
``--platform`` and defaults to ``cuda``.

Usage:
  python -m mlc_llm_tpu_torch.cli --model vicuna-v1-7b --weights dist/vicuna-v1-7b-q4bf16
  python -m mlc_llm_tpu_torch.cli --model vicuna-v1-7b --random-weights
  python -m mlc_llm_tpu_torch.cli --model tiny-llama --random-weights \
      --prompt hi --temperature 0 --device cpu
  # greedy turns through prompt-lookup speculation, 4-token verify blocks
  python -m mlc_llm_tpu_torch.cli --model tiny-llama --random-weights \
      --prompt hi --temperature 0 --speculative 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def find_artifacts(model: str, quantization: str):
    """Search the conventional checkpoint locations for a built model:
    ``dist/<model>-<quantization>``, ``dist/<model>/<quantization>``,
    ``dist/<model>``. A candidate whose manifest records another
    quantization than the one requested is skipped with a warning on
    stderr. Returns a directory or None."""
    for cand in (f"dist/{model}-{quantization}", f"dist/{model}/{quantization}",
                 f"dist/{model}"):
        mf = os.path.join(cand, "manifest.json")
        if not os.path.isfile(mf):
            continue
        try:
            with open(mf) as f:
                meta = json.load(f).get("meta", {})
        except (OSError, ValueError):
            continue
        built_quant = meta.get("quantization")
        if built_quant and built_quant != quantization:
            print(f"skipping {cand}: built as {built_quant}, requested {quantization}",
                  file=sys.stderr)
            continue
        return cand
    return None


def build_session(args):
    from .engine import InferenceEngine
    from .engine.session import ChatConfig, ChatSession
    from .models import get_config, init_random_params
    from .tokenizer import load_tokenizer
    from .utils.checkpoint import load_model_params

    cfg = get_config(args.model)
    if not args.random_weights and not args.weights:
        found = find_artifacts(args.model, args.quantization)
        if found:
            print(f"using checkpoint {found}", file=sys.stderr)
            args.weights = found
    if args.random_weights:
        params = init_random_params(cfg, args.quantization, seed=0, fabricate=args.fabricate,
                                    device=args.device)
    elif args.weights:
        params, _ = load_model_params(args.weights, cfg.name, device=args.device)
    else:
        raise SystemExit(f"need --weights DIR or --random-weights (searched dist/{args.model}*; "
                         "build one with `python -m mlc_llm_tpu_torch.build`)")
    engine = InferenceEngine(
        cfg, params, max_batch=1,
        max_seq_len=min(cfg.max_seq_len, args.max_window_size * 2),
        device=args.device,
    )
    tok = load_tokenizer(args.tokenizer, add_prefix_space=cfg.family == "moss")
    chat = ChatConfig(
        temperature=args.temperature,
        top_p=args.top_p,
        max_gen_len=args.max_gen_len,
        max_window_size=args.max_window_size,
        seed=args.seed,
    )
    return ChatSession(engine, tok, cfg, chat, conv_template=args.conv_template,
                       speculative_k=args.speculative)


HELP = """Commands:
  /help    print this message
  /exit    quit
  /stats   print encode/decode tok/s of the last round
  /reset   restart a fresh chat
"""


def main(argv=None):
    ap = argparse.ArgumentParser("mlc_llm_tpu_torch.cli")
    ap.add_argument("--model", default="vicuna-v1-7b")
    ap.add_argument("--weights", default=None, help="checkpoint directory")
    ap.add_argument("--tokenizer", default=None, help="HF tokenizer path (default: byte tokenizer)")
    ap.add_argument("--quantization", default="q4bf16")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--fabricate", action="store_true", help="fabricated packed random weights (fast init)")
    ap.add_argument("--conv-template", default=None)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--max-gen-len", type=int, default=512)
    ap.add_argument("--max-window-size", type=int, default=768)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--speculative", type=int, default=None, metavar="K",
                    help="prompt-lookup speculative decoding with K-token verify blocks on "
                         "greedy turns (temperature 0): the greedy stream in fewer passes")
    ap.add_argument("--prompt", default=None, help="one-shot prompt (no REPL)")
    ap.add_argument("--evaluate", action="store_true", help="built-in smoke benchmark")
    ap.add_argument("--try-tokenizer", action="store_true",
                    help="tokenizer encode/decode round-trip smoke")
    ap.add_argument("--debug-dump-dir", default=None,
                    help="dump each engine program's aten ops and, on the card, its device "
                         "kernels, graph, and the SASS and PTX of the kernels it launches to "
                         "this directory, and exit (debug/dump.py)")
    ap.add_argument("--debug-load-kernel", default=None, metavar="NAME:KERNEL=PATH",
                    help="re-inject an edited kernel source: compile PATH in place of csrc "
                         "kernel KERNEL (e.g. dequant_gemv_qs) and run engine program NAME "
                         "(prefill / decode_w<N> / prefill_slot / a dumped key) eagerly on the "
                         "dump's arguments, print output summaries, and exit (the card only)")
    args = ap.parse_args(argv)

    session = build_session(args)

    if args.debug_dump_dir:
        from .debug.dump import dump_engine_programs

        for w in dump_engine_programs(session.engine, args.debug_dump_dir):
            print(f"wrote {args.debug_dump_dir}/{w}")
        return

    if args.debug_load_kernel:
        from .debug.dump import reinject_engine_program

        name, _, rest = args.debug_load_kernel.partition(":")
        kernel, _, path = rest.partition("=")
        if not (name and kernel and path):
            raise SystemExit("--debug-load-kernel wants NAME:KERNEL=PATH")
        for i, o in enumerate(reinject_engine_program(session.engine, name, kernel, path)):
            print(f"out[{i}]: shape={tuple(o.shape)} dtype={str(o.dtype).split('.')[-1]} "
                  f"mean={o.double().mean().item():.6g}")
        return

    if args.try_tokenizer:
        for text in ("Hello world!", "你好 123", "<s>[INST]"):
            ids = session.tokenizer.encode(text)
            back = session.tokenizer.decode(ids)
            print(f"{text!r} -> {len(ids)} tokens -> {back!r}")
        return

    if args.evaluate:
        import time as _time

        from .engine import GenerationConfig

        tokens = session.tokenizer.encode("The capital of Canada is")
        eng = session.engine
        t0 = _time.perf_counter()
        logits = eng.prefill([tokens])
        first10 = logits[0, :10].cpu().numpy()
        t1 = _time.perf_counter()
        out = eng.generate([tokens], GenerationConfig(max_new_tokens=16, temperature=0.0))
        t2 = _time.perf_counter()
        print(f"logits[:10] = {first10}")
        print(f"prefill[{len(tokens)} tok]: {(t1-t0)*1e3:.1f} ms; "
              f"decode[{len(out[0])} tok]: {(t2-t1)*1e3:.1f} ms")
        print(f"[{session.stats_text}]")
        return

    if args.prompt is not None:
        for chunk in session.chat_stream(args.prompt):
            print(chunk, end="", flush=True)
        print()
        print(f"[{session.stats_text}]", file=sys.stderr)
        return

    roles = session.conv.roles
    print(f"Chatting with {args.model} ({session.conv.name} template).")
    print("Type /help for commands.")
    while True:
        try:
            line = input(f"{roles[0]}: ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        cmd = line.strip()
        if cmd == "/exit":
            break
        if cmd == "/help":
            print(HELP)
            continue
        if cmd == "/stats":
            print(session.stats_text)
            continue
        if cmd == "/reset":
            session.reset()
            print("chat restarted")
            continue
        if not cmd:
            continue
        print(f"{roles[1]}: ", end="", flush=True)
        for chunk in session.chat_stream(cmd):
            print(chunk, end="", flush=True)
        print()


if __name__ == "__main__":
    main()
