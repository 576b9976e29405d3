"""Serving front door: a continuous-batching scheduler behind TCP/JSON.

The counterpart of ``mlc_llm_tpu/serve.py``, with the same flags except
``--device`` (default ``cuda``) in place of ``--platform``. One host's
InferenceEngine + scheduler is served over the wire protocol
(``parallel/wire.py``); the client mode submits token ids and streams
the generation back.

  # server (the paged KV pool, as on the H100)
  python -m mlc_llm_tpu_torch.serve --model vicuna-v1-7b --random-weights \\
      --port 8100 --max-batch 8 --paged

  # on the CPU, at a tiny size
  python -m mlc_llm_tpu_torch.serve --model tiny-llama --random-weights \\
      --device cpu --paged

  # anywhere else: submit token ids and stream the generation back
  python -m mlc_llm_tpu_torch.serve --connect HOST:8100 --prompt-ids 1,2,3

Checkpoints are not loadable yet (``--weights`` raises, ROADMAP.md queue
1, item 1); ``--speculative`` raises (item 5); ``--precompile`` is the
engine's no-op (PyTorch runs eagerly, kernels build at first use).
"""

from __future__ import annotations

import argparse
import sys
import time


def _multi_step_arg(v: str):
    """--multi-step accepts an int K or 'auto'/'auto:K' (adaptive)."""
    if v.startswith("auto"):
        if ":" in v:
            int(v.split(":", 1)[1])  # validate
        return v
    return int(v)


def build_engine(args):
    from .engine import InferenceEngine
    from .models import get_config, init_random_params

    cfg = get_config(args.model)
    if args.weights:
        raise SystemExit("checkpoint loading is not ported yet (ROADMAP queue 1, item 1)")
    if not args.random_weights:
        raise SystemExit("need --random-weights (checkpoint loading is not ported yet)")
    params = init_random_params(cfg, args.quantization, seed=0, fabricate=args.fabricate,
                                device=args.device)
    kwargs = {}
    if args.paged:
        kwargs.update(kv_layout="paged", page_size=args.page_size,
                      prefix_cache_pages=args.prefix_cache_pages)
    return InferenceEngine(cfg, params, max_batch=args.max_batch,
                           max_seq_len=min(cfg.max_seq_len, args.max_seq_len),
                           device=args.device, **kwargs)


def run_server(args) -> None:
    from .engine.scheduler import ContinuousBatchingScheduler
    from .parallel.wire import SchedulerServer

    engine = build_engine(args)
    if args.precompile:
        engine.precompile(progress=lambda m: print(f"precompile: {m}", flush=True))
    sched = ContinuousBatchingScheduler(
        engine, seed=args.seed or 0, prefill_chunk=args.prefill_chunk,
        speculative_k=args.speculative, decode_ahead=args.decode_ahead,
        multi_step=args.multi_step)
    server = SchedulerServer(sched, host=args.host, port=args.port)
    server.start()
    print(f"serving {args.model} on {args.host}:{server.port} (max_batch={args.max_batch}"
          f"{', paged' if args.paged else ''}, device={args.device})", flush=True)
    try:
        while server.error is None:
            time.sleep(0.5)
        print(server.error, file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        print(engine.stats.text())
    if server.error is not None:
        raise SystemExit(1)


def run_client(args) -> None:
    from .engine.engine import GenerationConfig
    from .parallel.wire import RemoteScheduler

    host, _, port = args.connect.rpartition(":")
    client = RemoteScheduler((host or "127.0.0.1", int(port)))
    prompt = [int(t) for t in args.prompt_ids.split(",") if t.strip()]
    gen = GenerationConfig(max_new_tokens=args.max_gen_len, temperature=args.temperature,
                           top_p=args.top_p, seed=args.seed)
    req = client.submit(prompt, gen, on_token=lambda t: print(t, flush=True))
    if not req.wait(args.timeout):
        raise SystemExit("request timed out")
    st = client.stats()
    print(f"# done: {len(req.output)} tokens; server decode "
          f"{st['decode_tokens']} tok / {st['decode_time']:.2f} s", file=sys.stderr)
    client.close()


def main(argv=None):
    ap = argparse.ArgumentParser("mlc_llm_tpu_torch.serve")
    ap.add_argument("--model", default="vicuna-v1-7b")
    ap.add_argument("--weights", default=None, help="checkpoint directory (not ported yet)")
    ap.add_argument("--quantization", default="q4bf16")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--fabricate", action="store_true")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool instead of slot-contiguous")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts in chunks of this many tokens (a prefill bucket) "
                         "so active requests keep decoding during long admissions")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    help="enable automatic prefix caching on the paged pool, holding up "
                         "to this many pages of shared prompt-prefix KV")
    ap.add_argument("--speculative", type=int, default=None, metavar="K",
                    help="batched prompt-lookup speculation (not ported yet: raises)")
    ap.add_argument("--multi-step", type=_multi_step_arg, default=None, metavar="K|auto[:K]",
                    help="run K decode steps per dispatch (stop detection lags up to K-1 "
                         "tokens inside a block); 'auto' (max 8) or 'auto:K' picks the "
                         "block size from slot occupancy and queue backlog")
    ap.add_argument("--decode-ahead", type=int, default=1,
                    help="decode steps kept in flight before blocking on the oldest "
                         "token readback (stop detection lags this many tokens)")
    ap.add_argument("--precompile", action="store_true",
                    help="warm-up before serving (a no-op: kernels build at first use)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    # client mode
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="client mode: submit to a running server")
    ap.add_argument("--prompt-ids", default=None,
                    help="client mode: comma-separated token ids")
    ap.add_argument("--max-gen-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)

    if args.connect:
        if not args.prompt_ids:
            raise SystemExit("client mode needs --prompt-ids")
        run_client(args)
    else:
        run_server(args)


if __name__ == "__main__":
    main()
