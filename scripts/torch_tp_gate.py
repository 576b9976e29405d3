"""How far tensor-parallel logits sit from the unsharded forward's, by
depth, on one GPU.

    python scripts/torch_tp_gate.py [--layers 1,2,8,32]

Starts two gloo ranks of this script on the one card (tp = 2). Each draws
Vicuna-7B q4bf16 (seed 0), keeps its first L layers for each L, and runs
chip_smoke.py's slot gate on them: an 1100-token reset prefill
(prefill_flash: kernel 8) and three decode steps fed the unsharded
forward's greedy tokens. Against two unsharded references on the same
weights, the qsplit order as drawn and the pair order the shards are
repacked to (exact), it prints |tp - unsharded| / max |logit| of each
forward for the row-parallel partials all-reduced in f32 (the forward's)
and in bf16 (rounded to the activation dtype first), and the two
references' own distance (the kernel bodies' rounding points, no
sharding). Rank 0 prints one JSON line at the end with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mlc_llm_tpu_torch.models import (  # noqa: E402
    forward,
    get_config,
    init_kv_cache,
    init_random_params,
)
from mlc_llm_tpu_torch.models import transformer as tr  # noqa: E402
from mlc_llm_tpu_torch.models.transformer import pad_params  # noqa: E402
from mlc_llm_tpu_torch.parallel.multihost import initialize  # noqa: E402
from mlc_llm_tpu_torch.parallel.sharding import (  # noqa: E402
    _repack_hsplit_for_sharding,
    make_mesh,
    shard_params,
)
from mlc_llm_tpu_torch.quant import QuantizedTensor  # noqa: E402

VICUNA = get_config("vicuna-v1-7b")


def row_parallel_bf16(x, w, l, bias, tp):
    """The row-parallel matmul with its partials rounded to x's dtype
    before the all-reduce (the variant the forward does not take)."""
    if tp is None:
        return tr.qmatmul_stacked(x, w, l, bias)
    y = tr.all_reduce(tr.qmatmul_stacked(x, w, l), tp)
    return y if bias is None else y + bias.to(y.dtype)


def first_layers(params, L):
    def cut(v):
        return v.map(lambda t: t[:L]) if isinstance(v, QuantizedTensor) else v[:L]

    return {k: {n: cut(v) for n, v in params[k].items()} if k == "layers" else params[k]
            for k in params}


def gate(params, cfg, mesh, toks_ref=None):
    """Logits of the slot gate's four forwards (and the greedy tokens fed)."""
    gen = torch.Generator().manual_seed(4)
    toks = torch.zeros((1, 1152), dtype=torch.int64)
    toks[0, :1100] = torch.randint(3, cfg.vocab_size, (1100,), generator=gen)
    cache = init_kv_cache(cfg, 1, 2048, device="cuda", tp=1 if mesh is None else 2)
    lg, cache = forward(params, cfg, toks.cuda(), cache, seq_lens=[1100], prefill_flash=True,
                        mesh=mesh)
    out, fed = [lg.float().cpu()], []
    for i in range(3):
        nxt = lg.argmax(-1, keepdim=True) if toks_ref is None else toks_ref[i].cuda()
        fed.append(nxt.cpu())
        lg, cache = forward(params, cfg, nxt, cache, mesh=mesh)
        out.append(lg.float().cpu())
    return out, fed


def ratios(got, ref):
    return [(a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, ref)]


def rank_main(rank: int, port: str, layers):
    initialize(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(tp=2, device_type="cuda")
    full = init_random_params(VICUNA, "q4bf16", seed=0, device="cuda")
    rows = []
    for L in layers:
        cfg = VICUNA.replace(num_layers=L)
        part = first_layers(full, L)
        ref_q, toks = gate(pad_params(part), cfg, None)
        ref_p, _ = gate(pad_params(_repack_hsplit_for_sharding(part)), cfg, None, toks)
        local = pad_params(shard_params(part, mesh, cfg))
        row = dict(layers=L, pair_vs_qsplit=ratios(ref_p, ref_q))
        for name, fn in (("f32", tr._row_parallel), ("bf16", row_parallel_bf16)):
            keep, tr._row_parallel = tr._row_parallel, fn
            try:
                got, _ = gate(local, cfg, mesh, toks)
            finally:
                tr._row_parallel = keep
            row[f"allreduce_{name}_vs_pair"] = ratios(got, ref_p)
            row[f"allreduce_{name}_vs_qsplit"] = ratios(got, ref_q)
        rows.append(row)
        if rank == 0:
            print(json.dumps(row), flush=True)
    torch.distributed.destroy_process_group()
    if rank == 0:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(json.dumps({"card": card, "rows": rows}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="1,2,8,32")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", default=None)
    args = ap.parse_args()
    layers = [int(x) for x in args.layers.split(",")]
    if args.rank is not None:
        rank_main(args.rank, args.port, layers)
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs the GPU")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = [subprocess.Popen([sys.executable, __file__, "--layers", args.layers, "--rank",
                               str(r), "--port", port]) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=1200)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise SystemExit(f"ranks exited {[p.returncode for p in procs]}")


if __name__ == "__main__":
    main()
