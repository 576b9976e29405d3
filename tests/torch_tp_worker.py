"""One rank of the port's tensor-parallel CPU tests (tests/test_torch_sharding.py).

    python tests/torch_tp_worker.py <world> <rank> <port> <dir> [<device> <case>]

joins a gloo process group of `world` ranks on localhost:<port> and runs
every case of CASES whose mesh holds `world` ranks, in order, so that one
process group serves all of them (or only <case>, on <device>: "cuda"
puts every rank on the card, tests/test_torch_cuda.py). Each case loads its full params from
<dir>/<model>-<quant>.pt (the test wrote them, converted from the JAX
package's), cuts this rank's shards with parallel.shard_params and
writes what the rank computed to <dir>/<case>.<rank>.pt:

- a forward case: the logits of a right-padded [2, 8] prefill and two
  decode steps (this rank's dp rows), on the slot cache or on the paged
  cache (bf16 or int8 pools), the rank's part of the full cache cut by
  parallel.shard_cache / shard_paged_cache;
- an engine case: the greedy streams of InferenceEngine(mesh=) on the
  slot and the paged layout.

The module imports no JAX: the test imports its case table.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mlc_llm_tpu_torch.models import get_config  # noqa: E402

# tiny-llama's H = 64 gives 16-row shards at tp = 4, half a group of 32 at
# wo, so the tp cases widen it: 256 wide, 8 heads of 32 (8 groups a
# row-parallel k, 2 at tp = 4), I = 512
WIDE = dict(hidden_size=256, intermediate_size=512, num_heads=8, num_kv_heads=8)

# case: (model, quant, mesh shape, cache)
CASES = {
    "tp2_f32": ("tiny-llama", "f32", {"dp": 1, "tp": 2}, "slot"),
    "tp2_q4bf16": ("tiny-llama", "q4bf16", {"dp": 1, "tp": 2}, "slot"),
    "paged_bf16": ("tiny-llama", "f32", {"dp": 1, "tp": 2}, "paged_bf16"),
    "paged_int8": ("tiny-llama", "f32", {"dp": 1, "tp": 2}, "paged_int8"),
    "neox_q4f16_hs": ("tiny-gpt_neox", "q4f16_hs", {"dp": 1, "tp": 2}, "slot"),
    "plane": ("tiny-llama", "q4bf16_plane", {"dp": 1, "tp": 2}, "slot"),
    "engine": ("tiny-llama", "f32", {"dp": 1, "tp": 2}, "engine"),
    "tp4_f32": ("tiny-llama", "f32", {"dp": 1, "tp": 4}, "slot"),
    "tp4_q4bf16": ("tiny-llama", "q4bf16", {"dp": 1, "tp": 4}, "slot"),
    "dp2_tp2": ("tiny-llama", "f32", {"dp": 2, "tp": 2}, "slot"),
    "dcn2_tp2": ("tiny-llama", "f32", {"dcn": 2, "dp": 1, "tp": 2}, "slot"),
}
TOKENS = np.random.default_rng(5).integers(0, 256, (2, 8))
SEQ_LENS = [8, 6]
DECODE = [[[3], [5]], [[7], [9]]]
PROMPTS = [[5, 6, 7], [1, 2]]
NEW_TOKENS = 6
PAGE_SIZE, NUM_PAGES, MAX_PAGES = 8, 16, 4
PAGE_TABLE = np.array([[3, 7, 1, 12], [5, 2, 9, 4]], np.int32)
HEAD_BLOCK = 2  # 8 kv heads in G = 4 groups: whole groups at tp 2 and 4


def config(model: str):
    return get_config(model).replace(**WIDE)


def cache_dtype(quant: str):
    from mlc_llm_tpu_torch.quant import resolve_spec
    from mlc_llm_tpu_torch.quant.groupwise import torch_dtype

    return torch_dtype(resolve_spec(quant).dtype)


def make_cache(cfg, kind: str, quant: str, batch: int, device="cpu"):
    from mlc_llm_tpu_torch.models import init_kv_cache, init_paged_kv_cache

    if kind == "slot":
        return init_kv_cache(cfg, batch, 32, dtype=cache_dtype(quant), device=device)
    dtype = torch.bfloat16 if kind == "paged_bf16" else torch.int8
    return init_paged_kv_cache(cfg, batch, NUM_PAGES, PAGE_SIZE, MAX_PAGES, dtype=dtype,
                               head_block=HEAD_BLOCK, device=device)


def to_device(params, device):
    from mlc_llm_tpu_torch.models.transformer import tree_map
    from mlc_llm_tpu_torch.quant import QuantizedTensor

    return tree_map(lambda x: x.map(lambda t: t.to(device)) if isinstance(x, QuantizedTensor)
                    else x.to(device), params)


def run_forward(params, cfg, cache, rows, mesh=None):
    """The logits of the prefill and the decode steps of `rows`."""
    from mlc_llm_tpu_torch.models import forward

    paged = hasattr(cache, "page_table")
    dev = (cache.k_pages if paged else cache.k).device
    if paged:
        cache.set_page_table(PAGE_TABLE[rows])
    toks = torch.from_numpy(TOKENS[rows]).long().to(dev)
    lg, cache = forward(params, cfg, toks, cache, seq_lens=[SEQ_LENS[r] for r in rows],
                        mesh=mesh)
    out = [lg.cpu()]
    for step in DECODE:
        lg, cache = forward(params, cfg, torch.tensor([step[r] for r in rows], device=dev),
                            cache, mesh=mesh)
        out.append(lg.cpu())
    return out


def run_engines(params, cfg, mesh=None):
    """Greedy streams of a slot and a paged engine."""
    from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine

    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, temperature=0.0)
    out = {}
    for layout in ("slot", "paged"):
        eng = InferenceEngine(cfg, params, max_batch=2, max_seq_len=64, kv_layout=layout,
                              page_size=PAGE_SIZE, device="cpu", mesh=mesh)
        out[layout] = eng.generate(PROMPTS, gen)
    return out


def main():
    world, rank, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4])
    device, only = (sys.argv[5], sys.argv[6]) if len(sys.argv) > 6 else ("cpu", None)
    torch.set_num_threads(1)
    from mlc_llm_tpu_torch.parallel.multihost import initialize, make_pod_mesh
    from mlc_llm_tpu_torch.parallel.sharding import (
        make_mesh,
        shard_cache,
        shard_paged_cache,
        shard_params,
    )

    initialize(f"localhost:{port}", world, rank, backend="gloo")
    for case, (model, quant, shape, kind) in CASES.items():
        if int(np.prod(list(shape.values()))) != world or only not in (None, case):
            continue
        cfg = config(model)
        full = to_device(torch.load(os.path.join(out_dir, f"{model}-{quant}.pt"),
                                    weights_only=False), device)
        if "dcn" in shape:
            mesh = make_pod_mesh(tp=shape["tp"], dp=shape["dp"], dcn=shape["dcn"],
                                 device_type=device)
        else:
            mesh = make_mesh(tp=shape["tp"], dp=shape["dp"], device_type=device)
        local = shard_params(full, mesh, cfg)
        if kind == "engine":
            result = run_engines(local, cfg, mesh)
        else:
            dp, d = shape["dp"], mesh.get_local_rank("dp")
            rows = list(range(2))[d * 2 // dp:(d + 1) * 2 // dp]
            full_cache = make_cache(cfg, kind, quant, 2, device)
            if kind == "slot":
                cache = shard_cache(full_cache, mesh)
            else:
                full_cache.set_page_table(PAGE_TABLE)
                cache = shard_paged_cache(full_cache, mesh)
            result = run_forward(local, cfg, cache, rows, mesh)
        torch.save(result, os.path.join(out_dir, f"{case}.{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
