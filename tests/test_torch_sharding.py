"""The port's tensor-parallel sharding (parallel/sharding.py,
parallel/multihost.py, the sharded forward and engine) against the JAX
package's.

- param_specs equals JAX's param_shardings(...).spec leaf for leaf
  (tiny llama, GPT-NeoX and MOSS trees at tp 2, 4 and 8, the
  replicate-on-indivisible fallback included), and so do the cache specs;
- every rank's shards, put back together, dequantize bit-equal to the
  whole tensor (qsplit and hsplit repacked to the pair order, u4 planes);
- TP forwards run in spawned gloo process groups (tests/torch_tp_worker.py:
  one group of 2 ranks and one of 4 run every case, each rank in its own
  process) and are held against the port's unsharded forward (f32 1e-4,
  the 16-bit presets 2e-2, as tests/test_sharding.py holds JAX's; f32 on
  int8 pages 1e-3, an int8 code tipped by the last bit of K) and
  against JAX's sharded forward on the virtual mesh of this process (5e-2:
  the port's CPU path rounds like the TPU kernels, JAX's sharded matmuls
  take its jnp route);
- an engine at tp = 2 gives the unsharded engine's greedy streams;
- Llama-65B's shard plan at tp = 8 on the meta device: every rank-local
  leaf's shape.

The tp cases widen tiny-llama to H = 256, I = 512, 8 heads (torch_tp_worker.
WIDE): at H = 64, tp = 4 cuts wo's k into 16-row shards, half a group.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.models import forward as jforward
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_kv_cache as jinit_kv_cache
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.models import paged_cache as jpc
from mlc_llm_tpu.parallel import cache_shardings as jcache_shardings
from mlc_llm_tpu.parallel import make_mesh as jmake_mesh
from mlc_llm_tpu.parallel import paged_cache_shardings as jpaged_cache_shardings
from mlc_llm_tpu.parallel import param_shardings as jparam_shardings
from mlc_llm_tpu.parallel import shard_cache as jshard_cache
from mlc_llm_tpu.parallel import shard_paged_cache as jshard_paged_cache
from mlc_llm_tpu.parallel import shard_params as jshard_params
from mlc_llm_tpu.parallel.multihost import make_pod_mesh as jmake_pod_mesh
from mlc_llm_tpu.parallel.multihost import shard_params_pod as jshard_params_pod
from mlc_llm_tpu_torch.models import get_config, init_kv_cache, init_random_params
from mlc_llm_tpu_torch.models import paged_cache as tpc
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.parallel import multihost
from mlc_llm_tpu_torch.parallel.sharding import (
    _repack_hsplit_for_sharding,
    cache_shardings,
    local_params,
    paged_cache_shardings,
    param_specs,
)
from mlc_llm_tpu_torch.quant import QuantizedTensor, resolve_spec
from mlc_llm_tpu_torch.quant.groupwise import dequantize, pad_cols, words_per_group

import torch_tp_worker as w

torch.set_num_threads(2)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.int8: jnp.int8}


def _flat(tree, prefix=""):
    """'/'-joined path -> tensor of a nested dict, a QuantizedTensor's
    fields as <path>/data, /scale, /zero (JAX's flatten paths)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, QuantizedTensor):
            out.update({f"{prefix}{k}/{f}": t for f, t in
                        (("data", v.data), ("scale", v.scale), ("zero", v.zero))
                        if t is not None})
        else:
            out[prefix + k] = v
    return out


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jflat_specs(shardings):
    """JAX sharding tree -> '/'-joined path -> spec tuple (ndim long)."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    out = {}
    for path, ns in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)
        out[key] = tuple(ns.spec)
    return out


def _pad_spec(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


# ------------------------------------------------------------ param specs

@pytest.mark.parametrize("quant", ["q4bf16", "f32"])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("model,jquant", [("tiny-llama", None), ("tiny-gpt_neox", "q4f16_hs"),
                                          ("tiny-moss", None)])
def test_param_specs_match_jax(model, jquant, tp, quant):
    quant = jquant if (jquant and quant != "f32") else quant
    jp = jinit(jget_config(model), quant, seed=0)
    want = _jflat_specs(jparam_shardings(jp, jmake_mesh(tp=tp)))
    tp_params = params_from_jax(jax.tree.map(np.asarray, jp))
    leaves = _flat(tp_params)
    got = _flat_specs(param_specs(tp_params, {"dp": 1, "tp": tp}))
    assert set(got) == set(want) == set(leaves)
    for key, spec in got.items():
        assert spec == _pad_spec(want[key], leaves[key].ndim), key
    # the fallback is exercised: some dimension the rules shard is replicated
    if model == "tiny-llama" and quant == "q4bf16" and tp >= 4:
        assert got["layers/wo/scale"] == (None, None, None) and got["layers/wo/data"][1] == "tp"


@pytest.mark.parametrize("dp,tp,heads", [(2, 2, 4), (1, 8, 4), (2, 4, 8)])
def test_cache_specs_match_jax(dp, tp, heads):
    jcfg = jget_config("tiny-llama").replace(num_heads=heads, num_kv_heads=heads)
    cfg = get_config("tiny-llama").replace(num_heads=heads, num_kv_heads=heads)
    mesh = jmake_mesh(tp=tp, dp=dp)
    jc = jinit_kv_cache(jcfg, 2, 16, jnp.int8)
    want = jcache_shardings(mesh, int8=True, shapes=jc)
    tc = init_kv_cache(cfg, 2, 16, torch.int8, device="cpu")
    got = cache_shardings({"dp": dp, "tp": tp}, int8=True, shapes=tc)
    for f in ("k", "v", "lengths", "k_scale", "v_scale"):
        assert got[f] == _pad_spec(getattr(want, f).spec, getattr(tc, f).ndim), f
    jpcache = jpc.init_paged_kv_cache(jcfg, 2, 8, 8, 4, dtype=jnp.int8, head_block=1)
    want = jpaged_cache_shardings(mesh, jpcache)
    tpcache = tpc.init_paged_kv_cache(cfg, 2, 8, 8, 4, dtype=torch.int8, head_block=1,
                                      device="cpu")
    got = paged_cache_shardings({"dp": dp, "tp": tp}, tpcache)
    for f in ("k_pages", "v_pages", "page_table", "lengths", "k_scale", "v_scale"):
        assert got[f] == _pad_spec(getattr(want, f).spec, getattr(tpcache, f).ndim), f


# ------------------------------------------------------------ local shards

def _reassemble(parts, blocks):
    """Dense [..., k, n] shards -> the whole tensor: column blocks
    interleaved back (blocks: logical widths) or rows concatenated."""
    if blocks is None:
        return torch.cat(parts, dim=-2)
    out, tp = [], len(parts)
    start = [0] * tp
    for size in blocks:
        width = size // tp
        for r in range(tp):
            out.append(parts[r][..., start[r]:start[r] + width])
            start[r] += width
    return torch.cat(out, dim=-1)


def _dense(x, layer):
    x = x.map(lambda t: t[layer]) if isinstance(x, QuantizedTensor) else x[layer]
    return dequantize(x, "float32") if isinstance(x, QuantizedTensor) else x


@pytest.mark.parametrize("quant", ["q4bf16", "q4bf16_hs", "q4bf16_plane", "q8bf16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_local_shards_reassemble_bit_equal(quant, tp):
    cfg = w.config("tiny-llama")
    full = init_random_params(cfg, quant, seed=3, device="cpu")
    pair = _repack_hsplit_for_sharding(full)
    parts = [local_params(pair, cfg, r, tp) for r in range(tp)]
    d, F = cfg.head_dim, cfg.intermediate_size
    blocks = {"wqkv": [cfg.num_heads * d] * 3, "w_in": [F, F], "wo": None, "w_out": None}
    for name, blk in blocks.items():
        for layer in range(cfg.num_layers):
            want = _dense(full["layers"][name], layer)
            got = _reassemble([_dense(p["layers"][name], layer) for p in parts], blk)
            assert torch.equal(got, want), (name, layer)
        for p in parts:
            leaf = p["layers"][name]
            if isinstance(leaf, QuantizedTensor):
                assert leaf.spec.layout in ("pair", full["layers"][name].spec.layout)
                assert leaf.data.shape[-1] == pad_cols(leaf.shape[1])
    for key in ("embed", "lm_head"):
        whole = dequantize(full[key]["w"], "float32")
        got = torch.cat([dequantize(p[key]["w"], "float32") for p in parts], dim=1)
        assert torch.equal(got, whole), key


def test_indivisible_layer_weight_raises():
    # tiny-llama (H = 64, 4 heads of 16) at tp = 4: wo's k splits into 16
    # rows a rank, half a group of 32 (JAX shards its data, replicates its
    # scales)
    cfg = get_config("tiny-llama")
    params = init_random_params(cfg, "q4bf16", seed=0, device="cpu")
    with pytest.raises(ValueError, match="layers/wo"):
        local_params(_repack_hsplit_for_sharding(params), cfg, 0, 4)
    with pytest.raises(ValueError, match="layers/wqkv"):
        local_params(params, cfg, 0, 8)


def _meta_params(cfg, quant):
    """Llama-65B's param tree on the meta device, in quantize()'s stored
    layout (no memory)."""
    spec = resolve_spec(quant)
    H, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    meta = dict(device="meta")

    def qt(k, n, stacked=True):
        lead = (L,) if stacked else ()
        G = k // spec.group_size
        return QuantizedTensor(
            data=torch.empty((*lead, G * words_per_group(spec), pad_cols(n)), dtype=torch.int32,
                             **meta),
            scale=torch.empty((*lead, G, pad_cols(n)), dtype=torch.bfloat16, **meta),
            zero=None, spec=spec, shape=(k, n))

    layers = {"wqkv": qt(H, 3 * H), "wo": qt(H, H), "w_in": qt(H, 2 * F), "w_out": qt(F, H),
              "ln1_w": torch.empty((L, H), **meta), "ln2_w": torch.empty((L, H), **meta)}
    return {"embed": {"w": qt(H, V, False)}, "layers": layers,
            "final_ln": {"w": torch.empty((H,), **meta)}, "lm_head": {"w": qt(H, V, False)}}


def test_llama65b_shard_plan_on_meta():
    cfg = get_config("llama-65b")
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads) == (8192, 22016, 64)
    params = _repack_hsplit_for_sharding(_meta_params(cfg, "q4bf16"))
    H, F, V, L, tp = 8192, 22016, 32000, cfg.num_layers, 8
    # (logical k, n) and stored data / scale shapes of every rank's leaf
    want = {"wqkv": (H, 3 * H // tp), "wo": (H // tp, H), "w_in": (H, 2 * F // tp),
            "w_out": (F // tp, H)}
    for rank in range(tp):
        local = local_params(params, cfg, rank, tp)
        for name, (k, n) in want.items():
            leaf = local["layers"][name]
            assert leaf.spec.layout == "pair" and leaf.shape == (k, n), name
            assert leaf.data.shape == (L, k // 8, pad_cols(n)), name
            assert leaf.scale.shape == (L, k // 32, pad_cols(n)), name
        for key in ("embed", "lm_head"):
            leaf = local[key]["w"]
            assert leaf.shape == (H, V // tp) and leaf.data.shape == (H // 8, 4096), key
        assert local["layers"]["ln1_w"].shape == (L, H)
    # w_out: 2752 rows a rank = 86 groups; lm head 4000 columns stored 4096
    assert F // tp == 2752 and pad_cols(V // tp) == 4096


# ------------------------------------------------------- TP process groups

def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_JPARAMS = {}


def _params(model, quant):
    """(JAX params, the port's) of a case's widened config, seed 1."""
    if (model, quant) not in _JPARAMS:
        jcfg = jget_config(model).replace(**w.WIDE)
        jp = jinit(jcfg, quant, seed=1)
        _JPARAMS[(model, quant)] = (jp, params_from_jax(jax.tree.map(np.asarray, jp)))
    return _JPARAMS[(model, quant)]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Run every case of torch_tp_worker.CASES: one gloo group of 2 ranks
    and one of 4 at once, each rank a process; returns the output dir."""
    out = tmp_path_factory.mktemp("tp")
    for model, quant, _, _ in w.CASES.values():
        torch.save(_params(model, quant)[1], out / f"{model}-{quant}.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        port = str(_free_port())
        procs += [subprocess.Popen([sys.executable, WORKER, str(world), str(r), port, str(out)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                   env=env, cwd=REPO) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # the exact processes started here
                p.communicate()
    bad = [log for p, log in zip(procs, logs) if p.returncode != 0]
    assert not bad, "\n---\n".join(bad)
    return out


def _jax_forward(case):
    """JAX's sharded forward on the virtual mesh: the same prefill and
    decode steps as torch_tp_worker.run_forward, every row."""
    model, quant, shape, kind = w.CASES[case]
    jp, _ = _params(model, quant)
    jcfg = jget_config(model).replace(**w.WIDE)
    if "dcn" in shape:
        mesh = jmake_pod_mesh(tp=shape["tp"], dp=shape["dp"], dcn=shape["dcn"])
        sp = jshard_params_pod(jp, mesh)
    else:
        mesh = jmake_mesh(tp=shape["tp"], dp=shape["dp"])
        sp = jshard_params(jp, mesh)
    if kind == "slot":
        cache = jshard_cache(jinit_kv_cache(jcfg, 2, 32, JDT[w.cache_dtype(quant)]), mesh)
    else:
        dtype = jnp.bfloat16 if kind == "paged_bf16" else jnp.int8
        c = jpc.init_paged_kv_cache(jcfg, 2, w.NUM_PAGES, w.PAGE_SIZE, w.MAX_PAGES,
                                    dtype=dtype, head_block=w.HEAD_BLOCK)
        c = jpc.PagedKVCache(k_pages=c.k_pages, v_pages=c.v_pages,
                             page_table=jnp.asarray(w.PAGE_TABLE), lengths=c.lengths,
                             k_scale=c.k_scale, v_scale=c.v_scale)
        cache = jshard_paged_cache(c, mesh)
    fwd = jax.jit(jforward, static_argnames=("cfg",))
    lg, cache = fwd(sp, jcfg, jnp.asarray(w.TOKENS, jnp.int32), cache,
                    seq_lens=jnp.asarray(w.SEQ_LENS, jnp.int32))
    out = [np.asarray(lg)]
    for step in w.DECODE:
        lg, cache = fwd(sp, jcfg, jnp.asarray(step, jnp.int32), cache)
        out.append(np.asarray(lg))
    return out


@pytest.mark.parametrize("case", [c for c, v in w.CASES.items() if v[3] != "engine"])
def test_tp_forward_matches_unsharded_and_jax(tp_runs, case):
    model, quant, shape, kind = w.CASES[case]
    world = int(np.prod(list(shape.values())))
    cfg = w.config(model)
    _, params = _params(model, quant)
    cache = w.make_cache(cfg, kind, quant, 2)
    if kind != "slot":
        cache.set_page_table(w.PAGE_TABLE)
    ref = [t.numpy() for t in w.run_forward(params, cfg, cache, [0, 1])]
    jref = _jax_forward(case)
    # int8 pages: an absmax/127 code at a rounding tie flips with the last
    # f32 bit of K, which a sharded matmul sums in another order (one flip
    # moved a logit by 1.3e-4 here)
    tol = 2e-2 if quant != "f32" else 1e-3 if kind == "paged_int8" else 1e-4
    for rank in range(world):
        got = torch.load(tp_runs / f"{case}.{rank}.pt", weights_only=False)
        d = (rank // shape["tp"]) % shape["dp"]
        rows = slice(d * 2 // shape["dp"], (d + 1) * 2 // shape["dp"])
        assert len(got) == len(ref) == 1 + len(w.DECODE)
        for g, r, j in zip(got, ref, jref):
            assert g.shape == r[rows].shape
            np.testing.assert_allclose(g.numpy(), r[rows], atol=tol, rtol=tol)
            np.testing.assert_allclose(g.numpy(), j[rows], atol=5e-2, rtol=0)


def test_tp_engine_streams_match_unsharded(tp_runs):
    model, quant, _, _ = w.CASES["engine"]
    want = w.run_engines(_params(model, quant)[1], w.config(model))
    for rank in range(2):
        assert torch.load(tp_runs / f"engine.{rank}.pt", weights_only=False) == want


def test_initialize_without_coordinator_is_a_noop():
    # one process and no coordinator: no process group, as JAX's initialize
    env = os.environ.pop("MLC_COORDINATOR", None)
    try:
        multihost.initialize(backend="gloo")
        assert not torch.distributed.is_initialized()
    finally:
        if env is not None:
            os.environ["MLC_COORDINATOR"] = env


@pytest.mark.parametrize("G,Hq,tp", [(4, 32, 2), (4, 32, 8), (2, 32, 4), (8, 12, 8), (1, 8, 1)])
def test_paged_flash_tp_rule_matches_jax(monkeypatch, G, Hq, tp):
    """JAX's rule for a sharded paged decode on kernel 7 (tp divides the
    pool's head groups and the query heads); the port's engine raises where
    it fails (no rank-local pool)."""
    import types

    monkeypatch.setenv("MLC_PAGED_TP_INTERPRET", "1")  # JAX's CPU opt-in
    want = jpc.paged_flash_tp_enabled(G, Hq, jmake_mesh(tp=tp))
    mesh = types.SimpleNamespace(mesh_dim_names=("dp", "tp"), shape=(1, tp))
    assert tpc.paged_flash_tp_enabled(G, Hq, mesh) == want
    assert not tpc.paged_flash_tp_enabled(G, Hq, None)
