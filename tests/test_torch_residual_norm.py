"""Kernel 9, the residual sum and norm(s) of a decoder norm site
(``ops/norm.py``, ``csrc/residual_norm.cu``), on the CPU.

The CUDA kernel has no interpret mode; its row math is emulated here in
torch, with the kernel's f32 reduction order (``launch_plan``'s thread
layout, the warp's xor shuffles, the warps' partials in order) and its
rounding points, and held against the plain op chain and the JAX
package's norms with the same adds. The CPU wrapper is held bit for bit
to the op chain the decoder ran before the kernel, and the decoder's
restructured layer loop to the layer order before it. The kernel itself
is held to the chain on the card in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.models import layers as jax_layers
from mlc_llm_tpu_torch.models import (
    MODEL_REGISTRY,
    forward,
    forward_block,
    forward_decode,
    get_config,
    init_kv_cache,
    init_paged_kv_cache,
    init_random_params,
)
from mlc_llm_tpu_torch.models import transformer as tr
from mlc_llm_tpu_torch.models.transformer import pad_params
from mlc_llm_tpu_torch.ops import kernel_wrappers
from mlc_llm_tpu_torch.ops import norm

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16, torch.float32: jnp.float32}
EPS = 1e-5


# ---------------------------------------------------------------- emulation

def _block_sum(vals, threads):
    """The kernel's block_sum of per-thread terms vals [R, threads, n]: each
    thread adds its n terms in order from 0, the warp reduces by xor
    shuffles (own + other), then the warps' partials add in warp order."""
    R = vals.shape[0]
    s = torch.zeros((R, threads))
    for j in range(vals.shape[-1]):
        s = s + vals[..., j]
    w = s.reshape(R, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., torch.arange(32) ^ o]
    total = torch.zeros(R)
    for k in range(threads // 32):
        total = total + w[:, k, 0]
    return total


def emulate(h, terms, biases, norms, eps, kind, clamp):
    """The kernel's row math in torch: f32 from the dtype, each biased term
    and each add rounded to the dtype, the clamp against the bound rounded
    to the dtype, the statistics reduced in the kernel's order, every
    product and sum rounded once, the outputs rounded once."""
    dtype, H = h.dtype, h.shape[-1]
    vec = 16 // h.element_size()
    vpt, threads = norm.launch_plan(H, dtype)

    def rnd(v):
        return v.to(dtype).float()

    x = h.reshape(-1, H).float()
    for t, b in zip(terms, biases):
        t = t.reshape(-1, H).float()
        if b is not None:
            t = rnd(t + b.float())
        x = rnd(x + t)
    if terms and clamp is not None:
        c = float(torch.tensor(clamp, dtype=dtype))
        x = torch.where(x > c, c, torch.where(x < -c, -c, x))
    R = x.shape[0]
    # thread t's elements: vectors t, t + threads, ..., VEC elements each
    pad = torch.zeros((R, threads * vpt * vec))
    pad[:, :H] = x
    live = torch.zeros_like(pad, dtype=torch.bool)
    live[:, :H] = True

    def per_thread(v):
        return v.reshape(R, vpt, threads, vec).permute(0, 2, 1, 3).reshape(R, threads, -1)

    xt = per_thread(pad)
    n = torch.tensor(float(H))
    if kind == "rmsnorm":
        s = _block_sum(xt * xt, threads)
        mean = None
        r = 1.0 / torch.sqrt(s / n + torch.tensor(eps, dtype=torch.float32))
    else:
        s = _block_sum(xt, threads)
        mean = s / n
        d = torch.where(per_thread(live), xt - mean[:, None, None], torch.zeros(()))
        q = _block_sum(d * d, threads)
        r = 1.0 / torch.sqrt(q / n + torch.tensor(eps, dtype=torch.float32))
    outs = []
    for w, b in norms:
        if kind == "rmsnorm":
            y = (x * r[:, None]) * w.float()
        else:
            y = ((x - mean[:, None]) * r[:, None]) * w.float() + b.float()
        outs.append(y.to(dtype).reshape(h.shape))
    return x.to(dtype).reshape(h.shape), outs


def _site(shape, dtype, kind, nterms, nnorms, biased, seed=0, big=False):
    g = torch.Generator().manual_seed(seed)

    def rand(*s, center=0.0, std=1.0):
        return (center + std * torch.randn(s, generator=g)).to(dtype)

    H = shape[-1]
    if big:  # f16 rows near 65504: h + t passes the clamp bound or overflows
        h, *terms = (((torch.rand(shape, generator=g) * 2 - 1) * 40000.0).to(dtype)
                     for _ in range(1 + nterms))
    else:
        h, terms = rand(*shape), [rand(*shape) for _ in range(nterms)]
    biases = [rand(H, std=0.1) if biased else None for _ in range(nterms)]
    norms = [(rand(H, center=1.0, std=0.1), rand(H, std=0.1) if kind == "layernorm" else None)
             for _ in range(nnorms)]
    return h, terms, biases, norms


def _assert_within_one_ulp(got, want):
    """16-bit: the same value or its neighbour (a sum in another order may
    round the other way next to a rounding boundary); f32: a few ulps of
    the row's scale, the order's difference unrounded."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
        return
    bits = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    near_zero = (got.float() - want.float()).abs() <= 1e-6
    assert bool(((bits <= 1) | near_zero).all()), int(bits.max())


def _jax_site(h, terms, biases, norms, eps, kind, clamp):
    """The same site through the JAX package's norms, the adds in jnp."""
    dt = JNP[h.dtype]

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(dt)

    x = j(h)
    for t, b in zip(terms, biases):
        t = j(t) if b is None else j(t) + j(b)
        x = x + t
    if terms and clamp is not None:
        x = jnp.clip(x, dt(-clamp), dt(clamp))
    if kind == "rmsnorm":
        outs = [jax_layers.rms_norm(x, j(w), eps) for w, _ in norms]
    else:
        outs = [jax_layers.layer_norm(x, j(w), j(b), eps) for w, b in norms]

    def back(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(h.dtype)

    return back(x), [back(o) for o in outs]


SITES = [  # (kind, terms, norms, biased)
    ("layernorm", 0, 1, False), ("layernorm", 0, 2, False),
    ("layernorm", 1, 1, False), ("layernorm", 1, 1, True),
    ("layernorm", 2, 2, True), ("layernorm", 2, 1, True), ("layernorm", 2, 2, False),
    ("rmsnorm", 0, 1, False), ("rmsnorm", 1, 1, False), ("rmsnorm", 1, 2, True),
    ("rmsnorm", 2, 1, True),
]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("kind,nterms,nnorms,biased", SITES,
                         ids=[f"{k[:3]}-{t}t-{n}n-{'b' if b else 'nb'}" for k, t, n, b in SITES])
@pytest.mark.parametrize("shape", [(3, 64), (2, 3, 200), (5, 2560)], ids=["64", "200", "2560"])
def test_emulation_matches_plain_chain_and_jax(dtype, kind, nterms, nnorms, biased, shape):
    assert norm.residual_norm_supported(shape[-1], dtype)
    h, terms, biases, norms = _site(shape, dtype, kind, nterms, nnorms, biased)
    clamp = 55504.0 if dtype == torch.float16 and nterms else None
    got_h, got = emulate(h, terms, biases, norms, EPS, kind, clamp)
    want_h, want = norm.residual_norm_plain(h, terms, biases, norms, EPS, kind, clamp)
    jax_h, jax_out = _jax_site(h, terms, biases, norms, EPS, kind, clamp)
    assert torch.equal(got_h, want_h)
    assert torch.equal(got_h, jax_h)
    for a, b, c in zip(got, want, jax_out):
        _assert_within_one_ulp(a, b)
        _assert_within_one_ulp(a, c)


@pytest.mark.parametrize("R", [1, 8, 33])
def test_emulation_clamps_f16_rows_near_65504(R):
    h, terms, biases, norms = _site((R, 2560), torch.float16, "layernorm", 2, 2, True, big=True)
    got_h, got = emulate(h, terms, biases, norms, EPS, "layernorm", 55504.0)
    want_h, want = norm.residual_norm_plain(h, terms, biases, norms, EPS, "layernorm", 55504.0)
    jax_h, jax_out = _jax_site(h, terms, biases, norms, EPS, "layernorm", 55504.0)
    # the bound as torch.clamp and jnp.clip apply it to f16: 55504 rounds to 55488
    assert float(want_h.abs().max()) == 55488.0
    assert bool((h.float() + terms[0].float()).abs().max() > 55504.0)
    assert torch.equal(got_h, want_h) and torch.equal(got_h, jax_h)
    for a, b, c in zip(got, want, jax_out):
        assert bool(torch.isfinite(a.float()).all())
        _assert_within_one_ulp(a, b)
        _assert_within_one_ulp(a, c)


def _old_chain(h, terms, biases, norms, eps, kind, clamp):
    """The decoder's ops before the kernel, written out: each row-parallel
    bias added in qmatmul_stacked, h + attn_out + mlp_out, the f16 clamp,
    then _norm's layer_norm or rms_norm of models/layers.py."""
    terms = [t if b is None else t + b.to(t.dtype) for t, b in zip(terms, biases)]
    for t in terms:
        h = h + t
    if clamp is not None:
        h = h.clamp(-clamp, clamp)
    outs = []
    for w, b in norms:
        xf = h.float()
        if kind == "rmsnorm":
            var = (xf * xf).mean(dim=-1, keepdim=True)
            outs.append((xf * torch.rsqrt(var + eps) * w.float()).to(h.dtype))
        else:
            mean = xf.mean(dim=-1, keepdim=True)
            var = (xf - mean).square().mean(dim=-1, keepdim=True)
            out = (xf - mean) * torch.rsqrt(var + eps)
            outs.append((out * w.float() + b.float()).to(h.dtype))
    return h, outs


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("kind,nterms,nnorms,biased", SITES,
                         ids=[f"{k[:3]}-{t}t-{n}n-{'b' if b else 'nb'}" for k, t, n, b in SITES])
def test_cpu_wrapper_is_the_old_op_chain(dtype, kind, nterms, nnorms, biased):
    h, terms, biases, norms = _site((2, 3, 96), dtype, kind, nterms, nnorms, biased, seed=7)
    clamp = 55504.0 if dtype == torch.float16 and nterms else None
    before = norm.residual_norm.launches
    got_h, got = norm.residual_norm(h, terms, biases, norms, EPS, kind, clamp)
    assert norm.residual_norm.launches == before  # the CPU runs the chain, no kernel
    want_h, want = _old_chain(h, terms, biases, norms, EPS, kind, clamp)
    assert torch.equal(got_h, want_h) and len(got) == nnorms
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if not nterms:
        assert got_h is h


@pytest.mark.parametrize("case", ["kind", "terms", "norms", "term-shape", "param-shape",
                                  "shift", "clamp", "clamp-no-terms", "strided"])
def test_wrapper_refuses_bad_sites(case):
    h, terms, biases, norms = _site((2, 64), torch.bfloat16, "layernorm", 1, 1, True)
    kind, clamp = "layernorm", None
    if case == "kind":
        kind = "batchnorm"
    elif case == "terms":
        terms, biases = terms * 3, biases * 3
    elif case == "norms":
        norms = []
    elif case == "term-shape":
        terms = [terms[0][:1]]
    elif case == "param-shape":
        biases = [biases[0][:32]]
    elif case == "shift":
        kind = "rmsnorm"  # a shift given to an RMSNorm
    elif case == "strided":  # the kernel's rows are contiguous; so are the chain's inputs
        h = h.T.contiguous().T
    elif case == "clamp-no-terms":  # the clamp bounds a residual sum, and there is none
        terms, biases, clamp = [], [], 55504.0
    else:
        clamp = 0.0
    with pytest.raises(ValueError):
        norm.residual_norm(h, terms, biases, norms, EPS, kind, clamp)


def test_every_preset_hidden_size_passes_the_gate():
    sizes = {c.hidden_size for c in MODEL_REGISTRY.values()}
    assert {2560, 4096, 5120, 6144, 8192} <= sizes
    for H in sizes:
        for dtype in DTYPES.values():
            assert norm.residual_norm_supported(H, dtype), (H, dtype)
            vpt, threads = norm.launch_plan(H, dtype)
            vec = 16 // torch.empty((), dtype=dtype).element_size()
            assert threads % 32 == 0 and 32 <= threads <= norm.MAX_THREADS
            assert vpt in norm.VPTS and threads * vpt * vec >= H
            # no whole warp idles
            assert (threads - 32) * vpt * vec < H


def test_gate_refuses_what_the_kernel_cannot_take():
    assert not norm.residual_norm_supported(2564, torch.bfloat16)  # not whole 16-byte vectors
    assert norm.residual_norm_supported(2564, torch.float32)
    assert not norm.residual_norm_supported(2562, torch.float32)
    assert not norm.residual_norm_supported(4096, torch.int8)
    assert norm.residual_norm_supported(16384, torch.float16)
    assert not norm.residual_norm_supported(16384 + 8, torch.float16)  # past 512 threads of 4
    assert norm.residual_norm_supported(8192, torch.float32)
    assert not norm.residual_norm_supported(8192 + 4, torch.float32)
    assert norm.launch_plan(2560, torch.float16) == (1, 320)
    assert norm.launch_plan(6144, torch.bfloat16) == (2, 384)
    assert norm.launch_plan(8192, torch.float32) == (4, 512)


def test_residual_norm_is_a_counted_kernel_wrapper():
    from mlc_llm_tpu_torch import ops

    assert ops.KERNELS[-1] == "residual_norm"
    assert kernel_wrappers()[-1] is norm.residual_norm
    assert isinstance(norm.residual_norm.launches, int)


# ------------------------------------------- the decoder against its old order

def _old_layer(h, lp, weights, cache, l, cfg, rot_cos, rot_sin, positions, slot_index, slots,
               start_dev, attn_window, paged, prefill_flash, tp):
    """The layer as the decoder ran it before its norm sites were fused:
    its norms at its entry, the residual and clamp in its tail."""
    from mlc_llm_tpu_torch.models.layers import activate, apply_rotary
    from mlc_llm_tpu_torch.ops.norm import layer_norm, rms_norm
    from mlc_llm_tpu_torch.ops.matmul import qmatmul_stacked

    def _norm(x, w, b):
        return rms_norm(x, w, cfg.norm_eps) if cfg.norm_type == "rmsnorm" else layer_norm(
            x, w, b, cfg.norm_eps)

    def row_parallel(x, w, bias):
        return qmatmul_stacked(x, w, l, bias)

    B, S, _ = h.shape
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h_mlp_in = None
    if cfg.single_norm:
        h_attn_in = h_mlp_in = _norm(h, lp["ln1_w"], lp.get("ln1_b"))
    else:
        h_attn_in = _norm(h, lp["ln1_w"], lp.get("ln1_b"))
        if cfg.parallel_residual:
            h_mlp_in = _norm(h, lp["ln2_w"], lp.get("ln2_b"))
    qkv = qmatmul_stacked(h_attn_in, weights["wqkv"], l, lp.get("bqkv"))
    q, k, v = qkv.split([nh * d, nkv * d, nkv * d], dim=-1)
    q = apply_rotary(q.reshape(B, S, nh, d), rot_cos, rot_sin, positions, cfg.rotary_style)
    k = apply_rotary(k.reshape(B, S, nkv, d), rot_cos, rot_sin, positions, cfg.rotary_style)
    v = v.reshape(B, S, nkv, d)
    if paged is not None:
        attn = tr._attend_paged(q, k, v, cache, l, paged, start_dev, d, tp)
    else:
        attn = tr._attend_slot(q, k, v, cache, l, slot_index, start_dev, attn_window, slots,
                               prefill_flash)
    attn = attn.transpose(1, 2).reshape(B, S, nh * d)
    attn_out = row_parallel(attn, weights["wo"], lp.get("bo"))
    if h_mlp_in is None:
        h = h + attn_out
        h_mlp_in = _norm(h, lp["ln2_w"], lp.get("ln2_b"))
    if cfg.act == "silu_gated":
        gate, up = qmatmul_stacked(h_mlp_in, weights["w_in"], l, lp.get("b_in")).chunk(2, -1)
        mid = torch.nn.functional.silu(gate) * up
    else:
        mid = activate(qmatmul_stacked(h_mlp_in, weights["w_in"], l, lp.get("b_in")), cfg.act)
    mlp_out = row_parallel(mid, weights["w_out"], lp.get("b_out"))
    if cfg.parallel_residual or cfg.single_norm:
        h = h + attn_out + mlp_out
    else:
        h = h + mlp_out
    if h.dtype == torch.float16:
        h = h.clamp(-55504.0, 55504.0)
    return h, _norm


def _old_forward(params, cfg, tokens, cache, slots, start_dev, seq_lens, last_only,
                 attn_window, prefill_flash=False, mesh=None):
    """transformer._forward with the layer order before the fused sites."""
    assert mesh is None
    B, S = tokens.shape
    dev = tokens.device
    positions = (start_dev[:, None] + torch.arange(S, device=dev)[None, :]).clamp(
        max=cache.max_len - 1)
    paged = slot_index = None
    if isinstance(cache, tr.PagedKVCache):
        maxp = cache.page_table.shape[1]
        if attn_window is not None:
            maxp = min(maxp, -(-attn_window // cache.page_size))
        table = cache.page_table if slots is None else cache.page_table.index_select(0, slots)
        paged = tr._PagedStep(index=tr.paged_write_index(table, start_dev, S, cache.page_size),
                              lengths=start_dev.to(torch.int32), maxp=maxp, table=table,
                              decode=S == 1 and slots is None)
    else:
        slot_index = tr.slot_write_index(start_dev, S, cache.max_len, slots)
    h = tr._embed(params["embed"]["w"], tokens, cfg, None)
    rot_cos, rot_sin = params["rotary"]["cos"], params["rotary"]["sin"]
    weights = {k: v for k, v in params["layers"].items() if k in tr.WEIGHT_KEYS}
    small = {k: v for k, v in params["layers"].items() if k not in tr.WEIGHT_KEYS}
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in small.items()}
        h, _norm = _old_layer(h, lp, weights, cache, l, cfg, rot_cos, rot_sin, positions,
                              slot_index, slots, start_dev, attn_window, paged, prefill_flash,
                              None)
    h = _norm(h, params["final_ln"]["w"], params["final_ln"].get("b"))
    if last_only:
        h = h[torch.arange(B, device=dev), (seq_lens - 1).clamp(0, S - 1)][:, None]
    if cfg.fp32_lm_head:
        h = h.float()
    logits = tr._lm_head(h, params["lm_head"], cfg, None)
    return logits[:, 0] if last_only else logits


MODELS = {  # (config, quant)
    "llama": (get_config("tiny-llama"), "q4bf16"),
    "llama-f16": (get_config("tiny-llama"), "q4f16"),
    "gpt_neox": (get_config("tiny-gpt_neox"), "q4f16_hs"),
    "gpt_neox-seq": (get_config("tiny-gpt_neox").replace(parallel_residual=False), "q4f32"),
    "moss": (get_config("tiny-moss"), "q4bf16"),
}


def _model(name):
    cfg, quant = MODELS[name]
    params = pad_params(init_random_params(cfg, quant, seed=1, device="cpu"))
    g = torch.Generator().manual_seed(2)
    for k, v in params["layers"].items():  # norms and biases away from 1 and 0
        if k not in tr.WEIGHT_KEYS:
            params["layers"][k] = (v.float() + 0.1 * torch.randn(v.shape, generator=g)).to(v.dtype)
    for k, v in params["final_ln"].items():
        params["final_ln"][k] = (v.float() + 0.1 * torch.randn(v.shape, generator=g)).to(v.dtype)
    return cfg, params


def _cache(cfg, params, kind, batch=3):
    dt = params["layers"]["ln1_w"].dtype
    if kind == "slot":
        return init_kv_cache(cfg, batch, dtype=dt, device="cpu")
    maxp = cfg.max_seq_len // 16
    cache = init_paged_kv_cache(cfg, batch, batch * maxp + 1, page_size=16, dtype=dt,
                                device="cpu")
    cache.page_table[:] = torch.arange(1, 1 + batch * maxp, dtype=torch.int32).reshape(batch, maxp)
    return cache


def _clone(cache):
    return dataclasses.replace(cache, **{f.name: getattr(cache, f.name).clone()
                                         for f in dataclasses.fields(cache)
                                         if isinstance(getattr(cache, f.name), torch.Tensor)})


def _run_all(cfg, params, cache):
    """forward, forward_block on two of the slots, then two decode steps:
    every output and the cache."""
    g = torch.Generator().manual_seed(3)
    out = []
    lg, cache = forward(params, cfg, torch.randint(3, 250, (3, 11), generator=g), cache,
                        seq_lens=[11, 6, 9], last_only=False)
    out.append(lg)
    slots = torch.tensor([2, 0])
    starts = cache.lengths.index_select(0, slots)
    cache.lengths_dev.copy_(cache.lengths)
    out.append(forward_block(params, cfg, torch.randint(3, 250, (2, 5), generator=g), cache,
                             slots, starts, torch.tensor([5, 3])))
    cache.lengths[slots] = starts + torch.tensor([5, 3])
    for _ in range(2):
        out.append(forward_decode(params, cfg, torch.randint(3, 250, (3, 1), generator=g), cache,
                                  torch.tensor([1, 1, 0])))
    tensors = [getattr(cache, f.name) for f in dataclasses.fields(cache)
               if isinstance(getattr(cache, f.name), torch.Tensor)]
    return out + tensors


@pytest.mark.parametrize("kv", ["slot", "paged"])
@pytest.mark.parametrize("name", MODELS)
def test_decoder_is_bit_equal_to_the_old_layer_order(name, kv, monkeypatch):
    cfg, params = _model(name)
    cache = _cache(cfg, params, kv)
    new = _run_all(cfg, params, _clone(cache))
    monkeypatch.setattr(tr, "_forward", _old_forward)
    old = _run_all(cfg, params, _clone(cache))
    assert len(new) == len(old)
    for a, b in zip(new, old):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["llama", "gpt_neox", "gpt_neox-seq", "moss"])
def test_each_forward_runs_one_site_a_norm(name, monkeypatch):
    # layer 0's entry, one site between layers, the final norm with the
    # last residual: L + 1 calls; the sequential residual adds one a layer
    cfg, params = _model(name)
    calls = []

    def spy(h, terms, biases, norms, eps, kind, clamp):
        calls.append((len(terms), len(norms), clamp))
        return norm.residual_norm(h, terms, biases, norms, eps, kind, clamp)

    monkeypatch.setattr(tr, "residual_norm", spy)
    cache = _cache(cfg, params, "slot")
    forward(params, cfg, torch.randint(3, 250, (3, 4)), cache)
    L = cfg.num_layers
    sequential = not (cfg.parallel_residual or cfg.single_norm)
    n_entry = 2 if cfg.parallel_residual and not cfg.single_norm else 1
    clamp = 55504.0 if params["layers"]["ln1_w"].dtype == torch.float16 else None
    # a layer's sites: (h + attn_out, ln2) unclamped under the sequential
    # residual, then its end, clamped in f16, with the next entry's norms
    layer = ([(1, 1, None), (1, n_entry, clamp)] if sequential else [(2, n_entry, clamp)])
    want = [(0, n_entry, None)] + layer * L
    want[-1] = want[-1][:1] + (1,) + want[-1][2:]  # the last end takes final_ln
    assert calls == want


def test_row_stride_reads_rows_at_one_stride():
    # the matmuls' outputs are column slices of their padded buffers
    assert norm.row_stride(torch.zeros(2, 5, 128)[..., :64]) == 128
    assert norm.row_stride(torch.zeros(2, 5, 64)) == 64
    assert norm.row_stride(torch.zeros(8, 1, 128)[..., :64]) == 128
    assert norm.row_stride(torch.zeros(8, 64).as_strided((8, 1, 64), (64, 999, 1))) == 64
    assert norm.row_stride(torch.zeros(1, 1, 64)) == 64
    # rows out of order, columns apart, rows that overlap
    assert norm.row_stride(torch.zeros(2, 5, 64).transpose(0, 1)) is None
    assert norm.row_stride(torch.zeros(64, 2).T) is None
    assert norm.row_stride(torch.zeros(64).expand(4, 64)) is None
