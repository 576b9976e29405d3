"""The port's prefill programs against the JAX engine's, on the CPU.

Every prefill the port runs is a step program (``engine/programs.py``)
over ``forward_block``: the target slots, starts and seq_lens are device
tensors, so one graph serves every slot. These tests hold the programs
against the JAX engine's jitted ``_prefill``, ``_prefill_slot`` (fresh,
append, a chunked second segment), ``_prefill_slots`` (G = 2, 4) and
``_prefill_slot_paged`` (positions past the table's capacity, an adopted
prefix) on the same f32 weights, in bf16 and int8 KV, at the port's
tolerance against JAX (atol = rtol = 5e-2, tests/test_pallas_kernels.py):
the logits and the written K/V rows (int8 dequantized). The other slots'
rows must be bit-equal to what they were. The device-index path is also
held against the host-driven ``forward`` on the same inputs, bit for bit,
and the keys ``precompile`` captures against the programs JAX's
``precompile`` compiles.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu_torch.engine import InferenceEngine
from mlc_llm_tpu_torch.models import forward, forward_block, get_config, init_kv_cache
from mlc_llm_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

TOL = dict(atol=5e-2, rtol=5e-2)
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}
MODELS = ("tiny-llama", "tiny-gpt_neox")


@pytest.fixture(scope="module")
def model(request):
    jcfg = jget_config(request.param)  # parametrized indirectly
    jp = jinit(jcfg, "f32", seed=1)
    return request.param, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _engines(model, kv, layout):
    name, jcfg, jp, tp = model
    kw = dict(max_batch=4, max_seq_len=64)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    jdt, tdt = KV[kv]
    return (JEngine(jcfg, jp, cache_dtype=jdt, **kw),
            InferenceEngine(get_config(name), tp, cache_dtype=tdt, device="cpu", **kw))


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 256, n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.float()
    return None if x is None else np.asarray(x, np.float32)


def _slot_rows(cache, slot, n, D, table=None):
    """K and V of a slot's positions [0, n), f32 [L, H, n, D] each (int8
    dequantized), from a JAX or a port cache of either layout (table: the
    paged layout's host page table)."""
    if table is None:
        k, v = _np(cache.k)[:, slot, :, :n], _np(cache.v)[:, slot, :, :, :n].swapaxes(-1, -2)
        if cache.k_scale is not None:
            k = k * _np(cache.k_scale)[:, slot, :, :n, None]
            v = v * _np(cache.v_scale)[:, slot, :, :n, None]
        return k, v
    ps = cache.k_pages.shape[3]
    pos = np.arange(n)
    pid, off = table[slot][pos // ps], pos % ps
    out = []
    for pages, scales in ((cache.k_pages, cache.k_scale), (cache.v_pages, cache.v_scale)):
        x = _np(pages)[:, :, pid, off]  # [G, L, n, hb*D]
        G, L = x.shape[:2]
        hb = x.shape[-1] // D
        x = x.reshape(G, L, n, hb, D)
        if scales is not None:
            sc = _np(scales)
            if scales is cache.k_scale:  # [G, L, P, hb, ps] -> [G, L, P, ps, hb]
                sc = sc.swapaxes(3, 4)
            x = x * sc[:, :, pid, off][..., None]
        out.append(x.transpose(1, 0, 3, 2, 4).reshape(L, G * hb, n, D))
    return tuple(out)


def _check(jeng, eng, jl, tl, slot_lens):
    """Logits and the K/V rows of every (slot, n) at the port's tolerance."""
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), **TOL)
    table = None
    if eng.kv_layout == "paged":
        table = eng._table_np
        np.testing.assert_array_equal(table, jeng._table_np)
    D = eng.cfg.head_dim
    for slot, n in slot_lens:
        for a, b in zip(_slot_rows(eng.cache, slot, n, D, table),
                        _slot_rows(jeng.cache, slot, n, D, table)):
            np.testing.assert_allclose(a, b, **TOL)
    assert eng.cache.lengths.tolist() == np.asarray(jeng.cache.lengths).tolist()


def _untouched(eng, targets, fn):
    """Run fn, a prefill into the slots `targets`; every other slot's rows
    (slot layout), or every page outside the targets' table rows but the
    null page (paged), is bit-equal after."""
    c = eng.cache
    paged = eng.kv_layout == "paged"
    names = ("k_pages", "v_pages", "k_scale", "v_scale") if paged else ("k", "v", "k_scale",
                                                                        "v_scale")
    before = {n: getattr(c, n).clone() for n in names if getattr(c, n) is not None}
    out = fn()
    if paged:
        theirs = {int(p) for s in targets for p in eng._table_np[s]}
        keep = sorted(set(range(c.k_pages.shape[2])) - theirs - {0})
    else:
        keep = sorted(set(range(eng.max_batch)) - set(targets))
    for n, t in before.items():
        now = getattr(c, n)
        assert torch.equal(now[:, :, keep], t[:, :, keep]) if paged else \
            torch.equal(now[:, keep], t[:, keep]), n
    return out


def _block(prompt, bucket=16):
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :len(prompt)] = prompt
    return toks


def _jslot(jeng, toks, n, slot, append, window):
    logits, jeng.cache = jeng._prefill_slot(
        jeng.params, jnp.asarray(toks, jnp.int32), jnp.int32(n), jeng.cache, jnp.int32(slot),
        jnp.bool_(append), attn_window=window, prefill_flash=not append)
    return logits


def _both_slot(jeng, eng, prompt, slot, append, window, bucket=16):
    toks = _block(prompt, bucket)
    jl = _jslot(jeng, toks, len(prompt), slot, append, window)
    tl = _untouched(eng, [slot], lambda: eng._prefill_slot(toks, len(prompt), slot, append,
                                                           attn_window=window))
    return jl, tl


# each model, KV dtype and layout at least once: the JAX side compiles a
# program per shape and engine, which sets the file's time
@pytest.mark.parametrize("model,kv", [("tiny-llama", "bf16"), ("tiny-gpt_neox", "int8")],
                         indirect=["model"])
def test_slot_prefill_programs_match_jax(model, kv):
    jeng, eng = _engines(model, kv, "slot")
    # _prefill: two prompts at slots 0 and 1 (the B = 4 batch program)
    prompts = [_prompt(0, 12), _prompt(1, 5)]
    jl, tl = jeng.prefill(prompts), eng.prefill(prompts)
    _check(jeng, eng, jl[:2], tl[:2], [(0, 12), (1, 5)])
    # _prefill_slot: fresh into slot 2, then 5 tokens appended to slot 0
    jl, tl = _both_slot(jeng, eng, _prompt(2, 7), 2, False, 16)
    _check(jeng, eng, jl, tl, [(2, 7)])
    jl, tl = _both_slot(jeng, eng, _prompt(3, 5), 0, True, 32)
    _check(jeng, eng, jl, tl, [(0, 17)])
    # a chunked admission into slot 3: 16 tokens fresh, then a second
    # segment of 10 appended at window decode_window(16 + 16)
    chunk = _prompt(4, 26)
    _both_slot(jeng, eng, chunk[:16], 3, False, 16)
    jl, tl = _both_slot(jeng, eng, chunk[16:], 3, True, 32)
    _check(jeng, eng, jl, tl, [(3, 26)])
    # _prefill_slots: G = 2 into slots (1, 3), then G = 4 into (3, 0, 2, 1)
    for slots in ((1, 3), (3, 0, 2, 1)):
        G = len(slots)
        lens = np.array([5, 16, 9, 1][:G])
        toks = np.zeros((G, 16), np.int64)
        for g, n in enumerate(lens):
            toks[g, :n] = _prompt(10 + g, n)
        jl, jeng.cache = jeng._prefill_slots(
            jeng.params, jnp.asarray(toks, jnp.int32), jnp.asarray(lens, jnp.int32),
            jeng.cache, jnp.asarray(slots, jnp.int32), attn_window=16, prefill_flash=True,
            group=G)
        tl = _untouched(eng, slots, lambda: eng._prefill_slots(toks, lens, slots, attn_window=16))
        _check(jeng, eng, jl, tl, list(zip(slots, lens)))
    # JAX's programs: its static prefill_flash is the key's last field
    assert eng.programs.keys == {("prefill", 4, 16, 16, True), ("prefill_slots", 1, 16, 16, True),
                                 ("prefill_slots", 1, 16, 32, False),
                                 ("prefill_slots", 2, 16, 16, True),
                                 ("prefill_slots", 4, 16, 16, True)}


@pytest.mark.parametrize("model,kv", [("tiny-llama", "int8"), ("tiny-gpt_neox", "bf16")],
                         indirect=["model"])
def test_paged_prefill_programs_match_jax(model, kv):
    jeng, eng = _engines(model, kv, "paged")
    engines = (jeng, eng)
    prompts = [_prompt(0, 12), _prompt(1, 5)]
    jl, tl = jeng.prefill(prompts, reserve_tokens=4), eng.prefill(prompts, reserve_tokens=4)
    _check(jeng, eng, jl[:2], tl[:2], [(0, 12), (1, 5)])
    # fresh admission into slot 2, its pages first (the scheduler's order)
    for e in engines:
        e.assign_pages(2, e.pages_needed(2, 7 + 4))
    jl, tl = _both_slot(jeng, eng, _prompt(2, 7), 2, False, 16)
    _check(jeng, eng, jl, tl, [(2, 7)])
    jl, tl = _both_slot(jeng, eng, _prompt(3, 3), 0, True, 32)
    _check(jeng, eng, jl, tl, [(0, 15)])
    # slot 3 at length 56 of its 64-position table: a 16-token bucket
    # (5 real tokens) runs past the capacity; JAX drops positions >= 64,
    # the port writes them to the null page
    for e in engines:
        e.assign_pages(3, 8)
        e.set_slot_length(3, 56)
    jl, tl = _both_slot(jeng, eng, _prompt(5, 5), 3, True, 64)
    _check(jeng, eng, jl, tl, [(3, 61)])
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        a, b = getattr(eng.cache, name), getattr(jeng.cache, name)
        if a is not None:  # every page but the null page
            np.testing.assert_allclose(_np(a)[:, :, 1:], _np(b)[:, :, 1:], **TOL)
    # prefix adoption: slot 1 takes slot 0's first (full) page, then
    # prefills its 6-token suffix from position 8
    shared = eng._table_np[0, :1].tolist()
    for e in engines:
        e.free_slot_pages(1)
        e.adopt_shared_pages(1, shared)
        e.set_slot_length(1, 8)
        e.assign_pages(1, e.pages_needed(1, 8 + 16))
    jl, tl = _both_slot(jeng, eng, _prompt(6, 6), 1, True, 32)
    _check(jeng, eng, jl, tl, [(1, 14), (0, 15)])
    assert {k[0] for k in eng.programs.keys} == {"prefill", "prefill_slots"}
    assert all(k[1] == 1 for k in eng.programs.keys if k[0] == "prefill_slots")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_block_program_matches_host_forward(layout, kv):
    # tolerance 0: forward_block on slots (2, 0) of a 3-slot cache against
    # the host-driven forward on a 2-slot cache holding copies of those
    # rows (the slot layout) or those table rows over a copy of the pool
    # (paged): the same plain ops on the same values
    cfg = get_config("tiny-llama")
    from mlc_llm_tpu_torch.models import init_random_params

    params = init_random_params(cfg, "q4bf16", seed=0, device="cpu")
    kw = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    eng = InferenceEngine(cfg, params, max_batch=3, max_seq_len=64, cache_dtype=KV[kv][1],
                          device="cpu", **kw)
    eng.prefill([_prompt(0, 9), _prompt(1, 3), _prompt(2, 14)], reserve_tokens=20)
    rows = torch.tensor([2, 0])
    c = eng.cache
    if layout == "paged":
        sub = type(c)(k_pages=c.k_pages.clone(), v_pages=c.v_pages.clone(),
                      page_table=c.page_table[rows].clone(), lengths=c.lengths[rows].clone(),
                      k_scale=None if c.k_scale is None else c.k_scale.clone(),
                      v_scale=None if c.v_scale is None else c.v_scale.clone())
    else:
        sub = init_kv_cache(cfg, 2, 64, KV[kv][1], device="cpu")
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(c, name) is not None:
                getattr(sub, name).copy_(getattr(c, name)[:, rows])
        sub.lengths.copy_(c.lengths[rows])
    toks = torch.from_numpy(np.stack([_block(_prompt(3, 5))[0], _block(_prompt(4, 16))[0]]))
    seq_lens = torch.tensor([5, 16])
    want, _ = forward(eng.params, cfg, toks, sub, seq_lens=seq_lens, attn_window=32)
    got = forward_block(eng.params, cfg, toks, c, rows, c.lengths[rows].clone(), seq_lens,
                        attn_window=32)
    assert torch.equal(got, want)
    assert c.lengths_dev[rows].tolist() == sub.lengths.tolist() == [19, 25]
    for name in ("k", "v", "k_scale", "v_scale", "k_pages", "v_pages"):
        a, b = getattr(c, name, None), getattr(sub, name, None)
        if a is not None:
            assert torch.equal(a if layout == "paged" else a[:, rows], b), name


class _Lowering:
    """Stands in for one of the JAX engine's jitted programs in its
    precompile: records each .lower() (nothing compiles); eval_shape is
    handed the program itself."""

    def __init__(self, fn, kind, log):
        self.fn, self.kind, self.log = fn, kind, log

    def lower(self, *args, **kw):
        self.log.append((self.kind, args, kw))
        return types.SimpleNamespace(compile=lambda: None)


def _jax_precompile_keys(jeng, multi_step, monkeypatch):
    """The programs the JAX engine's precompile compiles, as port keys."""
    log = []
    shape_of = jax.eval_shape
    monkeypatch.setattr(jax, "eval_shape", lambda f, *a, **kw: shape_of(
        f.fn if isinstance(f, _Lowering) else f, *a, **kw))
    for attr, kind in (("_prefill", "prefill"), ("_prefill_slot_jit", "prefill_slots"),
                       ("_prefill_slots", "prefill_slots"), ("_sample_perslot", "sample"),
                       ("_decode_sample", "decode"), ("_decode_sample_k", "decode_k")):
        if getattr(jeng, attr) is not None:
            setattr(jeng, attr, _Lowering(getattr(jeng, attr), kind, log))
    n = jeng.precompile(multi_step=multi_step)
    keys = set()
    for kind, args, kw in log:
        if kind == "sample":
            keys.add(("sample", args[0].shape[0]))
        elif kind == "decode":  # one program for both t/p layouts
            keys.add(("decode", args[1].shape[0], kw["attn_window"]))
        elif kind == "decode_k":
            keys.add(("decode_k", args[1].shape[0], kw["k_steps"], kw["attn_window"]))
        else:  # the paged programs have no prefill_flash
            keys.add((kind,) + args[1].shape + (kw["attn_window"],
                                                kw.get("prefill_flash", False)))
    assert n == len(log)
    return keys


@pytest.mark.parametrize("model", MODELS, indirect=True)
@pytest.mark.parametrize("layout,batch,multi_step", [("slot", 4, (2, 4)), ("paged", 2, 4)])
def test_precompile_keys_match_jax(model, layout, batch, multi_step, monkeypatch):
    name, jcfg, jp, tp = model
    kw = dict(max_batch=batch, max_seq_len=64)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    want = _jax_precompile_keys(JEngine(jcfg, jp, **kw), multi_step, monkeypatch)
    eng = InferenceEngine(get_config(name), tp, device="cpu", **kw)
    got = eng.precompile_keys(multi_step)
    assert len(got) == len(set(got))
    # the port draws every first token in its sampler program, so it adds
    # the single admission's (G = 1) and generate's (G = B) samplers
    assert set(got) - want == {("sample", 1), ("sample", batch)} - want
    assert want <= set(got)
    assert {k[0] for k in got} == {"prefill", "prefill_slots", "sample", "decode", "decode_k"}
    assert eng.precompile(multi_step=multi_step) == 0 and eng.programs.count == 0
