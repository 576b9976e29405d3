"""The reset prefill's flash attention (kernel 8) against the JAX package,
on the CPU.

JAX routes a reset prefill on the slot cache through ``flash_prefill``
(the Pallas TPU kernel of ``jax.experimental.pallas.ops.tpu``), gated by
``flash_prefill_shape_ok`` and, on any backend but the TPU, not taken: its
CPU forward runs ``attend`` over the cache. The port takes the branch on
every device where the shape gate holds; on CPU tensors the wrapper runs
the kernel's plain version. These tests hold:

- the gate, equal to JAX's over a grid of (S, D);
- ``flash_prefill_plain`` and the CPU wrapper against JAX's
  ``mha_reference(causal=True)`` (on the same values in f32) and JAX's
  ``attend`` (in the input dtype), bf16/f16 at 5e-2 and f32 at 1e-4 (the
  repo's kernel-vs-jnp tolerance; the plain version rounds p to v's dtype
  before p . v where ``attend`` rounds the normalised probabilities);
- the bf16/f16 kernel's tiling, emulated in torch (128-query blocks of two
  64-row warpgroups, 128- or 64-key tiles, the mask on each warpgroup's
  last tile only, the running max and sum, the exp2 fold, p rounded to v's
  dtype), against the plain version, ``mha_reference`` and ``attend``;
- the f32 kernel's arithmetic, emulated in torch (3xTF32 products with
  TF32 rounded as cvt.rna does it, its 32- or 16-key tiles, S fresh each
  tile, each tile's P V a fresh part folded with the rescale), against the
  same three at 1e-4, and one TF32 product instead of three missing 1e-4;
- the slice: a 2-layer model (hidden 256, 2 heads of D = 128) prefilled
  at S = 1024 with ``prefill_flash=True`` through the port's ``forward``
  (the branch taken, once a layer) and JAX's (``attend``): logits and the
  written K/V at 5e-2, greedy tokens over decode steps equal; the port's
  ``forward_block`` equal to its ``forward`` bit for bit; the logits do not
  depend on the cache dtype (nothing is read back from the cache);
- the int8 and paged forwards never take the branch;
- the engine's program keys keep a reset and an append of one bucket and
  window apart, and its precompile keys flash only on the slot layout;
- the wrapper's plumbing on meta tensors (a tensor off the CPU takes the
  kernel's path: strides, type id, output layout, one launch, and raises
  on what the kernel does not take).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from mlc_llm_tpu.models import forward as jforward
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_kv_cache as jinit_kv
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.ops import attention as jatt
from mlc_llm_tpu_torch.engine import InferenceEngine
from mlc_llm_tpu_torch.models import forward, forward_block, get_config, init_kv_cache
from mlc_llm_tpu_torch.models import transformer as tr
from mlc_llm_tpu_torch.models.convert import params_from_jax
from mlc_llm_tpu_torch.models.paged_cache import init_paged_kv_cache
from mlc_llm_tpu_torch.ops import attention as att

torch.set_num_threads(2)

TOL = {torch.bfloat16: 5e-2, torch.float16: 5e-2, torch.float32: 1e-4}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16, torch.float32: jnp.float32}
_jforward = jax.jit(jforward, static_argnames=("cfg", "attn_window", "prefill_flash",
                                               "last_only"))


@pytest.mark.parametrize("D", [64, 80, 100, 128, 256])
@pytest.mark.parametrize("S", [512, 896, 1024, 1025, 1088, 1152, 2048])
def test_flash_gate_matches_jax(S, D):
    assert att.flash_prefill_shape_ok(S, D) == jatt.flash_prefill_shape_ok(S, D)
    # the port's gate is the shape gate on every device
    assert att.flash_prefill_supported(S, D) == jatt.flash_prefill_shape_ok(S, D)


def _qkv(seed, B, Hq, Hkv, S, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, D), np.float32)).to(dtype)
               for h in (Hq, Hkv, Hkv))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("B,Hkv", [(1, 4), (2, 2)], ids=["b1-mha", "b2-gqa"])
def test_flash_prefill_plain_matches_jax(B, Hkv, S, D, dtype):
    Hq = 4
    q, k, v = _qkv(S + D, B, Hq, Hkv, S, D, dtype)
    before = att.flash_prefill.launches
    got = att.flash_prefill(q, k, v)
    assert att.flash_prefill.launches == before  # CPU tensors: the plain version
    assert got.dtype == dtype and got.shape == (B, Hq, S, D)
    assert torch.equal(got, att.flash_prefill_plain(q, k, v))
    got = got.float().numpy()
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    rep = Hq // Hkv
    qf, kf, vf = (np.asarray(t.float()) for t in (q, k, v))
    want = mha_reference(jnp.asarray(qf), jnp.asarray(np.repeat(kf, rep, 1)),
                         jnp.asarray(np.repeat(vf, rep, 1)), None, causal=True,
                         sm_scale=D**-0.5)
    np.testing.assert_allclose(got, np.asarray(want), **tol)
    jd = JDT[dtype]
    want = jatt.attend(jnp.asarray(qf, jd), jnp.asarray(kf, jd), jnp.asarray(vf, jd),
                       jnp.zeros((B,), jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), **tol)


def _kernel_tiling(q, k, v):
    """The bf16/f16 kernel's loop (csrc/flash_prefill.cu flash_prefill_wg)
    in torch: a block of 128 queries is two warpgroups of 64 rows; a
    warpgroup runs over the key tiles (BN = 128 at D = 128, 64 at D = 256)
    that hold a key at or below one of its rows, masks its last tile only,
    keeps the running max of the raw scores m and the sum l in f32, takes p
    = exp2(s * c - m * c) with c = fl(1/sqrt(D)) * log2(e) in f32 (the fold
    of the scale into the exponential: one FMA, rounded once), rescales o
    by exp2((m_old - m) * c) before adding p (rounded to v's dtype) . v in
    f32, and writes o / l rounded once to q's dtype."""
    B, Hq, S, D = q.shape
    rep = Hq // k.shape[1]
    BN = 128 if D == 128 else 64
    c = np.float32(np.float32(1.0 / np.sqrt(np.float32(D))) * np.float32(np.log2(np.e)))
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(rep, 1) for t in (k, v))
    out = torch.empty_like(q)
    assert S % 128 == 0
    for r0 in range(0, S, 64):  # one warpgroup's 64 rows
        rows = torch.arange(r0, r0 + 64)
        n_tiles = (r0 + 64 + BN - 1) // BN
        assert n_tiles * BN > r0 + 63  # the tiles it skips: keys above all its rows
        m = torch.full((B, Hq, 64), -np.inf)
        l = torch.zeros((B, Hq, 64))
        o = torch.zeros((B, Hq, 64, D))
        for t in range(n_tiles):
            keys = torch.arange(t * BN, (t + 1) * BN)
            s = qf[:, :, r0:r0 + 64] @ kf[:, :, t * BN:(t + 1) * BN].transpose(-1, -2)
            above = keys[None, :] > rows[:, None]
            if t == n_tiles - 1:
                s = s.masked_fill(above, -np.inf)
            else:  # only the last tile crosses the diagonal
                assert not above.any()
            mx = torch.maximum(m, s.amax(-1))
            al = torch.exp2((m - mx) * c)
            nm = -(mx * c)
            p = torch.exp2((s.double() * float(c) + nm.double()[..., None]).float())
            l = l * al + p.sum(-1)
            o = o * al[..., None] + p.to(v.dtype).float() @ vf[:, :, t * BN:(t + 1) * BN]
            m = mx
        out[:, :, r0:r0 + 64] = (o / l[..., None]).to(q.dtype)
    return out


def _tf32(x):
    """f32 rounded to TF32 as cvt.rna.tf32.f32 does it (to nearest, ties
    away from zero), on the int32 view: half a unit of the 13 dropped bits
    added to the magnitude, then the 13 bits cleared."""
    return ((x.float().contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, products):
    """a @ b with each operand split into hi = tf32(x) and lo = tf32(x -
    hi): 3xTF32 is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (lo.lo dropped), 1xTF32
    a_hi.b_hi alone; every product of two TF32 values is exact in f32, and
    the sums are f32's."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _fma(a, b, c):
    """a * b + c rounded once to f32 (fmaf)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_tiling_f32(q, k, v, products=3):
    """The f32 kernel's loop (csrc/flash_prefill.cu flash_prefill_tf32) in
    torch: warpgroups of 64 query rows over its key tiles (BN = 32 at D =
    128, 16 at D = 256), the tiles with a key at or below one of the rows,
    the mask on the tiles that cross the first row; S = Q K^T in 3xTF32 (at
    D = 256 as the two warpgroups' halves of D, summed in f32), fresh each
    tile; the running max of the raw scores and the sum in f32, p = exp2(s
    * c - m * c) (one FMA) with c = fl(1/sqrt(D)) * log2(e); P V of the tile
    in 3xTF32 into a fresh part, folded as o = fmaf(o, alpha, part); the
    output o * (1 / l). The order of V^T's keys within each k8 step (0 2 4
    6 1 3 5 7) is a sum order inside the tensor cores' step and is not
    modelled. products=1: one TF32 product each (hi . hi)."""
    B, Hq, S, D = q.shape
    rep = Hq // k.shape[1]
    BN = 32 if D == 128 else 16
    c = np.float32(np.float32(1.0 / np.sqrt(np.float32(D))) * np.float32(np.log2(np.e)))
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(rep, 1) for t in (k, v))
    halves = [slice(0, 128), slice(128, 256)] if D == 256 else [slice(0, D)]
    out = torch.empty_like(qf)
    for r0 in range(0, S, 64):  # one warpgroup's 64 rows
        rows = torch.arange(r0, r0 + 64)
        m = torch.full((B, Hq, 64), -np.inf)
        l = torch.zeros((B, Hq, 64))
        o = torch.zeros((B, Hq, 64, D))
        for t in range((r0 + 64) // BN):
            keys = torch.arange(t * BN, (t + 1) * BN)
            kt, vt = kf[:, :, t * BN:(t + 1) * BN], vf[:, :, t * BN:(t + 1) * BN]
            s = None
            for hs in halves:
                part = _tf32_product(qf[:, :, r0:r0 + 64, hs], kt[..., hs].transpose(-1, -2),
                                     products)
                s = part if s is None else s + part
            above = keys[None, :] > rows[:, None]
            if (t + 1) * BN > r0:
                s = s.masked_fill(above, -np.inf)
            else:  # only the tiles that reach the first row cross the diagonal
                assert not above.any()
            mx = torch.maximum(m, s.amax(-1))
            al = torch.exp2((m - mx) * c)
            p = torch.exp2(_fma(s, torch.tensor(c), -(mx * c)[..., None]))
            l = l * al + p.sum(-1)
            o = _fma(o, al[..., None], _tf32_product(p, vt, products))
            m = mx
        out[:, :, r0:r0 + 64] = o * (1.0 / l)[..., None]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("S", [256, 384])
def test_kernel_tiling_matches_plain_and_jax(S, D, dtype):
    B, Hq, Hkv = 2, 2, 1
    q, k, v = _qkv(S * D, B, Hq, Hkv, S, D, dtype)
    got = (_kernel_tiling_f32 if dtype == torch.float32 else _kernel_tiling)(q, k, v)
    assert got.dtype == dtype and got.shape == (B, Hq, S, D)
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(got.float(), att.flash_prefill_plain(q, k, v).float(), **tol)
    got = got.float().numpy()
    qf, kf, vf = (np.asarray(t.float()) for t in (q, k, v))
    want = mha_reference(jnp.asarray(qf), jnp.asarray(np.repeat(kf, Hq // Hkv, 1)),
                         jnp.asarray(np.repeat(vf, Hq // Hkv, 1)), None, causal=True,
                         sm_scale=D**-0.5)
    np.testing.assert_allclose(got, np.asarray(want), **tol)
    jd = JDT[dtype]
    want = jatt.attend(jnp.asarray(qf, jd), jnp.asarray(kf, jd), jnp.asarray(vf, jd),
                       jnp.zeros((B,), jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("D", [128, 256])
def test_kernel_tiling_f32_needs_three_products(D):
    # one TF32 product (hi . hi: 11 significant bits an operand) misses the
    # f32 tolerance that 3xTF32 meets, on the same inputs and tiling
    q, k, v = _qkv(D, 2, 2, 1, 256, D, torch.float32)
    want = att.flash_prefill_plain(q, k, v)
    tol = dict(atol=TOL[torch.float32], rtol=TOL[torch.float32])
    torch.testing.assert_close(_kernel_tiling_f32(q, k, v), want, **tol)
    assert not torch.allclose(_kernel_tiling_f32(q, k, v, products=1), want, **tol)


# the slice's model: 2 layers, hidden 256, 2 heads of D = 128, vocab 256
SLICE = dict(hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=2,
             max_seq_len=1088)
S_FLASH = 1024


@pytest.fixture(scope="module")
def slice_model():
    jcfg = jget_config("tiny-llama").replace(**SLICE)
    jp = jinit(jcfg, "bf16", seed=5)
    cfg = get_config("tiny-llama").replace(**SLICE)
    assert cfg.head_dim == 128 and cfg.__dict__ == jcfg.__dict__
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp))


def _flash_calls(monkeypatch):
    """Count the forward's calls of the flash wrapper."""
    calls = []
    real = tr.flash_prefill
    monkeypatch.setattr(tr, "flash_prefill", lambda *a: calls.append(1) or real(*a))
    return calls


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (1, n)).astype(np.int64)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def test_flash_slice_matches_jax(slice_model, monkeypatch):
    jcfg, jp, cfg, tp = slice_model
    calls = _flash_calls(monkeypatch)
    n = S_FLASH - 24  # right-padded: the bucket is the flash block
    toks = np.zeros((1, S_FLASH), np.int64)
    toks[0, :n] = _tokens(cfg, n)[0]
    W = cfg.max_seq_len
    jc = jinit_kv(jcfg, 1, W)
    jl, jc = _jforward(jp, jcfg, jnp.asarray(toks, jnp.int32), jc,
                       seq_lens=jnp.asarray([n], jnp.int32), attn_window=W, prefill_flash=True)
    tc = init_kv_cache(cfg, 1, W, device="cpu")
    tl, tc = forward(tp, cfg, torch.from_numpy(toks), tc, seq_lens=[n], attn_window=W,
                     prefill_flash=True)
    assert len(calls) == cfg.num_layers  # the branch, once a layer
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2, rtol=5e-2)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):  # every written position
        np.testing.assert_allclose(_f32(a)[..., :n] if a is tc.v else _f32(a)[:, :, :, :n],
                                   _f32(b)[..., :n] if a is tc.v else _f32(b)[:, :, :, :n],
                                   atol=5e-2, rtol=5e-2)
    # the device-index body: bit for bit the host-driven forward's
    bc = init_kv_cache(cfg, 1, W, device="cpu")
    bl = forward_block(tp, cfg, torch.from_numpy(toks), bc, None, torch.zeros(1, dtype=torch.long),
                       torch.tensor([n]), attn_window=W, prefill_flash=True)
    assert len(calls) == 2 * cfg.num_layers
    assert torch.equal(bl, tl) and torch.equal(bc.k, tc.k) and torch.equal(bc.v, tc.v)
    # greedy decode steps after the flash prefill read the cache it wrote
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1)).reshape(1, 1)
        assert int(torch.argmax(tl, -1)) == int(nxt[0, 0])
        jl, jc = _jforward(jp, jcfg, jnp.asarray(nxt, jnp.int32), jc, attn_window=W)
        tl, tc = forward(tp, cfg, torch.from_numpy(nxt.astype(np.int64)), tc, attn_window=W)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2, rtol=5e-2)
    assert len(calls) == 2 * cfg.num_layers  # decode steps never take it


def test_flash_attends_the_compute_dtype_not_the_cache(slice_model):
    # the branch reads nothing back from the cache: with f32 activations
    # the logits are the same bit for bit whether the cache rounds K/V to
    # bf16 or keeps them in f32; without it they are not
    _, _, cfg, tp = slice_model
    tp = tr.tree_map(lambda x: x.float(), tp)
    toks = torch.from_numpy(_tokens(cfg, S_FLASH, seed=1))
    out = {}
    for flash in (True, False):
        for dt in (torch.bfloat16, torch.float32):
            c = init_kv_cache(cfg, 1, S_FLASH, dtype=dt, device="cpu")
            out[flash, dt], _ = forward(tp, cfg, toks, c, prefill_flash=flash)
    assert torch.equal(out[True, torch.bfloat16], out[True, torch.float32])
    assert not torch.equal(out[False, torch.bfloat16], out[False, torch.float32])


@pytest.mark.parametrize("layout", ["int8", "paged"])
def test_int8_and_paged_forwards_never_take_the_branch(slice_model, monkeypatch, layout):
    _, _, cfg, tp = slice_model
    calls = _flash_calls(monkeypatch)
    toks = torch.from_numpy(_tokens(cfg, S_FLASH, seed=2))

    def cache():
        if layout == "int8":
            return init_kv_cache(cfg, 1, S_FLASH, dtype=torch.int8, device="cpu")
        c = init_paged_kv_cache(cfg, 1, S_FLASH // 128 + 1, 128,
                                max_pages_per_slot=S_FLASH // 128, device="cpu")
        c.set_page_table([list(range(1, S_FLASH // 128 + 1))])
        return c

    flash, _ = forward(tp, cfg, toks, cache(), prefill_flash=True)
    plain, _ = forward(tp, cfg, toks, cache(), prefill_flash=False)
    assert calls == [] and torch.equal(flash, plain)


def _engine(cfg, tp, **kw):
    return InferenceEngine(cfg, tp, device="cpu", **kw)


def test_reset_and_append_prefill_run_different_programs(slice_model):
    # JAX's static prefill_flash is part of the key: a graph captured with
    # the flash branch, replayed for an append of the same bucket and
    # window, would attend without the history
    _, _, cfg, tp = slice_model
    eng = _engine(cfg, tp, max_seq_len=64)
    p = [int(t) for t in _tokens(cfg, 20)[0]]
    eng.prefill([p])
    eng.reset()
    eng.prefill([p], reset=False)  # from position 0: bucket 32, window 32 both times
    assert eng.programs.keys == {("prefill", 1, 32, 32, True), ("prefill", 1, 32, 32, False)}
    # the admission's: a fresh row, then 20 more tokens appended to its 20,
    # at one bucket (32) and window (64)
    toks = np.zeros((1, 32), np.int64)
    toks[0, :20] = p
    eng.reset()
    eng._prefill_slot(toks, 20, 0, False, attn_window=64)
    eng._prefill_slot(toks, 20, 0, True, attn_window=64)
    assert int(eng.cache.lengths[0]) == 40
    assert {k for k in eng.programs.keys if k[0] == "prefill_slots"} == {
        ("prefill_slots", 1, 32, 64, True), ("prefill_slots", 1, 32, 64, False)}


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_precompile_keys_flash_on_the_slot_layout(slice_model, layout):
    # every prefill key JAX's precompile compiles is a reset or a fresh
    # admission: flash on the slot layout; the paged programs have none
    # (the key sets themselves: tests/test_torch_prefill_programs.py)
    _, _, cfg, tp = slice_model
    kw = dict(kv_layout="paged", page_size=16) if layout == "paged" else {}
    eng = _engine(cfg, tp, max_batch=4, max_seq_len=64, **kw)
    flags = {k[-1] for k in eng.precompile_keys() if k[0].startswith("prefill")}
    assert flags == {layout == "slot"}


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "f16", "f32"])
def test_flash_call_on_a_device_tensor_launches(monkeypatch, dtype):
    # a tensor off the CPU takes the kernel's path (meta tensors stand in
    # for the card): the forward's [B, S, H, D] projections go by their
    # strides, the output is a [B, Hq, S, D] view of a [B, S, Hq, D] buffer
    # in q's dtype, one launch, and the plain version never runs
    lib = _FakeLib()
    monkeypatch.setattr(att, "load_kernel", lambda name, argtypes: lib)
    monkeypatch.setattr(att, "_stream", lambda x: 0)
    monkeypatch.setattr(att, "flash_prefill_plain", None)
    monkeypatch.setattr(att.flash_prefill, "launches", 0)
    B, S, Hq, Hkv, D = 2, 1024, 8, 2, 128
    qkv = _meta((B, S, (Hq + 2 * Hkv) * D), dtype)
    q, k, v = (t.reshape(B, S, -1, D).transpose(1, 2)
               for t in qkv.split([Hq * D, Hkv * D, Hkv * D], dim=-1))
    out = att.flash_prefill(q, k, v)
    (name, args), = lib.calls
    assert name == "mlc_flash_prefill" and args[4:10] == (B, Hq, Hkv, S, D,
                                                           att.FLASH_TYPES[dtype])
    W = (Hq + 2 * Hkv) * D
    assert args[10:19] == (S * W, D, W) * 3  # q, k, v: (batch, head, position)
    assert args[19:22] == (S * Hq * D, D, Hq * D)  # the output's
    assert out.shape == (B, Hq, S, D) and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous() and att.flash_prefill.launches == 1


@pytest.mark.parametrize("case", ["head_dim", "dtype", "length", "mixed", "length_64"])
def test_flash_call_the_kernel_does_not_take_raises(monkeypatch, case):
    # length_64: a multiple of the 64-query tile of the first design, not
    # of the 128-query block the kernel takes now
    lib = _FakeLib()
    monkeypatch.setattr(att, "load_kernel", lambda name, argtypes: lib)
    monkeypatch.setattr(att, "_stream", lambda x: 0)
    monkeypatch.setattr(att, "flash_prefill_plain", None)
    shape = {"head_dim": (1, 4, 1024, 80), "length": (1, 4, 1000, 128),
             "length_64": (1, 4, 1088, 128)}.get(case, (1, 4, 1024, 128))
    dt = torch.int8 if case == "dtype" else torch.bfloat16
    q = _meta(shape, dt)
    k = _meta(shape, torch.float16 if case == "mixed" else dt)
    with pytest.raises(NotImplementedError):
        att.flash_prefill(q, k, k)
    assert lib.calls == []


def test_flash_call_without_a_gpu_raises(monkeypatch):
    # with no card and no nvcc, a call on a tensor off the CPU raises when
    # the kernel cannot be built: nothing falls back to the plain version
    if torch.cuda.is_available():
        pytest.skip("holds the build failure without a GPU")
    from mlc_llm_tpu_torch import ops

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(ops, "_LIBS", {})
    monkeypatch.setattr(ops, "_stale", lambda name: True)
    monkeypatch.setattr(ops, "_nvcc", no_nvcc)
    monkeypatch.setattr(att, "_stream", lambda x: 0)
    monkeypatch.setattr(att, "flash_prefill_plain", None)
    q = _meta((1, 4, 1024, 128))
    with pytest.raises(RuntimeError, match="nvcc"):
        att.flash_prefill(q, q, q)
