"""Generic pre-norm decoder over a slot-contiguous or paged KV cache.

The counterpart of ``mlc_llm_tpu/models/transformer.py``: the same
parameter tree (layer leaves stacked along a leading L axis), the same
KV layouts (slot: k [L, B, H, Smax, D], v D-major [L, B, H, D, Smax];
paged: ``models/paged_cache.py``), bf16/f16/f32 or int8 KV with
per-(layer, slot, head, position) absmax scales, right-padded
``seq_lens``, ``attn_window``, ``last_only``, the f32 lm head and the
fp16 clamp. The layer loop is a Python loop (the JAX ``lax.scan``);
stacked quantized weights are read in place by the kernels at a pointer
offset. KV writes are in place.

On the paged cache, a decode step (S == 1) attends through
``ops.paged_attention.paged_flash_decode`` (the CUDA kernel on the card,
its plain version on the CPU); prefill and any S > 1 block gather the
windowed pages and run ``attend_cache``. The paged path never takes a
flash-prefill branch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..ops import resolve_device
from ..ops.attention import attend_cache
from ..ops.matmul import qmatmul, qmatmul_stacked
from ..ops.paged_attention import paged_flash_decode
from ..quant.groupwise import QuantizedTensor, pad_cols, quantize, take_dequantize, torch_dtype
from ..quant.spec import QuantSpec, resolve_spec, spec_for_k
from .config import ModelConfig
from .layers import activate, apply_rotary, layer_norm, make_rotary_tables, rms_norm
from .paged_cache import (
    PagedKVCache,
    PagedWriteIndex,
    gather_pages_k,
    gather_pages_scale_k,
    gather_pages_scale_v,
    gather_pages_v,
    paged_write_index,
    write_rows_paged,
    write_scale_rows_paged_k,
    write_scale_rows_paged_v,
)

Params = Dict[str, Any]

WEIGHT_KEYS = ("wqkv", "wo", "w_in", "w_out")


@dataclasses.dataclass
class KVCache:
    """k: [L, B, Hkv, Smax, D]; v: [L, B, Hkv, D, Smax] (D-major);
    lengths: [B] valid token count per slot, kept on the host (int64 CPU
    tensor) so the writes can slice without a device sync.

    int8 mode: k/v hold per-element int8 codes and k_scale/v_scale hold
    per-(layer, slot, head, position) absmax/127 scales [L, B, Hkv,
    Smax] in f32; other dtypes leave the scales None."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def slot_view(self, slot: int, start: int) -> "KVCache":
        """One slot's cache rows as views (writes land in place) with
        its own start length."""
        def rows(t):
            return None if t is None else t[:, slot:slot + 1]

        return KVCache(k=rows(self.k), v=rows(self.v),
                       lengths=torch.tensor([start], dtype=torch.int64),
                       k_scale=rows(self.k_scale), v_scale=rows(self.v_scale))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: Optional[int] = None,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    if dtype not in (torch.bfloat16, torch.float16, torch.float32, torch.int8):
        raise NotImplementedError(f"KV cache dtype {dtype} is not supported")
    dev = resolve_device(device)
    max_len = max_len or cfg.max_seq_len
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    scales = [None, None]
    if dtype == torch.int8:
        scales = [torch.zeros((L, batch, H, max_len), dtype=torch.float32, device=dev)
                  for _ in range(2)]
    return KVCache(
        k=torch.zeros((L, batch, H, max_len, D), dtype=dtype, device=dev),
        v=torch.zeros((L, batch, H, D, max_len), dtype=dtype, device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int64),
        k_scale=scales[0], v_scale=scales[1],
    )


def tree_map(fn, tree):
    """Apply fn to every leaf (tensor or QuantizedTensor) of a param tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _norm(x, w, b, cfg: ModelConfig):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, w, cfg.norm_eps)
    return layer_norm(x, w, b, cfg.norm_eps)


def _quantize_kv(x):
    """[B, H, S, D] -> int8 codes + per-(B, H, S) absmax/127 scale,
    clamped at 1e-8; codes round half to even and clip at +-127 (the
    JAX package's codes, bit for bit)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _quantize_kv_t(x):
    """[B, H, D, S] -> int8 codes + per-(B, H, S) absmax/127 scale
    (reduction over D = axis 2)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=2) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[:, :, None, :]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _layer_tail(h, attn_out, h_mlp_in, lp, weights, l, cfg: ModelConfig):
    """Residual + MLP tail. h_mlp_in is the parallel-residual MLP input
    (None for sequential residual)."""
    if h_mlp_in is None:
        h = h + attn_out
        h_mlp_in = _norm(h, lp["ln2_w"], lp.get("ln2_b"), cfg)
    if cfg.act == "silu_gated":
        gate_up = qmatmul_stacked(h_mlp_in, weights["w_in"], l, lp.get("b_in"))
        gate, up = gate_up.chunk(2, dim=-1)
        mid = torch.nn.functional.silu(gate) * up
    else:
        mid = activate(qmatmul_stacked(h_mlp_in, weights["w_in"], l, lp.get("b_in")), cfg.act)
    mlp_out = qmatmul_stacked(mid, weights["w_out"], l, lp.get("b_out"))
    if cfg.parallel_residual or cfg.single_norm:
        h = h + attn_out + mlp_out
    else:
        h = h + mlp_out
    if h.dtype == torch.float16:
        # the reference's fp16-safety clamp under float16's 65504 max
        h = h.clamp(-55504.0, 55504.0)
    return h


@dataclasses.dataclass
class _PagedStep:
    """What a paged forward computes once and every layer reuses."""

    index: PagedWriteIndex
    lengths: torch.Tensor  # [B] int32 on the device (pre-advance)
    maxp: int              # pages in the attention window


def _pool_rows(x, G):
    """[B, S, H, ...] -> [G, B*S, hb*...]: the pool's row layout."""
    B, S = x.shape[:2]
    return x.reshape(B, S, G, -1).permute(2, 0, 1, 3).reshape(G, B * S, -1)


def _attend_paged(q, k, v, cache: PagedKVCache, l, step: _PagedStep, start_dev, d):
    """Write this block's K/V into the pages, then attend (q/k/v
    [B, S, H, D] after rotary)."""
    S = q.shape[1]
    G = cache.k_pages.shape[0]
    if cache.k_pages.dtype == torch.int8:
        kq, ks = _quantize_kv(k)  # reductions over D: the JAX codes
        vq, vs = _quantize_kv(v)
        write_rows_paged(cache.k_pages, _pool_rows(kq, G), l, step.index)
        write_rows_paged(cache.v_pages, _pool_rows(vq, G), l, step.index)
        write_scale_rows_paged_k(cache.k_scale, _pool_rows(ks, G), l, step.index)
        write_scale_rows_paged_v(cache.v_scale, _pool_rows(vs, G), l, step.index)
    else:
        write_rows_paged(cache.k_pages, _pool_rows(k, G), l, step.index)
        write_rows_paged(cache.v_pages, _pool_rows(v, G), l, step.index)
    qt = q.transpose(1, 2)
    if S == 1:
        return paged_flash_decode(qt.contiguous(), cache.k_pages, cache.v_pages,
                                  cache.k_scale, cache.v_scale, cache.page_table,
                                  step.lengths, l, num_pages_window=step.maxp, head_dim=d)
    table = cache.page_table
    kc = gather_pages_k(cache.k_pages, l, table, step.maxp, d)
    vc = gather_pages_v(cache.v_pages, l, table, step.maxp, d)
    ksc = vsc = None
    if cache.k_pages.dtype == torch.int8:
        ksc = gather_pages_scale_k(cache.k_scale, l, table, step.maxp)
        vsc = gather_pages_scale_v(cache.v_scale, l, table, step.maxp)
    return attend_cache(qt, kc, vc, ksc, vsc, start_dev)


def _attend_slot(q, k, v, cache: KVCache, l, starts, start_dev, attn_window):
    """Write only the new tokens, IN PLACE (JAX returns an updated copy
    that XLA aliases); the start is clamped so the block fits, as
    jax.lax.dynamic_update_slice clamps it. Then attend the window."""
    B, S = q.shape[:2]
    smax = cache.max_len
    kt, vt = k.transpose(1, 2), v.permute(0, 2, 3, 1)  # [B,H,S,D], [B,H,D,S]
    ks = vs = None
    if cache.k.dtype == torch.int8:
        kt, ks = _quantize_kv(kt)
        vt, vs = _quantize_kv_t(vt)
    for b in range(B):
        st = min(starts[b], smax - S)
        cache.k[l, b, :, st:st + S] = kt[b].to(cache.k.dtype)
        cache.v[l, b, :, :, st:st + S] = vt[b].to(cache.v.dtype)
        if ks is not None:
            cache.k_scale[l, b, :, st:st + S] = ks[b]
            cache.v_scale[l, b, :, st:st + S] = vs[b]
    W = attn_window or smax
    ksc = vsc = None
    if ks is not None:
        ksc, vsc = cache.k_scale[l, :, :, :W], cache.v_scale[l, :, :, :W]
    return attend_cache(q.transpose(1, 2), cache.k[l, :, :, :W], cache.v[l, :, :, :, :W],
                        ksc, vsc, start_dev)


def _layer(h, lp, weights, cache, l: int, cfg: ModelConfig, rot_cos, rot_sin,
           positions, starts, start_dev, attn_window: Optional[int],
           paged: Optional[_PagedStep]):
    B, S, _ = h.shape
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h_mlp_in = None
    if cfg.single_norm:
        h_attn_in = h_mlp_in = _norm(h, lp["ln1_w"], lp.get("ln1_b"), cfg)
    else:
        h_attn_in = _norm(h, lp["ln1_w"], lp.get("ln1_b"), cfg)
        if cfg.parallel_residual:
            h_mlp_in = _norm(h, lp["ln2_w"], lp.get("ln2_b"), cfg)

    qkv = qmatmul_stacked(h_attn_in, weights["wqkv"], l, lp.get("bqkv"))
    q, k, v = qkv.split([nh * d, nkv * d, nkv * d], dim=-1)
    q = apply_rotary(q.reshape(B, S, nh, d), rot_cos, rot_sin, positions, cfg.rotary_style)
    k = apply_rotary(k.reshape(B, S, nkv, d), rot_cos, rot_sin, positions, cfg.rotary_style)
    v = v.reshape(B, S, nkv, d)
    if paged is not None:
        attn = _attend_paged(q, k, v, cache, l, paged, start_dev, d)
    else:
        attn = _attend_slot(q, k, v, cache, l, starts, start_dev, attn_window)
    attn = attn.transpose(1, 2).reshape(B, S, nh * d)
    attn_out = qmatmul_stacked(attn, weights["wo"], l, lp.get("bo"))
    return _layer_tail(h, attn_out, h_mlp_in, lp, weights, l, cfg)


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, tokens, cache, *,
            seq_lens=None, last_only: bool = True, attn_window: Optional[int] = None):
    """Run the decoder over a token block appended at each slot's length.

    tokens: [B, S] integer tensor on the params' device. cache: a
    KVCache or a PagedKVCache. seq_lens: [B] new-token count per slot
    (<= S, host ints); tokens beyond are right-padding whose junk K/V is
    rewritten before it is ever read. attn_window bounds the cache
    positions read (caller guarantees lengths + S <= attn_window).
    Returns (logits f32 [B, V] at each slot's last real token if
    last_only, else [B, S, V]; the cache, updated in place, lengths
    advanced by seq_lens)."""
    B, S = tokens.shape
    seq_lens = (torch.full((B,), S, dtype=torch.int64) if seq_lens is None
                else torch.as_tensor(seq_lens, dtype=torch.int64).cpu())
    dev = tokens.device
    starts = [int(s) for s in cache.lengths]
    start_dev = cache.lengths.to(dev)
    positions = start_dev[:, None] + torch.arange(S, device=dev)[None, :]
    positions = positions.clamp(max=cache.max_len - 1)
    paged = None
    if isinstance(cache, PagedKVCache):
        ps = cache.page_size
        maxp = cache.page_table.shape[1]
        if attn_window is not None:
            maxp = min(maxp, -(-attn_window // ps))
        # the write positions and kernel lengths once per forward, for all
        # L layers, from the host-side table and lengths (no device sync)
        paged = _PagedStep(
            index=paged_write_index(cache.table_host, starts, S, ps, dev),
            lengths=cache.lengths.to(torch.int32).to(dev), maxp=maxp)

    emb = params["embed"]["w"]
    h = take_dequantize(emb, tokens) if isinstance(emb, QuantizedTensor) else emb[tokens]
    rot_cos, rot_sin = params["rotary"]["cos"], params["rotary"]["sin"]
    weights = {k: v for k, v in params["layers"].items() if k in WEIGHT_KEYS}
    small = {k: v for k, v in params["layers"].items() if k not in WEIGHT_KEYS}
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in small.items()}
        h = _layer(h, lp, weights, cache, l, cfg, rot_cos, rot_sin, positions, starts,
                   start_dev, attn_window, paged)

    h = _norm(h, params["final_ln"]["w"], params["final_ln"].get("b"), cfg)
    if last_only:
        # lm head on each slot's last REAL position only
        idx = (seq_lens - 1).clamp(0, S - 1).to(dev)
        h = h[torch.arange(B, device=dev), idx][:, None]
    lm = params["lm_head"]
    if cfg.fp32_lm_head:
        h = h.float()
    logits = qmatmul(h, lm["w"], lm.get("b"), out_dtype=torch.float32).float()
    if last_only:
        logits = logits[:, 0]
    cache.lengths += seq_lens
    return logits, cache


# ---------------------------------------------------------------------------
# Parameter construction


def _stack(leaves):
    if isinstance(leaves[0], QuantizedTensor):
        z = leaves[0].zero
        return QuantizedTensor(
            data=torch.stack([q.data for q in leaves]),
            scale=torch.stack([q.scale for q in leaves]),
            zero=None if z is None else torch.stack([q.zero for q in leaves]),
            spec=leaves[0].spec, shape=leaves[0].shape)
    return torch.stack(leaves)


def init_random_params(cfg: ModelConfig, quant, seed: int = 0, scale: float = 0.02,
                       fabricate: bool = False, device="cuda") -> Params:
    """Random-weight params, generated on `device` (no network access).

    Weights are [k, n] everywhere; a quantized embedding is stored
    transposed [H, V]. Each weight is drawn and quantized one tensor at
    a time, so a 7B model never holds more than one f32 weight.
    fabricate=True skips the f32 draw and quantization and draws random
    packed codes and scales directly (exact storage layout)."""
    spec = resolve_spec(quant)
    dev = resolve_device(device)
    dtype = torch_dtype(spec.dtype)
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randw(k, n):
        return torch.randn((k, n), generator=gen, device=dev) * scale

    def fab(k, n, fspec: QuantSpec):
        g = fspec.group_size
        ngroups = -(-k // g)
        n_st = pad_cols(n)
        data = torch.randint(-2**31, 2**31, (ngroups * g // 8, n_st), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
        qscale = (torch.randn((ngroups, n_st), generator=gen, device=dev).abs()
                  * scale / max(fspec.max_int, 1)).to(torch_dtype(fspec.dtype))
        zero = None if fspec.sym else (-qscale * 8).to(qscale.dtype)
        return QuantizedTensor(data=data, scale=qscale, zero=zero, spec=fspec, shape=(k, n))

    def mk(k, n, sp=None):
        sp = spec_for_k(sp or spec, k)
        if not sp.is_quantized:
            return randw(k, n).to(torch_dtype(sp.dtype))
        if fabricate:
            return fab(k, n, sp)
        return quantize(randw(k, n), sp)

    gated = cfg.act == "silu_gated"
    shapes = {"wqkv": (H, (nh + 2 * nkv) * d), "wo": (nh * d, H),
              "w_in": (H, 2 * F if gated else F), "w_out": (F, H)}
    layers: Params = {key: _stack([mk(*shp) for _ in range(cfg.num_layers)])
                      for key, shp in shapes.items()}
    L = cfg.num_layers

    def const(n, value):
        return torch.full((L, n), value, dtype=dtype, device=dev)

    layers["ln1_w"] = const(H, 1.0)
    if cfg.norm_type == "layernorm":
        layers["ln1_b"] = const(H, 0.0)
    if not cfg.single_norm:
        layers["ln2_w"] = const(H, 1.0)
        if cfg.norm_type == "layernorm":
            layers["ln2_b"] = const(H, 0.0)
    if cfg.qkv_bias:
        layers["bqkv"] = const((nh + 2 * nkv) * d, 0.0)
    if cfg.out_bias:
        layers["bo"] = const(H, 0.0)
    if cfg.mlp_bias:
        layers["b_in"] = const(2 * F if gated else F, 0.0)
        layers["b_out"] = const(H, 0.0)

    cos, sin = make_rotary_tables(d, cfg.rotary_pct, cfg.rotary_base, cfg.max_seq_len,
                                  cfg.rotary_style, device=dev)
    head_spec = spec
    if cfg.fp32_lm_head:
        head_spec = (dataclasses.replace(spec, dtype="float32") if spec.is_quantized
                     else resolve_spec("f32"))
    params: Params = {
        "embed": {"w": mk(H, V) if spec.is_quantized else randw(V, H).to(dtype)},
        "layers": layers,
        "final_ln": {"w": torch.ones((H,), dtype=dtype, device=dev)},
        "lm_head": {"w": mk(H, V, head_spec)},
        "rotary": {"cos": cos, "sin": sin},
    }
    if cfg.norm_type == "layernorm":
        params["final_ln"]["b"] = torch.zeros((H,), dtype=dtype, device=dev)
    if cfg.lm_head_bias:
        params["lm_head"]["b"] = torch.zeros(
            (V,), dtype=torch.float32 if cfg.fp32_lm_head else dtype, device=dev)
    return params
