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

On the paged cache, a decode step (one token at every slot) attends
through ``ops.paged_attention.paged_flash_decode`` (the CUDA kernel on
the card, its plain version on the CPU); prefill and any other block
gather the target slots' windowed pages and run ``attend_cache``. The
paged path never takes a flash-prefill branch. On the slot cache, a
``prefill_flash`` block (the caller asserts every row starts at position
0: a reset prefill) whose length and head dim pass
``ops.attention.flash_prefill_supported`` writes its K/V into the cache
and then attends over its own post-rotary K/V in the compute dtype
through ``flash_prefill`` (kernel 8), reading nothing of the cache, as
JAX's branch does (``mlc_llm_tpu/models/transformer.py:335-345``); the
int8 cache never takes it.

Every entry point shares one body. ``forward`` is driven from the host:
the start lengths come from the cache's host mirror, which it advances.
``forward_block`` reads no host value, so that a CUDA graph can hold it
(``engine/programs.py``): the target slots [G] (or every slot in order),
their starts and ``seq_lens`` are device tensors, the slot cache's rows
are picked by ``index_select`` and scattered to by those slots, the
paged write positions come from the device page table
(``paged_write_index``), and it sets ``cache.lengths_dev`` of the target
slots to start + seq_lens; the host mirror is the caller's to advance.
``forward_decode`` is one decode step on those terms (every slot, at
the device lengths) and ``forward_verify`` the speculative verify pass
(slot cache only): an S-token block written at the device lengths, every
position's logits, no length advanced.

Tensor parallelism (Megatron placement, ``parallel/sharding.py``): every
entry point takes ``mesh``, a ``torch.distributed`` DeviceMesh with a
"tp" dimension, or None. With a mesh, ``params`` are this rank's shards
(``parallel.sharding.shard_params``) and the cache holds this rank's
heads (``init_kv_cache(..., tp=)``, ``shard_cache``): the rank computes
its Hq/tp query heads and Hkv/tp kv heads, its columns of ``wqkv`` and
``w_in`` and its rows of ``wo`` and ``w_out``, each matmul through the
same kernel route as an unsharded weight of the local shape. The
collectives, all ``all_reduce`` on the tp group (one code path for gloo
and NCCL, capturable in a CUDA graph under NCCL): one after ``wo`` and
one after ``w_out`` in every layer, on the f32 partial sums (rounded once
to the activation dtype after the sum), the row-parallel biases (``bo``,
``b_out``) added once after them, by the norm site that takes the sum as
its term; one after a vocab-parallel embedding
(each rank looks up the tokens of its vocab range, zero elsewhere); one
that gathers a vocab-parallel lm head's logits into a zeroed full-vocab
buffer, so every rank holds the full [B, V] logits. A replicated
embedding or lm head needs none. A paged decode runs kernel 7 on the
rank's local head groups (``paged_flash_decode_tp``). The JAX package
places the same collectives through GSPMD from sharding annotations;
the port passes the mesh explicitly and holds no module state.

Norm sites. Each norm of the decoder and the residual sum before it are
one call of ``ops.norm.residual_norm`` (kernel 9 on the card, the plain
op chain on the CPU): layer 0's entry takes the norm(s) of the embedding;
layer l's entry sums layer l-1's residual (its attention and MLP outputs,
with their row-parallel biases ``bo`` and ``b_out``, clamped in f16) and
takes layer l's ln1, with ln2 from the same pass under the parallel
residual, or the one norm both branches share (``single_norm``); under
the sequential residual ``h + attn_out`` is summed with ln2 mid-layer,
unclamped; the last layer's residual is summed with ``final_ln``. The
rounding points are the op chain's: each biased term rounded to the
dtype, then ``(h + t1) + t2``, then the clamp.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..ops import resolve_device
from ..ops.attention import attend_cache, flash_prefill, flash_prefill_supported
from ..ops.matmul import qmatmul, qmatmul_stacked
from ..ops.norm import residual_norm
from ..ops.paged_attention import paged_flash_decode
from ..quant.groupwise import (
    QuantizedTensor,
    pad_cols,
    pad_quantized_groups,
    quantize,
    take_dequantize,
    torch_dtype,
    words_per_group,
)
from ..quant.spec import QuantSpec, resolve_spec, spec_for_k
from .config import ModelConfig
from .layers import activate, apply_rotary, make_rotary_tables
from .paged_cache import (
    PagedKVCache,
    PagedWriteIndex,
    paged_flash_decode_tp,
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


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The "tp" dimension of a mesh as one forward uses it."""

    mesh: Any
    group: Any  # the tp process group
    rank: int   # this process's coordinate on tp
    size: int


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """The tp view of a DeviceMesh with a "tp" dimension (None: no mesh)."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names
    if not names or "tp" not in names:
        raise ValueError(f"the mesh needs a 'tp' dimension, got {names}")
    return TensorParallel(mesh, mesh.get_group("tp"), mesh.get_local_rank("tp"),
                          mesh.shape[names.index("tp")])


def all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Sum x over the tp group, in place (x contiguous), in x's dtype."""
    x = x.contiguous()
    dist.all_reduce(x, group=tp.group)
    return x


@dataclasses.dataclass
class KVCache:
    """k: [L, B, Hkv, Smax, D]; v: [L, B, Hkv, D, Smax] (D-major);
    lengths: [B] valid token count per slot, kept on the host (int64 CPU
    tensor), the source of truth; lengths_dev: its device copy, a fixed
    buffer that a step reads and advances (staged from the host mirror
    before each step).

    int8 mode: k/v hold per-element int8 codes and k_scale/v_scale hold
    per-(layer, slot, head, position) absmax/127 scales [L, B, Hkv,
    Smax] in f32; other dtypes leave the scales None."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    lengths_dev: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.lengths_dev is None:
            self.lengths_dev = self.lengths.to(self.k.device, copy=True)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: Optional[int] = None,
                  dtype=torch.bfloat16, device="cuda", tp: int = 1) -> KVCache:
    """A zeroed slot cache; tp > 1: one tensor-parallel rank's, Hkv/tp
    heads."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32, torch.int8):
        raise NotImplementedError(f"KV cache dtype {dtype} is not supported")
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp = {tp} does not divide num_kv_heads {cfg.num_kv_heads}")
    dev = resolve_device(device)
    max_len = max_len or cfg.max_seq_len
    L, H, D = cfg.num_layers, cfg.num_kv_heads // tp, cfg.head_dim
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


def pad_params(params):
    """Every word-packed quantized leaf zero-padded to a multiple of 32
    groups (``pad_quantized_groups``, exact), as the engine does at init,
    so that every matmul routes to its kernel; checkpoints hold the
    unpadded params."""
    return tree_map(lambda x: pad_quantized_groups(x) if isinstance(x, QuantizedTensor) else x,
                    params)


def param_bytes(params) -> int:
    """Stored bytes of a param tree: words or planes, scales, minima and
    dense leaves."""
    sizes = []
    tree_map(lambda x: sizes.append(x.nbytes() if isinstance(x, QuantizedTensor)
                                    else x.numel() * x.element_size()), params)
    return sum(sizes)


# the reference's fp16-safety clamp at the end of a layer, under float16's
# 65504 max
F16_CLAMP = 55504.0


def _norm_site(h, terms, biases, norms, cfg: ModelConfig, layer_end: bool):
    """h + the terms (each plus its bias), clamped in f16 where a layer
    ends, and the norms ((w, b) pairs) of the sum: (h', [normalised])."""
    clamp = F16_CLAMP if layer_end and h.dtype == torch.float16 else None
    return residual_norm(h, terms, biases, norms, cfg.norm_eps, cfg.norm_type, clamp)


def _entry_norms(lp, cfg: ModelConfig):
    """The norms a layer's entry takes: ln1, and ln2 of the same h under
    the parallel residual (the single norm of ``single_norm`` serves both
    branches)."""
    norms = [(lp["ln1_w"], lp.get("ln1_b"))]
    if cfg.parallel_residual and not cfg.single_norm:
        norms.append((lp["ln2_w"], lp.get("ln2_b")))
    return norms


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


def _row_parallel(x, w, l, tp: Optional[TensorParallel]):
    """x @ w[l] for a row-parallel weight (wo, w_out), without its bias
    (the norm site adds it): under tp each rank holds k/tp rows, so its
    product is a partial sum. The partials stay in f32 (the kernels'
    accumulator), are all-reduced in f32 and rounded once to x's dtype, as
    the unsharded matmul rounds its f32 sum once."""
    if tp is None:
        return qmatmul_stacked(x, w, l)
    return all_reduce(qmatmul_stacked(x, w, l, out_dtype=torch.float32), tp).to(x.dtype)


def _layer_tail(h, attn_out, h_mlp_in, lp, weights, l, cfg: ModelConfig, next_norms,
                tp: Optional[TensorParallel] = None):
    """MLP tail and the norm site that ends the layer: (h', the norms of
    next_norms). attn_out comes without ``bo``; h_mlp_in is the
    parallel-residual MLP input (None for the sequential residual, whose
    mid-layer site sums h + attn_out and takes ln2)."""
    terms, biases = [attn_out], [lp.get("bo")]
    if h_mlp_in is None:
        h, (h_mlp_in,) = _norm_site(h, terms, biases, [(lp["ln2_w"], lp.get("ln2_b"))], cfg,
                                    layer_end=False)
        terms, biases = [], []
    if cfg.act == "silu_gated":
        gate_up = qmatmul_stacked(h_mlp_in, weights["w_in"], l, lp.get("b_in"))
        gate, up = gate_up.chunk(2, dim=-1)
        mid = torch.nn.functional.silu(gate) * up
    else:
        mid = activate(qmatmul_stacked(h_mlp_in, weights["w_in"], l, lp.get("b_in")), cfg.act)
    mlp_out = _row_parallel(mid, weights["w_out"], l, tp)
    return _norm_site(h, terms + [mlp_out], biases + [lp.get("b_out")], next_norms, cfg,
                      layer_end=True)


@dataclasses.dataclass
class _PagedStep:
    """What a paged forward computes once and every layer reuses."""

    index: PagedWriteIndex
    lengths: torch.Tensor  # [B] int32 on the device (pre-advance)
    maxp: int              # pages in the attention window
    table: torch.Tensor    # the target slots' page-table rows [G, max_pages]
    decode: bool           # one token at every slot: the paged decode kernel


def _pool_rows(x, G):
    """[B, S, H, ...] -> [G, B*S, hb*...]: the pool's row layout."""
    B, S = x.shape[:2]
    return x.reshape(B, S, G, -1).permute(2, 0, 1, 3).reshape(G, B * S, -1)


def _attend_paged(q, k, v, cache: PagedKVCache, l, step: _PagedStep, start_dev, d,
                  tp: Optional[TensorParallel] = None):
    """Write this block's K/V into the pages, then attend (q/k/v
    [B, S, H, D] after rotary; under tp the rank's heads and pools)."""
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
    if step.decode:
        decode = paged_flash_decode if tp is None else functools.partial(
            paged_flash_decode_tp, mesh=tp.mesh)
        return decode(qt.contiguous(), cache.k_pages, cache.v_pages, cache.k_scale,
                      cache.v_scale, cache.page_table, step.lengths, l,
                      num_pages_window=step.maxp, head_dim=d)
    table = step.table
    kc = gather_pages_k(cache.k_pages, l, table, step.maxp, d)
    vc = gather_pages_v(cache.v_pages, l, table, step.maxp, d)
    ksc = vsc = None
    if cache.k_pages.dtype == torch.int8:
        ksc = gather_pages_scale_k(cache.k_scale, l, table, step.maxp)
        vsc = gather_pages_scale_v(cache.v_scale, l, table, step.maxp)
    return attend_cache(qt, kc, vc, ksc, vsc, start_dev)


def slot_write_index(start_dev, S: int, smax: int, slots=None):
    """(slot rows [G, 1], positions [G, S]) of an S-token block written at
    each target slot's start (slots [G], or None for every slot in
    order), the start clamped so the block fits (start = min(start, smax
    - S), as jax.lax.dynamic_update_slice clamps it), from device values
    only."""
    st = torch.clamp(start_dev, max=smax - S)
    rows = torch.arange(st.shape[0], device=st.device) if slots is None else slots
    return rows[:, None], st[:, None] + torch.arange(S, device=st.device)[None, :]


def _attend_slot(q, k, v, cache: KVCache, l, slot_index, start_dev, attn_window, slots,
                 prefill_flash: bool = False):
    """Write only the new tokens, IN PLACE (JAX returns an updated copy
    that XLA aliases): one batched scatter a buffer at `slot_index`
    (``slot_write_index``). Then attend the window of the target slots'
    rows (slots [G]: an index_select of those rows; None: every row), or,
    for a flash reset prefill on a non-int8 cache, the block's own K/V."""
    smax = cache.max_len
    kt, vt = k.transpose(1, 2), v.permute(0, 2, 3, 1)  # [B,H,S,D], [B,H,D,S]
    ks = vs = None
    if cache.k.dtype == torch.int8:
        kt, ks = _quantize_kv(kt)
        vt, vs = _quantize_kv_t(vt)
    rows, pos = slot_index
    # advanced indices (rows, pos) first: each target is [B, S, H, ...]
    cache.k[l][rows, :, pos] = kt.permute(0, 2, 1, 3).to(cache.k.dtype)
    cache.v[l][rows, :, :, pos] = vt.permute(0, 3, 1, 2).to(cache.v.dtype)
    if ks is not None:
        cache.k_scale[l][rows, :, pos] = ks.transpose(1, 2)
        cache.v_scale[l][rows, :, pos] = vs.transpose(1, 2)
    elif prefill_flash and flash_prefill_supported(q.shape[1], q.shape[-1]):
        # the block is the whole context: causal attention over its own K/V
        # in the compute dtype, nothing read back from the cache
        return flash_prefill(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    W = attn_window or smax

    def window(t):  # positions on axis 3 of k and the scales, last of D-major v
        if t is None:
            return None
        t = t[l, ..., :W] if t is cache.v else t[l, :, :, :W]
        return t if slots is None else t.index_select(0, slots)

    return attend_cache(q.transpose(1, 2), window(cache.k), window(cache.v),
                        window(cache.k_scale), window(cache.v_scale), start_dev)


def _layer(h, normed, lp, next_norms, weights, cache, l: int, cfg: ModelConfig, rot_cos,
           rot_sin, positions, slot_index, slots, start_dev, attn_window: Optional[int],
           paged: Optional[_PagedStep], prefill_flash: bool = False,
           tp: Optional[TensorParallel] = None):
    """Layer l from h and its entry norms `normed` (``_entry_norms``):
    returns the next site's (h', norms of next_norms)."""
    B, S, _ = h.shape
    n = 1 if tp is None else tp.size
    nh, nkv, d = cfg.num_heads // n, cfg.num_kv_heads // n, cfg.head_dim
    h_attn_in = normed[0]
    h_mlp_in = normed[-1] if cfg.parallel_residual or cfg.single_norm else None

    qkv = qmatmul_stacked(h_attn_in, weights["wqkv"], l, lp.get("bqkv"))
    q, k, v = qkv.split([nh * d, nkv * d, nkv * d], dim=-1)
    q = apply_rotary(q.reshape(B, S, nh, d), rot_cos, rot_sin, positions, cfg.rotary_style)
    k = apply_rotary(k.reshape(B, S, nkv, d), rot_cos, rot_sin, positions, cfg.rotary_style)
    v = v.reshape(B, S, nkv, d)
    if paged is not None:
        attn = _attend_paged(q, k, v, cache, l, paged, start_dev, d, tp)
    else:
        attn = _attend_slot(q, k, v, cache, l, slot_index, start_dev, attn_window, slots,
                            prefill_flash)
    attn = attn.transpose(1, 2).reshape(B, S, nh * d)
    attn_out = _row_parallel(attn, weights["wo"], l, tp)
    return _layer_tail(h, attn_out, h_mlp_in, lp, weights, l, cfg, next_norms, tp)


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, tokens, cache, *,
            seq_lens=None, last_only: bool = True, attn_window: Optional[int] = None,
            prefill_flash: bool = False, mesh=None):
    """Run the decoder over a token block appended at each slot's length.

    tokens: [B, S] integer tensor on the params' device. cache: a
    KVCache or a PagedKVCache. seq_lens: [B] new-token count per slot
    (<= S, host ints); tokens beyond are right-padding whose junk K/V is
    rewritten before it is ever read. attn_window bounds the cache
    positions read (caller guarantees lengths + S <= attn_window).
    prefill_flash: the caller asserts every slot starts at position 0 (a
    reset prefill); the slot cache's attention then runs the causal flash
    kernel over the block itself where the gate lets it (JAX's argument).
    mesh: a DeviceMesh with a "tp" dimension when params and cache are one
    tensor-parallel rank's (the module doc), else None.
    Returns (logits f32 [B, V] at each slot's last real token if
    last_only, else [B, S, V]; the cache, updated in place, its host
    lengths advanced by seq_lens)."""
    B, S = tokens.shape
    seq_lens = (torch.full((B,), S, dtype=torch.int64) if seq_lens is None
                else torch.as_tensor(seq_lens, dtype=torch.int64).cpu())
    dev = tokens.device
    logits = _forward(params, cfg, tokens, cache, None, cache.lengths.to(dev), seq_lens.to(dev),
                      last_only, attn_window, prefill_flash, mesh)
    cache.lengths += seq_lens
    return logits, cache


@torch.no_grad()
def forward_block(params: Params, cfg: ModelConfig, tokens, cache, slots, starts, seq_lens, *,
                  attn_window: Optional[int] = None, last_only: bool = True,
                  prefill_flash: bool = False, mesh=None):
    """A token block (tokens [G, S]) that reads no host value: row g is
    written into slot slots[g] from position starts[g] (slots None: row g
    is slot g, G == B), seq_lens[g] of its tokens real. slots, starts and
    seq_lens are [G] int64 device tensors. Sets ``cache.lengths_dev`` of
    the target slots to starts + seq_lens, in place; the host mirror is
    the caller's to advance. prefill_flash: every row starts at position 0
    (see ``forward``), and so is mesh. Returns the f32 logits ([G, V] at
    each row's last real token if last_only, else [G, S, V])."""
    logits = _forward(params, cfg, tokens, cache, slots, starts, seq_lens, last_only,
                      attn_window, prefill_flash, mesh)
    end = starts + seq_lens
    if slots is None:
        cache.lengths_dev.copy_(end)
    else:
        cache.lengths_dev.index_copy_(0, slots, end)
    return logits


def forward_decode(params: Params, cfg: ModelConfig, tokens, cache, seq_lens, *,
                   attn_window: Optional[int] = None, mesh=None):
    """One decode step (tokens [B, 1]) at the device lengths
    ``cache.lengths_dev``, which it advances by seq_lens ([B] int64 on
    the device: 1 active, 0 frozen); the paged write positions come from
    the device page table. Returns the f32 logits [B, V]."""
    return forward_block(params, cfg, tokens, cache, None, cache.lengths_dev, seq_lens,
                         attn_window=attn_window, mesh=mesh)


def forward_verify(params: Params, cfg: ModelConfig, tokens, cache, *,
                   attn_window: Optional[int] = None, mesh=None):
    """The speculative verify pass (tokens [B, S]) that reads no host
    value: the block is written at ``cache.lengths_dev``, K/V rows [len,
    len + S) in place (the start clamped to Smax - S, as JAX's
    dynamic_update_slice clamps it), and no length advances, the JAX
    verify's ``forward(..., seq_lens=0, last_only=False)``. Slot cache
    only. Returns the f32 logits [B, S, V] of every position."""
    if isinstance(cache, PagedKVCache):
        raise ValueError("the speculative verify pass needs the slot KV cache")
    return forward_block(params, cfg, tokens, cache, None, cache.lengths_dev,
                         torch.zeros_like(cache.lengths_dev), attn_window=attn_window,
                         last_only=False, mesh=mesh)


def _vocab_range(n_local: int, cfg: ModelConfig, tp: Optional[TensorParallel]):
    """The first vocab id of this rank's embedding or lm head columns,
    or None when the leaf holds the whole vocabulary (replicated)."""
    if tp is None or n_local == cfg.vocab_size:
        return None
    return tp.rank * n_local


def _embed(emb, tokens, cfg: ModelConfig, tp: Optional[TensorParallel]):
    """Token embeddings [B, S, H]; a vocab-parallel table looks up the
    tokens of its own range (zero elsewhere), then one all-reduce."""
    quantized = isinstance(emb, QuantizedTensor)
    v_local = emb.shape[1] if quantized else emb.shape[0]
    v0 = _vocab_range(v_local, cfg, tp)
    if v0 is None:
        # a quantized table's rows come out as a transposed view: the first
        # norm site takes its rows contiguous
        return take_dequantize(emb, tokens).contiguous() if quantized else emb[tokens]
    local = tokens - v0
    mine = (local >= 0) & (local < v_local)
    local = torch.where(mine, local, torch.zeros_like(local))
    h = take_dequantize(emb, local) if quantized else emb[local]
    return all_reduce(torch.where(mine[..., None], h, torch.zeros_like(h)), tp)


def _lm_head(h, lm, cfg: ModelConfig, tp: Optional[TensorParallel]):
    """f32 logits [..., V]; a vocab-parallel head's columns are gathered
    into a zeroed full-vocab buffer by one all-reduce."""
    logits = qmatmul(h, lm["w"], lm.get("b"), out_dtype=torch.float32).float()
    v0 = _vocab_range(logits.shape[-1], cfg, tp)
    if v0 is None:
        return logits
    full = torch.zeros((*logits.shape[:-1], cfg.vocab_size), dtype=torch.float32,
                       device=logits.device)
    full[..., v0:v0 + logits.shape[-1]] = logits
    return all_reduce(full, tp)


def _forward(params, cfg: ModelConfig, tokens, cache, slots, start_dev, seq_lens,
             last_only: bool, attn_window: Optional[int], prefill_flash: bool = False,
             mesh=None):
    """The decoder body on device values: slots [G] (None: every slot in
    order), start_dev and seq_lens [G] int64 on the tokens' device."""
    B, S = tokens.shape
    dev = tokens.device
    tp = tensor_parallel(mesh)
    positions = start_dev[:, None] + torch.arange(S, device=dev)[None, :]
    positions = positions.clamp(max=cache.max_len - 1)
    paged = slot_index = None
    if isinstance(cache, PagedKVCache):
        ps = cache.page_size
        maxp = cache.page_table.shape[1]
        if attn_window is not None:
            maxp = min(maxp, -(-attn_window // ps))
        table = cache.page_table if slots is None else cache.page_table.index_select(0, slots)
        # the write positions and kernel lengths once per forward, for all
        # L layers
        paged = _PagedStep(index=paged_write_index(table, start_dev, S, ps),
                           lengths=start_dev.to(torch.int32), maxp=maxp, table=table,
                           decode=S == 1 and slots is None)
    else:
        slot_index = slot_write_index(start_dev, S, cache.max_len, slots)

    h = _embed(params["embed"]["w"], tokens, cfg, tp)
    rot_cos, rot_sin = params["rotary"]["cos"], params["rotary"]["sin"]
    weights = {k: v for k, v in params["layers"].items() if k in WEIGHT_KEYS}
    small = {k: v for k, v in params["layers"].items() if k not in WEIGHT_KEYS}
    lps = [{k: v[l] for k, v in small.items()} for l in range(cfg.num_layers)]
    final = [(params["final_ln"]["w"], params["final_ln"].get("b"))]
    h, normed = _norm_site(h, [], [], _entry_norms(lps[0], cfg), cfg, layer_end=False)
    for l, lp in enumerate(lps):
        next_norms = _entry_norms(lps[l + 1], cfg) if l + 1 < len(lps) else final
        h, normed = _layer(h, normed, lp, next_norms, weights, cache, l, cfg, rot_cos, rot_sin,
                           positions, slot_index, slots, start_dev, attn_window, paged,
                           prefill_flash, tp)

    h = normed[0]
    if last_only:
        # lm head on each slot's last REAL position only
        idx = (seq_lens - 1).clamp(0, S - 1)
        h = h[torch.arange(B, device=dev), idx][:, None]
    if cfg.fp32_lm_head:
        h = h.float()
    logits = _lm_head(h, params["lm_head"], cfg, tp)
    if last_only:
        logits = logits[:, 0]
    return logits


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
        # the stored layout of quantize(): i8 planes and u4 code planes
        # [G*g, N], or words [G * words_per_group, N] as int32 (u32) /
        # int16 (u16) bits
        g = fspec.group_size
        ngroups = -(-k // g)
        n_st = pad_cols(n)
        if fspec.storage == "u4":
            data = torch.randint(0, 16, (ngroups * g, n_st), generator=gen, device=dev,
                                 dtype=torch.uint8)
        elif fspec.storage == "i8":
            data = torch.randint(-127, 128, (ngroups * g, n_st), generator=gen, device=dev,
                                 dtype=torch.int8)
        else:
            half = 2**31 if fspec.storage == "u32" else 2**15
            data = torch.randint(-half, half, (ngroups * words_per_group(fspec), n_st),
                                 generator=gen, device=dev, dtype=torch.int64)
            data = data.to(torch.int32 if fspec.storage == "u32" else torch.int16)
        qscale = (torch.randn((ngroups, n_st), generator=gen, device=dev).abs()
                  * scale / max(fspec.max_int, 1)).to(torch_dtype(fspec.dtype))
        zero = None if fspec.sym else (-qscale * (1 << (fspec.nbit - 1))).to(qscale.dtype)
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
