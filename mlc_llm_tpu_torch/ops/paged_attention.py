"""Paged flash-decode attention: one decode step of one layer over the
head-packed page pool, a CUDA kernel and its plain PyTorch version.

``paged_flash_decode`` (``csrc/paged_flash_decode.cu``) replaces the
Pallas kernel ``_kernel`` / ``paged_flash_decode`` of
``mlc_llm_tpu/ops/pallas/paged_attention.py`` and keeps its signature:
q [B, Hq, 1, D] unscaled, pages [G, L, P, ps, hb*D] (bf16, f16, f32, or
int8 codes with f32 scales k [G, L, P, hb, ps] and v [G, L, P, ps,
hb]), int32 page table [B, maxp] and PRE-advance lengths [B]. For slot
b, query head hq reads kv-head h = hq // rep at lanes (h % hb)*D of
group h // hb.

What both versions compute, page by page (an online softmax):
- q_pos = lengths[b]; pages p = 0 .. min(np_ - 1, q_pos // ps), page id
  table[b, p], np_ = min(num_pages_window, maxp);
- s = (q . k) in f32 on q cast to the page type (bf16 for int8 codes),
  times ks[pos] in int8 mode, times 1/sqrt(D); positions > q_pos get
  -1e30;
- m, l, acc in f32; pij = exp(s - m_new) is rounded to bf16 before the
  PV product when the pages are bf16, kept f32 otherwise (in int8 mode V
  is v_code * vs[pos] in f32);
- out = acc / max(l, 1e-20) in q's dtype.

The CUDA kernel takes q in bf16, f16 or f32, the four page types and
the head dims of the registry's models (``KERNEL_HEAD_DIMS``). The
wrapper runs the plain version on CPU tensors and launches the kernel on
CUDA tensors, or raises. ``paged_flash_decode.launches``
counts kernel launches only.

Split-KV: the kernel walks the window in splits of ``launch_plan``'s
pages (``split_pages`` over the page table's width, so that a slot's
splits do not depend on the window), each from an empty softmax state
(with bf16 pages the probabilities round against the split's own running
max), and its last split to finish combines the partials in split order,
in the same launch. ``paged_flash_decode_plain(..., pages_per_split=pps)`` repeats
that split and combine; with the default ``None`` it walks the whole
window as one split, and the CPU path calls it so.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import check_launch, load_kernel, zeroed_tickets

NEG_INF = -1e30
# the head dims the kernel's lane layouts take: 8 elements a lane (80 on 10
# of a row's 16 lanes, 128), or 16 (256)
KERNEL_HEAD_DIMS = (80, 128, 256)
# the kernel's type ids (csrc enum QType, and the page types' switch)
Q_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
PAGE_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2, torch.int8: 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = {"mlc_paged_flash_decode": [_P] * 8 + [_I] * 15 + [_P] * 4}

# The split plan of the kernel's page walk. A block walks its pages one
# after another, each page a few dependent load round trips, so a long
# slot is latency bound and wants many blocks in flight; a split costs a
# partial written and read once and one more block to schedule, and a
# split past a slot's length exits at once. The plan takes the fewest
# pages per split that gives the grid at least SPLIT_BLOCKS[elements a
# lane] blocks, fitted to scripts/torch_plan_sweep.py on an H100 (700 W)
# at the serve pool's shapes (b1 x 255, 256, 1023, 2047; b8 over mixed
# lengths and b8 x 1024 and x 2047; bf16 and int8 pages; the fastest plan
# did not depend on the page type): 8 elements a lane (D 80, 128; 4 blocks
# an SM) at 2048 blocks (b1: 16 one-page splits; b8: 8 splits of 2 pages,
# within 5% of one split at b8 x 1024), 16 (D 256, twice the
# registers, half the blocks an SM) at 256 (b1: 8 splits of 2 pages; b8: 2
# of 8).
SPLIT_BLOCKS = {8: 2048, 16: 256}


def split_pages(num_pages: int, batch: int, kv_heads: int, rep: int, head_dim: int) -> int:
    """Pages per split of the kernel's walk over a `num_pages` window for
    `batch` slots of `kv_heads` kv-heads with `rep` query heads each: a
    plan of shapes the host knows, never of the slots' lengths (reading
    them would sync the device every decode step). The splits cover the
    window and none is empty: (nsplit - 1) * pps < num_pages <= nsplit *
    pps."""
    # the kernel's lane layout and the query rows a block holds (csrc
    # launch_rows: the fewest of 1, 2, 4, 8 that hold rep; 2 at D = 256)
    lane_elems = 16 if head_dim == 256 else 8
    rows = min(rep, 2) if lane_elems == 16 else next(r for r in (1, 2, 4, 8) if r >= min(rep, 8))
    cells = batch * kv_heads * -(-rep // rows)
    want = max(1, min(num_pages, -(-SPLIT_BLOCKS[lane_elems] // cells)))
    return -(-num_pages // want)


def launch_plan(q, k_pages, page_table, num_pages_window: int):
    """(pages per split, splits) of the kernel's launch on these shapes:
    the pages per split of `split_pages` over the table's width maxp, and
    as many splits as cover the window min(num_pages_window, maxp). Reads
    no tensor, so the slots' lengths never reach the plan; and a slot's
    splits are the same whatever the window, so its result does not
    depend on the window the batch's longest slot sets (a split past its
    pages is empty and weighs 0 in the combine): a request's stream does
    not depend on what shares its steps."""
    B, Hq, _, D = q.shape
    G, _, _, _, hbD = k_pages.shape
    maxp = page_table.shape[1]
    np_ = min(num_pages_window, maxp)
    hkv = G * (hbD // D)
    pps = min(split_pages(maxp, B, hkv, Hq // hkv, D), np_)
    return pps, -(-np_ // pps)


def paged_flash_decode_plain(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                             layer, *, num_pages_window: int, head_dim: int,
                             pages_per_split: Optional[int] = None):
    """The kernel's arithmetic in PyTorch, vectorized over slots and
    heads, one page of the window per iteration. Pages past a slot's
    length are fully masked and add nothing, as the kernel skips them.

    The window walks in the kernel's splits of `pages_per_split` pages
    (None: one split of the whole window, the unsplit walk): split s
    runs pages [s * pps, (s + 1) * pps) from an empty state; a split that
    starts past a slot's last page (min(np_ - 1, q_pos // ps)) is the empty
    partial (m = -1e30, l = 0, acc = 0); then m = the max of the splits'
    m, and acc and l are summed in split order, each split's weighted by
    exp(m_s - m)."""
    B, Hq, _, D = q.shape
    G, _, _, ps, hbD = k_pages.shape
    hb = hbD // D
    Hkv = G * hb
    rep = Hq // Hkv
    np_ = min(num_pages_window, page_table.shape[1])
    int8 = k_pages.dtype == torch.int8
    cdt = torch.bfloat16 if int8 else k_pages.dtype
    dev = q.device
    qh = q[:, :, 0].to(cdt).float().reshape(B, Hkv, rep, D)
    lens = torch.as_tensor(lengths).to(dev, torch.int64)
    scale = 1.0 / math.sqrt(D)
    kl, vl = k_pages[:, layer], v_pages[:, layer]
    lane = torch.arange(ps, device=dev)

    def heads(x):  # [G, B, ps, hb*D] -> [B, Hkv, ps, D]
        return x.reshape(G, B, ps, hb, D).permute(1, 0, 3, 2, 4).reshape(B, Hkv, ps, D)

    def walk(p0, p1):  # the online softmax over pages [p0, p1) from an empty state
        m = torch.full((B, Hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, rep), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, rep, D), dtype=torch.float32, device=dev)
        for p in range(p0, p1):
            pid = page_table[:, p].long()
            k = heads(kl[:, pid]).to(cdt).float()
            s = torch.einsum("bhrd,bhpd->bhrp", qh, k)
            if int8:
                ks = k_scale[:, layer][:, pid]  # [G, B, hb, ps]
                s = s * ks.permute(1, 0, 2, 3).reshape(B, Hkv, 1, ps)
            s = s * scale
            valid = (p * ps + lane)[None, :] <= lens[:, None]  # [B, ps]
            s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pij = torch.exp(s - m_new[..., None])
            l = l * alpha + pij.sum(dim=-1)
            m = m_new
            v = heads(vl[:, pid]).float()
            if int8:
                vs = v_scale[:, layer][:, pid]  # [G, B, ps, hb]
                v = v * vs.permute(1, 0, 3, 2).reshape(B, Hkv, ps, 1)
            elif v_pages.dtype == torch.bfloat16:
                pij = pij.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.einsum("bhrp,bhpd->bhrd", pij, v)
        return m, l, acc

    pps = pages_per_split or np_
    last_page = torch.clamp(lens // ps, max=np_ - 1)  # [B]
    parts = []
    for p0 in range(0, np_, pps):
        m_s, l_s, acc_s = walk(p0, min(np_, p0 + pps))
        empty = (p0 > last_page)[:, None, None]  # [B, 1, 1]
        parts.append((torch.where(empty, torch.full_like(m_s, NEG_INF), m_s),
                      torch.where(empty, torch.zeros_like(l_s), l_s),
                      torch.where(empty[..., None], torch.zeros_like(acc_s), acc_s)))
    m = parts[0][0]
    for m_s, _, _ in parts[1:]:
        m = torch.maximum(m, m_s)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_s, l_s, acc_s in parts:
        w = torch.exp(m_s - m)
        l = l + w * l_s
        acc = acc + w[..., None] * acc_s
    out = acc / l.clamp(min=1e-20)[..., None]
    return out.reshape(B, Hq, D)[:, :, None, :].to(q.dtype)


def _check_cuda_args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer,
                     head_dim):
    B, Hq, S, D = q.shape
    if S != 1 or D != head_dim:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)} must be [B, Hq, 1, {head_dim}]")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"paged_flash_decode: the CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {D}")
    if q.dtype not in Q_TYPES:
        raise NotImplementedError(
            f"paged_flash_decode: q must be one of {[str(t) for t in Q_TYPES]}, got {q.dtype}")
    if k_pages.dtype not in PAGE_TYPES or v_pages.dtype != k_pages.dtype:
        raise NotImplementedError(
            f"paged_flash_decode: pages must be one of {[str(t) for t in PAGE_TYPES]}, got "
            f"{k_pages.dtype}/{v_pages.dtype}")
    G, L, P, ps, hbD = k_pages.shape
    if v_pages.shape != k_pages.shape or hbD % D or Hq % (G * hbD // D):
        raise ValueError(f"paged_flash_decode: bad pool {tuple(k_pages.shape)} for q "
                         f"{tuple(q.shape)}")
    hb = hbD // D
    tensors = [q, k_pages, v_pages, page_table, lengths]
    if k_pages.dtype == torch.int8:
        if (k_scale is None or v_scale is None
                or k_scale.shape != (G, L, P, hb, ps) or v_scale.shape != (G, L, P, ps, hb)
                or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
            raise ValueError("paged_flash_decode: int8 pages need f32 scales "
                             "[G, L, P, hb, ps] and [G, L, P, ps, hb]")
        tensors += [k_scale, v_scale]
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_flash_decode: page_table and lengths must be int32")
    if page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_flash_decode: page_table/lengths batch mismatch")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("paged_flash_decode: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("paged_flash_decode: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_flash_decode: q and the pages must be 16-byte aligned")
    if not 0 <= layer < L:
        raise IndexError(f"paged_flash_decode: layer {layer} out of range")


def paged_flash_decode(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer,
                       *, num_pages_window: int, head_dim: int):
    """Returns [B, Hq, 1, D] attention output for one decode step."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                        lengths, layer, num_pages_window=num_pages_window,
                                        head_dim=head_dim)
    layer = int(layer)
    _check_cuda_args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer,
                     head_dim)
    B, Hq, _, D = q.shape
    G, L, P, ps, hbD = k_pages.shape
    maxp = page_table.shape[1]
    np_ = min(num_pages_window, maxp)
    if np_ < 1:
        raise ValueError("paged_flash_decode: empty page window")
    int8 = k_pages.dtype == torch.int8
    hb = hbD // D
    pps, nsplit = launch_plan(q, k_pages, page_table, num_pages_window)
    part = ml = tickets = None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if nsplit > 1:
        part = torch.empty((nsplit, B * Hq, D), dtype=torch.float32, device=q.device)
        ml = torch.empty((nsplit, B * Hq, 2), dtype=torch.float32, device=q.device)
        tickets = zeroed_tickets(q.device, stream, B * Hq)
    lib = load_kernel("paged_flash_decode", _ARGS)
    out = torch.empty((B, Hq, 1, D), dtype=q.dtype, device=q.device)
    err = lib.mlc_paged_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hq, G, L, P, ps, hb, D, maxp, np_, layer, PAGE_TYPES[k_pages.dtype],
        Q_TYPES[q.dtype], nsplit, pps, None if part is None else part.data_ptr(),
        None if ml is None else ml.data_ptr(), None if tickets is None else tickets.data_ptr(),
        stream)
    check_launch(err, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
