"""Paged flash-decode attention: one decode step of one layer over the
head-packed page pool, a CUDA kernel and its plain PyTorch version.

``paged_flash_decode`` (``csrc/paged_flash_decode.cu``) replaces the
Pallas kernel ``_kernel`` / ``paged_flash_decode`` of
``mlc_llm_tpu/ops/pallas/paged_attention.py`` and keeps its signature:
q [B, Hq, 1, D] unscaled, pages [G, L, P, ps, hb*D] (bf16, or int8 codes
with f32 scales k [G, L, P, hb, ps] and v [G, L, P, ps, hb]), int32 page
table [B, maxp] and PRE-advance lengths [B]. For slot b, query head
hq reads kv-head h = hq // rep at lanes (h % hb)*D of group h // hb.

What both versions compute, page by page (an online softmax):
- q_pos = lengths[b]; pages p = 0 .. min(np_ - 1, q_pos // ps), page id
  table[b, p], np_ = min(num_pages_window, maxp);
- s = (q . k) in f32 on q cast to the key's type (bf16 for int8 codes),
  times ks[pos] in int8 mode, times 1/sqrt(D); positions > q_pos get
  -1e30;
- m, l, acc in f32; pij = exp(s - m_new) is rounded to bf16 before the
  PV product when the pages are bf16, kept f32 in int8 mode, where V is
  v_code * vs[pos] in f32;
- out = acc / max(l, 1e-20) in q's dtype.

The wrapper runs the plain version on CPU tensors and launches the
kernel on CUDA tensors, or raises. ``paged_flash_decode.launches``
counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import check_launch, load_kernel

NEG_INF = -1e30
KERNEL_HEAD_DIM = 128  # the kernel's block is one thread per head-dim lane

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = {"mlc_paged_flash_decode": [_P] * 8 + [_I] * 12 + [_P]}


def paged_flash_decode_plain(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                             layer, *, num_pages_window: int, head_dim: int):
    """The kernel's arithmetic in PyTorch, vectorized over slots and
    heads, one page of the window per iteration. Pages past a slot's
    length are fully masked and add nothing, as the kernel skips them."""
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
    m = torch.full((B, Hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, rep, D), dtype=torch.float32, device=dev)
    kl, vl = k_pages[:, layer], v_pages[:, layer]
    lane = torch.arange(ps, device=dev)

    def heads(x):  # [G, B, ps, hb*D] -> [B, Hkv, ps, D]
        return x.reshape(G, B, ps, hb, D).permute(1, 0, 3, 2, 4).reshape(B, Hkv, ps, D)

    for p in range(np_):
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
    out = acc / l.clamp(min=1e-20)[..., None]
    return out.reshape(B, Hq, D)[:, :, None, :].to(q.dtype)


def _check_cuda_args(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer,
                     head_dim):
    B, Hq, S, D = q.shape
    if S != 1 or D != head_dim:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)} must be [B, Hq, 1, {head_dim}]")
    if D != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"paged_flash_decode: the CUDA kernel takes head_dim {KERNEL_HEAD_DIM}, got {D}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"paged_flash_decode: q must be bf16, got {q.dtype}")
    if k_pages.dtype not in (torch.bfloat16, torch.int8) or v_pages.dtype != k_pages.dtype:
        raise NotImplementedError(
            f"paged_flash_decode: pages must be bf16 or int8, got {k_pages.dtype}/{v_pages.dtype}")
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
    lib = load_kernel("paged_flash_decode", _ARGS)
    out = torch.empty((B, Hq, 1, D), dtype=q.dtype, device=q.device)
    err = lib.mlc_paged_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hq, G, L, P, ps, hbD // D, D, maxp, np_, layer, int(int8),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
