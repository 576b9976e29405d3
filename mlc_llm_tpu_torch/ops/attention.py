"""Attention against the slot KV cache, in plain PyTorch, and the causal
flash attention of a reset prefill (kernel 8).

The counterpart of ``mlc_llm_tpu/ops/attention.py``. ``attend`` and
``attend_cache``: QK^T/sqrt(d) with f32 scores, f32 softmax, causal mask
over history plus the current block, the probabilities rounded to q's
dtype, PV accumulated in f32 and rounded once to q's dtype; V kept
D-major. On CUDA both products take the operands in their dtype on the
tensor cores with f32 accumulation and an f32 result (one f32-output
``bmm`` each), as JAX's einsums with ``preferred_element_type=f32`` do
(``:48-67``); PV's is then rounded once to q's dtype. On the CPU the
operands go to f32 first (the same values: products of two bf16/f16
values are exact in f32).

``flash_prefill`` is the reset prefill's attention: a block at position 0
attends over its own K/V only, so nothing of the cache is read and no
[S, S] score matrix is built. JAX calls its library's Pallas TPU kernel
there (``flash_attention(causal=True)``); the port's is a hand-written
CUDA kernel, ``csrc/flash_prefill.cu``, with its plain version
``flash_prefill_plain`` beside it. The gate is JAX's shape gate,
``flash_prefill_shape_ok``, on every device: JAX's
``flash_prefill_supported`` also asks for a TPU because the Pallas kernel
has no interpret mode, while the port's kernel has a plain version, which
the wrapper runs on CPU tensors as every port kernel does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import check_launch, load_kernel

# JAX's DEFAULT_MASK_VALUE (jax.experimental.pallas.ops.tpu.flash_attention)
FLASH_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the kernel's head dims and type ids (csrc/flash_prefill.cu enum DType)
FLASH_HEAD_DIMS = (128, 256)
FLASH_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# query rows a block of the bf16/f16 body (two consumer warpgroups of 64):
# the sequence length the kernel takes is a multiple
FLASH_ROWS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FLASH_ARGS = {"mlc_flash_prefill": [_P] * 4 + [_I] * 6 + [_L] * 12 + [_P]}


def _f32_product(a, b):
    """a [B, H, n, k] @ b [B, H, k, p] with f32 accumulation and an f32
    result. CUDA, bf16/f16: the operands in their dtype through one
    f32-output bmm over B*H; otherwise (the CPU, f32) in f32."""
    if a.device.type != "cuda" or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    B, H, n, k = a.shape
    y = torch.bmm(a.reshape(B * H, n, k), b.reshape(B * H, k, b.shape[-1]),
                  out_dtype=torch.float32)
    return y.reshape(B, H, n, b.shape[-1])


def attend(q, k, v, q_pos, *, mask_value: float = -1e30, v_transposed: bool = False):
    """Masked attention of a query block against full K/V buffers.

    q: [B, Hq, Sq, D]; k: [B, Hkv, Smax, D]; v: [B, Hkv, Smax, D], or
    [B, Hkv, D, Smax] when v_transposed; q_pos: [B] int absolute position
    of the first query token. Returns [B, Hq, Sq, D] in q.dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Smax = k.shape[1], k.shape[2]
    if Hq != Hkv:
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = _f32_product(q, k.transpose(-1, -2)) * (1.0 / D**0.5)
    kpos = torch.arange(Smax, device=q.device)[None, None, :]
    qabs = q_pos.to(q.device)[:, None, None] + torch.arange(Sq, device=q.device)[None, :, None]
    valid = kpos <= qabs  # [B, Sq, Smax]
    # in place: a graph's pool holds one [B, H, Sq, Smax] f32 matrix less
    scores.masked_fill_(~valid[:, None], mask_value)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    vt = v.transpose(-1, -2) if v_transposed else v
    return _f32_product(probs, vt).to(q.dtype)


def attend_cache(q, kc, vc, ksc, vsc, q_pos):
    """Attention of a query block against the (possibly int8) cache.

    kc [B, Hkv, Smax, D], vc [B, Hkv, D, Smax] (current tokens already
    written); ksc/vsc: int8-mode scales [B, Hkv, Smax], else None. int8
    codes are scaled in f32 (k = kc*ksc, v = vc*vsc), then cast to
    q.dtype, as the JAX package does."""
    if ksc is not None:
        k = (kc.float() * ksc[..., None]).to(q.dtype)
        v = (vc.float() * vsc[:, :, None, :]).to(q.dtype)
    else:
        k, v = kc.to(q.dtype), vc.to(q.dtype)
    return attend(q, k, v, q_pos, v_transposed=True)


def flash_prefill_shape_ok(S: int, D: int) -> bool:
    """JAX's shape gate of the flash-prefill route, word for word: S >=
    1024 (below it JAX measured its windowed path faster on the TPU), S %
    128 == 0 (the TPU kernel's block) and D % 128 == 0 (lane alignment)."""
    return S >= 1024 and S % 128 == 0 and D % 128 == 0


def flash_prefill_supported(S: int, D: int) -> bool:
    """The port's gate of the reset-prefill flash branch: the shape gate on
    every device (the kernel's plain version runs on the CPU)."""
    return flash_prefill_shape_ok(S, D)


def flash_prefill_plain(q, k, v):
    """What the TPU kernel computes, at its rounding points: s = q . k with
    f32 accumulation times 1/sqrt(D) in f32; the causal mask (col <= row)
    added as JAX's mask value; m, p = exp(s - m) and l = sum p in f32; p
    rounded to v's dtype before p . v, which accumulates in f32; the
    output acc / l cast once to q's dtype. q [B, Hq, S, D], k and v [B,
    Hkv, S, D]; query head h reads kv-head h // (Hq / Hkv) (grouped, not
    repeated)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    qf = q.float().reshape(B, Hkv, rep, S, D)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2)) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    s = s + torch.where(pos[None, :] <= pos[:, None], 0.0, FLASH_MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float()[:, :, None])
    return (acc / l).reshape(B, Hq, S, D).to(q.dtype)


def _check_flash_args(q, k, v):
    B, Hq, S, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D) \
            or Hq % k.shape[1]:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B, Hq, S, D] and [B, Hkv, S, D], Hkv | Hq")
    if D not in FLASH_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_prefill: the CUDA kernel takes head_dim in {FLASH_HEAD_DIMS}, got {D}")
    if q.dtype not in FLASH_TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash_prefill: q, k and v must share one of {[str(t) for t in FLASH_TYPES]}, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if S % FLASH_ROWS:
        raise NotImplementedError(
            f"flash_prefill: the CUDA kernel takes S a multiple of {FLASH_ROWS}, got {S}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("flash_prefill: tensors on different devices")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (st * t.element_size()) % 16 for st in t.stride()[:3]):
            raise ValueError("flash_prefill: each tensor needs a contiguous last dimension, "
                             "16-byte aligned rows and base")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_prefill(q, k, v):
    """Causal self-attention of a block over its own K/V (a reset
    prefill: every row starts at position 0). q [B, Hq, S, D], k and v
    [B, Hkv, S, D], in one dtype, any strides with a contiguous last
    dimension (the forward passes its [B, S, H, D] projections
    transposed). Returns [B, Hq, S, D] in q's dtype, a view of a [B, S,
    Hq, D] buffer on the card. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v)
    _check_flash_args(q, k, v)
    B, Hq, S, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = load_kernel("flash_prefill", _FLASH_ARGS)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    err = lib.mlc_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, k.shape[1], S, D,
        FLASH_TYPES[q.dtype], *strides, _stream(q))
    check_launch(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
