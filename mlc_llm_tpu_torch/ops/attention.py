"""Attention against the slot KV cache, in plain PyTorch.

The counterpart of ``mlc_llm_tpu/ops/attention.py`` ``attend`` and
``attend_cache``: QK^T/sqrt(d) and PV with f32 products and f32 softmax,
causal mask over history plus the current block, V kept D-major.

Prefill attention goes through ``attend`` too, which is what the JAX
package does on every backend but the TPU (its ``flash_prefill`` calls
JAX's library kernel); a hand-written causal flash-prefill kernel is
later work (ROADMAP.md queue 2).
"""

from __future__ import annotations

import torch


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
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / D**0.5)
    kpos = torch.arange(Smax, device=q.device)[None, None, :]
    qabs = q_pos.to(q.device)[:, None, None] + torch.arange(Sq, device=q.device)[None, :, None]
    valid = kpos <= qabs  # [B, Sq, Smax]
    scores = torch.where(valid[:, None], scores, torch.full_like(scores, mask_value))
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    vt = v.float().transpose(-1, -2) if v_transposed else v.float()
    return torch.matmul(probs, vt).to(q.dtype)


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
