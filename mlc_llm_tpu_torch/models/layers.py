"""Functional layers shared by all families (``mlc_llm_tpu/models/layers.py``).

The norms live in ``ops/norm.py``, beside the kernel that fuses them
with the residual sum. Rotary is applied in f32 from precomputed cos/sin
tables, results return in the input dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def make_rotary_tables(head_dim: int, rotary_pct: float, base: float,
                       max_seq_len: int, style: str, device="cpu"):
    """cos/sin tables [max_seq_len, rotary_dim] (f32), built in NumPy as
    the JAX package builds them. neox: concat(freq, freq); gptj:
    repeat(freq, 2)."""
    rotary_dim = int(head_dim * rotary_pct)
    inv_freq = 1.0 / (base ** (np.arange(0, rotary_dim, 2, dtype=np.float32) / rotary_dim))
    t = np.arange(max_seq_len, dtype=np.float32)
    freq = np.einsum("i,j->ij", t, inv_freq)
    if style == "neox":
        emb = np.concatenate([freq, freq], axis=-1)
    elif style == "gptj":
        emb = np.repeat(freq, 2, axis=-1)
    else:
        raise ValueError(f"unknown rotary style {style!r}")
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def apply_rotary(x, cos, sin, positions, style: str):
    """Rotary embedding on the leading rotary_dim of each head.
    x: [B, S, H, D]; positions: [B, S] absolute positions."""
    rotary_dim = cos.shape[-1]
    xr = x[..., :rotary_dim].float()
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    if style == "neox":
        half = rotary_dim // 2
        swz = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    else:  # gptj: pairs (even, odd) -> (-odd, even)
        pairs = xr.reshape(*xr.shape[:-1], rotary_dim // 2, 2)
        swz = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xr.shape)
    rotated = (xr * c + swz * s).to(x.dtype)
    if rotary_dim == x.shape[-1]:
        return rotated
    return torch.cat([rotated, x[..., rotary_dim:]], dim=-1)


def activate(x, act: str):
    if act == "gelu":
        return torch.nn.functional.gelu(x)
    if act == "gelu_new":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "silu":
        return torch.nn.functional.silu(x)
    if act == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {act!r}")
