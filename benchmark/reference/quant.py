"""Group-wise int4 weight quantization, worked out from the float weights.

Asymmetric, 4 bits, groups of 32 along k (the reduction axis): a group's
scale is (max - min) / 15 and its minimum is min, both stored in the scale
type (a multiply by the f32 reciprocal of 15, rounded once); a weight's
code is round((w - min) / scale), ties to even, clipped to 0..15. The
weight the products use is code * scale + min, here exact in f32.
"""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def int4_asym(w: torch.Tensor, scale_dtype: str, group: int = 32) -> torch.Tensor:
    """The f32 weight [k, n] that int4 group quantization of w gives."""
    k, n = w.shape
    kp = -(-k // group) * group
    w = w.float()
    if kp != k:
        w = torch.nn.functional.pad(w, (0, 0, 0, kp - k))
    wg = w.reshape(kp // group, group, n)
    lo, hi = wg.amin(dim=1), wg.amax(dim=1)
    inv15 = torch.tensor(1.0 / 15.0, dtype=torch.float32, device=w.device)
    dt = _DTYPES[scale_dtype]
    scale = ((hi - lo) * inv15).to(dt).float()
    zero = lo.to(dt).float()
    codes = torch.round((wg - zero[:, None]) / scale.clamp(min=1e-10)[:, None]).clamp(0, 15)
    return (codes * scale[:, None] + zero[:, None]).reshape(kp, n)[:k]
