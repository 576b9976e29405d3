"""What the plain references of every architecture share: f32 products
with TF32 off, the lower precisions of the controls, the norms, rotary and
causal attention. Each architecture's own reference (``arch/<name>.py``,
its ``Reference``) wires these into its block; none imports a module of
the program, and each works the weights' int4 quantization out again
(``reference.quant``) from the benchmark's draws.

``precision="fp8"`` is the control: the reference computed in float8 e4m3
where the program computes in its 16-bit type. Every tensor the program
holds in that type is rounded to e4m3 (one absmax scale per row, to 448):
the embedded tokens, each norm's output, q, k and v (the cache), the
attention probabilities and output, each product's input, weight and
output, the activation's output and the residual stream after every
layer. Products accumulate and softmax and norms reduce in f32, as the
program's kernels do, and the logits stay f32 as the program's do.
``precision="bf16"`` rounds the same tensors to bfloat16 instead (no
scale): the 16-bit sibling of an f16 configuration, read beside the
control by calibrate.py to show how far the comparison resolves.
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0
PRECISIONS = ("f32", "fp8", "bf16")


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for matmuls and cuDNN, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale along `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def layer_norm(x, w, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def rms_norm(x, w, eps):
    return x / torch.sqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rotary(x: torch.Tensor, rd: int, base: float, style: str) -> torch.Tensor:
    """Rotary position embedding on the first rd channels of x [S, H, D],
    position p at row p."""
    S = x.shape[0]
    inv = 1.0 / (base ** (torch.arange(0, rd, 2, dtype=torch.float64) / rd))
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).float().to(x.device)[:, None, :]
    sin = torch.sin(ang).float().to(x.device)[:, None, :]
    r, rest = x[..., :rd], x[..., rd:]
    if style == "neox":
        a, b = r[..., : rd // 2], r[..., rd // 2:]
        out = torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)
    elif style == "gptj":
        a, b = r[..., 0::2], r[..., 1::2]
        out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).flatten(-2)
    else:
        raise ValueError(f"unknown rotary style {style!r}")
    return torch.cat([out, rest], dim=-1)


class Plain:
    """A plain reference's precision: how it holds a tensor between
    operations and how it multiplies. An architecture's Reference derives
    from it and gives ``logits(segments, wanted)``."""

    def __init__(self, model: dict, deployment: dict, seed: int, device,
                 precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.m = model
        self.dep = deployment
        self.seed = seed
        self.device = torch.device(device)
        self.precision = precision
        self.act = deployment["compute_dtype"]
        self.head_dtype = "float32" if model.get("fp32_lm_head") else self.act

    def _lo(self, x, dim: int = -1):
        """x as the computation holds it between operations."""
        if self.precision == "fp8":
            return _fp8(x, dim)
        if self.precision == "bf16":
            return x.to(torch.bfloat16).float()
        return x

    def _mm(self, x, w, head: bool = False):
        """x @ w; a lower precision rounds the inputs and (not the lm
        head's f32 logits) the output."""
        if self.precision == "f32":
            return x @ w
        y = self._lo(x) @ self._lo(w, 0)
        return y if head else self._lo(y)

    def _causal(self, q, k, v, d: int) -> torch.Tensor:
        """softmax(q k^T / sqrt(d)) v over causal positions, q [nh, S, .]
        and k, v [nkv, S, .] as the cache holds them; k and v serve
        nh / nkv query heads each. Returns [S, nh * dv]."""
        nh, S = q.shape[0], q.shape[1]
        if k.shape[0] != nh:
            k = k.repeat_interleave(nh // k.shape[0], dim=0)
            v = v.repeat_interleave(nh // v.shape[0], dim=0)
        s = (q @ k.transpose(1, 2)) / math.sqrt(d)
        mask = torch.ones((S, S), dtype=torch.bool, device=s.device).triu(1)
        p = self._lo(torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1))
        return self._lo((p @ v).transpose(0, 1).reshape(S, nh * v.shape[-1]))
