"""The plain reference: the GPT-NeoX and the MOSS (GPT-J-style) decoder in
f32, layer by layer, with no kernel, cache or batching of the program.

It follows the published blocks. GPT-NeoX (``use_parallel_residual``):
h + attn(LN1(h)) + mlp(LN2(h)), exact GELU, rotary "rotate half" on the
first ``rotary_pct`` of each head, biases on every product, the lm head
without bias. MOSS / GPT-J: one LayerNorm feeding both branches, h +
attn(LN(h)) + mlp(LN(h)), tanh GELU, rotary on interleaved pairs of the
first ``rotary_dim`` channels, no attention biases, an lm head with bias.
Attention is causal softmax(q k^T / sqrt(D)) v. The weights' columns are
laid out as the benchmark draws them: wqkv's output is [q | k | v], each
head-major.

The weights come from the benchmark's draws (``harness.weights``), and
their int4 quantization is worked out here again (``reference.quant``),
so the reference takes nothing the program made. It imports no module of
the program.

``precision="fp8"`` is the control: the reference computed in float8 e4m3
where the program computes in its 16-bit type. Every tensor the program
holds in that type is rounded to e4m3 (one absmax scale per row, to 448):
the embedded tokens, each norm's output, q, k and v (the cache), the
attention probabilities and output, each product's input, weight and
output, the GELU's output and the residual stream after every layer.
Products accumulate and softmax and norms reduce in f32, as the
program's kernels do, and the logits stay f32 as the program's do.
``precision="bf16"`` rounds the same tensors to bfloat16 instead (no
scale): the 16-bit sibling of an f16 configuration, read beside the
control by calibrate.py to show how far the comparison resolves.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

from harness import weights
from reference.quant import int4_asym

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


def gelu(x, kind: str):
    if kind == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if kind == "gelu_new":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    raise ValueError(f"the reference has no activation {kind!r}")


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


class Reference:
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

    def _attention(self, qkv: torch.Tensor) -> torch.Tensor:
        m = self.m
        S = qkv.shape[0]
        nh, nkv = m["num_heads"], m["num_kv_heads"]
        d = m["hidden_size"] // nh
        q, k, v = qkv.split([nh * d, nkv * d, nkv * d], dim=-1)
        rd = int(d * m.get("rotary_pct", 1.0))
        base = m.get("rotary_base", 10000.0)
        q = self._lo(rotary(q.reshape(S, nh, d), rd, base, m["rotary_style"])).transpose(0, 1)
        k = self._lo(rotary(k.reshape(S, nkv, d), rd, base, m["rotary_style"])).transpose(0, 1)
        v = self._lo(v.reshape(S, nkv, d)).transpose(0, 1)
        if nkv != nh:
            k = k.repeat_interleave(nh // nkv, dim=0)
            v = v.repeat_interleave(nh // nkv, dim=0)
        s = (q @ k.transpose(1, 2)) / math.sqrt(d)
        mask = torch.ones((S, S), dtype=torch.bool, device=s.device).triu(1)
        p = self._lo(torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1))
        return self._lo((p @ v).transpose(0, 1).reshape(S, nh * d))

    def _layer(self, h, W: Dict[str, torch.Tensor], sm: Dict[str, torch.Tensor]):
        m = self.m
        eps = m.get("norm_eps", 1e-5)
        lo = self._lo
        x1 = lo(layer_norm(h, sm["ln1_w"], sm["ln1_b"], eps))
        qkv = self._mm(x1, W["wqkv"])
        if "bqkv" in sm:
            qkv = lo(qkv + sm["bqkv"])
        attn = self._mm(self._attention(qkv), W["wo"])
        if "bo" in sm:
            attn = lo(attn + sm["bo"])

        def mlp(x):
            y = self._mm(x, W["w_in"])
            if "b_in" in sm:
                y = lo(y + sm["b_in"])
            y = self._mm(lo(gelu(y, m["act"])), W["w_out"])
            return lo(y + sm["b_out"]) if "b_out" in sm else y

        if m.get("single_norm"):
            return lo(h + attn + mlp(x1))
        if m.get("parallel_residual"):
            return lo(h + attn + mlp(lo(layer_norm(h, sm["ln2_w"], sm["ln2_b"], eps))))
        h = lo(h + attn)
        return lo(h + mlp(lo(layer_norm(h, sm["ln2_w"], sm["ln2_b"], eps))))

    @torch.no_grad()
    def logits(self, segments: Sequence[Sequence[int]],
               wanted: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """f32 logits [len(wanted[i]), V] at positions wanted[i] of each
        token segment (a segment starts at position 0)."""
        m, dev, seed = self.m, self.device, self.seed
        with exact_f32():
            emb = int4_asym(weights.embedding(m, seed, dev).T, self.act)  # [H, V]
            toks = [torch.as_tensor(list(s), dtype=torch.long, device=dev) for s in segments]
            hs = [self._lo(emb[:, t].T.contiguous()) for t in toks]
            del emb
            small = weights.small_leaves(m, seed, dev)
            for layer in range(m["num_layers"]):
                W = {leaf: int4_asym(weights.layer_matrix(m, seed, leaf, layer, dev), self.act)
                     for leaf in weights.BIG}
                sm = {k: v[layer] for k, v in small.items() if v.dim() == 2}
                hs = [self._layer(h, W, sm) for h in hs]
                del W
            head = int4_asym(weights.lm_head(m, seed, dev), self.head_dtype)
            eps = m.get("norm_eps", 1e-5)
            out = []
            for h, want in zip(hs, wanted):
                x = self._lo(layer_norm(
                    h[torch.as_tensor(list(want), dtype=torch.long, device=dev)],
                    small["final_ln_w"], small["final_ln_b"], eps))
                y = self._mm(x, head, head=True)
                if "lm_head_b" in small:
                    y = y + small["lm_head_b"]
                out.append(y)
            return out
