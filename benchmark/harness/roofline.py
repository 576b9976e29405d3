"""The yardstick's peaks and the work of each step, counted from shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): HBM3 at 3.35 TB/s; 989 TFLOP/s on bf16/f16 tensor
cores; 495 TFLOP/s TF32, the fastest rate at which the chip multiplies
f32 operands. A least time is the larger of operations over the peak rate
and bytes over the peak bandwidth, so a share of it can never pass 1.

Bytes are counted as the work needs them, whatever a kernel reads: a
quantized weight's int4 codes over its logical [k, n], one scale (and one
minimum, asymmetric) per group of 32 along k in the scale type, read
once; activations in their dtype, read once; outputs written once. Group
and column padding that the program stores is not work and is not
counted, so removing it shows as a gain. Operations: 2 k n a row of a
product; attention 4 D a (position, query head) pair (the score and the
PV dots).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the formulas need of a configuration as it is run."""

    hidden: int
    ffn: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    gated: bool            # w_in holds gate and up (2 * ffn columns)
    act_dtype: str         # the layers' compute dtype
    head_dtype: str        # the lm head's activation and scale dtype
    kv_dtype: str          # the KV cache's element type
    bits: int = 4          # weight code width
    group: int = 32        # group length along k
    asym: bool = True      # a minimum beside each scale

    @classmethod
    def of(cls, model: dict, deployment: dict) -> "Shapes":
        d = model["hidden_size"] // model["num_heads"]
        act = deployment["compute_dtype"]
        return cls(hidden=model["hidden_size"], ffn=model["intermediate_size"],
                   layers=model["num_layers"], heads=model["num_heads"],
                   kv_heads=model["num_kv_heads"], head_dim=d, vocab=model["vocab_size"],
                   gated=model.get("act") == "silu_gated", act_dtype=act,
                   head_dtype="float32" if model.get("fp32_lm_head") else act,
                   kv_dtype=deployment["kv_dtype"])


def layer_products(s: Shapes) -> List[Tuple[str, int, int]]:
    """(name, k, n) of one layer's weight products."""
    qkv = (s.heads + 2 * s.kv_heads) * s.head_dim
    return [("wqkv", s.hidden, qkv), ("wo", s.heads * s.head_dim, s.hidden),
            ("w_in", s.hidden, 2 * s.ffn if s.gated else s.ffn), ("w_out", s.ffn, s.hidden)]


def weight_bytes(s: Shapes, k: int, n: int, scale_dtype: str) -> float:
    """Logical stored bytes of a quantized [k, n] weight."""
    groups = -(-k // s.group)
    per_group = DTYPE_BYTES[scale_dtype] * (2 if s.asym else 1)
    return k * n * s.bits / 8 + groups * n * per_group


def layer_weight_bytes(s: Shapes) -> float:
    """One layer's."""
    return sum(weight_bytes(s, k, n, s.act_dtype) for _, k, n in layer_products(s))


def head_weight_bytes(s: Shapes) -> float:
    return weight_bytes(s, s.hidden, s.vocab, s.head_dtype)


def layer_params(s: Shapes) -> int:
    """One layer's."""
    return sum(k * n for _, k, n in layer_products(s))


def product_bound(m: int, k: int, n: int, w_bytes: float, x_dtype: str, out_dtype: str,
                  op_dtype: str) -> Tuple[float, float]:
    """(least seconds by bytes, by operations) of y[m, n] = x[m, k] @ W."""
    nbytes = m * k * DTYPE_BYTES[x_dtype] + w_bytes + m * n * DTYPE_BYTES[out_dtype]
    return nbytes / HBM_BYTES_PER_S, 2.0 * m * k * n / PEAK_FLOPS[op_dtype]


def products_bound_s(s: Shapes, m: int, head_m: int) -> float:
    """Least seconds of one forward's weight products, each bounded alone:
    the L layers' four at m rows and the lm head at head_m rows (0: none)."""
    total = 0.0
    for _, k, n in layer_products(s):
        total += s.layers * max(product_bound(m, k, n, weight_bytes(s, k, n, s.act_dtype),
                                              s.act_dtype, s.act_dtype, s.act_dtype))
    if head_m:
        total += max(product_bound(head_m, s.hidden, s.vocab, head_weight_bytes(s),
                                   s.head_dtype, "float32", s.head_dtype))
    return total


def kv_bytes_per_token(s: Shapes) -> float:
    """K and V of one position over every layer."""
    return 2.0 * s.layers * s.kv_heads * s.head_dim * DTYPE_BYTES[s.kv_dtype]


def step_least_s(s: Shapes, rows: Iterable[Tuple[int, int]], head_rows: int) -> float:
    """Least seconds of one forward that appends rows = [(context, new
    tokens)] (context: positions already cached; new: real tokens this
    forward adds) and runs the lm head on head_rows rows: the larger of its
    operations at the compute type's peak and its bytes at the HBM peak.
    Operations: 2 x the L layers' params a new token, 2 x hidden x vocab a head row,
    and causal attention, 4 D (context + j + 1) a query head of new token j
    in every layer. Bytes: every weight once (head included), the context's
    K/V read once, the new tokens' K/V written once."""
    tokens, attn_pos, ctx = 0, 0, 0
    for c, n in rows:
        tokens += n
        ctx += c
        attn_pos += n * c + n * (n + 1) // 2
    flops = (2.0 * s.layers * layer_params(s) * tokens + 2.0 * s.hidden * s.vocab * head_rows
             + 4.0 * s.head_dim * s.heads * s.layers * attn_pos)
    nbytes = (s.layers * layer_weight_bytes(s) + head_weight_bytes(s)
              + kv_bytes_per_token(s) * (ctx + tokens))
    return max(flops / PEAK_FLOPS[s.act_dtype], nbytes / HBM_BYTES_PER_S)


def share(least_s: float, measured_s: float):
    """least / measured, or None when nothing was measured."""
    if measured_s <= 0 or least_s <= 0:
        return None
    return least_s / measured_s
