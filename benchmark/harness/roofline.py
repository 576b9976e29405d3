"""The yardstick's peaks and the bound of one weight product.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): HBM3 at 3.35 TB/s; 989 TFLOP/s on bf16/f16 tensor
cores; 495 TFLOP/s TF32, the fastest rate at which the chip multiplies
f32 operands. A least time is the larger of operations over the peak rate
and bytes over the peak bandwidth, so a share of it can never pass 1.

Bytes are counted as the work needs them, whatever a kernel reads: a
quantized weight's codes over its logical [k, n], one scale (and one
minimum, asymmetric) per group along k in the scale type, read once;
activations in their dtype, read once; outputs written once. Group and
column padding that the program stores is not work and is not counted,
so removing it shows as a gain. Operations: 2 k n a row of a product.
What a step of a model holds (its products, its attention, its cache) is
counted by its architecture (``arch/<name>.py``, its ``work``).
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def quantized_bytes(k: int, n: int, scale_dtype: str, bits: int, group: int,
                    asym: bool) -> float:
    """Logical stored bytes of a [k, n] weight of `bits`-wide codes in
    groups of `group` along k."""
    groups = -(-k // group)
    per_group = DTYPE_BYTES[scale_dtype] * (2 if asym else 1)
    return k * n * bits / 8 + groups * n * per_group


def product_bound(m: int, k: int, n: int, w_bytes: float, x_dtype: str, out_dtype: str,
                  op_dtype: str) -> Tuple[float, float]:
    """(least seconds by bytes, by operations) of y[m, n] = x[m, k] @ W."""
    nbytes = m * k * DTYPE_BYTES[x_dtype] + w_bytes + m * n * DTYPE_BYTES[out_dtype]
    return nbytes / HBM_BYTES_PER_S, 2.0 * m * k * n / PEAK_FLOPS[op_dtype]


def share(least_s: float, measured_s: float):
    """least / measured, or None when nothing was measured."""
    if measured_s <= 0 or least_s <= 0:
        return None
    return least_s / measured_s
