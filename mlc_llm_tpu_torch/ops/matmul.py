"""Quantized matmul: y = x @ W (+ bias), W dense or group-quantized.

Routing follows ``mlc_llm_tpu/ops/matmul.py`` and the Pallas dispatch
(``mlc_llm_tpu/ops/pallas/dequant_matmul.py:1788-1876``) through
``dequant_matmul.route`` (format x m -> kernel; the table is in that
module's doc):

- q4bf16 (int4, u32, qsplit): ``gemv_qs`` at m <= 8, ``gemm_qs`` up to
  m = 2048;
- q3bf16_s16 (int3, u16, group 40): ``gemv_gp3`` at m <= 2 (G % 16 ==
  0), ``gemm_plane`` above;
- q3bf16 (int3, u32), fp4bf16, q8bf16: ``gemm_plane`` at every m up to
  2048;
- above m = 2048, or a split layout the kernels cannot block: dequantize
  once and multiply, as the reference leaves that case to XLA.

Every kernel route runs the kernel on CUDA tensors and its plain version
on CPU tensors. The int4 hsplit and pair orders have no CUDA kernel yet:
they run the dequantize-then-matmul path on CPU tensors and raise on
CUDA tensors (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant.groupwise import QuantizedTensor
from .dequant_matmul import dense_matmul, dequant_matmul, route

_NOT_PORTED = ("gemv_gp", "gemm_pairs")


def _quant_matmul(x, w: QuantizedTensor, out_dtype, layer: Optional[int]):
    m = x.numel() // x.shape[-1]
    kind = route(w.spec, w.n_groups, m)
    if kind == "dense" or (kind in _NOT_PORTED and x.device.type == "cpu"):
        return dense_matmul(x, w, out_dtype, layer)
    # CUDA tensors of an int4 body without a kernel raise in here
    return dequant_matmul(x, w, out_dtype=out_dtype, layer=layer)


def qmatmul(x, w, bias=None, out_dtype=None):
    """x: [..., k]; w: [k, n] (dense tensor or QuantizedTensor); -> [..., n]."""
    if isinstance(w, QuantizedTensor):
        y = _quant_matmul(x, w, out_dtype, None)
    else:
        y = torch.matmul(x, w.to(x.dtype))
        if out_dtype is not None:
            y = y.to(out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def qmatmul_stacked(x, w, layer: int, bias=None, out_dtype=None):
    """Layer-stacked qmatmul: w holds leaves with a leading layer axis.
    Quantized weights are read in place by the kernels (pointer offset);
    dense weights are indexed as a view."""
    if isinstance(w, QuantizedTensor):
        y = _quant_matmul(x, w, out_dtype, int(layer))
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y
    return qmatmul(x, w[layer], bias=bias, out_dtype=out_dtype)
