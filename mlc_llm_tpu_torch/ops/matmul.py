"""Quantized matmul: y = x @ W (+ bias), W dense or group-quantized.

Routing follows ``mlc_llm_tpu/ops/matmul.py`` and the Pallas dispatch
(``mlc_llm_tpu/ops/pallas/dequant_matmul.py:1788-1876``) through
``dequant_matmul.route`` (format x m -> kernel; the table is in that
module's doc):

- int4 in u32 words, any order and compute dtype: ``gemv_qs`` (qsplit)
  or ``gemv_gp`` (pair, hsplit) at m <= 8, ``gemm_qs`` or ``gemm_pairs``
  up to m = 2048;
- q3bf16_s16 (int3, u16, group 40): ``gemv_gp3`` at m <= 2 (G % 16 ==
  0), ``gemm_plane`` above;
- q3bf16 (int3, u32), fp4bf16, q8bf16: ``gemm_plane`` at every m up to
  2048;
- above m = 2048, or a split layout the kernels cannot block: dequantize
  once and multiply, as the reference leaves that case to XLA.

Every kernel route runs the kernel on CUDA tensors and its plain version
on CPU tensors; no int4 order raises.
"""

from __future__ import annotations

import torch

from ..quant.groupwise import QuantizedTensor
from .dequant_matmul import dequant_matmul


def qmatmul(x, w, bias=None, out_dtype=None):
    """x: [..., k]; w: [k, n] (dense tensor or QuantizedTensor); -> [..., n]."""
    if isinstance(w, QuantizedTensor):
        y = dequant_matmul(x, w, out_dtype=out_dtype)
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
        y = dequant_matmul(x, w, out_dtype=out_dtype, layer=int(layer))
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y
    return qmatmul(x, w[layer], bias=bias, out_dtype=out_dtype)
