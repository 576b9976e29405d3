"""Turn the JAX package's parameters, as NumPy arrays, into the port's.

``params_from_jax(tree)`` takes the JAX parameter tree after
``jax.tree.map(np.asarray, params)``: nested dicts whose leaves are
NumPy arrays or quantized-tensor objects (``data``, ``scale``, ``zero``,
``spec``, ``shape``) holding NumPy arrays. It imports neither jax nor
the JAX package: the leaves are read by duck typing.

- u32 words become an int32 view and u16 words an int16 view (the same
  bits); int8 planes pass through; ml_dtypes ``uint4`` planes (one code a
  byte on the host) become uint8 planes of the same bytes.
- bf16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
  refuses: it is viewed as int16, then as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..quant.groupwise import QuantizedTensor
from ..quant.spec import QuantSpec


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy())
    if a.dtype.name == "uint4":
        return torch.from_numpy(a.view(np.uint8).copy())
    return torch.from_numpy(a.copy())


def _spec(s) -> QuantSpec:
    return QuantSpec(mode=s.mode, group_size=s.group_size, sym=s.sym, storage=s.storage,
                     dtype=s.dtype, layout=s.layout)


def params_from_jax(tree):
    """JAX param tree of NumPy leaves -> the port's param tree (CPU)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if hasattr(tree, "spec") and hasattr(tree, "data"):
        return QuantizedTensor(
            data=tensor_from_numpy(tree.data), scale=tensor_from_numpy(tree.scale),
            zero=None if tree.zero is None else tensor_from_numpy(tree.zero),
            spec=_spec(tree.spec), shape=tuple(tree.shape))
    return tensor_from_numpy(tree)
