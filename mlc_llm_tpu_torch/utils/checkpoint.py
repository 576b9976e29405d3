"""Param checkpoint format, the counterpart of ``mlc_llm_tpu/utils/checkpoint.py``.

One raw ``.bin`` file per tree leaf plus ``manifest.json``, which holds
each leaf's file, dtype string and shape, each QuantizedTensor's spec,
logical shape and whether it has minima, and the model info (``meta``).
The format is the JAX package's in both directions:

- leaf keys are the '/'-joined tree path (a QuantizedTensor's fields are
  ``<path>/data``, ``/scale``, ``/zero``) and files the key with '.' for
  '/' (``layers/wqkv/data`` -> ``layers.wqkv.data.bin``);
- dtype strings are NumPy's names as JAX writes them: packed words are
  ``"uint32"`` / ``"uint16"`` (the port holds the same bits as int32 /
  int16) and bf16 is ``"bfloat16"``. Reading needs no ``ml_dtypes``: bf16
  bytes are read as int16 and viewed as ``torch.bfloat16``.

Each leaf is read from disk once into one host buffer and moved to the
requested device. Checkpoints hold the params as built: group padding
(``pad_quantized_groups``, done at engine init) is refused on save. The
JAX package's multithreaded native reader is not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import resolve_device
from ..quant.groupwise import QuantizedTensor, _check_ported
from ..quant.spec import QuantSpec

MANIFEST = "manifest.json"
FORMAT = "mlc-llm-tpu-params-v1"

# manifest dtype string -> (NumPy dtype to read the raw bytes as, torch
# dtype the leaf is viewed as)
_READ = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float16": (np.float16, torch.float16),
    "float32": (np.float32, torch.float32),
    "int8": (np.int8, torch.int8),
    "int16": (np.int16, torch.int16),
    "int32": (np.int32, torch.int32),
    "uint32": (np.int32, torch.int32),
    "uint16": (np.int16, torch.int16),
}
_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32",
          torch.int8: "int8", torch.int32: "int32", torch.int16: "int16"}
_WORDS = {"u32": "uint32", "u16": "uint16"}


def _flatten(tree, prefix: str, leaves: list, quantized: dict) -> None:
    """Append (key, tensor, dtype string) of every leaf to `leaves` in the
    JAX package's flatten order (dict keys sorted; a QuantizedTensor's
    data, scale, zero), and each QuantizedTensor's manifest entry to
    `quantized`."""
    for k in sorted(tree):
        node, key = tree[k], f"{prefix}{k}"
        if isinstance(node, dict):
            _flatten(node, key + "/", leaves, quantized)
        elif isinstance(node, QuantizedTensor):
            k_, g = node.shape[0], node.spec.group_size
            if node.n_groups != -(-k_ // g):
                raise ValueError(
                    f"{key}: {node.n_groups} groups for k = {k_} (group {g}): "
                    "group-padded params (engine init pads them) must not be saved")
            quantized[key] = {"spec": dataclasses.asdict(node.spec), "shape": list(node.shape),
                              "has_zero": node.zero is not None}
            words = _WORDS.get(node.spec.storage)
            leaves.append((key + "/data", node.data, words or _NAMES[node.data.dtype]))
            leaves += [(f"{key}/{f}", t, _NAMES[t.dtype])
                       for f, t in (("scale", node.scale), ("zero", node.zero)) if t is not None]
        else:
            leaves.append((key, node, _NAMES[node.dtype]))


def save_params(params, out_dir: str, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write `params` (a nested dict of tensors and QuantizedTensors, on
    any device) as a checkpoint directory the JAX package loads too."""
    leaves, qt_meta = [], {}
    _flatten(params, "", leaves, qt_meta)
    os.makedirs(out_dir, exist_ok=True)
    entries = {}
    total = 0
    for key, t, dtype in leaves:
        fname = key.replace("/", ".") + ".bin"
        host = t.detach().contiguous().cpu()
        with open(os.path.join(out_dir, fname), "wb") as f:
            host.reshape(-1).view(torch.uint8).numpy().tofile(f)
        entries[key] = {"file": fname, "dtype": dtype, "shape": list(t.shape)}
        total += t.numel() * t.element_size()
    manifest = {
        "format": FORMAT,
        "total_bytes": total,
        "leaves": entries,
        "quantized": qt_meta,
        "meta": meta or {},
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def _read_leaf(path: str, dtype: str, shape, device: torch.device) -> torch.Tensor:
    if dtype not in _READ:
        raise ValueError(f"{path}: unsupported leaf dtype {dtype!r}")
    np_dtype, t_dtype = _READ[dtype]
    host = torch.from_numpy(np.fromfile(path, dtype=np_dtype)).view(t_dtype)
    if host.numel() != int(np.prod(shape)):
        raise ValueError(f"{path}: {host.numel()} elements, manifest says shape {shape}")
    return host.reshape(shape).to(device)


def load_params(in_dir: str, device="cuda") -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint onto `device` (``"cuda"`` raises without a GPU).
    Returns (params, meta)."""
    dev = resolve_device(device)
    with open(os.path.join(in_dir, MANIFEST)) as f:
        manifest = json.load(f)
    specs = {}
    for path, info in manifest["quantized"].items():
        # manifests written before the layout field existed hold pair-packed
        # data (the JAX loader defaults it the same way)
        spec = QuantSpec(**{"layout": "pair", **info["spec"]})
        _check_ported(spec)
        specs[path] = spec

    tree: Dict[str, Any] = {}
    for key, e in manifest["leaves"].items():
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = _read_leaf(os.path.join(in_dir, e["file"]), e["dtype"], e["shape"], dev)

    for path, spec in specs.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node[p]
        sub = node[name]
        node[name] = QuantizedTensor(data=sub["data"], scale=sub["scale"], zero=sub.get("zero"),
                                     spec=spec,
                                     shape=tuple(manifest["quantized"][path]["shape"]))
    return tree, manifest.get("meta", {})


def load_model_params(in_dir: str, model: str, device="cuda"):
    """The CLI's and the tools' ``--weights DIR``: load_params, with a
    clear exit when DIR holds no checkpoint and a warning on stderr when it
    was built for another model than `model`."""
    if not os.path.isfile(os.path.join(in_dir, MANIFEST)):
        raise SystemExit(f"no checkpoint in {in_dir!r} ({MANIFEST} missing); build one with "
                         "`python -m mlc_llm_tpu_torch.build`")
    params, meta = load_params(in_dir, device=device)
    if meta.get("model") and meta["model"] != model:
        print(f"warning: checkpoint was built for {meta['model']}, requested {model}",
              file=sys.stderr)
    return params, meta
