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
  int16), u4 planes ``"uint4"`` (one code a byte, which the port holds as
  uint8) and bf16 is ``"bfloat16"``. Reading needs no ``ml_dtypes``: a
  leaf's bytes land in a tensor of its torch dtype as they are.

Every leaf is read through the port's multithreaded native reader
(``native.load_files_parallel``, ``csrc/host/ckpt_loader.cc``), as the JAX
package reads through its own (``READ_THREADS`` threads). On the CPU the
threads read straight into the leaves' tensors. On the card they fill a ring of two pinned staging
buffers (``STAGE_BYTES`` each): while the copies of one buffer run to
the card (``non_blocking``), the threads fill the other. A leaf larger
than a buffer crosses several; the reads are split into pieces of
``PIECE_BYTES``, so the threads share a large leaf. The native library
must build: nothing reads through Python instead. Checkpoints hold the
params as built: group padding (``pad_quantized_groups``, done at engine
init) is refused on save.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Dict, Optional, Tuple

import torch

from .. import native
from ..ops import resolve_device
from ..quant.groupwise import QuantizedTensor
from ..quant.spec import QuantSpec

MANIFEST = "manifest.json"
FORMAT = "mlc-llm-tpu-params-v1"
# the reader's threads, one read's bytes and each of the two pinned staging
# buffers' bytes (card loads): on an H100 machine (8 cores; PERF.md §6)
# the warm 4.26 GB Vicuna-7B load ran 5.7-7.9 GB/s with 4 threads and 64 MB
# buffers against 4.9-6.2 with 8 threads or 256 MB; the copies to the card
# ran at ~50 GB/s, so the reads from the page cache bound it
READ_THREADS = 4
PIECE_BYTES = 16 << 20
STAGE_BYTES = 64 << 20

# manifest dtype string -> the torch dtype whose bytes the leaf file holds
# (packed u32/u16 words as int32/int16, the same bits; uint4 codes one a
# byte, as uint8)
_READ = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
         "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
         "uint32": torch.int32, "uint16": torch.int16, "uint4": torch.uint8}
_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32",
          torch.int8: "int8", torch.int32: "int32", torch.int16: "int16"}
_WORDS = {"u32": "uint32", "u16": "uint16", "u4": "uint4"}


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


def _alloc_leaf(path: str, dtype: str, shape, device: torch.device) -> torch.Tensor:
    """The empty tensor a leaf file fills, after checking its dtype and that
    the file holds exactly its bytes."""
    if dtype not in _READ:
        raise ValueError(f"{path}: unsupported leaf dtype {dtype!r}")
    t = torch.empty(tuple(shape), dtype=_READ[dtype], device=device)
    want = t.numel() * t.element_size()
    have = os.path.getsize(path)
    if have != want:
        raise ValueError(f"{path}: {have} bytes, manifest says shape {list(shape)} {dtype} "
                         f"({want} bytes)")
    return t


def _read(jobs) -> None:
    """Read each job (path, file offset, destination: a contiguous CPU
    uint8 tensor) with the native reader's threads, in pieces of
    PIECE_BYTES so that they share a large leaf."""
    paths, offsets, bufs = [], [], []
    for path, off, dst in jobs:
        for o in range(0, dst.numel(), PIECE_BYTES):
            paths.append(path)
            offsets.append(off + o)
            bufs.append(dst[o:o + PIECE_BYTES])
    native.load_files_parallel(paths, bufs, READ_THREADS, offsets)


def _stage_chunks(leaves, size: int):
    """The staging buffer's fills for leaves [(path, flat uint8 tensor)]:
    lists of (path, offset, bytes, flat), each list at most `size` bytes
    and every list but the last exactly `size`; together they cover the
    leaves' bytes once, in order."""
    chunks, chunk, fill = [], [], 0
    for path, flat in leaves:
        off = 0
        while off < flat.numel():
            n = min(flat.numel() - off, size - fill)
            chunk.append((path, off, n, flat))
            fill += n
            off += n
            if fill == size:
                chunks.append(chunk)
                chunk, fill = [], 0
    return chunks + ([chunk] if chunk else [])


def _fill(buf: torch.Tensor, chunk) -> None:
    """Read one chunk's ranges into buf, back to back."""
    jobs, at = [], 0
    for path, off, n, _ in chunk:
        jobs.append((path, off, buf[at:at + n]))
        at += n
    _read(jobs)


def _read_staged(leaves, device: torch.device) -> None:
    """Fill card leaves [(path, tensor)] through two pinned staging
    buffers: the threads fill one buffer with the next STAGE_BYTES of the
    leaves' bytes (in order) while the other's copies run to the card."""
    flats = [(path, t.view(-1).view(torch.uint8)) for path, t in leaves]
    total = sum(flat.numel() for _, flat in flats)
    if not total:
        return
    size = min(STAGE_BYTES, total)
    ring = [torch.empty(size, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    done = [None, None]  # the event after each buffer's last copies
    stream = torch.cuda.current_stream(device)
    for i, chunk in enumerate(_stage_chunks(flats, size)):
        buf = ring[i % 2]
        if done[i % 2] is not None:
            done[i % 2].synchronize()
        _fill(buf, chunk)
        at = 0
        for _, off, n, flat in chunk:
            flat[off:off + n].copy_(buf[at:at + n], non_blocking=True)
            at += n
        done[i % 2] = torch.cuda.Event()
        done[i % 2].record(stream)
    for ev in done:
        if ev is not None:
            ev.synchronize()


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
        specs[path] = QuantSpec(**{"layout": "pair", **info["spec"]})

    tree: Dict[str, Any] = {}
    leaves = []
    for key, e in manifest["leaves"].items():
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        path = os.path.join(in_dir, e["file"])
        node[name] = _alloc_leaf(path, e["dtype"], e["shape"], dev)
        leaves.append((path, node[name]))
    if dev.type == "cuda":
        _read_staged(leaves, dev)
    else:
        _read([(path, 0, t.view(-1).view(torch.uint8)) for path, t in leaves])

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
