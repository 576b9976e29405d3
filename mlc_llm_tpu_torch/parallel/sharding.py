"""Tensor- and data-parallel sharding over a ``torch.distributed`` DeviceMesh.

The counterpart of ``mlc_llm_tpu/parallel/sharding.py``, with the same
Megatron placement and the same rules:

- ``wqkv``, ``w_in`` (and their biases): column-parallel, the output dim
  over "tp";
- ``wo``, ``w_out``: row-parallel, the reduction dim over "tp" (the
  forward all-reduces after them, ``models/transformer.py``);
- the embedding and the lm head: vocab over "tp";
- the KV cache: heads (slot) or head groups (paged) over "tp", batch rows
  over "dp";
- norms, rotary tables and the row-parallel biases: replicated.

JAX annotates global arrays and GSPMD partitions the program. Here each
rank holds only its own shards and runs the same forward on them, so
``shard_params`` returns the rank-local tree and the shards are cut by
the LOGICAL shape, not the stored one: ``wqkv`` per block ``[q | k | v]``
by heads (each rank holds ``[q_r | k_r | v_r]``), ``w_in`` per block
``[gate | up]`` (``[gate_r | up_r]``, which the forward's ``chunk(2)``
splits unchanged), ``wo`` and ``w_out`` by logical k in whole groups, the
vocab by logical columns; each shard is then padded again with
``pad_cols`` (the engine pads its groups, ``pad_quantized_groups``). A
contiguous split of the stored columns would put padded columns, or
another block's, on the wrong rank. Split layouts (hsplit, qsplit) map
elements by the total k, so every quantized leaf is first repacked to the
pair order (``_repack_hsplit_for_sharding``, exact), as JAX does; each
rank then calls the same kernel route on its shard as on an unsharded
weight of that shape.

``param_specs`` is JAX's ``param_shardings`` as a tree of per-dimension
axis names (a QuantizedTensor becomes ``{"data", "scale"[, "zero"]}``),
with JAX's fallback: a dimension that the axis does not divide (stored
shape) is replicated. It decides whether the embedding and the lm head
are vocab-parallel (a replicated one needs no collective). A layer weight
whose logical dimension does not split into whole heads or whole groups
raises ``ValueError`` naming the leaf: JAX shards the data of such a leaf
and replicates its scales, a mix with no rank-local form.

The mesh is passed explicitly (``shard_params``, the forward, the engine);
there is no module state. ``make_mesh`` needs the default process group
(``parallel.multihost.initialize``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.paged_cache import PagedKVCache
from ..models.transformer import KVCache
from ..quant.groupwise import QuantizedTensor, pad_cols, to_pair_layout, words_per_group

# JAX's rules: path pattern -> spec of the [k, n] weight; L-stacked leaves
# get None prepended for the layer axis
_COL = (None, "tp")  # column-parallel: shard n
_ROW = ("tp", None)  # row-parallel: shard k
_WEIGHT_RULES = [
    (r"layers/wqkv", _COL),
    (r"layers/w_in", _COL),
    (r"layers/wo", _ROW),
    (r"layers/w_out", _ROW),
    (r"embed/w", _COL),     # quantized embed stored [H, V]: shard vocab
    (r"lm_head/w", _COL),   # [H, V]: shard vocab
]
_BIAS_RULES = [
    (r"layers/bqkv", ("tp",)),
    (r"layers/b_in", ("tp",)),
    (r"layers/bo", (None,)),
    (r"layers/b_out", (None,)),
    (r"lm_head/b", ("tp",)),
]
_DENSE_EMBED = ("tp", None)  # a dense embedding is [V, H]: shard vocab = dim 0


def make_mesh(tp: Optional[int] = None, dp: int = 1, device_type: str = "cuda"):
    """A ("dp", "tp") DeviceMesh over the default process group's ranks,
    tp varying fastest (rank = dp_index * tp + tp_index). tp defaults to
    world // dp; dp * tp must be the world size."""
    world = dist.get_world_size()
    tp = tp or world // dp
    if dp * tp != world:
        raise ValueError(f"dp ({dp}) * tp ({tp}) != world size ({world})")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh; a mapping of axis sizes is taken
    as it is (plans computed without a process group, as on JAX's
    virtual mesh)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _spec_for(path_s: str, stacked: bool) -> tuple:
    """JAX's _spec_for: the rule's spec, the layer axis prepended."""
    for pat, spec in _WEIGHT_RULES + _BIAS_RULES:
        if re.search(pat, path_s):
            if path_s == "embed/w":
                spec = _DENSE_EMBED
            return ((None,) + spec) if stacked else spec
    return ()


def _leaf_spec(path_s: str, t: torch.Tensor, sizes: Dict[str, int]) -> tuple:
    stacked = path_s.startswith("layers/") or "/layers/" in path_s
    dims = list(_spec_for(path_s, stacked))[:t.ndim]
    dims += [None] * (t.ndim - len(dims))
    # replicate any axis the mesh does not divide (JAX's fallback)
    return tuple(None if ax is not None and t.shape[i] % sizes[ax] else ax
                 for i, ax in enumerate(dims))


def param_specs(params, mesh):
    """JAX's ``param_shardings(params, mesh)`` specs: the tree of params
    with each tensor replaced by a tuple of axis names (or None) per
    dimension, a QuantizedTensor by {"data", "scale"[, "zero"]}. mesh: a
    DeviceMesh or a mapping of axis sizes."""
    sizes = axis_sizes(mesh)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        path = prefix[:-1]
        if isinstance(node, QuantizedTensor):
            fields = {"data": node.data, "scale": node.scale, "zero": node.zero}
            return {f: _leaf_spec(f"{path}/{f}", t, sizes)
                    for f, t in fields.items() if t is not None}
        return _leaf_spec(path, node, sizes)

    return walk(params, "")


def _repack_hsplit_for_sharding(params):
    """Every split-packed (hsplit/qsplit) leaf in the pair order, exactly:
    the split orders are global in k, so only the pair order keeps a
    contiguous split of k shard-local."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return to_pair_layout(node) if isinstance(node, QuantizedTensor) else node

    return walk(params)


def _col_blocks(x, blocks, rank: int, tp: int):
    """Rank `rank`'s columns of each block of x (blocks: the logical widths
    of consecutive column blocks), concatenated: [..., sum(blocks) / tp]
    logical columns, re-padded with pad_cols for a QuantizedTensor."""
    spans, start = [], 0
    for size in blocks:
        w = size // tp
        spans.append((start + rank * w, w))
        start += size

    def take(t):
        return torch.cat([t[..., a:a + w] for a, w in spans], dim=-1)

    if not isinstance(x, QuantizedTensor):
        return take(x).contiguous()
    n = sum(w for _, w in spans)

    def cut(t):
        return torch.nn.functional.pad(take(t), (0, pad_cols(n) - n)).contiguous()

    return QuantizedTensor(data=cut(x.data), scale=cut(x.scale),
                           zero=None if x.zero is None else cut(x.zero),
                           spec=x.spec, shape=(x.shape[0], n))


def _rows(x, rank: int, tp: int, name: str):
    """Rank `rank`'s contiguous k/tp rows of a row-parallel weight, in
    whole groups for a QuantizedTensor (its logical groups: group padding
    is ignored)."""
    if not isinstance(x, QuantizedTensor):
        k = x.shape[-2]
        kl = k // tp
        return x[..., rank * kl:(rank + 1) * kl, :].contiguous()
    k, g = x.shape[0], x.spec.group_size
    if k % tp or (k // tp) % g:
        raise ValueError(f"{name}: k = {k} does not split into {tp} shards of whole "
                         f"groups of {g}")
    gl = k // tp // g
    rpg = g if x.spec.storage in ("i8", "u4") else words_per_group(x.spec)

    def cut(t, per):
        return t[..., rank * gl * per:(rank + 1) * gl * per, :].contiguous()

    return QuantizedTensor(data=cut(x.data, rpg), scale=cut(x.scale, 1),
                           zero=None if x.zero is None else cut(x.zero, 1),
                           spec=x.spec, shape=(k // tp, x.shape[1]))


def _vocab_sharded(spec, tp: int, vocab: int) -> bool:
    """Is the embedding or lm head leaf vocab-parallel? Where JAX's spec
    shards its vocab dimension and the logical vocab splits evenly."""
    data = spec["data"] if isinstance(spec, dict) else spec
    return "tp" in data and vocab % tp == 0


def local_params(params, cfg: ModelConfig, rank: int, tp: int):
    """Tensor-parallel rank `rank`'s shards of `params` (pair order
    already, see the module doc): layer weights and their biases cut by
    the logical shape, the embedding and lm head by vocab where
    ``param_specs`` shards them, everything else as it is. Raises
    ValueError naming a layer leaf that does not split into whole heads or
    whole groups."""
    specs = param_specs(params, {"tp": tp})
    nh, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F = cfg.intermediate_size
    if nh % tp or nkv % tp:
        raise ValueError(f"layers/wqkv: {nh} query and {nkv} kv heads do not split over "
                         f"tp = {tp}")
    if F % tp:
        raise ValueError(f"layers/w_in: {F} columns do not split over tp = {tp}")
    qkv = [nh * d, nkv * d, nkv * d]
    mlp = [F, F] if cfg.act == "silu_gated" else [F]
    cols = {"wqkv": qkv, "bqkv": qkv, "w_in": mlp, "b_in": mlp}
    out = {}
    for key, node in params.items():
        if key == "layers":
            layers = {}
            for name, leaf in node.items():
                if name in cols:
                    layers[name] = _col_blocks(leaf, cols[name], rank, tp)
                elif name in ("wo", "w_out"):
                    layers[name] = _rows(leaf, rank, tp, f"layers/{name}")
                else:
                    layers[name] = leaf
            out[key] = layers
        elif key in ("embed", "lm_head") and _vocab_sharded(specs[key]["w"], tp,
                                                            cfg.vocab_size):
            V = cfg.vocab_size
            sub = {}
            for name, leaf in node.items():
                if name == "w" and not isinstance(leaf, QuantizedTensor) and key == "embed":
                    sub[name] = leaf[rank * (V // tp):(rank + 1) * (V // tp)].contiguous()
                else:
                    sub[name] = _col_blocks(leaf, [V], rank, tp)
            out[key] = sub
        else:
            out[key] = node
    return out


def shard_params(params, mesh, cfg: ModelConfig):
    """This rank's shards of the full `params` over `mesh`'s "tp"
    dimension (replicated over the others), as the forward and the engine
    take them. Over a mesh with any dimension larger than 1, split-packed
    leaves are repacked to the pair order first (JAX's shard_params does
    the same); at tp = 1 the tree is otherwise returned as it is."""
    sizes = axis_sizes(mesh)
    if any(n > 1 for n in sizes.values()):
        params = _repack_hsplit_for_sharding(params)
    tp = sizes.get("tp", 1)
    if tp == 1:
        return params
    return local_params(params, cfg, mesh.get_local_rank("tp"), tp)


def _rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def _take(t, dims: tuple, mesh, sizes):
    """Rank's block of t along every dimension `dims` names (None: whole)."""
    if t is None:
        return None
    for i, ax in enumerate(dims):
        if ax is not None:
            n = t.shape[i] // sizes[ax]
            t = t.narrow(i, _rank(mesh, ax) * n, n)
    return t.contiguous()


def _fallback(spec: tuple, t, sizes) -> tuple:
    return tuple(None if ax is None or t is None or t.shape[i] % sizes.get(ax, 1) else ax
                 for i, ax in enumerate(spec))


def cache_shardings(mesh, int8: bool = False, shapes: Optional[KVCache] = None):
    """Specs of a slot cache (k/v [L, B, H, ...]: batch over "dp", heads
    over "tp"; lengths over "dp") as {field: spec}; `shapes` (a KVCache)
    applies JAX's replicate-on-indivisible fallback."""
    sizes = axis_sizes(mesh)
    dp = "dp" if "dp" in sizes else None
    kv, sc = (None, dp, "tp", None, None), (None, dp, "tp", None)

    def fb(spec, name):
        return spec if shapes is None else _fallback(spec, getattr(shapes, name), sizes)

    out = {"k": fb(kv, "k"), "v": fb(kv, "v"), "lengths": fb((dp,), "lengths")}
    if int8:
        out.update(k_scale=fb(sc, "k_scale"), v_scale=fb(sc, "v_scale"))
    return out


def shard_cache(cache: KVCache, mesh) -> KVCache:
    """This rank's part of a full slot cache: its Hkv/tp heads and, over
    "dp", its rows. The heads must split over tp (the forward computes
    Hq/tp and Hkv/tp heads)."""
    sizes = axis_sizes(mesh)
    s = cache_shardings(mesh, cache.k_scale is not None, cache)
    if s["k"][2] is None and sizes.get("tp", 1) > 1:
        raise ValueError(f"{cache.k.shape[2]} kv heads do not split over tp = {sizes['tp']}")
    take = lambda t, spec: _take(t, spec, mesh, sizes)  # noqa: E731
    return KVCache(k=take(cache.k, s["k"]), v=take(cache.v, s["v"]),
                   lengths=take(cache.lengths, s["lengths"]).clone(),
                   k_scale=take(cache.k_scale, s.get("k_scale", ())),
                   v_scale=take(cache.v_scale, s.get("v_scale", ())))


def paged_cache_shardings(mesh, cache: PagedKVCache):
    """Specs of a paged cache: pools [G, L, P, ps, hb*D] and int8 scales
    with head groups over "tp", page table and lengths over "dp", as
    {field: spec} (None for an absent field), with JAX's fallback."""
    sizes = axis_sizes(mesh)
    dp = "dp" if "dp" in sizes else None
    pool = ("tp", None, None, None, None)
    fields = {"k_pages": pool, "v_pages": pool, "k_scale": pool, "v_scale": pool,
              "page_table": (dp, None), "lengths": (dp,)}
    return {f: None if getattr(cache, f) is None else _fallback(spec, getattr(cache, f), sizes)
            for f, spec in fields.items()}


def shard_paged_cache(cache: PagedKVCache, mesh) -> PagedKVCache:
    """This rank's part of a full paged cache: its G/tp head groups and,
    over "dp", its slots' table rows and lengths. The groups must split
    over tp (pick head_block <= num_kv_heads / tp)."""
    sizes = axis_sizes(mesh)
    s = paged_cache_shardings(mesh, cache)
    if s["k_pages"][0] is None and sizes.get("tp", 1) > 1:
        raise ValueError(f"the pool's {cache.k_pages.shape[0]} head groups do not split over "
                         f"tp = {sizes['tp']}")
    take = lambda f: _take(getattr(cache, f), s[f] or (), mesh, sizes)  # noqa: E731
    return PagedKVCache(k_pages=take("k_pages"), v_pages=take("v_pages"),
                        page_table=take("page_table"), lengths=take("lengths").clone(),
                        k_scale=take("k_scale"), v_scale=take("v_scale"))

