"""Paged KV cache: head-packed page-pool storage + per-slot page tables.

The counterpart of ``mlc_llm_tpu/models/paged_cache.py``, same layouts:

- k_pages / v_pages: [G, L, P, ps, hb*D]; hb kv-heads interleaved in the
  last dim (G = Hkv/hb head groups), so kv-head h sits in group h // hb
  at lanes (h % hb)*D .. +D of each [ps, hb*D] page row;
- page_table: [B, max_pages] int32 on the pool's device; unused entries
  point at page 0, the reserved null page, whose contents are garbage
  but always masked (positions >= length);
- lengths: [B] valid tokens per slot, kept on the host (int64 CPU
  tensor, as the slot cache's), the source of truth. ``page_table`` and
  ``lengths_dev`` (the device copy of the lengths that a step reads and
  advances) are fixed buffers that live as long as the cache: every
  update is an in-place copy, so a captured graph keeps reading the
  current table and lengths;
- int8 mode: per-(head, position) absmax scales, k-scales
  [G, L, P, hb, ps] and v-scales [G, L, P, ps, hb].

Writes are IN PLACE (JAX returns an updated copy that XLA aliases), as
the slot path's are. The (page id, offset) of every written token is
computed once per forward on the device, from the device table rows and
starts (``paged_write_index``), and reused for all L layers: each
layer's write is then one ``index_copy_`` per pool, not a copy per slot
and page. Semantics are the JAX package's: page 0 is the null page,
padded bucket tokens are written too, positions at or past the table's
capacity are dropped (a decode write, S == 1, clamps its page column
instead, as JAX does), and an unaligned append keeps the earlier tokens
of the page it starts in. A dropped position is written to the null
page rather than left out, so that a block always makes the same number
of writes (no host value, no data-dependent shape: a graph holds it).

Tensor parallelism: the pool's head groups G are its shard dimension
(each group's pages and int8 scales are self-contained), so a
tensor-parallel rank holds G/tp groups (``init_paged_kv_cache(..., tp=)``,
``parallel.sharding.shard_paged_cache``) and the page table and lengths
whole. ``paged_flash_tp_enabled`` is JAX's rule for when a sharded decode
runs kernel 7, and ``paged_flash_decode_tp`` runs it on the rank's local
groups and query heads: JAX's ``shard_map`` over the mesh, with no
collective inside (the head-sharded output feeds the row-parallel
``wo``, whose all-reduce the forward makes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops import resolve_device
from ..ops.paged_attention import paged_flash_decode
from .config import ModelConfig


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor             # [G, L, P, ps, hb*D]
    v_pages: torch.Tensor             # [G, L, P, ps, hb*D]
    page_table: torch.Tensor          # [B, max_pages] int32, pool device
    lengths: torch.Tensor             # [B] int64, host
    k_scale: Optional[torch.Tensor] = None  # [G, L, P, hb, ps] (int8 mode)
    v_scale: Optional[torch.Tensor] = None  # [G, L, P, ps, hb] (int8 mode)
    lengths_dev: Optional[torch.Tensor] = None  # [B] int64, pool device

    def __post_init__(self):
        if self.lengths_dev is None:
            self.lengths_dev = self.lengths.to(self.k_pages.device, copy=True)

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    def set_page_table(self, table) -> None:
        """Install a host page table [B, max_pages]: one upload, in place
        into the device table."""
        self.page_table.copy_(torch.as_tensor(np.array(table, np.int32)))


def default_head_block(num_kv_heads: int) -> int:
    """Heads interleaved per page row block (8 when it divides Hkv)."""
    for hb in (8, 4, 2, 1):
        if num_kv_heads % hb == 0:
            return min(hb, num_kv_heads)
    return 1


def init_paged_kv_cache(cfg: ModelConfig, batch: int, num_pages: int, page_size: int = 128,
                        max_pages_per_slot: Optional[int] = None, dtype=torch.bfloat16,
                        head_block: Optional[int] = None, device="cuda",
                        tp: int = 1) -> PagedKVCache:
    """A zeroed pool of G = Hkv/hb head groups; tp > 1: one
    tensor-parallel rank's G/tp groups (G must be a multiple of tp: pick
    head_block so, as JAX's engine note says)."""
    dev = resolve_device(device)
    if max_pages_per_slot is None:
        max_pages_per_slot = -(-cfg.max_seq_len // page_size)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    hb = head_block or default_head_block(H)
    if H % hb:
        raise ValueError(f"head_block {hb} does not divide num_kv_heads {H}")
    if (H // hb) % tp:
        raise ValueError(f"tp = {tp} does not divide the pool's {H // hb} head groups "
                         f"(head_block {hb}); pick head_block <= num_kv_heads / tp")
    G = H // hb // tp
    kshape = (G, L, num_pages, page_size, hb * D)
    k_scale = v_scale = None
    if dtype == torch.int8:
        k_scale = torch.zeros((G, L, num_pages, hb, page_size), dtype=torch.float32, device=dev)
        v_scale = torch.zeros((G, L, num_pages, page_size, hb), dtype=torch.float32, device=dev)
    return PagedKVCache(
        k_pages=torch.zeros(kshape, dtype=dtype, device=dev),
        v_pages=torch.zeros(kshape, dtype=dtype, device=dev),
        page_table=torch.zeros((batch, max_pages_per_slot), dtype=torch.int32, device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int64),
        k_scale=k_scale, v_scale=v_scale)


def paged_flash_tp_enabled(G: int, Hq: int, mesh) -> bool:
    """Does a sharded paged decode run kernel 7 on each rank's shard?
    JAX's rule: the mesh has a "tp" dimension whose size divides both the
    pool's head-group count G and the query head count Hq (global
    counts)."""
    if mesh is None or "tp" not in (mesh.mesh_dim_names or ()):
        return False
    tp = mesh.shape[mesh.mesh_dim_names.index("tp")]
    return tp >= 1 and G % tp == 0 and Hq % tp == 0


def paged_flash_decode_tp(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, layer,
                          *, num_pages_window: int, head_dim: int, mesh):
    """Kernel 7 on one tensor-parallel rank: q [B, Hq/tp, 1, D] (the rank's
    query heads) over its local pools [G/tp, L, P, ps, hb*D] (and int8
    scales), the page table and lengths whole. No collective: each rank's
    heads are its own. Returns the rank's [B, Hq/tp, 1, D] output."""
    if mesh is None or "tp" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"paged_flash_decode_tp: no 'tp' dimension in mesh {mesh}")
    return paged_flash_decode(q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
                              layer, num_pages_window=num_pages_window, head_dim=head_dim)


# ----------------------------------------------------------------- reads

def _layer_pages(pages, l, table, maxp):
    """pages[:, l] at the first maxp table columns -> [G, B, mp, ...]."""
    return pages[:, l][:, table[:, :maxp].long()]


def gather_pages_k(pages, l, table, maxp: int, head_dim: int):
    """pages [G, L, P, ps, hb*D] -> [B, H, maxp*ps, D] for layer l."""
    G, _, _, ps, hbD = pages.shape
    hb = hbD // head_dim
    sub = _layer_pages(pages, l, table, maxp)  # [G, B, mp, ps, hbD]
    B, mp = sub.shape[1], sub.shape[2]
    sub = sub.reshape(G, B, mp, ps, hb, head_dim)
    return sub.permute(1, 0, 4, 2, 3, 5).reshape(B, G * hb, mp * ps, head_dim)


def gather_pages_v(pages, l, table, maxp: int, head_dim: int):
    """pages [G, L, P, ps, hb*D] -> [B, H, D, maxp*ps] (D-major, the
    attend_cache layout) for layer l."""
    G, _, _, ps, hbD = pages.shape
    hb = hbD // head_dim
    sub = _layer_pages(pages, l, table, maxp)
    B, mp = sub.shape[1], sub.shape[2]
    sub = sub.reshape(G, B, mp, ps, hb, head_dim)
    return sub.permute(1, 0, 4, 5, 2, 3).reshape(B, G * hb, head_dim, mp * ps)


def gather_pages_scale_k(scales, l, table, maxp: int):
    """[G, L, P, hb, ps] -> [B, H, maxp*ps]."""
    G, _, _, hb, ps = scales.shape
    sub = _layer_pages(scales, l, table, maxp)  # [G, B, mp, hb, ps]
    B, mp = sub.shape[1], sub.shape[2]
    return sub.permute(1, 0, 3, 2, 4).reshape(B, G * hb, mp * ps)


def gather_pages_scale_v(scales, l, table, maxp: int):
    """[G, L, P, ps, hb] -> [B, H, maxp*ps]."""
    G, _, _, ps, hb = scales.shape
    sub = _layer_pages(scales, l, table, maxp)  # [G, B, mp, ps, hb]
    B, mp = sub.shape[1], sub.shape[2]
    return sub.permute(1, 0, 4, 2, 3).reshape(B, G * hb, mp * ps)


# ---------------------------------------------------------------- writes

@dataclasses.dataclass
class PagedWriteIndex:
    """Where a forward's new tokens land: ``flat`` [B*S] holds page_id*ps
    + offset (a row of a layer's [P*ps] pool rows) for each written (b,
    s), in b-major order; every one of the B*S tokens is written."""

    flat: torch.Tensor
    page_size: int
    _kidx: Optional[torch.Tensor] = None

    def k_scale_index(self, hb: int) -> torch.Tensor:
        """Flat indices into a layer's [P*hb*ps] k-scales, [N*hb]."""
        if self._kidx is None:
            ps = self.page_size
            pid, off = self.flat // ps, self.flat % ps
            hh = torch.arange(hb, device=self.flat.device)
            self._kidx = ((pid[:, None] * hb + hh[None]) * ps + off[:, None]).reshape(-1)
        return self._kidx


def paged_write_index(table, start, S: int, page_size: int) -> PagedWriteIndex:
    """The write positions of an S-token block appended at each row's
    start: table [B, maxp] (the rows' page-table rows) and start [B] are
    tensors on one device, and everything is computed there. Decode (S ==
    1) clamps the page column to the table's last; a block sends its
    positions at or past the table's capacity (the JAX ``posv < cap``
    mask) to the null page, page 0."""
    ps = page_size
    maxp = table.shape[1]
    pos = start.to(torch.int64)[:, None] + torch.arange(S, device=table.device)[None, :]
    col = torch.clamp(pos // ps, max=maxp - 1)
    pid = table.gather(1, col).to(torch.int64)
    if S > 1:
        pid = torch.where(pos < maxp * ps, pid, torch.zeros_like(pid))
    return PagedWriteIndex(flat=(pid * ps + pos % ps).reshape(-1), page_size=ps)


def write_rows_paged(pages, rows, l: int, index: PagedWriteIndex) -> None:
    """rows [G, B*S, hb*D] (b-major) into layer l of a page pool."""
    G, _, P, ps, hbD = pages.shape
    pages[:, l].view(G, P * ps, hbD).index_copy_(1, index.flat, rows.to(pages.dtype))


def write_scale_rows_paged_k(scales, rows, l: int, index: PagedWriteIndex) -> None:
    """rows [G, B*S, hb] into layer l of the k-scales [G, L, P, hb, ps]."""
    G, _, P, hb, ps = scales.shape
    vals = rows.to(scales.dtype).reshape(G, -1)
    scales[:, l].view(G, P * hb * ps).index_copy_(1, index.k_scale_index(hb), vals)


def write_scale_rows_paged_v(scales, rows, l: int, index: PagedWriteIndex) -> None:
    """rows [G, B*S, hb] into layer l of the v-scales [G, L, P, ps, hb]."""
    G, _, P, ps, hb = scales.shape
    scales[:, l].view(G, P * ps, hb).index_copy_(1, index.flat, rows.to(scales.dtype))


# The JAX package's write functions, for one layer and a table and start
# given as tensors; forward instead builds one PagedWriteIndex per step and
# calls the write_*rows_paged functions for every layer.

def _index(device, table, start, S, ps):
    return paged_write_index(torch.as_tensor(table, device=device),
                             torch.as_tensor(start, device=device), S, ps)


def write_tokens_paged_k(pages, new, l: int, table, start):
    """pages [G, L, P, ps, hb*D]; new [B, H, S, D]; start [B]. Writes in
    place and returns pages."""
    B, H, S, D = new.shape
    G, _, _, ps, hbD = pages.shape
    hb = hbD // D
    rows = new.reshape(B, G, hb, S, D).permute(1, 0, 3, 2, 4).reshape(G, B * S, hbD)
    write_rows_paged(pages, rows, l, _index(pages.device, table, start, S, ps))
    return pages


def write_tokens_paged_v(pages, new, l: int, table, start):
    """pages [G, L, P, ps, hb*D]; new [B, H, D, S] (the transposed
    activation layout); start [B]. V pages share K's layout."""
    return write_tokens_paged_k(pages, new.transpose(2, 3), l, table, start)


def _scale_rows(new, G):
    B, H, S = new.shape
    return new.reshape(B, G, H // G, S).permute(1, 0, 3, 2).reshape(G, B * S, H // G)


def write_scales_paged_k(scales, new, l: int, table, start):
    """scales [G, L, P, hb, ps]; new [B, H, S]."""
    G, ps = scales.shape[0], scales.shape[4]
    write_scale_rows_paged_k(scales, _scale_rows(new, G), l,
                             _index(scales.device, table, start, new.shape[2], ps))
    return scales


def write_scales_paged_v(scales, new, l: int, table, start):
    """scales [G, L, P, ps, hb]; new [B, H, S]."""
    G, ps = scales.shape[0], scales.shape[3]
    write_scale_rows_paged_v(scales, _scale_rows(new, G), l,
                             _index(scales.device, table, start, new.shape[2], ps))
    return scales


# ------------------------------------------------------------- allocator

class PageAllocator:
    """Host-side refcounted free-list page allocator (a copy of the JAX
    package's). Page 0 is the reserved null page. Refcounts enable
    prefix sharing: a page can back several slots' tables and a
    PrefixCache entry at once; free() returns it at zero."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need at least 2 pages (page 0 is reserved), got {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # stack; 0 reserved
        self._refs = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"paged KV: need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def ref(self, pages) -> None:
        """Take an additional reference on already-allocated pages."""
        for p in pages:
            if not (0 < p < self.num_pages and self._refs[p] > 0):
                raise ValueError(f"page {p} is not allocated")
            self._refs[p] += 1

    def free(self, pages) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} out of range")
            if self._refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)


class PrefixCache:
    """Page-granular prompt-prefix cache (a copy of the JAX package's).

    A cached prefix is a list of page ids that several slots' page
    tables (and this cache) reference at once. Entries cover FULL pages
    only, so a new request's suffix prefill always starts in a fresh
    page and no copy-on-write is needed. Entries are keyed by the exact
    token tuple of each page-aligned prefix; lookup probes aligned
    lengths longest-first. The cache holds its own reference on every
    entry's pages; evict() releases LRU entries."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_pages: Optional[int] = None):
        self.allocator = allocator
        self.page_size = page_size
        self.max_pages = max_pages
        self._entries: dict = {}  # token tuple -> [pages]
        self._clock = 0
        self._last_used: dict = {}
        self.hits = 0
        self.misses = 0

    @property
    def pages_held(self) -> int:
        """UNIQUE pages referenced by the cache."""
        return len({p for pages in self._entries.values() for p in pages})

    def lookup(self, prompt) -> tuple:
        """(shared_pages, shared_len): the longest cached page-aligned
        prefix STRICTLY shorter than the prompt (the last prompt token
        must still be prefilled to produce first-token logits)."""
        ps = self.page_size
        max_len = (len(prompt) - 1) // ps * ps
        for n in range(max_len, 0, -ps):
            key = tuple(prompt[:n])
            pages = self._entries.get(key)
            if pages is not None:
                self._clock += 1
                self._last_used[key] = self._clock
                self.hits += 1
                return list(pages), n
        self.misses += 1
        return [], 0

    def _held(self) -> set:
        return {p for pages in self._entries.values() for p in pages}

    def insert(self, prompt, slot_pages) -> None:
        """Register every page-aligned prefix of a fully-prefilled
        prompt (slot_pages[i] backs positions [i*ps, (i+1)*ps))."""
        ps = self.page_size
        for n in range(ps, len(prompt) + 1, ps):
            key = tuple(prompt[:n])
            if key in self._entries:
                continue
            npages = n // ps
            if self.max_pages is not None:
                held = self._held()
                new = len(set(slot_pages[:npages]) - held)
                while len(held) + new > self.max_pages and self._entries:
                    if not self.evict(1):
                        break
                    held = self._held()
                    new = len(set(slot_pages[:npages]) - held)
                if len(held) + new > self.max_pages:
                    return
            pages = list(slot_pages[:npages])
            self.allocator.ref(pages)
            self._entries[key] = pages
            self._clock += 1
            self._last_used[key] = self._clock

    def evict(self, n_entries: int = 1) -> int:
        """Release up to n_entries LRU entries; returns how many."""
        done = 0
        for key in sorted(self._entries, key=lambda k: self._last_used[k]):
            if done >= n_entries:
                break
            self.allocator.free(self._entries.pop(key))
            self._last_used.pop(key, None)
            done += 1
        return done

    def clear(self) -> None:
        while self._entries:
            self.evict(len(self._entries))
