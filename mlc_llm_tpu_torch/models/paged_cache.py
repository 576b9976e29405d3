"""Paged KV cache: head-packed page-pool storage + per-slot page tables.

The counterpart of ``mlc_llm_tpu/models/paged_cache.py``, same layouts:

- k_pages / v_pages: [G, L, P, ps, hb*D]; hb kv-heads interleaved in the
  last dim (G = Hkv/hb head groups), so kv-head h sits in group h // hb
  at lanes (h % hb)*D .. +D of each [ps, hb*D] page row;
- page_table: [B, max_pages] int32 on the pool's device; unused entries
  point at page 0, the reserved null page, whose contents are garbage
  but always masked (positions >= length);
- lengths: [B] valid tokens per slot, kept on the host (int64 CPU
  tensor, as the slot cache's), with a host copy of the page table
  (``table_host``) beside the device one: the write indices are
  computed from both without a device sync;
- int8 mode: per-(head, position) absmax scales, k-scales
  [G, L, P, hb, ps] and v-scales [G, L, P, ps, hb].

Writes are IN PLACE (JAX returns an updated copy that XLA aliases), as
the slot path's are. The (page id, offset) of every written token is
computed once per forward on the host (``paged_write_index``) and reused
for all L layers: each layer's write is then one ``index_copy_`` per
pool, not a copy per slot and page. Semantics are the JAX package's:
page 0 is the null page, padded bucket tokens are written too,
positions at or past the table's capacity are dropped (a decode write,
S == 1, clamps its page column instead, as JAX does), and an unaligned
append keeps the earlier tokens of the page it starts in.

The tensor-parallel routing of the JAX module (``paged_flash_tp_enabled``,
``paged_flash_decode_tp``) is not ported yet (ROADMAP.md queue 1,
item 10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops import resolve_device
from .config import ModelConfig


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor             # [G, L, P, ps, hb*D]
    v_pages: torch.Tensor             # [G, L, P, ps, hb*D]
    page_table: torch.Tensor          # [B, max_pages] int32, pool device
    lengths: torch.Tensor             # [B] int64, host
    k_scale: Optional[torch.Tensor] = None  # [G, L, P, hb, ps] (int8 mode)
    v_scale: Optional[torch.Tensor] = None  # [G, L, P, ps, hb] (int8 mode)
    table_host: Optional[torch.Tensor] = None  # host copy of page_table

    def __post_init__(self):
        if self.table_host is None:
            self.table_host = self.page_table.to("cpu", torch.int32)

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    def set_page_table(self, table) -> None:
        """Install a host page table [B, max_pages]: one upload."""
        self.table_host = torch.as_tensor(np.array(table, np.int32))
        self.page_table = self.table_host.to(self.k_pages.device)

    def slot_view(self, slot: int, start: int) -> "PagedKVCache":
        """One slot's view: the shared pools, its table row, its start
        length. Writes through it touch only the slot's own pages."""
        return PagedKVCache(
            k_pages=self.k_pages, v_pages=self.v_pages,
            page_table=self.page_table[slot:slot + 1],
            lengths=torch.tensor([start], dtype=torch.int64),
            k_scale=self.k_scale, v_scale=self.v_scale,
            table_host=self.table_host[slot:slot + 1])


def default_head_block(num_kv_heads: int) -> int:
    """Heads interleaved per page row block (8 when it divides Hkv)."""
    for hb in (8, 4, 2, 1):
        if num_kv_heads % hb == 0:
            return min(hb, num_kv_heads)
    return 1


def init_paged_kv_cache(cfg: ModelConfig, batch: int, num_pages: int, page_size: int = 128,
                        max_pages_per_slot: Optional[int] = None, dtype=torch.bfloat16,
                        head_block: Optional[int] = None, device="cuda") -> PagedKVCache:
    dev = resolve_device(device)
    if max_pages_per_slot is None:
        max_pages_per_slot = -(-cfg.max_seq_len // page_size)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    hb = head_block or default_head_block(H)
    if H % hb:
        raise ValueError(f"head_block {hb} does not divide num_kv_heads {H}")
    G = H // hb
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
    """Where a forward's new tokens land: ``flat`` [N] holds page_id*ps +
    offset (a row of a layer's [P*ps] pool rows) for each written (b, s),
    in b-major order; ``sel`` [N] lists those (b, s) as b*S + s, or is
    None when every one of the B*S tokens is written."""

    flat: torch.Tensor
    sel: Optional[torch.Tensor]
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


def paged_write_index(table, start, S: int, page_size: int, device) -> PagedWriteIndex:
    """The write positions of an S-token block appended at each slot's
    start (host table [B, maxp], host start [B]). Decode (S == 1) clamps
    the page column to the table's last; a block drops its positions at
    or past the table's capacity (the JAX ``posv < cap`` mask)."""
    table = np.asarray(table, np.int64)
    start = np.asarray(start, np.int64)
    B, maxp = table.shape
    ps = page_size
    pos = start[:, None] + np.arange(S)[None, :]
    keep = np.ones_like(pos, bool) if S == 1 else pos < maxp * ps
    pid = table[np.arange(B)[:, None], np.minimum(pos // ps, maxp - 1)]
    flat = (pid * ps + pos % ps).reshape(-1)
    keep = keep.reshape(-1)
    sel = None
    if not keep.all():
        sel = np.nonzero(keep)[0]
        flat = flat[sel]
        sel = torch.from_numpy(sel).to(device)
    return PagedWriteIndex(flat=torch.from_numpy(flat).to(device), sel=sel, page_size=ps)


def _pick(rows, index: PagedWriteIndex):
    return rows if index.sel is None else rows[:, index.sel]


def write_rows_paged(pages, rows, l: int, index: PagedWriteIndex) -> None:
    """rows [G, B*S, hb*D] (b-major) into layer l of a page pool."""
    G, _, P, ps, hbD = pages.shape
    pages[:, l].view(G, P * ps, hbD).index_copy_(1, index.flat,
                                                 _pick(rows, index).to(pages.dtype))


def write_scale_rows_paged_k(scales, rows, l: int, index: PagedWriteIndex) -> None:
    """rows [G, B*S, hb] into layer l of the k-scales [G, L, P, hb, ps]."""
    G, _, P, hb, ps = scales.shape
    vals = _pick(rows, index).to(scales.dtype).reshape(G, -1)
    scales[:, l].view(G, P * hb * ps).index_copy_(1, index.k_scale_index(hb), vals)


def write_scale_rows_paged_v(scales, rows, l: int, index: PagedWriteIndex) -> None:
    """rows [G, B*S, hb] into layer l of the v-scales [G, L, P, ps, hb]."""
    G, _, P, ps, hb = scales.shape
    scales[:, l].view(G, P * ps, hb).index_copy_(1, index.flat,
                                                 _pick(rows, index).to(scales.dtype))


# The JAX package's write functions, for one layer and a table and start
# given as tensors; forward instead builds one PagedWriteIndex per step and
# calls the write_*rows_paged functions for every layer.

def _index(device, table, start, S, ps):
    return paged_write_index(torch.as_tensor(table).cpu().numpy(),
                             torch.as_tensor(start).cpu().numpy(), S, ps, device)


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
