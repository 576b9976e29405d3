"""Single-host inference engine: bucketed prefill, decode/sample loop and
the continuous-batching scheduler's hooks.

The counterpart of ``mlc_llm_tpu/engine/engine.py``. Prefill lengths are
padded to the same static buckets and attention reads a bucketed
window, so the kernels see the same shapes as the reference's programs.
PyTorch runs eagerly: each JAX program is a method that runs the
forward(s) and the on-device sampler, with no host readback inside
(a K-step decode block is a Python loop of K forwards). The decode loop
keeps the reference's pipelining: the next step is enqueued on the
device before the previous step's token is read back.

KV layouts: ``"slot"`` (slot-contiguous [B, Smax] per slot), ``"paged"``
(one shared page pool + per-slot page tables, ``models/paged_cache.py``)
or ``"auto"`` (paged for int8 KV at batch > 1, slot otherwise: the slot
path dequantizes the whole int8 window before attention, the paged
decode kernel dequantizes inside its dots).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.paged_cache import PageAllocator, PrefixCache, init_paged_kv_cache
from ..models.transformer import forward, init_kv_cache, tree_map
from ..ops import resolve_device, synchronize
from ..ops.sampling import sample_token_perslot
from ..quant.groupwise import QuantizedTensor, pad_quantized_groups
from .stats import RuntimeStats

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass
class GenerationConfig:
    """Per-request generation parameters (the reference CLI's defaults)."""

    max_new_tokens: int = 128
    temperature: float = 0.7
    top_p: float = 0.95
    stop_tokens: Sequence[int] = ()
    seed: Optional[int] = None
    # nucleus-prefilter width; 0 = exact full-vocab top-p
    top_k: int = 64


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_batch: int = 1,
        max_seq_len: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        prefill_buckets: Sequence[int] = DEFAULT_BUCKETS,
        kv_layout: str = "slot",
        page_size: int = 128,
        num_pages: Optional[int] = None,
        page_head_block: Optional[int] = None,
        prefix_cache_pages: Optional[int] = None,
        device="cuda",
    ):
        """params may live on any device; they are moved to `device`.
        Every quantized leaf is zero-padded to a multiple of 32 groups
        (exact), as the reference engine does, so the kernels see the
        reference's stored shapes (w_out at 7B: 344 -> 352 groups).

        kv_layout: "slot", "paged" or "auto" (see the module doc).
        num_pages defaults to the slot-equivalent capacity plus the null
        page; size it smaller to oversubscribe (admission then
        backpressures on free pages). prefix_cache_pages enables the
        page-granular prefix cache (paged only)."""
        if kv_layout == "auto":
            kv_layout = "paged" if cache_dtype == torch.int8 and max_batch > 1 else "slot"
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"kv_layout must be slot, paged or auto, got {kv_layout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg

        def prep(x):
            x = x.map(lambda t: t.to(self.device)) if isinstance(x, QuantizedTensor) \
                else x.to(self.device)
            return pad_quantized_groups(x) if isinstance(x, QuantizedTensor) else x

        self.params = tree_map(prep, params)
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.cache_dtype = cache_dtype
        self.buckets = tuple(b for b in sorted(prefill_buckets) if b <= self.max_seq_len)
        if not self.buckets or self.buckets[-1] < self.max_seq_len:
            self.buckets = tuple(sorted({*self.buckets, self.max_seq_len}))
        self.stats = RuntimeStats()
        # decode forwards run (every S == 1 forward of the decode loops):
        # each launches the paged decode kernel once per layer
        self.decode_forwards = 0
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.allocator = None
        self.prefix_cache = None
        if kv_layout == "paged":
            pages_per_slot = -(-self.max_seq_len // page_size)
            if num_pages is None:
                num_pages = max_batch * pages_per_slot + 1  # +1: the null page
            self.num_pages = num_pages
            self.allocator = PageAllocator(num_pages)
            self._table_np = np.zeros((max_batch, pages_per_slot), np.int32)
            self._slot_pages = {s: [] for s in range(max_batch)}
            self.cache = init_paged_kv_cache(
                cfg, max_batch, num_pages, page_size, max_pages_per_slot=pages_per_slot,
                dtype=cache_dtype, head_block=page_head_block, device=self.device)
            if prefix_cache_pages:
                self.prefix_cache = PrefixCache(self.allocator, page_size,
                                                max_pages=prefix_cache_pages)
        elif prefix_cache_pages:
            raise ValueError("prefix_cache_pages requires kv_layout='paged'")
        else:
            self.cache = init_kv_cache(cfg, max_batch, self.max_seq_len, cache_dtype,
                                       device=self.device)

    def precompile(self, *, progress: Optional[Callable[[str], None]] = None) -> int:
        """No-op warm-up: PyTorch runs eagerly and the kernels are built
        at first use, so there is no program to compile ahead. Returns
        the number of programs compiled (0)."""
        return 0

    def decode_window(self, max_len_next: int) -> int:
        """Static attention-window bucket covering max_len_next."""
        for b in self.buckets:
            if max_len_next <= b:
                return b
        return self.max_seq_len

    # ------------------------------------------------------------------ utils
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max_seq_len {self.max_seq_len}")

    def reset(self, slots: Optional[Sequence[int]] = None) -> None:
        """Clear KV state (all slots, or the given subset)."""
        freed = list(range(self.max_batch)) if slots is None else [int(s) for s in slots]
        self.cache.lengths[freed] = 0
        if self.allocator is not None:
            for s in freed:
                self.free_slot_pages(s, push=False)
            if freed:
                self._push_table()

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(toks, np.int64)).to(self.device)

    # ----------------------------------------------------- paged-KV plumbing
    def pages_needed(self, slot: int, total_tokens: int) -> int:
        """Additional pages slot needs to hold total_tokens."""
        want = -(-total_tokens // self.page_size)
        return max(0, want - len(self._slot_pages[slot]))

    def _push_table(self) -> None:
        """Upload the host page table: once per batch of table edits."""
        self.cache.set_page_table(self._table_np)

    def assign_pages(self, slot: int, n_new: int, push: bool = True) -> None:
        """Allocate n_new pages to slot (MemoryError when the pool is
        exhausted; the scheduler checks can_alloc first). push=False
        defers the upload to a later _push_table()."""
        if n_new <= 0:
            return
        pages = self.allocator.alloc(n_new)
        self._slot_pages[slot].extend(pages)
        row = self._slot_pages[slot]
        self._table_np[slot, :] = 0
        self._table_np[slot, : len(row)] = row
        if push:
            self._push_table()

    def adopt_shared_pages(self, slot: int, pages) -> None:
        """Point slot's page table at already-allocated (prefix-cache)
        pages, taking a reference on each; free_slot_pages later drops
        that reference."""
        self.allocator.ref(pages)
        self._slot_pages[slot] = list(pages)
        self._table_np[slot, :] = 0
        self._table_np[slot, : len(pages)] = pages
        self._push_table()

    def set_slot_length(self, slot: int, n: int) -> None:
        """Set one slot's KV length (prefix adoption: the shared pages
        already hold n valid positions)."""
        self.cache.lengths[slot] = n

    def free_slot_pages(self, slot: int, push: bool = True) -> None:
        pages = self._slot_pages.get(slot)
        if not pages:
            return
        self.allocator.free(pages)
        self._slot_pages[slot] = []
        self._table_np[slot, :] = 0
        if push:
            self._push_table()

    # ------------------------------------------------------------- prefill/gen
    def prefill(self, prompts: List[List[int]], reset: bool = True, reserve_tokens: int = 64):
        """Prefill the batch. reset=True clears slot lengths first;
        reset=False appends to the existing KV state (multi-turn chat).
        reserve_tokens: paged mode allocates pages for prompt +
        reserve_tokens up front (generate_stream passes max_new_tokens).
        Returns last-token logits [B, V] f32 on the device."""
        B = self.max_batch
        if len(prompts) > B:
            raise ValueError(f"{len(prompts)} prompts for max_batch {B}")
        lens = [len(p) for p in prompts]
        bucket = self.bucket_for(max(lens))
        if reset:
            self.reset(range(len(prompts)))
        lens_host = self.cache.lengths.numpy().copy()
        if self.allocator is not None:
            try:
                for i, p in enumerate(prompts):
                    total = int(lens_host[i]) + len(p) + reserve_tokens + 1
                    self.assign_pages(i, self.pages_needed(i, min(total, self.max_seq_len)),
                                      push=False)
            finally:
                # push even when the pool runs out mid-loop: earlier slots'
                # table edits must reach the device or their writes land in
                # the null page
                self._push_table()
        toks = np.zeros((B, bucket), np.int64)
        seq_lens = np.zeros((B,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
            seq_lens[i] = len(p)
        if reset:
            window = self.decode_window(bucket)
        else:
            start_max = int(lens_host[: len(prompts)].max())
            window = self.decode_window(min(start_max + bucket, self.max_seq_len))
        t0 = time.perf_counter()
        logits, self.cache = forward(
            self.params, self.cfg, self._tokens(toks), self.cache,
            seq_lens=torch.from_numpy(seq_lens), attn_window=window)
        synchronize(self.device)
        self.stats.prefill_time += time.perf_counter() - t0
        self.stats.prefill_tokens += int(sum(lens))
        return logits

    def generate_stream(self, prompts: List[List[int]],
                        gen: GenerationConfig = GenerationConfig(), reset: bool = True):
        """Generator yielding (slot, token) as tokens are read back (one
        decode step behind the device). Slots not in 0..len(prompts)-1
        keep their state frozen."""
        B = self.max_batch
        n = len(prompts)
        logits = self.prefill(prompts, reset=reset, reserve_tokens=gen.max_new_tokens)

        # one generator per slot, seeded from gen.seed: a request's draws
        # depend only on its own seed and draw count
        base = gen.seed if gen.seed is not None else np.random.randint(0, 2**31 - 1)
        seeds = np.random.SeedSequence(base).generate_state(B)
        gens = [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]
        temps = np.zeros((B,), np.float32)
        temps[:n] = gen.temperature
        first = sample_token_perslot(logits, gens, temps, gen.top_p, gen.top_k)

        stop = set(gen.stop_tokens) | set(self.cfg.stop_tokens)
        emitted = [0] * n
        done = np.zeros((n,), bool)
        cur_lens = self.cache.lengths.numpy().copy()
        cur = first
        pending = [first]
        t0 = time.perf_counter()
        steps = 0
        max_steps = min(gen.max_new_tokens, int(self.max_seq_len - cur_lens[:n].max()))

        def drain_one():
            tok_host = pending.pop(0).cpu().numpy()
            for i in range(n):
                if done[i]:
                    continue
                tk = int(tok_host[i])
                if tk in stop:
                    done[i] = True
                    continue
                emitted[i] += 1
                if emitted[i] >= gen.max_new_tokens:
                    done[i] = True
                yield (i, tk)

        active = np.zeros((B,), bool)
        active[:n] = True
        max_len_host = int(cur_lens[:n].max())
        try:
            for _ in range(max_steps - 1):
                max_len_host += 1
                nxt = self._decode_sample(cur[:, None], active, gens, temps, gen.top_p,
                                          attn_window=self.decode_window(max_len_host + 1),
                                          top_k=gen.top_k)
                pending.append(nxt)
                cur = nxt
                steps += 1
                yield from drain_one()
                if done.all():
                    break
                active[:n] = ~done
            while pending:
                yield from drain_one()
        finally:
            synchronize(self.device)
            self.stats.decode_time += time.perf_counter() - t0
            self.stats.decode_tokens += steps * int(n)

    def generate(self, prompts: List[List[int]], gen: GenerationConfig = GenerationConfig(),
                 on_token: Optional[Callable[[int, int], None]] = None,
                 reset: bool = True) -> List[List[int]]:
        """Greedy/top-p generation for a batch of prompts. Returns the
        generated token lists (stop token not included)."""
        out: List[List[int]] = [[] for _ in range(len(prompts))]
        for slot, tok in self.generate_stream(prompts, gen, reset=reset):
            out[slot].append(tok)
            if on_token is not None:
                on_token(slot, tok)
        return out

    # ------------------------------------------------------ scheduler hooks
    def _decode_sample(self, tokens, active: np.ndarray, generators, temperature, top_p, *,
                       attn_window: int, top_k: int = 64):
        """One masked decode step + on-device sampling. tokens [B, 1] on
        the device; active [B] host bools: inactive slots do not advance
        their length and keep their token. temperature/top_p: host
        scalars or [B]; inactive rows are argmax and draw nothing.
        Returns [B] next tokens on the device; nothing is read back."""
        logits, self.cache = forward(
            self.params, self.cfg, tokens, self.cache,
            seq_lens=torch.from_numpy(active.astype(np.int64)), attn_window=attn_window)
        self.decode_forwards += 1
        temps = np.where(active, np.broadcast_to(temperature, active.shape), 0.0)
        nxt = sample_token_perslot(logits, generators, temps, top_p, top_k)
        return torch.where(torch.from_numpy(active).to(self.device), nxt, tokens[:, 0])

    def _decode_sample_k(self, tokens, active: np.ndarray, generators, temperature, top_p, *,
                         attn_window: int, top_k: int = 64, k_steps: int = 4):
        """k_steps decode steps in one block: a Python loop of eager
        forwards with no host readback inside; returns [K, B] tokens.
        Each request's generator draws in the same order as K single
        steps, so streams are identical. Stop detection happens at drain
        time: rows past a stop are discarded by the host, and their junk
        KV sits past the slot's valid length."""
        out = []
        tok = tokens
        for _ in range(k_steps):
            nxt = self._decode_sample(tok, active, generators, temperature, top_p,
                                      attn_window=attn_window, top_k=top_k)
            out.append(nxt)
            tok = nxt[:, None]
        return torch.stack(out)

    def _prefill_slot(self, tokens: np.ndarray, seq_len: int, slot: int, append: bool = False,
                      attn_window: Optional[int] = None):
        """Prefill ONE slot (tokens [1, S]) without touching the other
        slots' KV state: continuous-batching admission. append starts
        from the slot's existing length instead of 0. The slot layout
        runs the forward on views of the slot's cache rows, the paged
        layout on the slot's page-table row over the shared pools, so
        the writes land in place and nothing is spliced back."""
        start = int(self.cache.lengths[slot]) if append else 0
        sub = self.cache.slot_view(slot, start)
        logits, sub = forward(self.params, self.cfg, self._tokens(tokens), sub,
                              seq_lens=[seq_len], attn_window=attn_window)
        self.cache.lengths[slot] = sub.lengths[0]
        return logits

    def _prefill_slots(self, tokens: np.ndarray, seq_lens: np.ndarray, slots: Sequence[int],
                       attn_window: Optional[int] = None):
        """Prefill G fresh slots in one forward (tokens [G, S]; slot
        layout only, every row starts at position 0): one weight read
        for all G admissions. The rows' KV goes to a bucket-sized scratch
        cache, then into each slot's rows."""
        if self.kv_layout != "slot":
            raise ValueError("grouped admission prefill is slot-layout only")
        G, S = tokens.shape
        sub = init_kv_cache(self.cfg, G, S, self.cache_dtype, device=self.device)
        logits, sub = forward(self.params, self.cfg, self._tokens(tokens), sub,
                              seq_lens=torch.as_tensor(seq_lens, dtype=torch.int64),
                              attn_window=attn_window)
        c = self.cache
        for g, slot in enumerate(slots):
            c.k[:, slot, :, :S] = sub.k[:, g]
            c.v[:, slot, :, :, :S] = sub.v[:, g]
            if c.k_scale is not None:
                c.k_scale[:, slot, :, :S] = sub.k_scale[:, g]
                c.v_scale[:, slot, :, :S] = sub.v_scale[:, g]
            c.lengths[slot] = int(seq_lens[g])
        return logits
