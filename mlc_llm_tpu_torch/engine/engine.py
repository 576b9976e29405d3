"""Single-host inference engine: bucketed prefill, decode/sample loop and
the continuous-batching scheduler's hooks.

The counterpart of ``mlc_llm_tpu/engine/engine.py``. Prefill lengths are
padded to the same static buckets and attention reads a bucketed
window, so the kernels see the same shapes as the reference's programs.

The decode step is a step program (``engine/programs.py``), as JAX's
jitted ``_decode_sample``: on a CUDA engine every decode step replays
one captured CUDA graph, keyed by (batch, attention window) as JAX keys
its program on shapes and the static ``attn_window``. The graph reads
fixed buffers: the staged tokens and active mask, the cache's device
lengths and page table; it runs the forward, the greedy argmax and the
inactive rows' freeze. Sampled rows (T >= 1e-6) are drawn after the
replay from the graph's logits with each slot's own generator. A K-step
block is K replays fed by an in-stream copy. Prefill runs eagerly. On
the CPU the same step function runs eagerly. The decode loop keeps the
reference's pipelining: the next step is enqueued on the device before
the previous step's token is read back.

The speculative verify pass (``engine/speculative.py``) is one more
step program, keyed (batch, block width K, window) as JAX jits its
verify program per shape and ``attn_window``: it writes K/V rows [len,
len + K) of every slot, advances no length and returns each position's
greedy token, read back once a pass (``verify``). The caller advances
the host lengths by what the pass consumed.

KV layouts: ``"slot"`` (slot-contiguous [B, Smax] per slot), ``"paged"``
(one shared page pool + per-slot page tables, ``models/paged_cache.py``)
or ``"auto"`` (paged for int8 KV at batch > 1, slot otherwise: the slot
path dequantizes the whole int8 window before attention, the paged
decode kernel dequantizes inside its dots).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.paged_cache import PageAllocator, PrefixCache, init_paged_kv_cache
from ..models.transformer import (
    forward,
    forward_decode,
    forward_verify,
    init_kv_cache,
    tree_map,
)
from ..ops import resolve_device, synchronize
from ..ops.sampling import sample_rows, sample_token_perslot
from ..quant.groupwise import QuantizedTensor, pad_quantized_groups
from .programs import StepPrograms
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
        Every word-packed quantized leaf (u32 or u16 words, any code
        width) is zero-padded to a multiple of 32 groups (exact), as the
        reference engine does, so the kernels see the reference's stored
        shapes (w_out at 7B: 344 -> 352 groups in q4, 276 -> 288 in q3,
        where k=4096 goes 103 -> 128); int8 planes stay as they are.

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
        # decode steps run (every run of the decode program, a graph
        # replay on the card): each launches the paged decode kernel once
        # per layer
        self.decode_forwards = 0
        self.programs = StepPrograms(self.device)
        # the decode program's fixed input buffers
        self._step_tokens = torch.zeros((max_batch, 1), dtype=torch.int64, device=self.device)
        self._step_active = torch.zeros((max_batch,), dtype=torch.int64, device=self.device)
        # the verify program's fixed token buffers [B, K], by K; and its
        # runs (each a graph replay on the card)
        self._verify_tokens = {}
        self.verify_forwards = 0
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
        """Capture the decode program of every attention-window bucket at
        max_batch, {decode_window(b) for b in buckets} and max_seq_len
        (the JAX engine's decode windows), ahead of serving: one CUDA
        graph each, after an eager warm-up step that advances no length.
        Reports each through `progress` and returns the number captured.
        A CPU engine captures nothing and returns 0. Prefill stays eager;
        the kernels are built at first use."""
        if self.device.type != "cuda":
            return 0
        windows = sorted({self.decode_window(b) for b in self.buckets} | {self.max_seq_len})
        # the warm-up writes its junk K/V at each slot's current length
        self.cache.lengths_dev.copy_(self.cache.lengths)
        for w in windows:
            if progress is not None:
                progress(f"decode window {w} (batch {self.max_batch})")
            self.programs.capture(*self._decode_program_args(w))
        return len(windows)

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
    def _stage_decode(self, tokens, active: np.ndarray) -> None:
        """Fill the decode program's inputs: tokens [B, 1] (a device copy,
        in stream order), the active mask and the host lengths (copies
        from pinned host memory that do not block)."""
        self._step_tokens.copy_(tokens)
        host = torch.empty((2, self.max_batch), dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")
        host[0] = torch.from_numpy(active.astype(np.int64))
        host[1] = self.cache.lengths
        self._step_active.copy_(host[0], non_blocking=True)
        self.cache.lengths_dev.copy_(host[1], non_blocking=True)

    def _decode_program(self, attn_window: int):
        """The decode step on the fixed buffers, what one graph holds:
        the forward, then the argmax of every row, inactive rows keeping
        their token. Reads no host value; advances the device lengths of
        the active slots. Returns (logits [B, V] f32, next tokens [B])."""
        active = self._step_active
        logits = forward_decode(self.params, self.cfg, self._step_tokens, self.cache, active,
                                attn_window=attn_window)
        nxt = torch.where(active.bool(), torch.argmax(logits, dim=-1), self._step_tokens[:, 0])
        return logits, nxt

    def _decode_program_args(self, attn_window: int):
        """(key, program, warm-up) of the decode program of attn_window.
        The warm-up runs it with every slot inactive: no length advances
        and each slot's junk K/V lands at its length, as an inactive row's
        does at every step."""
        fn = functools.partial(self._decode_program, attn_window)

        def warm_up():
            staged = self._step_active.clone()
            self._step_active.zero_()
            fn()
            self._step_active.copy_(staged)

        return ("decode", self.max_batch, attn_window), fn, warm_up

    def _decode_step(self, active: np.ndarray, generators, temperature, top_p, top_k: int,
                     attn_window: int):
        """Run the decode program on the staged inputs and draw the
        sampled rows: returns [B] next tokens in a fresh tensor (the
        graph's outputs are overwritten by its next replay)."""
        logits, nxt = self.programs.run(*self._decode_program_args(attn_window))
        self.decode_forwards += 1
        out = nxt.clone()
        temps = np.where(active, np.broadcast_to(temperature, active.shape), 0.0)
        sample_rows(out, logits, generators, temps, top_p, top_k)
        return out

    def _decode_sample(self, tokens, active: np.ndarray, generators, temperature, top_p, *,
                       attn_window: int, top_k: int = 64):
        """One masked decode step + on-device sampling. tokens [B, 1] on
        the device; active [B] host bools: inactive slots do not advance
        their length and keep their token. temperature/top_p: host
        scalars or [B]; inactive rows are argmax and draw nothing.
        Returns [B] next tokens on the device, a fresh tensor; nothing is
        read back."""
        self._stage_decode(tokens, active)
        out = self._decode_step(active, generators, temperature, top_p, top_k, attn_window)
        self.cache.lengths += torch.from_numpy(active.astype(np.int64))
        return out

    def _decode_sample_k(self, tokens, active: np.ndarray, generators, temperature, top_p, *,
                         attn_window: int, top_k: int = 64, k_steps: int = 4):
        """k_steps decode steps in one block: K runs of the decode
        program, each step's tokens fed to the next by an in-stream copy,
        with no host readback inside; returns [K, B] tokens. Each
        request's generator draws in the same order as K single steps,
        so streams are identical. Stop detection happens at drain time:
        rows past a stop are discarded by the host, and their junk KV
        sits past the slot's valid length."""
        self._stage_decode(tokens, active)
        out = []
        for i in range(k_steps):
            if i:
                self._step_tokens.copy_(out[-1][:, None])
            out.append(self._decode_step(active, generators, temperature, top_p, top_k,
                                         attn_window))
        self.cache.lengths += k_steps * torch.from_numpy(active.astype(np.int64))
        return torch.stack(out)

    # ------------------------------------------------------ verify program
    def _stage_verify(self, tokens: np.ndarray) -> None:
        """Fill the verify program's inputs: the tokens [B, K] and the
        host lengths, copies from pinned host memory that do not block."""
        B, K = tokens.shape
        buf = self._verify_tokens.get(K)
        if buf is None:
            buf = self._verify_tokens[K] = torch.zeros((B, K), dtype=torch.int64,
                                                       device=self.device)
        host = torch.empty((B * K + B,), dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")
        host[:B * K] = torch.from_numpy(np.asarray(tokens, np.int64).reshape(-1))
        host[B * K:] = self.cache.lengths
        buf.copy_(host[:B * K].view(B, K), non_blocking=True)
        self.cache.lengths_dev.copy_(host[B * K:], non_blocking=True)

    def _verify_program(self, K: int, attn_window: int):
        """The verify pass on the fixed buffers, what one graph holds:
        the forward over the staged [B, K] block at the device lengths
        (no length advances), then each position's argmax. Returns
        (logits [B, K, V] f32, tokens [B, K])."""
        logits = forward_verify(self.params, self.cfg, self._verify_tokens[K], self.cache,
                                attn_window=attn_window)
        return logits, torch.argmax(logits, dim=-1)

    def _verify_program_args(self, K: int, attn_window: int):
        """(key, program, warm-up) of the verify program. The warm-up is
        the pass itself: its K/V rows [len, len + K) lie past every
        slot's length, and the pass rewrites them."""
        fn = functools.partial(self._verify_program, K, attn_window)
        return ("verify", self.max_batch, K, attn_window), fn, fn

    def verify(self, tokens: np.ndarray, attn_window: int) -> np.ndarray:
        """One verify pass over tokens [B, K] (host ints) appended at each
        slot's length: writes their K/V, advances no length, and returns
        the greedy token of every position [B, K], read back once (the
        pass's one synchronous readback). Slot KV only."""
        if self.kv_layout != "slot":
            raise ValueError("the speculative verify pass needs kv_layout='slot'")
        self._stage_verify(tokens)
        _, got = self.programs.run(*self._verify_program_args(tokens.shape[1], attn_window))
        self.verify_forwards += 1
        return got.cpu().numpy()

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
