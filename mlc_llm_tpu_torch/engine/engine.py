"""Single-host inference engine: bucketed prefill, decode/sample loop and
the continuous-batching scheduler's hooks.

The counterpart of ``mlc_llm_tpu/engine/engine.py``. Prefill lengths are
padded to the same static buckets and attention reads a bucketed
window, so the kernels see the same shapes as the reference's programs.

Every program the engine runs is a step program (``engine/programs.py``),
as JAX jits every one: on a CUDA engine each run replays one captured
CUDA graph, keyed as JAX keys its programs on shapes and static
arguments. The keys (``top_k`` joins a key as ``("top_k", k)`` when it is
not the default 64):

- ``("prefill", B, bucket, window, flash)``: ``prefill``, a [B, bucket]
  block at every slot (JAX's ``_prefill``); the chat session, the CLI and
  speculation run it;
- ``("prefill_slots", G, bucket, window, flash)``: admission, a [G,
  bucket] block into G target slots given as a device tensor. G = 1 is
  ``_prefill_slot`` (slot or paged, fresh or append, a chunk, a prefix
  adoption's suffix); G = 2, 4, ... is ``_prefill_slots`` (fresh, slot
  layout), JAX's ``_prefill_slot``, ``_prefill_slot_paged`` and
  ``_prefill_slots``;
- ``("sample", G)``: the first-token sampler over a prefill's [G, V]
  logits (JAX's ``_sample_perslot``);
- ``("decode", B, window)``: one decode step, its forward, the in-graph
  draw of every row and the inactive rows' freeze (``_decode_sample``);
- ``("decode_k", B, K, window)``: K decode steps in one graph, the draws
  at steps + i (``_decode_sample_k``);
- ``("verify", B, K, window)``: the speculative verify pass
  (``engine/speculative.py``): K/V rows [len, len + K) of every slot,
  no length advanced, each position's greedy token.

``flash`` is JAX's static ``prefill_flash``: the block is a reset prefill
(every row from position 0) on the slot layout, so its attention may run
the causal flash kernel over the block itself (``models/transformer.py``).
It is part of the key because a graph captured with the branch would skip
the history if it were replayed for an append of the same bucket and
window. It is set for a reset ``prefill``, a fresh admission and a
grouped one on the slot layout, as JAX's ``engine.py:727`` and its
scheduler's ``prefill_flash=not append`` and ``True`` (``scheduler.py:514,
336``) set it; paged blocks never take it.

A program reads fixed buffers that the engine fills from pinned host
memory before each run (tokens, target slots, starts, seq_lens, the
active mask, seeds, steps, temperatures and top-p; the cache's device
lengths and page table) and reads no host value, so a graph holds it.
The host lengths ``cache.lengths`` stay the source of truth: the engine
advances them after each run. Draws are keyed by (seed, step)
(``ops/sampling.py``), so the streams are the same whether a step runs
alone, inside a K-step block, replayed or eager. Outputs are copied out
before the next run (the shared pool's rule). On the CPU the same
functions run eagerly. ``precompile`` captures every program JAX's
``precompile`` compiles. The decode loop keeps the reference's
pipelining: the next step is enqueued on the device before the previous
step's token is read back.

Tracing: ``engine.trace`` (``engine/trace.py``) holds the engine's spans
(its programs' and its schedulers' too), off until ``trace.start()``.
Always on: the forwards each kind of program ran and the readbacks that
found their result landed or waited for it.

Tensor parallelism: ``mesh`` (a DeviceMesh with a "tp" dimension,
``parallel/sharding.py``) makes the engine one tp rank's: its params are
that rank's shards (``parallel.shard_params``), it allocates only its own
KV (Hkv/tp slot heads; G/tp paged head groups, ``page_head_block``
defaulting so that G is a multiple of tp) and its programs run the
sharded forward. Every rank gathers the full logits and draws the same
tokens: the draws are keyed by (seed, step), so the ranks' streams are
equal by construction. Every rank runs the same calls in the same order
(the collectives pair up). Under "dp" each dp group runs its own engine
over its own requests. An engine whose tp group runs on gloo runs its
programs eagerly (``engine/programs.py``); under NCCL they are captured
with the collectives inside.

KV layouts: ``"slot"`` (slot-contiguous [B, Smax] per slot), ``"paged"``
(one shared page pool + per-slot page tables, ``models/paged_cache.py``)
or ``"auto"`` (paged for int8 KV at batch > 1, slot otherwise: the slot
path dequantizes the whole int8 window before attention, the paged
decode kernel dequantizes inside its dots).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.paged_cache import (
    PageAllocator,
    PrefixCache,
    default_head_block,
    init_paged_kv_cache,
    paged_flash_tp_enabled,
)
from ..models.transformer import (
    forward_block,
    forward_decode,
    forward_verify,
    init_kv_cache,
    tensor_parallel,
    tree_map,
)
from ..ops import resolve_device, synchronize
from ..ops.sampling import counter_uniform, sample_token_perslot
from ..quant.groupwise import QuantizedTensor, pad_quantized_groups
from .programs import StepPrograms
from .stats import RuntimeStats
from .trace import Trace

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
DEFAULT_TOP_K = 64


@dataclasses.dataclass
class GenerationConfig:
    """Per-request generation parameters (the reference CLI's defaults)."""

    max_new_tokens: int = 128
    temperature: float = 0.7
    top_p: float = 0.95
    stop_tokens: Sequence[int] = ()
    seed: Optional[int] = None
    # nucleus-prefilter width; 0 = exact full-vocab top-p
    top_k: int = DEFAULT_TOP_K


def _with_top_k(key: tuple, top_k: int) -> tuple:
    return key if top_k == DEFAULT_TOP_K else key + (("top_k", top_k),)


def _rows(x, n: int, dtype) -> np.ndarray:
    """A host scalar or [n] vector as an [n] array of dtype."""
    return np.broadcast_to(np.asarray(x, dtype), (n,))


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
        mesh=None,
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
        page-granular prefix cache (paged only).

        mesh: a DeviceMesh with a "tp" dimension; params are then this
        rank's shards (see the module doc)."""
        if kv_layout == "auto":
            kv_layout = "paged" if cache_dtype == torch.int8 and max_batch > 1 else "slot"
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"kv_layout must be slot, paged or auto, got {kv_layout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        tp = tensor_parallel(mesh)
        ntp = 1 if tp is None else tp.size
        want = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim // ntp
        if params["layers"]["wqkv"].shape[-1] != want:
            raise ValueError(f"wqkv holds {params['layers']['wqkv'].shape[-1]} columns, "
                             f"{want} expected at tp = {ntp}: pass this rank's shards "
                             "(parallel.shard_params) with a mesh, the full params without")

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
        # forwards run by the decode programs (a K-step block counts K):
        # each launches the paged decode kernel once per layer; and by the
        # prefill programs
        self.decode_forwards = 0
        self.prefill_forwards = 0
        self.verify_forwards = 0
        # readbacks of results: those that found the result already there,
        # and those that waited for the device (generate_stream's and
        # verify's blocking copies, the scheduler's drain)
        self.readbacks_landed = 0
        self.readbacks_blocked = 0
        # the engine's spans (engine/trace.py), off until trace.start()
        self.trace = Trace(self.device)
        self.programs = StepPrograms(
            self.device, eager=tp is not None and dist.get_backend(tp.group) == "gloo",
            trace=self.trace)
        # the programs' fixed input buffers: the decode step's tokens [B,
        # 1], its [active, seed, step] rows and [temperature, top_p] rows;
        # the prefill blocks' tokens by (G, bucket) and [slot, start,
        # seq_len] rows by G; the sampler's logits, [seed, step] and
        # [temperature, top_p] by G; the verify pass's tokens by K
        B = max_batch
        self._step_tokens = self._zeros((B, 1), torch.int64)
        self._step_ints = self._zeros((3, B), torch.int64)
        self._step_floats = self._zeros((2, B), torch.float32)
        self._block_tokens = {}
        self._block_ints = {}
        self._sample_in = {}
        self._verify_tokens = {}
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
            hb = page_head_block or default_head_block(cfg.num_kv_heads // ntp)
            if tp is not None and not paged_flash_tp_enabled(cfg.num_kv_heads // hb,
                                                             cfg.num_heads, mesh):
                raise ValueError(f"head_block {hb}: the pool's head groups do not split over "
                                 f"tp = {ntp}")
            self.cache = init_paged_kv_cache(
                cfg, max_batch, num_pages, page_size, max_pages_per_slot=pages_per_slot,
                dtype=cache_dtype, head_block=hb, device=self.device, tp=ntp)
            if prefix_cache_pages:
                self.prefix_cache = PrefixCache(self.allocator, page_size,
                                                max_pages=prefix_cache_pages)
        elif prefix_cache_pages:
            raise ValueError("prefix_cache_pages requires kv_layout='paged'")
        else:
            self.cache = init_kv_cache(cfg, max_batch, self.max_seq_len, cache_dtype,
                                       device=self.device, tp=ntp)

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _upload(self, dst: torch.Tensor, rows) -> None:
        """Fill the fixed buffer dst with host values (dst's shape) by a
        copy from pinned memory that does not block."""
        host = torch.as_tensor(np.ascontiguousarray(rows), dtype=dst.dtype).reshape(dst.shape)
        if self.device.type == "cuda":
            host = host.pin_memory()
        dst.copy_(host, non_blocking=True)

    def _read_back(self, t: torch.Tensor) -> np.ndarray:
        """t on the host: a blocking copy on the stream, so it waits for
        every program enqueued before it, the ones after t's too. Counts
        whether the stream had run dry (landed) or the host waited
        (blocked)."""
        if self.device.type == "cuda" and not torch.cuda.current_stream(self.device).query():
            self.readbacks_blocked += 1
        else:
            self.readbacks_landed += 1
        with self.trace.span("readback"):
            return t.cpu().numpy()

    # ------------------------------------------------------------ precompile
    def precompile_keys(self, multi_step: Union[int, Sequence[int], None] = None) -> List[tuple]:
        """The programs ``precompile`` captures, in its order: JAX's
        ``precompile`` program for program, at the default top_k. Per
        bucket b at window decode_window(b): the batch prefill, the
        single-slot admission and (slot layout) the grouped admissions;
        the first-token sampler of each G the engine's paths use (1 for
        an admission, the grouped G, max_batch for generate); per decode
        window, the decode step and (multi_step: an int K or a sequence)
        every K-step block. The prefills are the reset and fresh ones
        JAX compiles: flash on the slot layout."""
        B = self.max_batch
        slot = self.kv_layout == "slot"
        # grouped admission (slot layout): the powers of two from 2 to B, as
        # the scheduler rounds a group
        groups = [1 << i for i in range(1, B.bit_length())] if slot else []
        keys = []
        for b in self.buckets:
            w = self.decode_window(b)
            keys += [("prefill", B, b, w, slot), ("prefill_slots", 1, b, w, slot)]
            keys += [("prefill_slots", g, b, w, True) for g in groups]
        keys += [("sample", g) for g in sorted({1, B, *groups})]
        ks = (multi_step,) if isinstance(multi_step, int) else tuple(multi_step or ())
        for w in sorted({self.decode_window(b) for b in self.buckets} | {self.max_seq_len}):
            keys.append(("decode", B, w))
            keys += [("decode_k", B, k, w) for k in ks]
        return keys

    def precompile(self, *, progress: Optional[Callable[[str], None]] = None,
                   multi_step: Union[int, Sequence[int], None] = None) -> int:
        """Capture every program of ``precompile_keys(multi_step)`` ahead
        of serving, one CUDA graph each after its eager warm-up, so that
        no request pays a capture mid-stream. Reports each key through
        `progress` and returns the number captured. A CPU engine captures
        nothing and returns 0. The warm-ups leave the state as they found
        it: every block runs with seq_lens 0 from each slot's length and
        every decode step with all slots inactive, so their junk K/V lies
        at or past every valid length."""
        if self.device.type != "cuda":
            return 0
        keys = self.precompile_keys(multi_step)
        lengths = self.cache.lengths.numpy()
        self._upload(self.cache.lengths_dev, lengths)
        for key in keys:
            if key[0].startswith("prefill"):
                G = key[1]
                self._block_buffers(G, key[2])
                self._upload(self._block_ints[G],
                             np.stack([np.arange(G), lengths[:G], np.zeros(G, np.int64)]))
            if progress is not None:
                progress(" ".join(str(x) for x in key))
            self.programs.capture(*self._program(key))
        return len(keys)

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
        One run of the ("prefill", B, bucket, window, flash) program, flash
        for a reset on the slot layout. Returns last-token logits [B, V]
        f32 on the device (a copy)."""
        B = self.max_batch
        if len(prompts) > B:
            raise ValueError(f"{len(prompts)} prompts for max_batch {B}")
        with self.trace.span("prefill"):
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
                    # push even when the pool runs out mid-loop: earlier
                    # slots' table edits must reach the device or their
                    # writes land in the null page
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
            logits = self._run_block("prefill", toks, np.arange(B), lens_host, seq_lens, window,
                                     reset and self.kv_layout != "paged")
            self.cache.lengths += torch.from_numpy(seq_lens)
            synchronize(self.device)
            self.stats.prefill_time += time.perf_counter() - t0
            self.stats.prefill_tokens += int(sum(lens))
            return logits

    def generate_stream(self, prompts: List[List[int]],
                        gen: GenerationConfig = GenerationConfig(), reset: bool = True):
        """Generator yielding (slot, token) as tokens are read back (one
        decode step behind the device). Slots not in 0..len(prompts)-1
        keep their state frozen. Traced as a ``turn``: its prefill and
        first draw, then a ``step`` per decode step (engine/trace.py)."""
        B = self.max_batch
        n = len(prompts)
        tr = self.trace
        with tr.turn():
            logits = self.prefill(prompts, reset=reset, reserve_tokens=gen.max_new_tokens)

            # per-slot uint32 seeds from gen.seed: slot b's draw at step s is
            # a function of (seeds[b], s) alone, JAX's fold_in(PRNGKey(seed), s)
            base = gen.seed if gen.seed is not None else np.random.randint(0, 2**31 - 1)
            seeds = np.random.SeedSequence(base).generate_state(B).astype(np.int64)
            steps = np.zeros((B,), np.int64)
            temps = np.zeros((B,), np.float32)
            temps[:n] = gen.temperature
            first = self.sample(logits, seeds, steps, temps, gen.top_p, gen.top_k)
            steps[:] = 1

            stop = set(gen.stop_tokens) | set(self.cfg.stop_tokens)
            emitted = [0] * n
            done = np.zeros((n,), bool)
            cur_lens = self.cache.lengths.numpy().copy()
            cur = first
            pending = [first]
            t0 = time.perf_counter()
            n_steps = 0
            max_steps = min(gen.max_new_tokens, int(self.max_seq_len - cur_lens[:n].max()))

            def drain_one():
                tok_host = self._read_back(pending.pop(0))
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
                    with tr.span("client"):
                        yield (i, tk)

            active = np.zeros((B,), bool)
            active[:n] = True
            max_len_host = int(cur_lens[:n].max())
            try:
                for _ in range(max_steps - 1):
                    with tr.span("step"):
                        max_len_host += 1
                        nxt = self._decode_sample(cur[:, None], active, seeds, steps, temps,
                                                  gen.top_p,
                                                  attn_window=self.decode_window(max_len_host + 1),
                                                  top_k=gen.top_k)
                        steps[active] += 1
                        pending.append(nxt)
                        cur = nxt
                        n_steps += 1
                        yield from drain_one()
                    if done.all():
                        break
                    active[:n] = ~done
                while pending:
                    with tr.span("step"):
                        yield from drain_one()
            finally:
                synchronize(self.device)
                self.stats.decode_time += time.perf_counter() - t0
                self.stats.decode_tokens += n_steps * int(n)

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

    # ------------------------------------------------------------ programs
    def _program(self, key: tuple):
        """(key, program, warm-up) of a program key (the module doc's
        list). A program reads its fixed buffers and returns a tuple; its
        warm-up runs it so that it advances nothing and leaves its junk
        K/V at or past every valid length (a block with seq_lens 0, a
        decode step with every slot inactive; a verify pass and the
        sampler are their own warm-up)."""
        kind = key[0]
        top_k = key[-1][1] if isinstance(key[-1], tuple) else DEFAULT_TOP_K
        if kind in ("prefill", "prefill_slots"):
            _, G, S, window, flash = key
            toks, ints = self._block_buffers(G, S)
            slots = None if kind == "prefill" else ints[0]

            def fn():
                return (forward_block(self.params, self.cfg, toks, self.cache, slots, ints[1],
                                      ints[2], attn_window=window, prefill_flash=flash,
                                      mesh=self.mesh),)

            def warm_up():
                staged = ints[2].clone()
                ints[2].zero_()
                fn()
                ints[2].copy_(staged)

            return key, fn, warm_up
        if kind == "sample":
            logits, ints, floats = self._sample_buffers(key[1])

            def fn():
                return (sample_token_perslot(logits, ints[0], ints[1], floats[0], floats[1],
                                             top_k),)

            return key, fn, fn
        if kind == "verify":
            _, B, K, window = key
            toks = self._verify_buffer(K)

            def fn():
                logits = forward_verify(self.params, self.cfg, toks, self.cache,
                                        attn_window=window, mesh=self.mesh)
                return logits, torch.argmax(logits, dim=-1)

            return key, fn, fn
        if kind == "decode":
            K, window = 1, key[2]
        elif kind == "decode_k":
            K, window = key[2], key[3]
        else:
            raise ValueError(f"unknown program key {key!r}")
        fn = self._decode_fn(K, window, top_k, kind == "decode")

        def warm_up():
            staged = self._step_ints[0].clone()
            self._step_ints[0].zero_()
            fn()
            self._step_ints[0].copy_(staged)

        return key, fn, warm_up

    def program_inputs(self, key: tuple) -> tuple:
        """The fixed input buffers program `key` reads besides the cache:
        a block's tokens [G, S] and [slot, start, seq_len] rows [3, G]; the
        sampler's logits [G, V], [seed, step] rows [2, G] and [temperature,
        top_p] rows [2, G]; the verify pass's tokens [B, K]; a decode step's
        or block's tokens [B, 1], [active, seed, step] rows [3, B] and
        [temperature, top_p] rows [2, B]."""
        kind = key[0]
        if kind in ("prefill", "prefill_slots"):
            return self._block_buffers(key[1], key[2])
        if kind == "sample":
            return self._sample_buffers(key[1])
        if kind == "verify":
            return (self._verify_buffer(key[2]),)
        if kind in ("decode", "decode_k"):
            return self._step_tokens, self._step_ints, self._step_floats
        raise ValueError(f"unknown program key {key!r}")

    def _decode_fn(self, K: int, window: int, top_k: int, single: bool):
        """K decode steps on the fixed buffers, what one graph holds: the
        K draws' uniforms at (seed, step + i), computed at once; per step
        the forward, the draw of every row and the inactive rows keeping
        their token; each step's tokens feed the next. Reads no host
        value; advances the device lengths of the active slots by K.
        Returns (logits [B, V] f32, tokens [B]) for a single step, ([K, B]
        tokens,) for a block."""
        active, seeds, steps = self._step_ints
        temps, top_p = self._step_floats

        def fn():
            # the block's K draws' uniforms at once, at (seed, step + i)
            u = counter_uniform(seeds.expand(K, -1), steps + torch.arange(
                K, device=steps.device)[:, None])
            tok, out = self._step_tokens, []
            for i in range(K):
                logits = forward_decode(self.params, self.cfg, tok, self.cache, active,
                                        attn_window=window, mesh=self.mesh)
                drawn = sample_token_perslot(logits, seeds, steps, temps, top_p, top_k,
                                             uniform=u[i])
                out.append(torch.where(active.bool(), drawn, tok[:, 0]))
                tok = out[-1][:, None]
            return (logits, out[0]) if single else (torch.stack(out),)

        return fn

    def _block_buffers(self, G: int, S: int):
        if (G, S) not in self._block_tokens:
            self._block_tokens[(G, S)] = self._zeros((G, S), torch.int64)
        if G not in self._block_ints:
            self._block_ints[G] = self._zeros((3, G), torch.int64)
        return self._block_tokens[(G, S)], self._block_ints[G]

    def _sample_buffers(self, G: int):
        if G not in self._sample_in:
            self._sample_in[G] = (self._zeros((G, self.cfg.vocab_size), torch.float32),
                                  self._zeros((2, G), torch.int64),
                                  self._zeros((2, G), torch.float32))
        return self._sample_in[G]

    def _verify_buffer(self, K: int):
        if K not in self._verify_tokens:
            self._verify_tokens[K] = self._zeros((self.max_batch, K), torch.int64)
        return self._verify_tokens[K]

    def _run_block(self, kind: str, tokens: np.ndarray, slots, starts, seq_lens,
                   window: Optional[int], flash: bool) -> torch.Tensor:
        """Stage a [G, S] block (host tokens, target slots, starts,
        seq_lens) and run its prefill program (flash: every row starts at
        position 0, see the module doc); returns a copy of its logits [G,
        V]. The host lengths are the caller's to advance."""
        G, S = tokens.shape
        window = window or self.max_seq_len
        with self.trace.span("stage"):
            toks, ints = self._block_buffers(G, S)
            self._upload(toks, np.asarray(tokens, np.int64))
            self._upload(ints, np.stack([_rows(slots, G, np.int64), _rows(starts, G, np.int64),
                                         _rows(seq_lens, G, np.int64)]))
        (logits,) = self.programs.run(*self._program((kind, G, S, window, bool(flash))))
        self.prefill_forwards += 1
        return logits.clone()

    def sample(self, logits: torch.Tensor, seeds, steps, temperature, top_p,
               top_k: int = DEFAULT_TOP_K) -> torch.Tensor:
        """Draw one token per row of logits [G, V] (a prefill's) with the
        ("sample", G) program: row g at (seeds[g], steps[g]) under its
        temperature and top-p (host scalars or [G]); T < 1e-6 is argmax.
        Returns [G] tokens on the device (a copy); nothing is read back."""
        G = logits.shape[0]
        with self.trace.span("sample"):
            with self.trace.span("stage"):
                buf, ints, floats = self._sample_buffers(G)
                buf.copy_(logits)
                self._upload(ints, np.stack([_rows(seeds, G, np.int64),
                                             _rows(steps, G, np.int64)]))
                self._upload(floats, np.stack([_rows(temperature, G, np.float32),
                                               _rows(top_p, G, np.float32)]))
            (tok,) = self.programs.run(*self._program(_with_top_k(("sample", G), top_k)))
            return tok.clone()

    # ------------------------------------------------------ scheduler hooks
    def _stage_decode(self, tokens, active: np.ndarray, seeds, steps, temperature,
                      top_p) -> None:
        """Fill the decode programs' inputs: tokens [B, 1] (a device copy,
        in stream order), then the active mask, seeds, steps,
        temperatures (0 on inactive rows), top-p and the host lengths
        (copies from pinned host memory that do not block)."""
        B = self.max_batch
        with self.trace.span("stage"):
            self._step_tokens.copy_(tokens)
            self._upload(self._step_ints, np.stack([active.astype(np.int64),
                                                    _rows(seeds, B, np.int64),
                                                    _rows(steps, B, np.int64)]))
            self._upload(self._step_floats,
                         np.stack([np.where(active, _rows(temperature, B, np.float32), 0.0),
                                   _rows(top_p, B, np.float32)]))
            self._upload(self.cache.lengths_dev, self.cache.lengths.numpy())

    def _decode_sample(self, tokens, active: np.ndarray, seeds, steps, temperature, top_p, *,
                       attn_window: int, top_k: int = DEFAULT_TOP_K):
        """One masked decode step with its draw, the ("decode", B,
        window) program. tokens [B, 1] on the device; active [B] host
        bools: inactive slots do not advance their length and keep their
        token. seeds, steps: [B] host ints, slot b drawing at (seeds[b],
        steps[b]); temperature, top_p: host scalars or [B]. Returns [B]
        next tokens on the device, a copy; nothing is read back."""
        self._stage_decode(tokens, active, seeds, steps, temperature, top_p)
        key = _with_top_k(("decode", self.max_batch, attn_window), top_k)
        _, nxt = self.programs.run(*self._program(key))
        self.decode_forwards += 1
        self.cache.lengths += torch.from_numpy(active.astype(np.int64))
        return nxt.clone()

    def _decode_sample_k(self, tokens, active: np.ndarray, seeds, steps, temperature, top_p, *,
                         attn_window: int, top_k: int = DEFAULT_TOP_K, k_steps: int = 4):
        """k_steps decode steps in one graph, the ("decode_k", B, K,
        window) program, step i drawing at steps + i: the same tokens as
        K single steps, with no host readback inside; returns [K, B]
        tokens (a copy). Stop detection happens at drain time: rows past
        a stop are discarded by the host, and their junk KV sits past the
        slot's valid length."""
        self._stage_decode(tokens, active, seeds, steps, temperature, top_p)
        key = _with_top_k(("decode_k", self.max_batch, k_steps, attn_window), top_k)
        (out,) = self.programs.run(*self._program(key))
        self.decode_forwards += k_steps
        self.cache.lengths += k_steps * torch.from_numpy(active.astype(np.int64))
        return out.clone()

    def verify(self, tokens: np.ndarray, attn_window: int) -> np.ndarray:
        """One verify pass over tokens [B, K] (host ints) appended at each
        slot's length, the ("verify", B, K, window) program: writes their
        K/V, advances no length, and returns the greedy token of every
        position [B, K], read back once (the pass's one synchronous
        readback). Slot KV only."""
        if self.kv_layout != "slot":
            raise ValueError("the speculative verify pass needs kv_layout='slot'")
        B, K = tokens.shape
        with self.trace.span("stage"):
            self._upload(self._verify_buffer(K), np.asarray(tokens, np.int64))
            self._upload(self.cache.lengths_dev, self.cache.lengths.numpy())
        _, got = self.programs.run(*self._program(("verify", B, K, attn_window)))
        self.verify_forwards += 1
        return self._read_back(got)

    def _prefill_slot(self, tokens: np.ndarray, seq_len: int, slot: int, append: bool = False,
                      attn_window: Optional[int] = None):
        """Prefill ONE slot (tokens [1, S]) without touching the other
        slots' KV state: continuous-batching admission, the
        ("prefill_slots", 1, S, window, flash) program with the slot and
        its start staged on the device. append starts from the slot's
        existing length instead of 0 (a session turn, a later chunk, an
        adopted prefix). A fresh row on the slot layout is flash (JAX's
        scheduler passes ``prefill_flash=not append``; its paged program
        has no flash). The slot layout writes the slot's cache rows, the
        paged layout the slot's pages through its page-table row."""
        with self.trace.span("prefill"):
            start = int(self.cache.lengths[slot]) if append else 0
            logits = self._run_block("prefill_slots", tokens, slot, start, seq_len, attn_window,
                                     not append and self.kv_layout == "slot")
            self.cache.lengths[slot] = start + int(seq_len)
            return logits

    def _prefill_slots(self, tokens: np.ndarray, seq_lens: np.ndarray, slots: Sequence[int],
                       attn_window: Optional[int] = None):
        """Prefill G fresh slots in one forward (tokens [G, S]; slot
        layout only, every row starts at position 0, so flash, as JAX's
        scheduler asks): one weight read for all G admissions, the
        ("prefill_slots", G, S, window, True) program writing each row
        straight into its slot's rows."""
        if self.kv_layout != "slot":
            raise ValueError("grouped admission prefill is slot-layout only")
        seq_lens = np.asarray(seq_lens, np.int64)
        with self.trace.span("prefill"):
            logits = self._run_block("prefill_slots", tokens, np.asarray(slots, np.int64), 0,
                                     seq_lens, attn_window, True)
            self.cache.lengths[list(slots)] = torch.from_numpy(seq_lens)
            return logits
