"""Continuous-batching scheduler.

The counterpart of ``mlc_llm_tpu/engine/scheduler.py``: N engine slots
share one batched decode step, requests are admitted into free slots
through a single-slot prefill that leaves other slots' KV untouched (or
a grouped prefill of several fresh same-bucket requests, slot layout),
and finished slots are recycled mid-flight. It covers FIFO page
backpressure on the paged pool, pinned and append (session) requests,
the admission clamps, chunked prefill, the prefix cache,
dispatch-ahead (``decode_ahead``), static and adaptive ``multi_step``
blocks, the dispatch budget and the (slot, request-id) drain.

Decode runs for ALL slots every step (inactive slots masked). Per-request
temperature/top_p ride as [B] host vectors; each request samples from its
own ``torch.Generator`` seeded from its seed, so its stream depends only
on its seed and draw count. A decode result is read back without
blocking: a copy into pinned host memory is started with
``non_blocking=True`` and a ``torch.cuda.Event`` recorded after it; the
result has "landed" when the event has completed (always, on the CPU).

Speculative decoding (``speculative_k``) is not ported yet (ROADMAP.md
queue 1, item 5) and raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..ops.sampling import sample_token_perslot
from .engine import GenerationConfig, InferenceEngine


@dataclasses.dataclass
class Request:
    id: int
    prompt: List[int]
    gen: GenerationConfig
    on_token: Optional[Callable[[int], None]] = None
    # pin_slot: admit only into this (reserved) slot; append: extend the
    # slot's existing KV state instead of starting at 0 (scheduler-backed
    # multi-turn ChatSessions)
    pin_slot: Optional[int] = None
    append: bool = False
    # filled by the scheduler
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    seed: int = 0  # resolved uint32 sampling seed (from gen.seed or the scheduler)
    generator: Optional[torch.Generator] = None  # this request's draws
    sampled: int = 0  # tokens sampled so far
    start_len: int = 0  # KV tokens already in the slot before this prompt
    pf_pos: int = 0  # prompt tokens already prefilled (chunked admission)
    # prefix-cache adoption: tokens known to precede req.prompt in the
    # slot (req.prompt is trimmed to the un-cached suffix)
    prefix_tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


class _Readback:
    """A device tensor's copy to the host, started without blocking."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def landed(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ContinuousBatchingScheduler:
    def __init__(self, engine: InferenceEngine, seed: int = 0, slots=None,
                 prefill_chunk: Optional[int] = None,
                 speculative_k: Optional[int] = None,
                 decode_ahead: int = 1,
                 multi_step=None):
        """slots: engine slots this scheduler owns (default: all).

        prefill_chunk: admit long prompts in chunks of this many tokens
        (one of the engine's prefill buckets), ONE chunk per step, so
        active slots keep decoding between chunks. None = whole-prompt
        admission.

        multi_step: K decode steps per dispatch (an int), or "auto" /
        "auto:K" for the adaptive block size (_choose_k, default max 8).
        Stop detection and max_new_tokens lag up to K-1 tokens inside a
        block (the drain discards post-stop rows); it engages only for
        transient batches with K rows of window headroom. Token streams
        equal the single-step scheduler's.

        decode_ahead: decode steps kept in flight before the scheduler
        blocks on the oldest readback; stop detection lags as many
        tokens (the (slot, request-id) drain discards them).

        speculative_k: not ported yet; raises NotImplementedError."""
        if speculative_k:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP.md queue 1, item 5)")
        self.engine = engine
        self.slots = list(slots) if slots is not None else list(range(engine.max_batch))
        if prefill_chunk is not None and prefill_chunk not in engine.buckets:
            raise ValueError(f"prefill_chunk {prefill_chunk} must be one of the "
                             f"engine's prefill buckets {engine.buckets}")
        self.prefill_chunk = prefill_chunk
        self.decode_ahead = max(1, int(decode_ahead))
        self.adaptive_multi_step = False
        if isinstance(multi_step, str):
            self.adaptive_multi_step = True
            self.multi_step = int(multi_step.split(":", 1)[1]) if ":" in multi_step else 8
        else:
            self.multi_step = int(multi_step) if multi_step else None
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self._prefilling: Dict[int, Request] = {}  # slot -> mid-chunk request
        self._ids = itertools.count()
        self._seed_rng = np.random.default_rng(seed)
        self._reserved: set = set()  # slots pinned to sessions
        self._pending_tokens: Deque[_Readback] = deque()
        # decode rows per pending entry (K for a [K, B] block, 1 for a
        # single step, 0 for a first-token entry): the dispatch budget
        # sums it to know how many rows are in flight
        self._pending_rows: Deque[int] = deque()
        self._pending_slots: Deque = deque()
        self._first_token: Dict[int, torch.Tensor] = {}  # slot -> first token [1]
        self._cur_tokens: Optional[torch.Tensor] = None  # [B, 1] on the device

    # ------------------------------------------------------------------ API
    def submit(self, prompt: List[int], gen: GenerationConfig = GenerationConfig(),
               on_token: Optional[Callable[[int], None]] = None,
               pin_slot: Optional[int] = None, append: bool = False) -> Request:
        seed = int(np.random.SeedSequence(gen.seed).generate_state(1)[0]
                   if gen.seed is not None
                   else self._seed_rng.integers(0, 2**32, dtype=np.uint32))
        req = Request(
            id=next(self._ids), prompt=list(prompt), gen=gen, on_token=on_token,
            pin_slot=pin_slot, append=append, submitted_at=time.perf_counter(), seed=seed,
            generator=torch.Generator(device=self.engine.device).manual_seed(seed))
        self.pending.append(req)
        return req

    def reserve_slot(self) -> int:
        """Reserve a slot for a session: it is never handed to other
        requests and keeps its KV state across that session's turns."""
        for s in self.slots:
            if s not in self._reserved:
                self._reserved.add(s)
                return s
        raise RuntimeError("no free slot to reserve")

    def release_slot(self, slot: int) -> None:
        self._reserved.discard(slot)
        if self.engine.allocator is not None and slot not in self.active:
            self.engine.free_slot_pages(slot)

    def cancel(self, req: Request) -> None:
        """Stop a request; its slot stops decoding next step."""
        if not req.done:
            self._finish(req)
        try:
            self.pending.remove(req)
        except ValueError:
            pass

    @property
    def num_active(self) -> int:
        return len(self.active)

    def has_work(self) -> bool:
        return bool(self.pending or self.active or self._prefilling or self._pending_tokens)

    def run(self) -> None:
        """Drive until all submitted requests complete."""
        while self.has_work():
            self.step()
        self._drain(all_remaining=True)

    # ----------------------------------------------------------------- steps
    def _free_slots(self) -> List[int]:
        return [s for s in self.slots
                if s not in self.active and s not in self._prefilling
                and s not in self._reserved]

    def _clamp(self, req: Request, limit: int) -> None:
        if len(req.prompt) >= limit:
            # keep the newest end so prompt + generation fit the window
            keep = max(1, limit - req.gen.max_new_tokens - 1)
            req.prompt = req.prompt[-keep:]

    def _admit_group(self) -> None:
        """Admit a FIFO prefix of groupable fresh requests through ONE
        grouped prefill (engine._prefill_slots): transient, slot layout,
        whole-prompt, same padded bucket and top_k. The scan stops at the
        first non-groupable request so admission order is kept; the
        group size rounds down to a power of two and the overflow returns
        to the queue head."""
        eng = self.engine
        if eng.kv_layout != "slot" or eng.prefix_cache is not None or len(self.pending) < 2:
            return
        free = deque(self._free_slots())
        group: List[tuple] = []
        bucket = top_k = None
        while self.pending and free and len(group) < len(self.slots):
            req = self.pending[0]
            if req.pin_slot is not None or req.append or req.start_len:
                break
            prompt = req.prompt
            limit = eng.max_seq_len
            if len(prompt) >= limit:
                prompt = prompt[-max(1, limit - req.gen.max_new_tokens - 1):]
            if self.prefill_chunk is not None and len(prompt) > self.prefill_chunk:
                break  # chunked admission stays on the single path
            fit = max((b for b in eng.buckets if b <= limit), default=None)
            if fit is None:
                break
            if len(prompt) > fit:
                prompt = prompt[-fit:]
            b = eng.bucket_for(len(prompt))
            if bucket is None:
                bucket, top_k = b, req.gen.top_k
            elif b != bucket or req.gen.top_k != top_k:
                break
            req.prompt = prompt
            self.pending.popleft()
            group.append((req, free.popleft()))
        if len(group) < 2:
            for req, _ in reversed(group):
                self.pending.appendleft(req)
            return
        G = 1 << (len(group).bit_length() - 1)
        for req, _ in reversed(group[G:]):
            self.pending.appendleft(req)
        group = group[:G]
        toks = np.zeros((G, bucket), np.int64)
        lens = np.zeros((G,), np.int64)
        for g, (req, slot) in enumerate(group):
            toks[g, : len(req.prompt)] = req.prompt
            lens[g] = len(req.prompt)
            req.slot = slot
        t0 = time.perf_counter()
        logits = eng._prefill_slots(toks, lens, [s for _, s in group],
                                    attn_window=eng.decode_window(bucket))
        # the same first draw per request as the single path
        firsts = self._sample_first(logits, [r for r, _ in group], top_k)
        eng.stats.prefill_time += time.perf_counter() - t0
        eng.stats.prefill_tokens += int(lens.sum())
        for g, (req, slot) in enumerate(group):
            req.sampled = 1
            self.active[slot] = req
            self._first_token[slot] = firsts[g:g + 1]

    def _sample_first(self, logits, reqs: List[Request], top_k: int):
        return sample_token_perslot(
            logits, [r.generator for r in reqs],
            np.array([r.gen.temperature for r in reqs], np.float32),
            np.array([r.gen.top_p for r in reqs], np.float32), top_k)

    def _admit(self) -> None:
        self._admit_group()
        free = deque(self._free_slots())
        deferred: List[Request] = []
        blocked = False  # a transient hit page backpressure this round
        while self.pending:
            req = self.pending.popleft()
            if blocked and req.pin_slot is None:
                # FIFO page fairness among transients once one is
                # page-starved; pinned requests are still tried (they may
                # need no new pages)
                deferred.append(req)
                continue
            if req.pin_slot is not None:
                if req.pin_slot in self.active or req.pin_slot in self._prefilling:
                    deferred.append(req)  # session slot still busy
                    continue
                slot = req.pin_slot
            elif free:
                slot = free.popleft()
            else:
                # no free slot for this transient: keep scanning, a pinned
                # request behind it may target an idle reserved slot
                deferred.append(req)
                continue
            if not self._admit_one(req, slot):
                deferred.append(req)  # paged-KV backpressure
                blocked = True
                if req.pin_slot is None:
                    free.appendleft(slot)
                continue
        deferred.extend(self.pending)
        self.pending = deque(deferred)

    def _admit_one(self, req: Request, slot: int) -> bool:
        """Admit req into slot. Returns False (no side effects beyond
        prompt clamping) when the paged-KV pool lacks pages."""
        eng = self.engine
        if req.append:
            req.start_len = int(eng.cache.lengths[slot])
        limit = eng.max_seq_len - req.start_len
        self._clamp(req, limit)
        # chunked admission (remainder-first segmentation) can admit any
        # prompt < limit; it needs room for a full chunk after the history
        chunked = (self.prefill_chunk is not None and len(req.prompt) > self.prefill_chunk
                   and limit > self.prefill_chunk)
        if not chunked:
            # whole-prompt admission: the PADDED bucket must fit, or the
            # slot cache's clamped write would shift it over valid KV
            fit = max((b for b in eng.buckets if b <= limit), default=None)
            if fit is None:
                raise ValueError(
                    f"slot history ({req.start_len} tokens) leaves no room for any "
                    f"prefill bucket (max_seq_len {eng.max_seq_len}); shift or reset the "
                    "session window first")
            if len(req.prompt) > fit:
                req.prompt = req.prompt[-fit:]
        if eng.allocator is not None:
            if not req.append:
                eng.free_slot_pages(slot)  # recycle a previous tenant's pages
            total = min(req.start_len + len(req.prompt) + req.gen.max_new_tokens + 1,
                        eng.max_seq_len)
            shared, shared_len = [], 0
            if not req.append and eng.prefix_cache is not None:
                shared, shared_len = eng.prefix_cache.lookup(req.prompt)
            want = -(-total // eng.page_size)
            while True:
                need = max(0, want - len(eng._slot_pages[slot]) - len(shared))
                if eng.allocator.can_alloc(need):
                    break
                # pool pressure: shed cached prefixes before deferring,
                # then look up again (eviction may free the looked-up pages)
                if eng.prefix_cache is None or not eng.prefix_cache.evict(1):
                    return False
                if shared_len:
                    shared, shared_len = eng.prefix_cache.lookup(req.prompt)
            if shared_len:
                eng.adopt_shared_pages(slot, shared)
                eng.set_slot_length(slot, shared_len)
                req.start_len = shared_len
                req.prefix_tokens = req.prompt[:shared_len]
                req.prompt = req.prompt[shared_len:]  # suffix only
                chunked = (self.prefill_chunk is not None
                           and len(req.prompt) > self.prefill_chunk
                           and (eng.max_seq_len - req.start_len) > self.prefill_chunk)
            eng.assign_pages(slot, eng.pages_needed(slot, total))
        req.slot = slot
        if chunked:
            req.pf_pos = 0
            self._prefilling[slot] = req
            self._prefill_chunk_step(req, slot)
        else:
            self._prefill_segment(req, slot, req.prompt, pos=0, final=True)
        return True

    def _prefill_segment(self, req: Request, slot: int, seg, pos: int, final: bool) -> None:
        """Prefill seg (= req.prompt[pos : pos+len(seg)]) into slot; on
        the final segment, sample the first token and move the request
        to the decoding set."""
        eng = self.engine
        bucket = eng.bucket_for(len(seg))
        toks = np.zeros((1, bucket), np.int64)
        toks[0, : len(seg)] = seg
        # append-like whenever the slot already holds valid KV below the
        # segment: a session append, a later chunk, or an adopted prefix
        append = req.append or pos > 0 or bool(req.prefix_tokens)
        t0 = time.perf_counter()
        logits = eng._prefill_slot(
            toks, len(seg), slot, append,
            attn_window=eng.decode_window(min(req.start_len + pos + bucket, eng.max_seq_len)))
        eng.stats.prefill_time += time.perf_counter() - t0
        eng.stats.prefill_tokens += len(seg)
        req.pf_pos = pos + len(seg)
        if not final:
            return
        first = self._sample_first(logits, [req], req.gen.top_k)
        req.sampled = 1
        self._prefilling.pop(slot, None)
        self.active[slot] = req
        self._first_token[slot] = first
        if not req.append and eng.prefix_cache is not None:
            # the slot now holds valid KV for the whole prompt from 0
            eng.prefix_cache.insert(req.prefix_tokens + req.prompt, eng._slot_pages[slot])

    def _prefill_chunk_step(self, req: Request, slot: int) -> None:
        """Advance one segment of a mid-admission request. Remainder-FIRST
        segmentation: the first segment carries len(prompt) % chunk
        tokens and every later one is an exact chunk, so only the first
        is padded and its bucket (<= chunk) always fits."""
        chunk = self.prefill_chunk
        pos = req.pf_pos
        rem = len(req.prompt) % chunk
        seg = req.prompt[:rem] if pos == 0 and rem else req.prompt[pos:pos + chunk]
        self._prefill_segment(req, slot, seg, pos=pos, final=pos + len(seg) >= len(req.prompt))

    def _choose_k(self) -> Optional[int]:
        """Adaptive multi-step block size: full K when requests are
        pending (saturation), K scaled by slot occupancy (rounded down to
        a power of two) at >= 3/4 occupancy, single-step below."""
        K = self.multi_step
        if not K:
            return None
        if not self.adaptive_multi_step:
            return K
        n, S = len(self.active), len(self.slots)
        if self.pending:
            return K
        if 4 * n >= 3 * S:
            k = (K * n) // S
            p = 1
            while p * 2 <= k:
                p *= 2
            return p if p > 1 else None
        return None

    def _multi_step_ready(self, K: Optional[int] = None) -> bool:
        K = K or self.multi_step
        if not K or K <= 1 or not self.active:
            return False
        if self._reserved or self._prefilling:
            return False
        # lengths run ahead of the host counters by the in-flight blocks;
        # every active slot needs headroom for all of them
        ahead_rows = (len(self._pending_tokens) + 1) * K
        for req in self.active.values():
            if req.pin_slot is not None or req.append:
                return False
            cur = req.start_len + len(req.prompt) + len(req.output)
            if cur + ahead_rows >= self.engine.max_seq_len - 1:
                return False
        return True

    def _decode_dispatch(self, k_steps: Optional[int] = None) -> None:
        eng = self.engine
        B = eng.max_batch
        active = np.zeros((B,), bool)
        temp = np.zeros((B,), np.float32)
        topp = np.ones((B,), np.float32)
        gens: List[Optional[torch.Generator]] = [None] * B
        owners = []
        top_k = 64
        for slot, req in self.active.items():
            active[slot] = True
            temp[slot] = req.gen.temperature
            topp[slot] = req.gen.top_p
            gens[slot] = req.generator
            req.sampled += k_steps or 1
            owners.append((slot, req.id))
            # exact sampling (top_k=0) wins; else the widest prefilter
            top_k = 0 if (top_k == 0 or req.gen.top_k == 0) else max(top_k, req.gen.top_k)
        max_len = max((r.start_len + len(r.prompt) + len(r.output) + 2
                       for r in self.active.values()), default=2)
        if k_steps:
            nxt = eng._decode_sample_k(self._cur_tokens, active, gens, temp, topp,
                                       attn_window=eng.decode_window(max_len + k_steps),
                                       top_k=top_k, k_steps=k_steps)  # [K, B]
            last = nxt[-1]
        else:
            nxt = eng._decode_sample(self._cur_tokens, active, gens, temp, topp,
                                     attn_window=eng.decode_window(max_len), top_k=top_k)
            last = nxt
        # start the device->host copy now; the drain reads it later
        self._pending_tokens.append(_Readback(nxt))
        self._pending_slots.append(owners)
        self._pending_rows.append(k_steps or 1)
        self._cur_tokens = last[:, None]

    def step(self) -> None:
        """One scheduler iteration: admit, advance chunked prefills by
        ONE chunk each, decode-dispatch, drain."""
        # snapshot BEFORE admission: a request admitted this step already
        # ran its first chunk inside _admit_one
        continuing = list(self._prefilling.items())
        self._admit()
        for slot, req in continuing:
            if self._prefilling.get(slot) is req:
                self._prefill_chunk_step(req, slot)
        if not self.active:
            self._drain(all_remaining=True)
            return
        self._sync_first_tokens()
        t0 = time.perf_counter()
        k = self._choose_k()
        # dispatch budget: a length-capped request can use only
        # max_new_tokens - emitted - in-flight more rows; session requests
        # get +1 (their last token's KV row must be written for the next
        # turn). Without the cap, dispatch-ahead keeps issuing dead rows
        # while a wave of requests finishes.
        inflight = sum(self._pending_rows)
        max_useful = max(
            (r.gen.max_new_tokens - len(r.output) - inflight
             + (1 if (r.pin_slot is not None or r.append) else 0)
             for r in self.active.values()),
            default=0)
        if max_useful <= 0:
            # everything still needed is in flight: flush it
            self._drain(all_remaining=True)
            self.engine.stats.decode_time += time.perf_counter() - t0
            return
        ms = k if (k and k > 1 and self._multi_step_ready(k)) else None
        if ms and ms > max_useful:
            ms = 1 << (max_useful.bit_length() - 1)
            if ms <= 1:
                ms = None
        self._decode_dispatch(k_steps=ms)
        self._drain()
        self.engine.stats.decode_time += time.perf_counter() - t0
        self.engine.stats.decode_tokens += len(self.active) * (ms or 1)

    # ------------------------------------------------------- token plumbing
    def _sync_first_tokens(self) -> None:
        """Merge prefill-sampled first tokens into the device-resident
        current-token vector (on the device, no readback); their host
        emission rides the pending FIFO like any decode token, so a
        request's first token always comes before its decode tokens."""
        eng = self.engine
        if self._cur_tokens is None:
            self._cur_tokens = torch.zeros((eng.max_batch, 1), dtype=torch.int64,
                                           device=eng.device)
        if not self._first_token:
            return
        # a fresh tensor: the old one may alias a pending readback
        cur = self._cur_tokens.clone()
        for slot, first in self._first_token.items():
            cur[slot, 0] = first[0]
            self._pending_tokens.append(_Readback(first))
            self._pending_slots.append(("first", slot, self.active[slot].id))
            self._pending_rows.append(0)
        self._cur_tokens = cur
        self._first_token.clear()

    def _emit(self, req: Request, tok: int) -> bool:
        """Record a token; returns True if the request just finished."""
        stop = set(req.gen.stop_tokens) | set(self.engine.cfg.stop_tokens)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        if tok in stop:
            self._finish(req)
            return True
        req.output.append(tok)
        if req.on_token is not None:
            req.on_token(tok)
        if len(req.output) >= req.gen.max_new_tokens or (
                req.start_len + len(req.prompt) + len(req.output)
                >= self.engine.max_seq_len - 1):
            self._finish(req)
            return True
        return False

    def _finish(self, req: Request) -> None:
        req.done = True
        req.finished_at = time.perf_counter()
        owned = False
        if req.slot is not None:
            if self._prefilling.get(req.slot) is req:
                del self._prefilling[req.slot]  # cancelled mid-admission
                owned = True
            if self.active.get(req.slot) is req:
                del self.active[req.slot]
                owned = True
        # reserved (session) slots keep their pages for the next turn
        if owned and self.engine.allocator is not None and req.slot not in self._reserved:
            self.engine.free_slot_pages(req.slot)

    def _drain(self, all_remaining: bool = False) -> None:
        """Read back one (or all) pending results: beyond the dispatch-
        ahead depth, or already landed. Tokens are matched by (slot,
        request-id), so a slot recycled mid-lag never delivers a stale
        token to its new occupant."""
        while self._pending_tokens and (
                all_remaining or len(self._pending_tokens) > self.decode_ahead
                or self._pending_tokens[0].landed()):
            toks = self._pending_tokens.popleft().numpy()
            owners = self._pending_slots.popleft()
            self._pending_rows.popleft()
            if isinstance(owners, tuple) and owners[0] == "first":
                _, slot, req_id = owners
                req = self.active.get(slot)
                if req is not None and not req.done and req.id == req_id:
                    self._emit(req, int(toks.reshape(-1)[0]))
                continue
            rows = toks[None, :] if toks.ndim == 1 else toks  # [K, B]
            for row in rows:
                for slot, req_id in owners:
                    req = self.active.get(slot)
                    if req is None or req.done or req.id != req_id:
                        continue  # post-stop / post-recycle rows are dropped
                    self._emit(req, int(row[slot]))
