"""Prompt-lookup speculative decoding (greedy-exact).

The counterpart of ``mlc_llm_tpu/engine/speculative.py``. The drafter
proposes the tokens that followed the most recent earlier occurrence of
the current suffix n-gram in the sequence's own history; one verify pass
at S = K checks a block [t_last, d1 .. d_{K-1}] and keeps a draft token
only when it equals the model's own argmax, so the emitted stream is the
greedy stream of the verify pass's numerics.

The verify pass is a step program of the engine (``engine.verify``): on
the card one CUDA graph per (batch, K, window), captured at the key's
first pass. It writes K/V rows [len, len + K) in place and advances no
length; the host decides acceptance from the [B, K] argmax, read back
once a pass, and advances the host lengths by what the stream consumed
(the next program stages them to the device). Rows written past the
advanced length are junk below a later valid length: every later pass
or step rewrites its own positions before it attends to them.

Exactness: the m = K verify pass and the m = 1 decode step run different
kernel bodies on the card (the tensor-core GEMV against the streaming
one), so their logits can differ in the last bits and an argmax tie on
random weights can break differently. On the card the stream is held
against the no-draft stream (the same passes with a drafter that
proposes nothing); on the CPU both run the same plain versions and the
stream equals plain greedy decode.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch


def rtt_gate_ok(engine, threshold_ms: Optional[float] = None) -> bool:
    """Engage speculation only where the host round trip is small.

    Every verify pass costs one host<->device round trip (the drafter
    needs the verified ids back), while the plain decode loop runs
    pipelined on the device. The gate times a trivial op on the engine's
    device and its readback three times, once per engine, and enables
    speculation when the mean is at most the threshold.
    MLC_SPEC_FORCE=1 overrides; MLC_SPEC_RTT_GATE_MS sets the threshold
    (default 2 ms)."""
    if os.environ.get("MLC_SPEC_FORCE") == "1":
        return True
    cached = getattr(engine, "_spec_rtt_ok", None)
    if cached is not None:
        return cached
    if threshold_ms is None:
        threshold_ms = float(os.environ.get("MLC_SPEC_RTT_GATE_MS", "2.0"))
    x = torch.zeros((), dtype=torch.float32, device=engine.device)
    (x + 1).item()  # first use outside the timed window
    t0 = time.perf_counter()
    for i in range(3):
        (x + i).item()
    rtt_ms = (time.perf_counter() - t0) / 3 * 1e3
    ok = rtt_ms <= threshold_ms
    engine._spec_rtt_ok = ok
    if not ok:
        logging.getLogger("mlc_llm_tpu_torch").info(
            "speculative decoding disabled: host-device RTT %.1f ms > %.1f ms gate (the "
            "pipelined decode loop is faster at this RTT; set MLC_SPEC_FORCE=1 to override)",
            rtt_ms, threshold_ms)
    return ok


class NgramDrafter:
    """Propose continuation tokens by matching the current suffix
    n-gram against the sequence's own history (prompt + generated)."""

    def __init__(self, history: List[int], max_ngram: int = 3):
        self.history = list(history)
        self.max_ngram = max_ngram

    def extend(self, toks: List[int]) -> None:
        self.history.extend(toks)

    def propose(self, k: int) -> List[int]:
        """Up to k draft tokens (possibly fewer / empty)."""
        h = self.history
        for n in range(min(self.max_ngram, len(h) - 1), 0, -1):
            suffix = h[-n:]
            # most recent earlier occurrence of the suffix
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == suffix:
                    out = h[i + n: i + n + k]
                    if out:
                        return out
                    break
        return []


def _make_verify(engine):
    """(verify, advance) of the engine, cached on it: verify(tokens [B,
    K] host ints, attn_window) runs the engine's verify program (one
    graph per (B, K, window) on the card, kept in engine.programs) and
    returns the [B, K] greedy tokens; advance(n) adds n (an int or [B])
    to the host lengths."""
    cached = getattr(engine, "_speculative_programs", None)
    if cached is not None:
        return cached

    def advance(n) -> None:
        engine.cache.lengths += torch.as_tensor(n, dtype=torch.int64)

    engine._speculative_programs = (engine.verify, advance)
    return engine._speculative_programs


def speculative_stream(
    engine,
    prompt: List[int],
    max_new_tokens: int = 128,
    draft_k: int = 8,
    stop_tokens: Optional[set] = None,
    stats: Optional[dict] = None,
    reset: bool = True,
):
    """Greedy generation with prompt-lookup speculation (batch 1),
    yielding tokens as they are emitted.

    draft_k is the static verify width (one program whatever the number
    of drafts a pass carries: short drafts are padded and their tail
    ignored). reset=False appends to the slot's KV state (multi-turn
    chat), as engine.prefill does."""
    assert engine.max_batch == 1, "speculative path is batch-1"
    assert engine.kv_layout == "slot", "speculative path needs slot KV"
    stop = set(stop_tokens or ()) | set(engine.cfg.stop_tokens)
    verify, advance = _make_verify(engine)

    logits = engine.prefill([prompt], reset=reset)
    t_last = int(torch.argmax(logits[0]))
    n_out = 0
    if t_last in stop:
        if stats is not None:
            stats.update(passes=0, accepted_drafts=0, tokens=0)
        return
    t0 = time.perf_counter()
    K = draft_k
    passes = accepted = 0
    try:
        yield t_last
        n_out = 1
        drafter = NgramDrafter(list(prompt) + [t_last])
        # lengths after prefill (t_last not yet fed); append mode starts
        # past the prior turns
        cur_len = int(engine.cache.lengths[0])

        while n_out < max_new_tokens:
            if cur_len + 1 >= engine.max_seq_len:
                break  # window full (plain greedy stops too)
            # near the window edge, shrink to single-token passes (a
            # second S = 1 program) instead of stopping K tokens early
            K_eff = K if cur_len + K < engine.max_seq_len else 1
            drafts = drafter.propose(K_eff - 1) if K_eff > 1 else []
            nfeed = 1 + len(drafts)
            toks = np.zeros((1, K_eff), np.int64)
            toks[0, 0] = t_last
            if drafts:
                toks[0, 1:nfeed] = drafts
            window = engine.decode_window(min(cur_len + K_eff, engine.max_seq_len))
            got = verify(toks, window)[0]  # [K] argmax tokens
            # longest accepted draft prefix
            a = 0
            while a < len(drafts) and got[a] == drafts[a]:
                a += 1
            emitted = list(drafts[:a]) + [int(got[a])]
            passes += 1
            accepted += a
            # What this pass consumes decides the advance. Between passes
            # lengths = prompt + emitted - 1 (the last emitted token is
            # not fed). Terminal lengths follow the plain decode loop:
            #   cap end:  prompt + emitted - 1 (last not fed)
            #   stop end: prompt + emitted + 1 (the plain loop's
            #     dispatch-ahead feeds the stop token itself before the
            #     host sees it)
            m = 0
            hit_stop = False
            for t in emitted:
                if t in stop:
                    hit_stop = True
                    break
                if n_out + m >= max_new_tokens:
                    break
                m += 1
            if hit_stop:
                # the rows of t_last and the m emitted tokens are valid;
                # the stop token must land in the KV too. A stop that was
                # a draft is written at row m + 1; a stop that was the
                # model's own token (got[a]) was never fed: feed it with
                # the S = 1 program, as plain's overshoot step does.
                if m < a:
                    advance(m + 2)
                    cur_len += m + 2
                else:
                    advance(m + 1)
                    feed = np.array([[emitted[m]]], np.int64)
                    verify(feed, engine.decode_window(min(cur_len + m + 2, engine.max_seq_len)))
                    advance(1)
                    cur_len += m + 2
            else:
                advance(m)
                cur_len += m
            for t in emitted[:m]:
                yield t
                n_out += 1
            if hit_stop or n_out >= max_new_tokens:
                break
            drafter.extend(emitted)
            t_last = emitted[-1]
    finally:
        # tok/s bookkeeping as the plain decode loop keeps it (the CLI's
        # /stats line); runs when the consumer abandons the stream too
        engine.stats.decode_time += time.perf_counter() - t0
        engine.stats.decode_tokens += max(0, n_out - 1)
        if stats is not None:
            stats.update(passes=passes, accepted_drafts=accepted, tokens=n_out)


def generate_speculative(
    engine,
    prompt: List[int],
    max_new_tokens: int = 128,
    draft_k: int = 8,
    stop_tokens: Optional[set] = None,
    stats: Optional[dict] = None,
    reset: bool = True,
) -> List[int]:
    """List-returning wrapper over speculative_stream."""
    return list(speculative_stream(
        engine, prompt, max_new_tokens=max_new_tokens, draft_k=draft_k,
        stop_tokens=stop_tokens, stats=stats, reset=reset,
    ))
