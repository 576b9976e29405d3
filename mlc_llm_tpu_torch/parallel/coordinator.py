"""Cross-host continuous-batching coordinator, the counterpart of
``mlc_llm_tpu/parallel/coordinator.py``.

Whole requests are routed between hosts, never activations:

- each host runs its own ContinuousBatchingScheduler over its
  process-local slot range (``multihost.process_local_slots``);
- the coordinator owns admission: least-loaded routing of requests to
  the host schedulers, and aggregate stats.

A peer is a local ContinuousBatchingScheduler or a
``wire.RemoteScheduler`` client of another host's SchedulerServer. The
coordinator routes by load either way (a remote peer's load rides the
wire), drives only the local schedulers (remote hosts drive their own
loops) and gathers every host's stats, over the wire for remote ones.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from ..engine.engine import GenerationConfig, InferenceEngine
from ..engine.scheduler import ContinuousBatchingScheduler, Request
from .multihost import process_local_slots


def local_scheduler(engine: InferenceEngine, seed: int = 0) -> ContinuousBatchingScheduler:
    """This host's scheduler over its process-local slot range."""
    return ContinuousBatchingScheduler(engine, seed=seed,
                                       slots=process_local_slots(engine.max_batch))


class HostCoordinator:
    """Routes requests across per-host schedulers and aggregates stats.

    Peers are local ContinuousBatchingSchedulers and/or
    wire.RemoteScheduler clients (other hosts' TCP front doors)."""

    def __init__(self, schedulers: Sequence):
        if not schedulers:
            raise ValueError("need at least one host scheduler")
        self.schedulers: List = list(schedulers)

    # ------------------------------------------------------------- routing
    @staticmethod
    def _is_remote(sched) -> bool:
        return not hasattr(sched, "step")

    def _load(self, sched) -> int:
        if self._is_remote(sched):
            return sched.load()
        return len(sched.pending) + sched.num_active

    def submit(self, prompt: List[int], gen: GenerationConfig = GenerationConfig(),
               on_token=None) -> Request:
        """Admit one request to the least-loaded host (the first of equals)."""
        sched = min(self.schedulers, key=self._load)
        return sched.submit(prompt, gen, on_token=on_token)

    def submit_many(self, prompts, gen: GenerationConfig = GenerationConfig()) -> List[Request]:
        return [self.submit(p, gen) for p in prompts]

    # ------------------------------------------------------------- driving
    def has_work(self) -> bool:
        return any(s.has_work() for s in self.schedulers)

    def step(self) -> None:
        """One interleaved scheduling round across the LOCAL hosts'
        schedulers (remote hosts drive their own loops server-side)."""
        for s in self.schedulers:
            if not self._is_remote(s) and s.has_work():
                s.step()

    def run(self) -> None:
        while self.has_work():
            self.step()
            if all(self._is_remote(s) or not s.has_work() for s in self.schedulers):
                time.sleep(0.002)  # only remote work left: poll, don't spin
        for s in self.schedulers:
            if self._is_remote(s):
                s.wait_all()
            else:
                s._drain(all_remaining=True)

    # --------------------------------------------------------------- stats
    def _host_stats(self, sched) -> dict:
        if self._is_remote(sched):
            return sched.stats()  # over the wire
        st = sched.engine.stats
        return {"prefill_tokens": st.prefill_tokens, "prefill_time": st.prefill_time,
                "decode_tokens": st.decode_tokens, "decode_time": st.decode_time}

    def stats_text(self) -> str:
        parts = []
        stats = [self._host_stats(s) for s in self.schedulers]
        for i, st in enumerate(stats):
            ptps = st["prefill_tokens"] / st["prefill_time"] if st["prefill_time"] else 0.0
            dtps = st["decode_tokens"] / st["decode_time"] if st["decode_time"] else 0.0
            parts.append(f"host{i}: encode: {ptps:.1f} tok/s, decode: {dtps:.1f} tok/s")
        agg = self.aggregate_throughput(stats)
        parts.append(f"aggregate decode: {agg:.1f} tok/s" if agg else "aggregate: n/a")
        return "\n".join(parts)

    def aggregate_throughput(self, stats=None) -> Optional[float]:
        """Hosts decode concurrently: total decode tokens over the slowest
        host's decode time (None before any decode)."""
        if stats is None:
            stats = [self._host_stats(s) for s in self.schedulers]
        tot_tok = sum(st["decode_tokens"] for st in stats)
        max_t = max((st["decode_time"] for st in stats), default=0.0)
        if max_t <= 0:
            return None
        return tot_tok / max_t
