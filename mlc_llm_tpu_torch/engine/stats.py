"""Runtime throughput stats (prefill/decode tok/s).

Mirrors the reference's encode/decode counters and report string
(reference cpp/llm_chat.cc:541-556,999-1004; surfaced by the CLI
`/stats` command, cli_main.cc:185-188).

After ``mlc_llm_tpu/engine/stats.py``, less its ``sample_time`` (nothing
wrote it): the port imports nothing of the JAX package, not even its
pure-Python modules.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RuntimeStats:
    """Tokens and host seconds of prefill and decode.

    ``engine.prefill`` waits for its program, so there ``prefill_time`` is
    the prefill's own. Under the scheduler it is the host's time to
    enqueue an admission's replays, which it does not wait for: the
    encode rate that ``/stats`` and the wire's ``stats`` message report
    from it is then an upper bound."""

    prefill_tokens: int = 0
    prefill_time: float = 0.0
    decode_tokens: int = 0
    decode_time: float = 0.0

    def reset(self) -> None:
        self.prefill_tokens = 0
        self.prefill_time = 0.0
        self.decode_tokens = 0
        self.decode_time = 0.0

    @property
    def prefill_tps(self) -> float:
        return self.prefill_tokens / self.prefill_time if self.prefill_time else 0.0

    @property
    def decode_tps(self) -> float:
        return self.decode_tokens / self.decode_time if self.decode_time else 0.0

    def text(self) -> str:
        # same shape as RuntimeStatsText (llm_chat.cc:541-556)
        return (
            f"encode: {self.prefill_tps:.1f} tok/s, "
            f"decode: {self.decode_tps:.1f} tok/s"
        )
