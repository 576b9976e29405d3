"""Stateful chat session: templating, window shift, streaming, stop logic.

The counterpart of ``mlc_llm_tpu/engine/session.py``, in engine mode
and scheduler mode (the speculative-decoding branch waits for ROADMAP.md
queue 1, item 5):

- incremental prompt assembly: only new turns are tokenized per round
- window-shift long-context policy: when
  total + new_ctx + mean_gen_len >= max_window_size, clear the KV cache
  and re-encode the newest turns until the prompt fills
  shift_fill_factor * max_window_size
- UTF-8-safe streaming and stop-string trimming
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator, List, Optional

from ..conversation import Conversation, get_conversation
from ..models.config import ModelConfig
from ..tokenizer import Tokenizer
from .engine import GenerationConfig, InferenceEngine


@dataclasses.dataclass
class ChatConfig:
    """init_chat parameter surface; defaults are the reference CLI's."""

    temperature: float = 0.7
    top_p: float = 0.95
    max_gen_len: int = 512
    mean_gen_len: int = 128
    max_window_size: int = 768
    shift_fill_factor: float = 0.3
    stream_interval: int = 1
    seed: Optional[int] = None


class ChatSession:
    """One chat session.

    Two backends:
    - engine mode (default): drives InferenceEngine.generate_stream
      directly on engine slot 0 (one session per engine);
    - scheduler mode (pass ``scheduler=``): reserves a persistent slot on
      a ContinuousBatchingScheduler and appends each turn to it through
      the scheduler, so N sessions share one engine and their turns ride
      the same batched decode step.
    """

    def __init__(
        self,
        engine: Optional[InferenceEngine] = None,
        tokenizer: Tokenizer = None,
        cfg: ModelConfig = None,
        chat: ChatConfig = ChatConfig(),
        conv_template: Optional[str] = None,
        scheduler=None,
    ):
        slot = 0
        if scheduler is not None:
            engine = scheduler.engine
            slot = scheduler.reserve_slot()
        self.scheduler = scheduler
        self.engine = engine
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.chat = chat
        self.slot = slot
        self.conv: Conversation = get_conversation(conv_template or cfg.conv_template)
        self.total_len = 0  # tokens currently in the KV cache for this slot

    def close(self) -> None:
        """Release the scheduler slot (scheduler mode)."""
        if self.scheduler is not None:
            self.scheduler.release_slot(self.slot)

    # ------------------------------------------------------------------ utils
    @property
    def stats_text(self) -> str:
        return self.engine.stats.text()

    def reset(self) -> None:
        self.conv.reset()
        self.engine.reset([self.slot])
        self.total_len = 0

    def _encode_prompt(self, text: str, first_chunk: bool) -> List[int]:
        ids = self.tokenizer.encode(text)
        # BOS on every turn, except vicuna_v1.1 after the first one
        if self.cfg.bos_token_id is not None and (
            first_chunk or self.conv.name != "vicuna_v1.1"
        ):
            ids = [self.cfg.bos_token_id] + ids
        return ids

    def _prompt_tokens(self) -> List[int]:
        """Incremental or (window-shifted) full prompt tokens."""
        max_window = min(self.chat.max_window_size, self.engine.max_seq_len)
        mean_gen = min(self.chat.mean_gen_len, max_window // 2)
        if self.total_len > 0:
            new_text = self.conv.get_prompt_unprocessed()
            new_tokens = self._encode_prompt(new_text, first_chunk=False)
            if self.total_len + len(new_tokens) + mean_gen < max_window:
                return new_tokens
        # full (re-)encode, trimming oldest turns to fit the fill target
        self.engine.reset([self.slot])
        self.total_len = 0
        fill = int(self.chat.shift_fill_factor * max_window)
        conv = self.conv
        tokens = self._encode_prompt(conv.get_prompt(), first_chunk=True)
        while (
            len(tokens) + mean_gen >= max_window
            and len(conv.messages) > conv.offset + 2
        ):
            # drop the oldest post-offset user/assistant pair
            del conv.messages[conv.offset : conv.offset + 2]
            conv._cur = 0
            tokens = self._encode_prompt(conv.get_prompt(), first_chunk=True)
            if len(tokens) < fill:
                break
        if len(tokens) + mean_gen >= max_window:
            tokens = tokens[-(max_window - mean_gen) :]
        return tokens

    def _engine_tokens(self, tokens: List[int], gen: GenerationConfig):
        for _, tok in self.engine.generate_stream(
            [tokens], gen, reset=(self.total_len == 0)
        ):
            yield tok

    def _scheduler_tokens(self, tokens: List[int], gen: GenerationConfig):
        out = deque()
        req = self.scheduler.submit(tokens, gen, on_token=out.append, pin_slot=self.slot,
                                    append=self.total_len > 0)
        try:
            while not req.done and self.scheduler.has_work():
                self.scheduler.step()
                while out:
                    yield out.popleft()
            self.scheduler._drain(all_remaining=True)
            while out:
                yield out.popleft()
        finally:
            if not req.done:  # the consumer stopped early (stop string)
                self.scheduler.cancel(req)

    # ------------------------------------------------------------------ chat
    def chat_stream(self, user_text: str) -> Iterator[str]:
        """Yields incremental reply text as it is generated; the full
        reply is recorded in the conversation history at stream end."""
        self.conv.append(self.conv.roles[0], user_text)
        self.conv.append(self.conv.roles[1], None)

        tokens = self._prompt_tokens()
        max_window = min(self.chat.max_window_size, self.engine.max_seq_len)
        gen = GenerationConfig(
            max_new_tokens=max(
                1, min(self.chat.max_gen_len, max_window - self.total_len - len(tokens) - 1)
            ),
            temperature=self.chat.temperature,
            top_p=self.chat.top_p,
            seed=self.chat.seed,
        )

        stop_str = self.conv.stop_str()
        reply_ids: List[int] = []
        emitted_chars = 0
        stopped = False
        final_text = ""
        if self.scheduler is not None:
            source = self._scheduler_tokens(tokens, gen)
        else:
            source = self._engine_tokens(tokens, gen)
        try:
            for tok in source:
                reply_ids.append(tok)
                text = _strip_partial_utf8(self.tokenizer.decode(reply_ids))
                if stop_str:
                    pos = text.find(stop_str)
                    if pos != -1:
                        final_text = text[:pos]
                        stopped = True
                        break
                    # hold back a possible stop-string prefix at the tail
                    safe = len(text) - len(stop_str) + 1
                else:
                    safe = len(text)
                if safe > emitted_chars:
                    yield text[emitted_chars:safe]
                    emitted_chars = safe
        finally:
            source.close()
        if not stopped:
            final_text = _strip_partial_utf8(self.tokenizer.decode(reply_ids))
            if stop_str:
                pos = final_text.find(stop_str)
                if pos != -1:
                    final_text = final_text[:pos]
        if len(final_text) > emitted_chars:
            yield final_text[emitted_chars:]

        self.total_len += len(tokens) + len(reply_ids) + 1
        self.conv.update_last(final_text.strip())

    def ask(self, user_text: str) -> str:
        return "".join(self.chat_stream(user_text))


def _strip_partial_utf8(text: str) -> str:
    # decoders mark incomplete sequences with U+FFFD; crop trailing ones
    return text.rstrip("�")
