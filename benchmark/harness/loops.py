"""The measured window: a closed chat loop or an open loop of requests.

Both time every token on the host clock as the program hands it to the
client's callback, and keep what the correctness check needs: the tokens
each cached context was built from and the tokens served on it.

Chat (one user, b1): the calls ``ChatSession`` makes on the engine, at the
token level. A session's first turn resets the slot; each later turn
appends the last answer token and the user's turn; when the cached
context, the new tokens and the mean answer would reach the window,
the slot is reset and the newest turns are prefilled again until they
fill ``shift_fill`` of it (MLC-LLM's window shift). An answer is capped at
``max_gen`` and at what the window leaves.

Open: requests are submitted to the continuous-batching scheduler when
they fall due, and the scheduler is stepped in between, as the server's
drive loop does; each request is timed from its due time, so a stall
delays every request queued behind it. After the window closes the loop
runs on, with arrivals, until every request due in the window has ended
(at most ``grace_s``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from harness import program
from harness.record import now


# what a traced window of each loop must have recorded through the
# harness's wrappers (harness/record.py): the host spans, and the program
# kinds that ran with their work staged; a hook that recorded nothing
# means the program no longer calls what the harness wraps
SPANS = {
    "chat": {"spans": ("admit", "sample", "dispatch", "generator"),
             "runs": (("prefill",), ("decode", "decode_k"))},
    "open": {"spans": ("admit", "sample", "dispatch", "drain", "scheduler"),
             "runs": (("prefill_slots",), ("decode", "decode_k"))},
}


@dataclasses.dataclass
class Served:
    """One request or turn as the client saw it."""

    due: float                 # when it was due (open) or sent (chat)
    prompt_len: int
    context: int               # cached tokens before its prompt
    asked: int                 # tokens asked for
    greedy: bool
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    submitted: Optional[float] = None
    done: bool = False
    error: Optional[str] = None
    segment: int = -1          # which cached context (chat) it was served on
    measured: bool = True      # due inside the window
    req: object = None         # the scheduler's Request (open loop)

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None


@dataclasses.dataclass
class Window:
    start: float
    end: float
    served: List[Served]
    segments: Dict[int, List[int]]   # segment id -> the tokens fed into it
    late_s: float = 0.0              # the largest lateness of a submission
    closed_at: float = 0.0


def run_chat(engine, mix: dict, sessions, seconds: float, rec, tracer) -> Window:
    W = min(mix["max_window"], engine.max_seq_len)
    mean_gen = min(mix["mean_gen"], W // 2)
    fill = int(mix["shift_fill"] * W)
    served: List[Served] = []
    segments: Dict[int, List[int]] = {}
    seg = -1
    start = now()
    win = Window(start, start + seconds, served, segments)
    rec.wrap(engine, "prefill", "admit")
    rec.wrap(engine, "sample", "sample")
    rec.wrap(engine, "_decode_sample", "dispatch")
    tracer.start_at = win.end - tracer.min_s
    for turns in sessions:
        kv: List[int] = []
        pairs: List[List[int]] = []
        for turn in turns:
            if not kv:
                tokens, reset = list(turn.user), True
            else:
                tokens, reset = [pairs[-1][-1]] + turn.user, False
                if len(kv) + len(tokens) + mean_gen >= W:
                    tokens, reset = list(turn.user), True
                    for p in reversed(pairs):
                        if len(tokens) >= fill:
                            break
                        tokens = p + tokens
                    if len(tokens) + mean_gen >= W:
                        tokens = tokens[-(W - mean_gen):]
            if reset:
                kv = []
                seg += 1
                segments[seg] = []
            cap = W - len(kv) - len(tokens) - 1
            asked = max(1, min(turn.answer, mix["max_gen"], cap))
            t0 = now()
            if t0 >= win.end:
                return _close(win)
            s = Served(due=t0, prompt_len=len(tokens), context=len(kv), asked=asked,
                       greedy=turn.greedy, submitted=t0, segment=seg)
            served.append(s)
            gen = program.generation(asked, turn.temperature, turn.top_p, turn.seed)
            stream = engine.generate_stream([tokens], gen, reset=reset)
            cut = False
            try:
                with rec.span("generator"):
                    for _, tok in stream:
                        t = now()
                        s.times.append(t)
                        s.tokens.append(tok)
                        tracer.tick(t, rec)
                        if t >= win.end:
                            cut = True
                            s.measured = False  # cut by the window's end, not failed
                            break
            except Exception as e:  # noqa: BLE001 - a failed turn is counted, not hidden
                s.error = repr(e)
                cut = True
            finally:
                stream.close()
            s.done = not cut and len(s.tokens) == asked
            segments[seg].extend(tokens + s.tokens[:-1])
            kv = kv + tokens + s.tokens[:-1]
            pairs.append(turn.user + s.tokens)
            if cut:
                return _close(win)
    return _close(win)


def _close(win: Window) -> Window:
    win.closed_at = now()
    return win


def run_open(engine, sched, mix: dict, reqs, seconds: float, rec, tracer) -> Window:
    grace = float(mix.get("grace_s", 60.0))
    served: List[Served] = []
    origin = now()
    start = origin + float(mix["preroll_s"])
    win = Window(start, start + seconds, served, {})
    tracer.start_at = win.end - tracer.min_s
    rec.wrap(engine, "_prefill_slot", "admit")
    rec.wrap(engine, "sample", "sample")
    rec.wrap(engine, "_decode_sample", "dispatch")
    rec.wrap(engine, "_decode_sample_k", "dispatch")
    rec.wrap(sched, "_drain", "drain")
    pending = []  # measured requests not yet ended
    i = 0
    n = len(reqs)
    while True:
        t = now()
        while i < n and start + reqs[i].due <= t:
            r = reqs[i]
            due = start + r.due
            s = Served(due=due, prompt_len=len(r.prompt), context=0, asked=r.max_new,
                       greedy=r.greedy, measured=win.start <= due < win.end)
            s.segment = len(win.segments)
            win.segments[s.segment] = list(r.prompt)

            def on_token(tok, s=s):
                s.times.append(now())
                s.tokens.append(tok)

            try:
                s.req = sched.submit(r.prompt, program.generation(r.max_new, r.temperature,
                                                                  r.top_p, r.seed),
                                     on_token=on_token)
            except Exception as e:  # noqa: BLE001
                s.error = repr(e)
            s.submitted = now()
            win.late_s = max(win.late_s, s.submitted - due)
            served.append(s)
            if s.measured:
                pending.append(s)
            i += 1
        pending = [s for s in pending if not _ended(s)]
        tracer.tick(t, rec)
        if t >= win.end and (not pending or t >= win.end + grace) and not tracer.running:
            break
        if sched.has_work():
            try:
                with rec.span("scheduler"):
                    sched.step()
            except Exception as e:  # noqa: BLE001 - every open request fails with the step
                for s in served:
                    if not _ended(s):
                        s.error = repr(e)
                break
        elif i < n:
            with rec.span("wait"):
                time.sleep(max(0.0, start + reqs[i].due - now()))
        elif t >= win.end:
            break
    for s in served:
        s.done = _ended(s) and s.error is None
        win.segments[s.segment].extend(s.tokens[:-1])
    tracer.stop()
    return _close(win)


def _ended(s: Served) -> bool:
    return s.error is not None or (s.req is not None and s.req.done)
