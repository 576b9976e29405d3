"""The one traffic generator: a mix's data file in, a seeded schedule out.

A mix (``traffic/<name>.json``) is parameters only. ``loop`` says who sends:

- ``"open"``: independent users; requests are due on a Poisson schedule at
  ``rate_rps`` whether or not earlier ones have finished. Arrivals start
  ``preroll_s`` before the window so that it opens on a loaded system.
- ``"chat"``: one user at a time (closed loop): sessions of turns, each
  turn sent when the previous answer has ended.

Lengths are drawn from ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` or ``{"dist": "uniform", "min", "max"}``. Every seed gets the same
multiset of lengths, gaps and greedy flags (the distribution's quantiles
at (i + 1/2) / n, clipped to [min, max]) in its own order, and its own
token ids (uniform over the vocabulary) and sampling seeds: so seeds
change which request is which, not how much work a run holds.

Open loop: the gaps (the exponential's quantile set, scaled so that each
stretch holds exactly rate x its length requests) and the lengths are
each put in a free seeded permutation of their own. The gaps in a run
are then exchangeable, as a Poisson stream's are: short gaps cluster
into bursts by chance, and the number due in a few seconds spreads as
a Poisson count does (tests/test_perfbench_traffic.py), while every
seed's window holds the same requests. Chat (closed loop): the turns'
lengths are dealt in blocks (``deal_block`` turns): the sorted set is
cut into that many strata and each block takes one value of every
stratum, in a seeded order, so that every stretch of a few turns holds a
representative mix of prefill and decode.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List

import numpy as np

_NORMAL = statistics.NormalDist()


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, stream]))


def quantile_set(dist: dict, n: int) -> np.ndarray:
    """n values of dist at its quantiles (i + 1/2) / n, clipped and rounded
    to whole tokens (ascending)."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([_NORMAL.inv_cdf(p) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def dealt(values: np.ndarray, block: int, rng: np.random.Generator) -> np.ndarray:
    """values (any order) in a seeded order in which each run of `block`
    consecutive entries holds one value of each of `block` strata of the
    sorted values (the last blocks one fewer when block does not divide)."""
    v = np.sort(np.asarray(values))
    n = len(v)
    k = -(-n // block)  # blocks
    members = [[] for _ in range(k)]
    for s in range(0, n, k):
        stratum = v[s:s + k]
        for val, b in zip(stratum, rng.permutation(k)[:len(stratum)]):
            members[b].append(val)
    return np.concatenate([rng.permutation(np.array(m, dtype=v.dtype)) for m in members])


def exponential_gaps(mean: float, n: int) -> np.ndarray:
    """n gaps at the exponential distribution's quantiles (i + 1/2) / n."""
    u = (np.arange(n) + 0.5) / n
    return -mean * np.log1p(-u)


def _flags(share: float, n: int) -> np.ndarray:
    k = int(round(share * n))
    return np.arange(n) < k


@dataclasses.dataclass
class Request:
    """One open-loop request; due: seconds from the window's start."""

    index: int
    due: float
    prompt: List[int]
    max_new: int
    temperature: float
    top_p: float
    seed: int

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclasses.dataclass
class Turn:
    user: List[int]
    answer: int  # tokens the turn asks for (before the window's cap)
    temperature: float
    top_p: float
    seed: int

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def open_schedule(mix: dict, seed: int, seconds: float, vocab: int) -> List[Request]:
    """The requests due from -preroll_s until tail_s past the window's end,
    in three stretches (before, the window, after), each with exactly
    rate x its length requests, whose gaps (the exponential's quantile
    set, scaled to fill the stretch) and lengths are freely permuted."""
    rate = float(mix["rate_rps"])
    samp = mix["sampling"]
    order = _rng(seed, 1)
    ids = _rng(seed, 2)
    reqs: List[Request] = []
    start = -float(mix["preroll_s"])
    for length in (float(mix["preroll_s"]), float(seconds), float(mix.get("tail_s", 10.0))):
        n = max(1, int(round(rate * length)))
        gaps = exponential_gaps(1.0, n)
        gaps = order.permutation(gaps * (length / gaps.sum()))
        due = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        prompts = order.permutation(quantile_set(mix["prompt_tokens"], n))
        outputs = order.permutation(quantile_set(mix["output_tokens"], n))
        greedy = order.permutation(_flags(samp.get("greedy_share", 0.0), n))
        for i in range(n):
            reqs.append(Request(
                index=len(reqs), due=float(due[i]),
                prompt=ids.integers(0, vocab, int(prompts[i])).tolist(),
                max_new=int(outputs[i]),
                temperature=0.0 if greedy[i] else float(samp["temperature"]),
                top_p=float(samp["top_p"]), seed=int(ids.integers(0, 2**31))))
        start += length
    return reqs


def chat_schedule(mix: dict, seed: int, vocab: int) -> List[List[Turn]]:
    """A pool of sessions, more than a window consumes: each a list of
    turns, the first carrying the session's opening prompt."""
    order = _rng(seed, 1)
    n_sess = int(mix["pool_sessions"])
    blk = int(mix["deal_block"])
    sblk = max(2, blk // 2)  # sessions: a block of them spans about blk turns or more
    lo, hi = mix["turns_per_session"]["min"], mix["turns_per_session"]["max"]
    per = dealt(quantile_set({"dist": "uniform", "min": lo, "max": hi}, n_sess), sblk, order)
    n_turns = int(per.sum())
    firsts = dealt(quantile_set(mix["first_turn_tokens"], n_sess), sblk, order)
    users = dealt(quantile_set(mix["user_turn_tokens"], n_turns - n_sess), blk, order)
    answers = dealt(quantile_set(mix["answer_tokens"], n_turns), blk, order)
    samp = mix["sampling"]
    greedy = dealt(_flags(samp.get("greedy_share", 0.0), n_turns), blk, order)
    ids = _rng(seed, 2)
    sessions, t, u = [], 0, 0
    for s in range(n_sess):
        turns = []
        for j in range(int(per[s])):
            if j == 0:
                n = int(firsts[s])
            else:
                n = int(users[u])
                u += 1
            turns.append(Turn(user=ids.integers(0, vocab, n).tolist(), answer=int(answers[t]),
                              temperature=0.0 if greedy[t] else float(samp["temperature"]),
                              top_p=float(samp["top_p"]), seed=int(ids.integers(0, 2**31))))
            t += 1
        sessions.append(turns)
    return sessions
