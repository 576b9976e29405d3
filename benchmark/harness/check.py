"""What decides `correct`: the served greedy tokens against the reference.

Once the window has closed and the program is freed, a sample drawn from
the seed of the greedy requests (or turns) that finished, the one with
the most served tokens always among them, is run through the plain
reference of the configuration's architecture (``arch/<name>.py``) once,
over each cached context with
its served tokens. At every served token the reading is how far the
token's reference logit lies below the reference's best there. A served
token that the reference also ranks first reads 0; rounding can make the
program pick a near tie; a wrong layer, cache or kernel picks tokens far
below the best. Three numbers are read over the sample: the widest gap;
the mean gap over every served position; and the logit error the
choices imply (``error_scale``), the number compared. How often rounding
tips a choice depends on how many near ties the sampled positions hold,
and greedy decoding on random weights falls into short cycles whose
margins differ by an order of magnitude between seeds; so the gaps
swing with the seed as much as with the precision. ``error_scale`` takes
the reference's own margin between its best two logits at each position
and finds, by maximum likelihood, the spread sigma of a Gaussian error on
that margin under which the served choices are likeliest: a position
with margin m picks another token with probability Phi(-m / sigma).
That is the precision of the served path, whatever the margins.

The control: the reference in a lower precision in the program's place,
read at the same positions of the same tokens through the token it puts
first (``control_tokens``); calibrate.py reads it, the runs do not.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def sample(window, seed: int, count: int):
    """The sampled served requests that finished greedy, longest first."""
    done = [s for s in window.served if s.greedy and s.done and s.tokens]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i].tokens), -i))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 7]))
    pick = rng.permutation(rest)[: max(0, count - 1)].tolist()
    return [done[i] for i in [longest] + sorted(pick)]


def segments_of(window, picked) -> Tuple[List[List[int]], List[List[int]], List[List[int]]]:
    """(token segments, wanted positions, served tokens at them): one
    segment per cached context, cut after the last picked token on it."""
    by_seg: Dict[int, list] = {}
    for s in picked:
        by_seg.setdefault(s.segment, []).append(s)
    segs, wanted, tokens = [], [], []
    for seg, group in sorted(by_seg.items()):
        pos, tok = [], []
        for s in group:
            p0 = s.context + s.prompt_len - 1
            pos += range(p0, p0 + len(s.tokens))
            tok += s.tokens
        full = window.segments[seg]
        segs.append(full[: max(pos) + 1])
        wanted.append(pos)
        tokens.append(tok)
    return segs, wanted, tokens


def gaps(logits: Sequence[torch.Tensor], tokens: Sequence[Sequence[int]]) -> torch.Tensor:
    """At every position: the reference's best logit - its logit of the
    token there (all positions of all segments, one vector)."""
    out = []
    for lg, tok in zip(logits, tokens):
        t = torch.as_tensor(list(tok), dtype=torch.long, device=lg.device)
        out.append(lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out).float() if out else torch.zeros(0)


def readings(logits, tokens) -> dict:
    """The numbers read from the served (or the control's) tokens."""
    g = gaps(logits, tokens)
    if g.numel() == 0:
        return {"max_gap": None, "mean_gap": None, "error_scale": None}
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "error_scale": error_scale(logits, tokens)}


SIGMAS = torch.logspace(-5, 1, 301)


def error_scale(logits: Sequence[torch.Tensor], tokens: Sequence[Sequence[int]]) -> float:
    """The sigma (logit units, on a grid from 1e-5 to 10) of a Gaussian
    error on the reference's best-two margin that makes the tokens'
    choices likeliest: each position picks a token other than the
    reference's first with probability Phi(-margin / sigma)."""
    m, flip = [], []
    for lg, tok in zip(logits, tokens):
        top2 = lg.topk(2, dim=-1)
        t = torch.as_tensor(list(tok), dtype=torch.long, device=lg.device)
        m.append((top2.values[:, 0] - top2.values[:, 1]).float().cpu())
        flip.append((t != top2.indices[:, 0]).float().cpu())
    if not m:
        return None
    m, flip = torch.cat(m).double(), torch.cat(flip).double()
    sig = SIGMAS.double()[:, None]
    p = torch.special.ndtr(-m[None, :] / sig).clamp(1e-12, 1 - 1e-12)
    ll = (flip * p.log() + (1 - flip) * (1 - p).log()).sum(dim=1)
    return float(SIGMAS[int(ll.argmax())])


def control_tokens(ctrl: Sequence[torch.Tensor]) -> list:
    """The token the control ranks first at every position."""
    return [c.argmax(dim=-1).tolist() for c in ctrl]


def served_count(tokens: Sequence[Sequence[int]]) -> int:
    return sum(len(t) for t in tokens)


def diagnose(ref, ctrl, tokens) -> dict:
    """What the calibration prints beside the readings: the reference's
    margin between its best two logits at the served positions (quantiles),
    at how many positions the program's token and the control's are not
    the reference's first, the spread of the control's logit error, and
    how many distinct tokens were served."""
    r = torch.cat(list(ref))
    c = torch.cat(list(ctrl))
    served = torch.as_tensor([t for tok in tokens for t in tok], device=r.device)
    top2 = r.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).float()
    q = torch.quantile(margin, torch.tensor([0.01, 0.1, 0.5], device=margin.device)).tolist()
    best = r.argmax(-1)
    return {"margin_p1": q[0], "margin_p10": q[1], "margin_p50": q[2],
            "positions": int(r.shape[0]),
            "program_flips": int((served != best).sum()),
            "control_flips": int((c.argmax(-1) != best).sum()),
            "control_err_std": float((c - r).std()), "logit_std": float(r.std()),
            "distinct_served": int(served.unique().numel())}
