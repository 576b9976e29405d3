"""On-device sampling: greedy below T=1e-6, else temperature + nucleus
(top-p) with a top-k prefilter.

The counterpart of ``mlc_llm_tpu/ops/sampling.py``. Randomness comes
from explicit ``torch.Generator``s (one per slot), so a request's draws
depend only on its own seed and draw count; they are not the JAX
package's threefry draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def sample_top_p(logits, generator, temperature: float, top_p: float, top_k: int = 64):
    """Nucleus sampling of ONE row. logits: [V] f32; returns a 0-d long.
    Keeps the smallest descending-probability prefix whose mass reaches
    top_p (the crossing token is kept); top_k > 0 prefilters with topk
    while the probabilities stay those of the full softmax."""
    scaled = logits.float() / max(float(temperature), 1e-6)
    V = scaled.shape[-1]
    if top_k and top_k < V:
        vals, idx = torch.topk(scaled, top_k)
    else:
        vals, idx = torch.sort(scaled, descending=True)
    probs = torch.exp(vals - torch.logsumexp(scaled, dim=-1))
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    masked = torch.where(keep, vals, torch.full_like(vals, -float("inf")))
    choice = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)
    return idx[choice[0]]


def sample_token(logits, generator=None, temperature: float = 0.7,
                 top_p: float = 0.95, top_k: int = 64):
    """[B, V] logits -> [B] long tokens; greedy (argmax, first index on a
    tie as jnp.argmax) when temperature < 1e-6."""
    if temperature < 1e-6:
        return torch.argmax(logits.float(), dim=-1)
    return torch.stack([sample_top_p(row, generator, temperature, top_p, top_k)
                        for row in logits])


def sample_token_perslot(logits, generators: Sequence[Optional[torch.Generator]],
                         temperature, top_p, top_k: int = 64):
    """Per-slot sampling for the continuous-batching decode step.

    temperature and top_p are host scalars or [B] host vectors (as the
    JAX package's [B] parameters). A row with T < 1e-6 is argmax and
    draws nothing; every other row b draws from generators[b] only, so a
    request's stream depends on its own seed and draw count, whatever
    else shares the batch. Rows are written into the argmax vector on
    the device: no host readback."""
    B = logits.shape[0]
    temps = np.broadcast_to(np.asarray(temperature, np.float64), (B,))
    topps = np.broadcast_to(np.asarray(top_p, np.float64), (B,))
    out = torch.argmax(logits.float(), dim=-1)
    for b in np.nonzero(temps >= 1e-6)[0]:
        out[b] = sample_top_p(logits[b], generators[b], float(temps[b]), float(topps[b]),
                              top_k)
    return out
