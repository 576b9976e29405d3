"""On-device sampling: greedy below T=1e-6, else temperature + nucleus
(top-p) with a top-k prefilter, drawn by inverse CDF from a counter-based
uniform.

The counterpart of ``mlc_llm_tpu/ops/sampling.py``. A row's draw is a
function of its (seed, step) alone, as JAX keys it with
``fold_in(PRNGKey(seed), step)``: the uniform is Philox-4x32-10 (Salmon
et al., SC'11) of the counter (step, 0, 0, 0) under the key (seed, 0),
written in plain torch integer ops on [B] int64 tensors from 16-bit limbs,
so that no int64 product overflows. A request's stream is therefore the
same whatever its row and whatever else shares the batch, and every op
takes device tensors of fixed shape, so the sampler runs inside a
captured CUDA graph (the engine's decode programs and its first-token
program). The draws are not JAX's threefry draws. Sampling is not a TPU
kernel: one version serves the CPU and the card.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
# Philox-4x32 multipliers and Weyl key increments (Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
GREEDY_T = 1e-6  # temperature below which a row is argmax


def philox4x32(counter, key, rounds: int = 10):
    """Philox-4x32 of counter [4, ...] under key [2, ...] (int64 tensors
    of uint32 values); returns [4, ...]. The state is kept as the two
    multiplied words (c0, c2) and the two others reversed, (c3, c1), and
    both products of a round are one product of 16-bit limbs, [2 limbs of
    a] x [2 limbs of M] (each below 2**32: no int64 product overflows), so
    a round is 15 small kernels. The constants are made on the counter's
    device by arithmetic (no host copy), so a CUDA graph can hold the
    call."""
    dev = counter.device
    lanes = key.dim() - 1
    two = torch.arange(2, device=dev, dtype=torch.int64).reshape((2,) + (1,) * lanes)
    mult = two * (_M1 - _M0) + _M0                              # (M0, M1)
    m_limbs = torch.stack((mult >> 16, mult & 0xFFFF))[None]    # [1, 2, 2, ...]
    shift = 16 * (1 - two[:, None])                             # a's limbs: >> 16, >> 0
    r = torch.arange(rounds, device=dev, dtype=torch.int64).reshape((rounds,) + (1,) * (lanes + 1))
    keys = (key + r * (two * (_W1 - _W0) + _W0)) & _MASK      # [rounds, 2, ...]
    mul, other_r = counter[0::2], counter[1::2].flip(0)         # (c0, c2), (c3, c1)
    for i in range(rounds):
        prod = ((mul[None] >> shift) & 0xFFFF)[:, None] * m_limbs  # [a limb, M limb, 2, ...]
        mid = prod[0, 1] + prod[1, 0]
        low = prod[1, 1] + ((mid & 0xFFFF) << 16)
        hi = prod[0, 0] + (mid >> 16) + (low >> 32)             # < 2**32: no mask
        # (c0, c2) <- (hi1 ^ c1 ^ k0, hi0 ^ c3 ^ k1); (c1, c3) <- (lo1, lo0)
        mul, other_r = (hi ^ other_r).flip(0) ^ keys[i], low & _MASK
    return torch.stack((mul[0], other_r[1], mul[1], other_r[0]))


def counter_uniform(seeds, steps):
    """f32 uniforms in [0, 1) keyed by (seed, step): 24 bits of
    Philox-4x32-10's first word. seeds, steps: integer tensors of one
    shape ([B], or [K, B] for a K-step block's draws at once)."""
    seeds = seeds.to(torch.int64) & _MASK
    steps = steps.to(torch.int64) & _MASK
    zero = torch.zeros_like(steps)
    word = philox4x32(torch.stack((steps, zero, zero, zero)), torch.stack((seeds, zero)))[0]
    return (word >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_token_perslot(logits, seeds, steps, temperature, top_p, top_k: int = 64,
                         uniform=None):
    """Per-row sampling, what the graphs hold. logits [B, V]; seeds,
    steps [B] integer tensors; temperature, top_p [B] f32 tensors, all on
    the logits' device. A row with T < 1e-6 is argmax (first index on a
    tie, as jnp.argmax). Every other row keeps the smallest
    descending-probability prefix whose mass reaches top_p (the crossing
    token is kept; at least the top one), top_k > 0 prefiltering with
    topk while the probabilities stay those of the full softmax, and
    picks by inverse CDF at counter_uniform(seed, step) (or at `uniform`
    [B], those values computed ahead: a K-step block draws all K rows'
    at once)."""
    logits = logits.float()
    scaled = logits / temperature.clamp(min=GREEDY_T)[:, None]
    V = scaled.shape[-1]
    if top_k and top_k < V:
        vals, idx = torch.topk(scaled, top_k)
    else:
        vals, idx = torch.sort(scaled, descending=True)
    probs = torch.exp(vals - torch.logsumexp(scaled, dim=-1, keepdim=True))
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    kept = torch.where(keep, torch.exp(vals - vals[:, :1]), torch.zeros_like(vals))
    cdf = torch.cumsum(kept, dim=-1)
    if uniform is None:
        uniform = counter_uniform(seeds, steps)
    target = uniform * cdf[:, -1]
    # the first kept entry whose cdf passes the target
    choice = torch.minimum((cdf <= target[:, None]).sum(-1), keep.sum(-1) - 1).clamp(min=0)
    drawn = idx.gather(1, choice[:, None])[:, 0]
    return torch.where(temperature < GREEDY_T, torch.argmax(logits, dim=-1), drawn)


def sample_token(logits, seed: int = 0, step: int = 0, temperature: float = 0.7,
                 top_p: float = 0.95, top_k: int = 64):
    """[B, V] logits -> [B] long tokens, every row under one (seed, step)
    and one temperature and top-p (host scalars)."""
    B, dev = logits.shape[0], logits.device

    def full(v, dtype):
        return torch.full((B,), v, dtype=dtype, device=dev)

    return sample_token_perslot(logits, full(seed, torch.int64), full(step, torch.int64),
                                full(temperature, torch.float32), full(top_p, torch.float32),
                                top_k)
