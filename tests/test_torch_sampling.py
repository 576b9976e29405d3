"""The port's sampler against the JAX sampler.

Greedy is exact (argmax, first index on a tie). Sampled streams cannot
match JAX's threefry draws, so the sampled path is held by its support
and its distribution, and by per-slot (seed, step) determinism.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.ops.sampling import sample_token as jsample
from mlc_llm_tpu_torch.ops.sampling import sample_token, sample_token_perslot

torch.set_num_threads(2)


def _logits(seed, shape=(3, 256)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _vec(values, dtype=torch.float32):
    return torch.tensor(values, dtype=dtype)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_matches_jax(seed):
    lg = _logits(seed)
    lg[1, 7] = lg[1, 200] = lg[1].max() + 1.0  # a tie: the first index wins
    want = np.asarray(jsample(jnp.asarray(lg), jax.random.PRNGKey(0), 0.0, 0.95))
    got = sample_token(torch.from_numpy(lg), 0, 0, 0.0, 0.95)
    assert got.tolist() == want.tolist() and got[1] == 7


def test_tiny_top_p_keeps_only_the_top_token():
    lg = torch.from_numpy(_logits(2))
    got = sample_token_perslot(lg, _vec([0, 1, 2], torch.int64), _vec([5, 5, 5], torch.int64),
                               _vec([1.0] * 3), _vec([1e-6] * 3))
    assert torch.equal(got, lg.argmax(-1))


def test_top_k_bounds_the_support():
    lg = torch.from_numpy(_logits(3, (1, 64)))
    top2 = set(torch.topk(lg[0], 2).indices.tolist())
    draws = {int(sample_token(lg, 0, step, temperature=5.0, top_p=1.0, top_k=2)[0])
             for step in range(50)}
    assert draws <= top2 and len(draws) == 2


def test_distribution_follows_softmax():
    n = 4000
    lg = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).expand(n, 4)
    # one row per draw: seed 0 at steps 0..n-1
    got = sample_token_perslot(lg, torch.zeros(n, dtype=torch.int64), torch.arange(n),
                               torch.ones(n), torch.ones(n), top_k=0)
    counts = np.bincount(got.numpy(), minlength=4)
    # 4000 draws: 4 standard errors of a share near 0.5 is ~0.03
    np.testing.assert_allclose(counts / n, torch.softmax(lg[0], -1).numpy(), atol=0.03)


def test_perslot_draws_depend_only_on_own_seed():
    lg = torch.from_numpy(_logits(4, (2, 256)))

    def stream(seeds, rows):
        return [sample_token_perslot(rows, _vec(seeds, torch.int64), _vec([s, s], torch.int64),
                                     _vec([0.9, 0.9]), _vec([0.95, 0.95])).tolist()
                for s in range(5)]

    a = stream([11, 12], lg)
    b = stream([11, 99], torch.stack([lg[0], lg[0] * 0.5]))
    assert [r[0] for r in a] == [r[0] for r in b]
