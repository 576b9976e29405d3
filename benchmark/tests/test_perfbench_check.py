"""The numbers that decide `correct`, on logits whose error is known."""

import math

import pytest
import torch



def _choices(sigma, n=4000, v=512, seed=0):
    g = torch.Generator().manual_seed(seed)
    ref = torch.randn((n, v), generator=g)
    noisy = ref + sigma * torch.randn((n, v), generator=g)
    return [ref], [noisy.argmax(-1).tolist()]


@pytest.mark.parametrize("sigma", [0.003, 0.01, 0.05])
def test_error_scale_recovers_the_error(sigma):
    from harness import check

    ref, tok = _choices(sigma)
    got = check.error_scale(ref, tok)
    # the error on a best-two margin has sqrt(2) x each logit's spread
    assert got == pytest.approx(math.sqrt(2) * sigma, rel=0.35)


def test_error_scale_is_zero_on_the_references_own_choices():
    from harness import check

    ref, _ = _choices(0.0)
    assert check.error_scale(ref, [ref[0].argmax(-1).tolist()]) == pytest.approx(1e-5)


def test_gaps_and_readings():
    from harness import check

    lg = torch.tensor([[0.0, 1.0, 0.5], [2.0, 0.0, 1.5]])
    r = check.readings([lg], [[1, 2]])
    assert r["max_gap"] == pytest.approx(0.5) and r["mean_gap"] == pytest.approx(0.25)
    ctrl = [torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])]
    assert check.control_tokens(ctrl) == [[2, 0]]
