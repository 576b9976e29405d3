"""The work formulas against numbers worked out by hand at MOSS's and
dolly's shapes."""

import pytest

from conftest import ROOT


def _shapes(name):
    from harness import spec

    c = spec.load_cell(ROOT, name)
    return spec.load_arch("dense").Shapes.of(c.model, c.deployment)


def test_moss_weight_bytes():
    from harness import spec

    roofline = spec.load_arch("dense")
    s = _shapes("moss16b-q4bf16.chat-b1")
    # codes k n / 2, then a bf16 scale and a bf16 minimum per 32 rows a column
    assert roofline.weight_bytes(s, 6144, 18432, "bfloat16") == 56623104 + 14155776
    assert roofline.layer_weight_bytes(s) == 70778880 + 23592960 + 94371840 + 94371840
    assert roofline.head_weight_bytes(s) == 328728576 + 82182144
    total = 34 * 283115520 + 410910720
    assert total == 10036838400
    # b1 decode at 1000 cached positions: bytes bound (weights, K/V of 1001)
    kv = 2 * 34 * 24 * 256 * 2 * 1001
    want = (total + kv) / 3.35e12
    assert roofline.step_least_s(s, [(1000, 1)], 1) == pytest.approx(want, rel=1e-12)


def test_dolly_weight_bytes_f32_head():
    from harness import spec

    roofline = spec.load_arch("dense")
    s = _shapes("dolly3b-q4f16hs.serve-chat")
    assert s.head_dtype == "float32" and s.act_dtype == "float16"
    assert roofline.layer_weight_bytes(s) == 12288000 + 4096000 + 16384000 + 16384000
    # f32 scale and minimum: 8 bytes per group a column
    assert roofline.head_weight_bytes(s) == 64358400 + 32179200
    assert 32 * 49152000 + 96537600 == 1669401600


def test_dolly_prefill_is_bound_by_operations():
    from harness import spec

    roofline = spec.load_arch("dense")
    s = _shapes("dolly3b-q4f16hs.serve-chat")
    n = 1500
    params = 2560 * (7680 + 2560 + 10240) + 10240 * 2560
    attn_pos = n * (n + 1) // 2
    flops = 2 * 32 * params * n + 2 * 2560 * 50280 + 4 * 80 * 32 * 32 * attn_pos
    got = roofline.step_least_s(s, [(0, n)], 1)
    assert got == pytest.approx(flops / 989e12, rel=1e-12)
    # against bytes: weights and 1500 positions of K/V written
    nbytes = 1669401600 + 1500 * 2 * 32 * 32 * 80 * 2
    assert flops / 989e12 > nbytes / 3.35e12


def test_products_bound_counts_rows():
    from harness import spec

    roofline = spec.load_arch("dense")
    s = _shapes("dolly3b-q4f16hs.serve-chat")
    b1 = roofline.products_bound_s(s, 1, 1)
    b8 = roofline.products_bound_s(s, 8, 8)
    # at m = 8 the bytes of x and of the outputs grow, the weights do not
    x8 = 32 * (8 * (2560 + 2560 + 2560 + 10240) * 2 + 8 * (7680 + 2560 + 10240 + 2560) * 2)
    head8 = 8 * 2560 * 4 + 8 * 50280 * 4
    assert b8 - b1 == pytest.approx(((x8 + head8) - (x8 + head8) / 8) / 3.35e12, rel=1e-9)
    # a share never passes 1 when the time measured is at least the bound
    from harness.roofline import share

    assert share(b8, b8) == 1.0 and share(b8, 0) is None


def test_k_step_block_least_counts_every_step():
    from harness import readers
    from harness.record import ProgramRun

    s = _shapes("dolly3b-q4f16hs.serve-chat")

    class C:
        shapes = s

    run = ProgramRun(0, ("decode_k", 8, 4, 512), 0.0, 0.0, [(100, 1), (300, 1)], 4, 2)
    from harness import spec

    roofline = spec.load_arch("dense")
    want = sum(roofline.step_least_s(s, [(100 + i, 1), (300 + i, 1)], 2) for i in range(4))
    assert readers.least_s(C, run) == pytest.approx(want)
