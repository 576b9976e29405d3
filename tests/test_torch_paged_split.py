"""Kernel 7's split-KV on the CPU: the split plain version against the JAX
package, and the split plan.

csrc/paged_flash_decode.cu walks a slot's window in splits of
`split_pages(...)` pages, each from an empty softmax state, and its last
split to finish combines the partials in split order. The card runs the
kernel (tests/test_torch_cuda.py); here the plain version with
`pages_per_split` repeats that split and combine, and is held against the
Pallas kernel in interpret mode (one online softmax over the whole
window). Tolerances: 1e-5 with f32 pages and f32 q (the same f32
arithmetic, summed in another order); 2e-2 otherwise, as
tests/test_torch_paged_neox.py holds the unsplit version (with bf16 pages
the probabilities round to bf16 against the split's own running max, not
the window's). Head dims 16, 20 and 32, q in f32/bf16, pages in
f32/bf16/int8, splits of one and of three pages, slot lengths
(pre-advance positions) 0, 1, on a split boundary of each, one past it and
the full window.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.models import paged_cache as jpc
from mlc_llm_tpu_torch.models.convert import tensor_from_numpy
from mlc_llm_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)

PS, WINDOW, HQ, L, P = 8, 4, 4, 2, 32
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a))


# slot lengths (pre-advance positions): 0, 1, the first position of a
# split of one page and one past it, the same for splits of three pages,
# and the last position of the window
LENGTHS = np.array([0, 1, PS, PS + 1, 3 * PS, 3 * PS + 1, WINDOW * PS - 1], np.int32)


@functools.lru_cache(maxsize=None)
def _case(D, qdt, pages):
    """Inputs from a seed, and the JAX kernel's output in interpret mode."""
    rng = np.random.default_rng(D)
    hb = jpc.default_head_block(HQ)
    G = HQ // hb
    shape = (G, L, P, PS, hb * D)
    ks = vs = None
    if pages == "int8":
        kp, vp = (rng.integers(-127, 127, shape).astype(np.int8) for _ in range(2))
        ks = (rng.random((G, L, P, hb, PS)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((G, L, P, PS, hb)) * 0.02 + 0.001).astype(np.float32)
    else:
        kp, vp = (np.asarray(jnp.asarray(rng.standard_normal(shape), JDT[pages]))
                  for _ in range(2))
    lens = LENGTHS
    table = (rng.permutation(P - 1)[:len(lens) * WINDOW] + 1).astype(np.int32)
    table = table.reshape(-1, WINDOW)
    q = np.asarray(jnp.asarray(rng.standard_normal((len(lens), HQ, 1, D)), JDT[qdt]))
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = jpc.paged_flash_decode(j(q), j(kp), j(vp), j(ks), j(vs), j(table), j(lens),
                                  jnp.int32(1), num_pages_window=WINDOW, head_dim=D,
                                  interpret=True)
    return (q, kp, vp, ks, vs, table, lens), np.asarray(want, np.float32)


@pytest.mark.parametrize("pps", [1, 3])
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 20, 32])
def test_split_plain_matches_pallas(D, qdt, pages, pps):
    args, want = _case(D, qdt, pages)
    got = pa.paged_flash_decode_plain(*map(_t, args), 1, num_pages_window=WINDOW, head_dim=D,
                                      pages_per_split=pps)
    assert got.dtype == (torch.float32 if qdt == "float32" else torch.bfloat16)
    tol = 1e-5 if pages == qdt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_empty_splits_weigh_nothing(pps):
    # with f32 pages and q, splits past a slot's length change nothing but
    # f32 rounding: the split walk meets the unsplit one at 1e-6
    args, _ = _case(32, "float32", "float32")
    t = list(map(_t, args))
    whole = pa.paged_flash_decode_plain(*t, 1, num_pages_window=WINDOW, head_dim=32)
    split = pa.paged_flash_decode_plain(*t, 1, num_pages_window=WINDOW, head_dim=32,
                                        pages_per_split=pps)
    torch.testing.assert_close(split, whole, atol=1e-6, rtol=1e-6)


# (window pages, slots, kv-heads, rep, head dim): the registry's serve
# pools (Vicuna-7B, the NeoX 3B, MOSS) at b1 and b8, and GQA shapes
SHAPES = [(np_, b, hkv, rep, d)
          for np_ in (1, 2, 3, 5, 8, 16, 17, 31, 64)
          for b in (1, 3, 8)
          for hkv, rep, d in ((32, 1, 128), (32, 1, 80), (24, 1, 256), (8, 4, 128), (4, 3, 256),
                              (8, 12, 128))]


def test_split_plan_covers_the_window():
    for np_, b, hkv, rep, d in SHAPES:
        pps = pa.split_pages(np_, b, hkv, rep, d)
        nsplit = -(-np_ // pps)
        # no split is empty over the window, and the splits cover it
        assert 1 <= pps <= np_ and (nsplit - 1) * pps < np_ <= nsplit * pps


@pytest.mark.parametrize("hkv,d,b1_pps,b8_pps", [(32, 128, 1, 2), (32, 80, 1, 2),
                                                  (24, 256, 2, 8)])
def test_split_plan_fills_the_card_at_small_batch(hkv, d, b1_pps, b8_pps):
    # the serve pool's 16-page window: a lone long slot splits into one-page
    # splits (two pages at D = 256), b8 into fewer, as the sweep found
    # fastest (scripts/torch_plan_sweep.py; SPLIT_BLOCKS)
    assert pa.split_pages(16, 1, hkv, 1, d) == b1_pps
    assert pa.split_pages(16, 8, hkv, 1, d) == b8_pps
    assert 8 * hkv * -(-16 // b8_pps) >= pa.SPLIT_BLOCKS[16 if d == 256 else 8]


@pytest.mark.parametrize("d,rep,rows", [(128, 1, 1), (128, 2, 2), (128, 3, 4), (128, 4, 4),
                                         (128, 5, 8), (128, 16, 8), (256, 1, 1), (256, 3, 2)])
def test_split_plan_counts_the_kernels_row_blocks(d, rep, rows):
    # the plan's blocks are the kernel's: kv-heads x ceil(rep / rows a
    # block holds) x splits (csrc launch_rows)
    want = max(1, min(64, -(-pa.SPLIT_BLOCKS[16 if d == 256 else 8] // (2 * -(-rep // rows)))))
    assert pa.split_pages(64, 1, 2, rep, d) == -(-64 // want)


def test_split_plan_ignores_lengths():
    # the wrapper's plan is a function of shapes only: slots of any lengths
    # in the same pool get the same split, and no tensor is read for it
    args, _ = _case(16, "bfloat16", "bfloat16")
    q, kp, _, _, _, table, _ = map(_t, args)
    plans = set()
    for lens in ([0] * 7, [31] * 7, [0, 7, 8, 9, 23, 24, 31]):
        lengths = torch.tensor(lens, dtype=torch.int32)
        plans.add(pa.launch_plan(q, kp, table, WINDOW))
        # the plain version under that plan stays finite for every length
        pps = pa.launch_plan(q, kp, table, WINDOW)[0]
        out = pa.paged_flash_decode_plain(q, kp, kp, None, None, table, lengths, 1,
                                          num_pages_window=WINDOW, head_dim=16,
                                          pages_per_split=pps)
        assert torch.isfinite(out.float()).all()
    assert len(plans) == 1


@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_split_plan_does_not_depend_on_the_window(pages):
    # tolerance 0: the plan takes its pages per split from the table's
    # width, so a slot within every window below gets the same splits
    # (the ones past its pages empty) and the same bits, whatever window
    # the batch's longest slot sets: Vicuna-7B's b8 shape (32 kv-heads, D
    # 128), a 16-page table, slots within 4 pages
    rng = np.random.default_rng(7)
    B, H, D, ps, maxp = 8, 32, 128, 8, 16
    hb = jpc.default_head_block(H)
    shape = (H // hb, 1, B * maxp + 1, ps, hb * D)
    ks = vs = None
    if pages == "int8":
        kp, vp = (torch.randint(-127, 128, shape, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((H // hb, 1, B * maxp + 1) + s) * 0.02 + 1e-3
                  for s in ((hb, ps), (ps, hb)))
    else:
        kp, vp = (torch.randn(shape).to(torch.bfloat16) for _ in range(2))
    table = torch.from_numpy(rng.permutation(B * maxp)[:B * maxp] + 1).int().reshape(B, maxp)
    lengths = torch.from_numpy(rng.integers(0, 4 * ps, B)).int()
    q = torch.randn((B, H, 1, D)).to(torch.bfloat16)
    outs, plans = [], []
    for window in (4, 8, 16):
        pps, nsplit = pa.launch_plan(q, kp, table, window)
        plans.append((pps, nsplit))
        outs.append(pa.paged_flash_decode_plain(q, kp, vp, ks, vs, table, lengths, 0,
                                                num_pages_window=window, head_dim=D,
                                                pages_per_split=pps))
    assert plans == [(2, 2), (2, 4), (2, 8)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
