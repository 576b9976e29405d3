"""The dense architecture (``arch/dense.py``) reads what the harness read
before its block-specific code moved there: the same draws, the same
port parameter tree, the same reference logits in f32 and in both lower
precisions, and the same work count at the full published widths.

``golden_dense.json`` holds the readings of the code before the move:
sha256 digests (dtype, shape and bytes) of every tree leaf and logits
tensor at the tiny size of ``conftest.tiny_cell``, on a one-thread CPU
run of PyTorch 2.13, and the work count's floats as they were printed.
"""

import hashlib
import json
import os

import pytest
import torch

from conftest import ROOT, tiny_cell

CELLS = ["moss16b-q4bf16.chat-b1", "dolly3b-q4f16hs.serve-chat"]
with open(os.path.join(os.path.dirname(__file__), "golden_dense.json")) as _f:
    GOLDEN = json.load(_f)
SEED = GOLDEN["seed"]
ROWS = {
    "decode_b1": [[1000, 1]],
    "decode_b8": [[c, 1] for c in (31, 100, 257, 511, 640, 1023, 1500, 2000)],
    "prefill": [[0, 1500]],
    "prefill_two": [[0, 300], [0, 700]],
    "append": [[512, 64]],
}
KSTEP = [[100, 1], [300, 1], [47, 1], [1990, 1]]
PRODUCTS = [[1, 1], [8, 8], [1, 0], [128, 0], [2048, 0], [8 * 1024, 0]]


def digest(t):
    t = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


def tree(params, prefix=""):
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(tree(v, name + "."))
        elif hasattr(v, "data") and hasattr(v, "scale") and hasattr(v, "spec"):
            out[name + ".data"] = digest(v.data)
            out[name + ".scale"] = digest(v.scale)
            out[name + ".zero"] = None if v.zero is None else digest(v.zero)
            out[name + ".meta"] = f"{v.spec!r} {tuple(v.shape)}"
        else:
            out[name] = digest(v)
    return out


def _dense():
    from harness import spec

    return spec.load_arch("dense")


@pytest.mark.parametrize("name", CELLS)
def test_parameter_tree_is_the_same(name):
    cell = tiny_cell(name)
    assert cell.arch is _dense()
    _, params = cell.arch.build_params(cell.model, cell.deployment, SEED, "cpu")
    assert tree(params) == GOLDEN["trees"][name]


@pytest.mark.parametrize("precision", ["f32", "fp8", "bf16"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_logits_are_the_same(name, precision):
    cell = tiny_cell(name)
    g = torch.Generator().manual_seed(7)
    a = torch.randint(0, 256, (48,), generator=g).tolist()
    b = torch.randint(0, 256, (21,), generator=g).tolist()
    wanted = [list(range(0, 48, 3)) + [47], list(range(21))]
    got = cell.arch.Reference(cell.model, cell.deployment, SEED, "cpu", precision).logits(
        [a, b], wanted)
    assert [digest(t) for t in got] == GOLDEN["logits"][name][precision]


@pytest.mark.parametrize("name", CELLS)
def test_draws_without_an_index_are_the_same(name):
    from harness import weights

    dense = _dense()
    model = tiny_cell(name).model
    lv = dense.leaves(model)
    got = {f"{leaf}.{layer}": digest(weights.draw(lv[leaf], SEED, layer, "cpu"))
           for leaf in dense.BIG for layer in lv[leaf].layers}
    got["embed"] = digest(weights.draw(lv["embed"], SEED, -1, "cpu"))
    got["lm_head"] = digest(weights.draw(lv["lm_head"], SEED, -1, "cpu"))
    for k, v in dense.small_leaves(model, SEED, "cpu").items():
        got["small." + k] = digest(v)
    assert got == GOLDEN["draws"][name]


def test_indexed_draws_are_fixed_and_independent_of_order():
    from harness import weights

    leaf = weights.Leaf("experts.w_in", 64, 48, 0.05, layers=(1, 2), count=4)
    keys = [(layer, e) for layer in leaf.layers for e in range(leaf.count)]
    first = {(l, e): weights.draw(leaf, SEED, l, "cpu", e) for l, e in keys}
    again = {(l, e): weights.draw(leaf, SEED, l, "cpu", e) for l, e in reversed(keys)}
    assert all(torch.equal(first[k], again[k]) for k in keys)
    # every (layer, index) draws its own matrix, none the unindexed one
    plain = weights.draw(leaf, SEED, 1, "cpu")
    flat = [first[k] for k in keys] + [plain]
    assert all(not torch.equal(x, y) for i, x in enumerate(flat) for y in flat[i + 1:])
    assert weights.leaf_seed(SEED, leaf.name, 1, 0) != weights.leaf_seed(SEED, leaf.name, 1)


@pytest.mark.parametrize("name", CELLS)
def test_work_count_is_the_same_at_full_width(name):
    from harness import spec

    full = spec.load_cell(ROOT, name)
    s = full.arch.work(full.model, full.deployment)
    want = GOLDEN["roofline"][name]
    for key, rows in ROWS.items():
        assert s.step_least_s([tuple(x) for x in rows], len(rows)) == want["step." + key], key
    assert [s.step_least_s([(c + i, n) for c, n in KSTEP], len(KSTEP))
            for i in range(4)] == want["step.kstep"]
    for m, hm in PRODUCTS:
        assert s.products_bound_s(m, hm) == want[f"products.{m}.{hm}"], (m, hm)
