"""The port's launch-plan tuner (``mlc_llm_tpu_torch/tune.py``) and the
plan table that the kernel wrappers read (``ops/dequant_matmul.py``
``launch_plan``), on the CPU: the shapes against JAX's tuner, the table's
round trip and provenance, the reader's precedence over the time models
and its card-name gate, the wrappers reading the table (meta tensors
stand in for the card), the plans with no table equal to the time
models' (the parent's plans), and the sweep refusing to run without a
card. The sweep itself runs on the card (chip_smoke.py, its tune phase).
"""

import json

import pytest
import torch

from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.tune import model_shapes as jmodel_shapes
from mlc_llm_tpu_torch import tune
from mlc_llm_tpu_torch.models import get_config
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.quant import pad_quantized_groups, quantize, resolve_spec

CARD = "NVIDIA H100 80GB HBM3"
HEADER = {"card": CARD, "power_limit": "700.00 W", "torch": "x", "cuda": "y"}
# (kernel, format, compute dtype, m, stored K, N) of main-path calls
CALLS = [("gemv_qs", "qsplit", torch.bfloat16, 1, 4096, 22016),
         ("gemv_qs", "qsplit", torch.bfloat16, 8, 4096, 12288),
         ("gemv_qs", "qsplit", torch.float32, 3, 2560, 10240),
         ("gemm_qs", "qsplit", torch.bfloat16, 128, 4096, 22016),
         ("gemm_qs", "qsplit", torch.bfloat16, 2048, 11008, 4096),
         ("gemm_qs", "qsplit", torch.float32, 128, 2560, 7680),
         ("gemv_gp", "pair", torch.float32, 1, 2560, 10240),
         ("gemv_gp", "hsplit", torch.float16, 8, 2560, 50432),
         ("gemm_pairs", "hsplit", torch.float16, 128, 2560, 10240),
         ("gemm_pairs", "pair", torch.float32, 2048, 2560, 10240),
         ("gemv_gp3", "int3_u16", torch.bfloat16, 2, 4160, 22016),
         ("gemm_plane", "int3_u16", torch.float16, 8, 4160, 4096),
         ("gemm_plane", "int3_u32", torch.bfloat16, 128, 4160, 22016),
         ("gemm_plane", "fp4_u32", torch.bfloat16, 2048, 4096, 22016),
         ("gemm_plane", "int8_i8", torch.float16, 128, 4096, 22016)]


@pytest.fixture
def table(tmp_path):
    """A scratch table made the one launch_plan reads; the committed path
    (no table) is read again after the test."""
    path = str(tmp_path / "tuned_plans.json")
    yield path
    dm.load_tuned_plans()


@pytest.mark.parametrize("model", ["vicuna-v1-7b", "RedPajama-INCITE-Chat-3B-v1", "dolly-v2-3b",
                                   "moss-moon-003-sft", "tiny-llama"])
def test_model_shapes_match_jax(model):
    assert tune.model_shapes(get_config(model)) == jmodel_shapes(jget_config(model))


def _parent_plan(kernel, fmt, dtype, m, K, N):
    """The plan each wrapper computed before the table existed."""
    f32 = dtype == torch.float32
    if kernel == "gemv_qs":
        if m >= 2 and not f32:
            return dm.gemm_tiles(m, N, K // dm.GEMV_STAGE_K, dm.GEMV_WIDTHS,
                                 max_splits=dm.GEMV_MAX_SPLITS)
        return dm.stream_plan("qsplit", m, K, N, dtype.itemsize)
    if kernel == "gemv_gp":
        if m >= 2:
            return dm.gemm_tiles(m, N, K // dm.GEMV_STAGE_K, dm.GEMV_WIDTHS,
                                 times=dm.GP_GEMV_TIMES)
        return dm.stream_plan(fmt, m, K, N, dtype.itemsize)
    if kernel == "gemm_qs":
        widths, times = dm.QS_PLAN[f32]
        return dm.gemm_tiles(m, N, K // dm.QS_STAGE_K, widths, times=times)
    if kernel == "gemm_pairs":
        stage_k, widths, times = dm.PAIRS_PLAN[(fmt, f32)]
        return dm.gemm_tiles(m, N, K // stage_k, widths, times=times)
    if kernel == "gemv_gp3":
        return dm.stream_plan("int3", m, K, N, dtype.itemsize)
    fid, per_row = dm.PLANE_FORMAT_NAMES[fmt]
    return dm.plane_tiles(fid, m, N, K // per_row)


@pytest.mark.parametrize("call", CALLS, ids=lambda c: f"{c[0]}-{c[1]}-m{c[3]}")
def test_no_table_plans_are_the_time_models(table, call):
    dm.load_tuned_plans(table)  # no file: an empty table
    assert dm.launch_plan(*call, card=CARD) == _parent_plan(*call)
    assert dm.model_plan(*call) == _parent_plan(*call)
    # the sweep's candidates hold the models' pick
    assert dm.model_plan(*call) in tune.plan_candidates(*call[:5])


def test_table_round_trip_and_provenance(table):
    rows = [dict(mt=128, parts=1, per=64, ms=0.091, ok=True, picked=True),
            dict(mt=64, parts=2, per=32, ms=0.080, ok=True, picked=False),
            dict(mt=16, parts=4, per=16, ms=0.050, ok=False, picked=False),
            dict(mt=256, parts=1, per=64, ms=0.085, ok=True, picked=False)]

    class Fake:  # a swept case: table_entry times its winner once more
        run = staticmethod(lambda: None)

    saved = tune.time_ms
    tune.time_ms = lambda fn, flush, reps: 0.082
    try:
        entry = tune.table_entry(Fake(), rows, None, 3)
    finally:
        tune.time_ms = saved
    # the plan that disagreed with the plain version never wins
    assert entry["plan"] == [64, 2, 32] and entry["runner_up"] == [256, 1, 64]
    assert entry["us"] == pytest.approx(80.0) and entry["validated"] is True
    assert entry["model_plan"] == [128, 1, 64] and entry["model_us"] == pytest.approx(91.0)
    assert set(entry) >= {"plan", "us", "validated", "runner_up", "model_plan", "model_us"}
    key = dm.plan_key("gemm_qs", "qsplit", torch.bfloat16, 128, 4096, 22016)
    assert key == "gemm_qs:qsplit:bfloat16:128:4096:22016"
    tune.write_table(table, HEADER, {key: entry})
    other = dm.plan_key("gemv_qs", "qsplit", torch.bfloat16, 1, 4096, 22016)
    tune.write_table(table, HEADER, {other: dict(entry, plan=[256, 3, 11])})
    header, plans = dm.load_tuned_plans(table)
    assert header == HEADER and set(plans) == {key, other} and plans[key] == entry
    # a table of another card is replaced, not merged
    tune.write_table(table, dict(HEADER, card="another card"), {other: entry})
    with open(table) as f:
        assert set(json.load(f)["plans"]) == {other}


def test_table_entry_flags_a_winner_that_does_not_repeat():
    rows = [dict(mt=16, parts=1, per=8, ms=0.010, ok=True, picked=True)]

    class Fake:
        run = staticmethod(lambda: None)

    saved = tune.time_ms
    tune.time_ms = lambda fn, flush, reps: 0.020
    try:
        entry = tune.table_entry(Fake(), rows, None, 3)
    finally:
        tune.time_ms = saved
    assert entry["validated"] is False and entry["runner_up"] is None
    assert tune.table_entry(Fake(), [dict(rows[0], ok=False)], None, 3) is None


@pytest.mark.parametrize("call", CALLS[:6], ids=lambda c: f"{c[0]}-m{c[3]}")
def test_table_precedence_and_card_gate(table, call):
    key = dm.plan_key(*call)
    forced = (16, 3, 7)
    tune.write_table(table, HEADER, {key: dict(plan=list(forced), us=1.0, validated=True,
                                               runner_up=None, model_plan=[0, 0, 0],
                                               model_us=2.0)})
    dm.load_tuned_plans(table)
    assert dm.launch_plan(*call, card=CARD) == forced  # the table first
    assert dm.launch_plan(*call, card="NVIDIA A100-SXM4-80GB") == dm.model_plan(*call)
    assert dm.launch_plan(*call) == dm.model_plan(*call)  # no card (CPU, meta): the models
    kernel, fmt, dtype, m, K, N = call
    assert dm.launch_plan(kernel, fmt, dtype, m + 1, K, N, card=CARD) == dm.model_plan(
        kernel, fmt, dtype, m + 1, K, N)  # the key is exact


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def test_wrappers_launch_the_table_plan(table, monkeypatch):
    # a gemm_qs call on a (meta) device tensor passes the table's plan to
    # its entry when the table names the call's card, the models' otherwise
    w = pad_quantized_groups(quantize(torch.randn(256, 384) * 0.02, resolve_spec("q4bf16")))
    m, K, N = 64, w.data.shape[0] * 8, w.data.shape[1]
    lib = _FakeLib()
    monkeypatch.setattr(dm, "load_kernel", lambda name, argtypes: lib)
    monkeypatch.setattr(dm, "_stream", lambda x: 0)
    monkeypatch.setattr(dm.gemm_qs, "launches", 0)
    key = dm.plan_key("gemm_qs", "qsplit", torch.bfloat16, m, K, N)
    tune.write_table(table, HEADER, {key: dict(plan=[16, 2, 2], us=1.0, validated=True,
                                               runner_up=None, model_plan=[64, 1, 4],
                                               model_us=2.0)})
    dm.load_tuned_plans(table)
    x = torch.empty((m, K), dtype=torch.bfloat16, device="meta")
    for card, want in ((CARD, (16, 2, 2)),
                       ("another card", dm.model_plan("gemm_qs", "qsplit", torch.bfloat16, m,
                                                      K, N))):
        monkeypatch.setattr(dm, "_card", lambda x, card=card: card)
        lib.calls.clear()
        dm.gemm_qs(x, _meta(w.data), _meta(w.scale), _meta(w.zero), out_dtype=torch.bfloat16)
        (name, args), = lib.calls
        assert name == "mlc_gemm_qs" and tuple(args[-4:-1]) == want


def test_forced_plan_restores_launch_plan():
    real = dm.launch_plan
    with tune.forced_plan((16, 1, 4)):
        assert dm.launch_plan("gemm_qs", "qsplit", torch.bfloat16, 8, 4096, 4096) == (16, 1, 4)
    assert dm.launch_plan is real


def test_tune_shapes_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("holds the refusal without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tune.tune_shapes([(256, 256)], "q4bf16", ms=(1,))
    with pytest.raises(RuntimeError, match="cuda"):
        tune.main(["--model", "tiny-llama", "--m", "1", "-o", "/nonexistent/t.json"])
