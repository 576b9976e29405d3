"""The f16 low-bit presets (q3f16, q3f16_s16, fp4f16, q8f16) against the
JAX package on the CPU: the int3 GEMV's and the plane GEMM's plain
versions, tiny-llama's logits and greedy tokens, the CLI, and the CUDA
wrappers' f16 plumbing.

The JAX side runs as tests/test_torch_lowbit_kernels.py runs it: the gp3
kernel through the dispatchers (dequant_matmul, dequant_matmul_stacked),
the generic plane kernels (_dequant_matmul_2d, _dequant_matmul_stacked_
generic_2d) called directly, all in Pallas interpret mode.

The int3 GEMV rounds each field's 8-element sum of x to x's dtype, as the
JAX body sums its f16 x planes in f16. At K 2560 and x ~ 2 N(0, 1) a sum
rounded to bf16 instead misses the JAX kernel by 5.6e-2 (m = 1) and
1.2e-1 (m = 2) on outputs of ~20: the plain version is held at atol 1e-3.
The plane GEMM is held at 1e-2 (atol and rtol), the low-bit files'
tolerance (XLA's CPU fusion may sum the x words in f32 and round once).
Logits at 5e-2 absolute, as tests/test_torch_lowbit_model.py holds q3bf16.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlc_llm_tpu.engine import GenerationConfig as JGen
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.models import forward as jforward
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_kv_cache as jinit_kv
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu.ops.pallas.dequant_matmul import (
    _dequant_matmul_2d,
    _dequant_matmul_stacked_generic_2d,
)
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul as jdm
from mlc_llm_tpu.ops.pallas.dequant_matmul import dequant_matmul_stacked as jdms
from mlc_llm_tpu.quant import quantize as jquantize
from mlc_llm_tpu.quant.groupwise import QuantizedTensor as JQT
from mlc_llm_tpu.quant.groupwise import pad_quantized_groups as jpad
from mlc_llm_tpu_torch import cli
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.models import forward, get_config, init_kv_cache
from mlc_llm_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from mlc_llm_tpu_torch.ops import dequant_matmul as dm

torch.set_num_threads(2)

F16_PRESETS = ["q3f16", "q3f16_s16", "fp4f16", "q8f16"]
PLANE_TOL = dict(atol=1e-2, rtol=1e-2)
LOGIT_ATOL = 5e-2
N = 384
# 16 groups each (q3*: group 40; fp4 and int8: group 32)
K_OF = {"q3f16": 640, "q3f16_s16": 640, "fp4f16": 512, "q8f16": 512}
_jforward = jax.jit(jforward, static_argnames=("cfg", "attn_window"))


def _stack(preset, k, n=N, seed=1, layers=2):
    rng = np.random.default_rng(seed)
    qts = [jquantize((rng.standard_normal((k, n)) * 0.05).astype(np.float32), preset)
           for _ in range(layers)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *qts)
    return qts, stacked, params_from_jax(jax.tree.map(np.asarray, stacked))


def _x(m, k, scale, seed, dtype=jnp.float16):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((m, k)) * scale, dtype)
    return x, tensor_from_numpy(np.asarray(x))


# ---- the int3 GEMV: each field's sum rounded to x's dtype ----

@pytest.mark.parametrize("preset", ["q3f16_s16", "q3bf16_s16"])
@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("m", [1, 2])
def test_gemv_gp3_plain_rounds_field_sums_in_x_dtype(m, stacked, preset):
    # K 2560 (64 groups), N 384, x ~ 2 N(0, 1): f32 out on both sides, so
    # only the arithmetic before the output rounding is compared
    qts, jst, tst = _stack(preset, 2560, seed=7)
    spec = tst.spec
    xj, xt = _x(m, 2560, 2.0, seed=m, dtype=spec.dtype)
    assert dm.route(spec, tst.n_groups, m) == "gemv_gp3"
    if stacked:
        want = jdms(xj, jst, jnp.int32(1), out_dtype=jnp.float32)
        got = dm.dequant_matmul(xt, tst, layer=1, out_dtype=torch.float32)
    else:
        flat = params_from_jax(jax.tree.map(np.asarray, qts[1]))
        want = jdm(xj, qts[1], out_dtype=jnp.float32)
        got = dm.dequant_matmul(xt, flat, out_dtype=torch.float32)
    assert dm.gemv_gp3.launches == 0  # CPU tensors never launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=1e-3, rtol=0)


# ---- the plane GEMM in f16 ----

@pytest.fixture(scope="module", params=F16_PRESETS)
def weights(request):
    preset = request.param
    return (preset,) + _stack(preset, K_OF[preset], layers=3)


def _port_x(xt, w):
    """x zero-padded to the stored k, as dequant_matmul pads it."""
    rows = w.data.shape[-2]
    k_stored = rows if w.spec.storage == "i8" else rows * w.spec.elems_per_word
    return torch.nn.functional.pad(xt, (0, k_stored - xt.shape[1]))


@pytest.mark.parametrize("m", [1, 8, 24])
def test_gemm_plane_f16_plain_matches_pallas_generic(weights, m):
    preset, qts, _, _ = weights
    jq = qts[2]
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    xj, xt = _x(m, K_OF[preset], 0.5, seed=10 + m)
    want = _dequant_matmul_2d(xj, jq.data, jq.scale, jq.zero, spec=jq.spec, shape=jq.shape,
                              out_dtype=jnp.float32, interpret=True)
    got = dm.gemm_plane(_port_x(xt, tq), tq.data, tq.scale, tq.zero, tq.spec,
                        out_dtype=torch.float32)
    assert dm.gemm_plane.launches == 0
    np.testing.assert_allclose(got[:, :N].numpy(), np.asarray(want, np.float32), **PLANE_TOL)


@pytest.mark.parametrize("m", [1, 8, 24])
def test_gemm_plane_f16_plain_matches_pallas_stacked_generic(weights, m):
    preset, _, jst, tst = weights
    xj, xt = _x(m, K_OF[preset], 0.5, seed=20 + m)
    want = _dequant_matmul_stacked_generic_2d(
        xj, jnp.asarray([1], jnp.int32), jst.data, jst.scale, jst.zero, spec=jst.spec,
        shape=jst.shape, out_dtype=jnp.float16, interpret=True)
    got = dm.gemm_plane(_port_x(xt, tst), tst.data, tst.scale, tst.zero, tst.spec, layer=1,
                        out_dtype=torch.float16)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got[:, :N].float().numpy(), np.asarray(want, np.float32),
                               **PLANE_TOL)


# ---- tiny-llama in the f16 presets ----

def _jparams(quant, seed):
    cfg = jget_config("tiny-llama")
    jp = jinit(cfg, quant, seed=seed)
    jp = jax.tree.map(lambda x: jpad(x) if isinstance(x, JQT) else x, jp,
                      is_leaf=lambda x: isinstance(x, JQT))
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("quant", F16_PRESETS)
def test_f16_forward_logits_match_jax(quant):
    # f16 KV on both sides; a right-padded prefill (13 real tokens in a 16
    # bucket: the plane GEMM), then 3 decodes (q3f16_s16: the int3 GEMV)
    cfg, jp, tp = _jparams(quant, seed=3)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    jc = jinit_kv(cfg, 1, 64, dtype=jnp.float16)
    tc = init_kv_cache(cfg, 1, 64, dtype=torch.float16, device="cpu")
    jl, jc = _jforward(jp, cfg, jnp.asarray(toks), jc, seq_lens=jnp.asarray([13]),
                       attn_window=64)
    tl, tc = forward(tp, cfg, torch.from_numpy(toks).long(), tc, seq_lens=[13],
                     attn_window=64)
    for step in range(4):
        assert tl.shape == (1, cfg.vocab_size) and torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
        if step == 3:
            break
        nxt = np.asarray(jnp.argmax(jl, -1)).reshape(1, 1).astype(np.int32)
        jl, jc = _jforward(jp, cfg, jnp.asarray(nxt), jc, attn_window=64)
        tl, tc = forward(tp, cfg, torch.from_numpy(nxt).long(), tc, attn_window=64)


@pytest.mark.parametrize("quant", F16_PRESETS)
def test_f16_engine_greedy_tokens_match_jax(quant):
    cfg, jp, tp = _jparams(quant, seed=0)
    prompt = [int(t) for t in np.random.default_rng(0).integers(3, 256, 11)]
    want = JEngine(cfg, jp, max_seq_len=128, cache_dtype=jnp.float16).generate(
        [prompt], JGen(max_new_tokens=12, temperature=0.0))
    eng = InferenceEngine(get_config("tiny-llama"), tp, max_seq_len=128,
                          cache_dtype=torch.float16, device="cpu")
    got = eng.generate([prompt], GenerationConfig(max_new_tokens=12, temperature=0.0))
    assert got == want


def test_cli_one_shot_q3f16_s16_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["--model", "tiny-llama", "--random-weights", "--quantization", "q3f16_s16",
                  "--prompt", "hi", "--temperature", "0", "--device", "cpu"])
    assert out.getvalue().endswith("\n")


# ---- the CUDA wrappers in f16, without a card ----

class _FakeLib:
    """Records each entry's arguments and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("preset", F16_PRESETS)
def test_f16_plane_call_on_a_device_tensor_launches(monkeypatch, preset):
    # a tensor off the CPU takes the kernel's path: gemm_plane passes the
    # f16 dtype id to its entry, allocates x_t in f16, counts one launch,
    # and never runs the plain version (meta tensors stand in for the card)
    _, _, tst = _stack(preset, K_OF[preset])
    lib = _FakeLib()
    monkeypatch.setattr(dm, "load_kernel", lambda name, argtypes: lib)
    monkeypatch.setattr(dm, "_stream", lambda x: 0)
    monkeypatch.setattr(dm, "gemm_plane_plain", None)
    # the launch counter is the process's: restored after the test
    monkeypatch.setattr(dm.gemm_plane, "launches", 0)
    epw = 1 if tst.spec.storage == "i8" else tst.spec.elems_per_word
    x = torch.empty((8, tst.data.shape[1] * epw), dtype=torch.float16, device="meta")
    data, scale = _meta(tst.data), _meta(tst.scale)
    scratch = []
    empty = torch.empty

    def spy_empty(shape, dtype=None, device=None):
        scratch.append(dtype)
        return empty(shape, dtype=dtype, device=device)

    monkeypatch.setattr(torch, "empty", spy_empty)
    out = dm.gemm_plane(x, data, scale, None, tst.spec, layer=1, out_dtype=torch.float16)
    (name, args), = lib.calls
    assert name == "mlc_gemm_plane" and args[1] == dm.DTYPE_IDS[torch.float16] == 1
    assert out.dtype == torch.float16 and dm.gemm_plane.launches == 1
    if tst.spec.storage != "i8":
        assert scratch[0] == torch.float16  # x_t, the prologue's output


def test_f16_gp3_call_on_a_device_tensor_launches(monkeypatch):
    _, _, tst = _stack("q3f16_s16", 640)
    lib = _FakeLib()
    monkeypatch.setattr(dm, "load_kernel", lambda name, argtypes: lib)
    monkeypatch.setattr(dm, "_stream", lambda x: 0)
    monkeypatch.setattr(dm, "zeroed_tickets", lambda dev, st, n: torch.empty(n, device="meta"))
    monkeypatch.setattr(dm, "gemv_gp3_plain", None)
    monkeypatch.setattr(dm.gemv_gp3, "launches", 0)
    for m in (1, 2):
        x = torch.empty((m, 640), dtype=torch.float16, device="meta")
        dm.gemv_gp3(x, _meta(tst.data), _meta(tst.scale), layer=1, out_dtype=torch.float16)
    assert [(n, a[0], a[7]) for n, a in lib.calls] == [("mlc_gemv_gp3", 1, 1),
                                                       ("mlc_gemv_gp3", 1, 2)]
    assert dm.gemv_gp3.launches == 2


def test_f16_plane_call_without_a_gpu_raises(monkeypatch):
    # with no card and no nvcc, an f16 call on a tensor off the CPU raises
    # when its kernel cannot be built: nothing falls back to the plain
    # version or a library product
    if torch.cuda.is_available():
        pytest.skip("holds the build failure without a GPU")
    _, _, tst = _stack("q3f16", 640)
    monkeypatch.setattr(dm, "gemm_plane_plain", None)
    monkeypatch.setattr(dm, "dense_matmul", None)
    monkeypatch.setattr(dm, "_stream", lambda x: 0)
    from mlc_llm_tpu_torch import ops

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(ops, "_LIBS", {})
    monkeypatch.setattr(ops, "_stale", lambda name: True)
    monkeypatch.setattr(ops, "_nvcc", no_nvcc)
    x = torch.empty((8, 640), dtype=torch.float16, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        dm.gemm_plane(x, _meta(tst.data), _meta(tst.scale), None, tst.spec, layer=1,
                      out_dtype=torch.float16)
    assert dm.gemm_plane.launches == 0
