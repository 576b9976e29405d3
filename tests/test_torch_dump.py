"""The port's engine program dumps and kernel re-injection
(``debug/dump.py``), the cases of tests/test_tools.py's dump tests on
slot and paged tiny-llama engines, on the CPU: one ``.ops.txt`` per
program, named as JAX names the programs it dumps; every other program
key the engine ran dumped under its key; the engine's cache, stats,
counters and programs unchanged by a dump; the dump's programs equal to
the engine's own path and to JAX's programs on the same arguments;
re-injection refusing to run off the card; the CLI flags. The kernel
and graph dumps and re-injection itself run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from mlc_llm_tpu.debug.dump import engine_program_args as jengine_program_args
from mlc_llm_tpu.engine import InferenceEngine as JEngine
from mlc_llm_tpu.models import get_config as jget_config
from mlc_llm_tpu.models import init_random_params as jinit
from mlc_llm_tpu_torch import cli, ops
from mlc_llm_tpu_torch.debug import dump
from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.models import get_config
from mlc_llm_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)
CFG = get_config("tiny-llama")


@pytest.fixture(scope="module")
def jparams():
    return jinit(jget_config("tiny-llama"), "f32", seed=3)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _engine(params, layout):
    kw = dict(page_size=16) if layout == "paged" else {}
    return InferenceEngine(CFG, params, max_batch=2, max_seq_len=64, kv_layout=layout,
                           device="cpu", **kw)


def _state(engine):
    """Everything a dump must leave as it found it."""
    cache = {k: t.clone() for k, t in dump._cache_tensors(engine.cache).items()}
    inputs = [b.clone() for k in engine.programs.keys for b in engine.program_inputs(k)]
    return (cache, inputs, dict(vars(engine.stats)), [w.launches for w in ops.kernel_wrappers()],
            dict(engine.programs.runs), set(engine.programs.keys),
            (engine.prefill_forwards, engine.decode_forwards, engine.verify_forwards))


def _same(a, b):
    ca, ia, *ra = a
    cb, ib, *rb = b
    return (ca.keys() == cb.keys() and all(torch.equal(ca[k], cb[k]) for k in ca)
            and len(ia) == len(ib) and all(torch.equal(x, y) for x, y in zip(ia, ib))
            and ra == rb)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_dump_names_and_state(params, jparams, layout, tmp_path):
    eng = _engine(params, layout)
    eng.generate([[3, 4, 5], [6, 7]], GenerationConfig(max_new_tokens=4, temperature=0.0))
    before = _state(eng)
    outdir = str(tmp_path / "dumps")
    written = dump.dump_engine_programs(eng, outdir, prefill_bucket=16)
    assert _same(before, _state(eng)), "a dump changed the engine's state"
    # one .ops.txt per program, no kernels or graphs off the card
    keys = dump.engine_program_keys(eng, 16)
    assert written == sorted(f"{n}.ops.txt" for n in keys)
    for w in written:
        text = open(os.path.join(outdir, w)).read()
        assert text.count("\n") > 20 and "aten." in text, w
    # JAX's names for the programs JAX dumps, at the same bucket and window
    jeng = JEngine(jget_config("tiny-llama"), jparams, max_batch=2, max_seq_len=64,
                   kv_layout=layout, **(dict(page_size=16) if layout == "paged" else {}))
    assert set(jengine_program_args(jeng, 16)) <= set(keys)
    slot = layout == "slot"
    assert keys["prefill"] == ("prefill", 2, 16, 16, slot)
    assert keys["prefill_slot"] == ("prefill_slots", 1, 16, 16, slot)
    assert keys["decode_w32"] == ("decode", 2, 32)
    # every key the engine ran is dumped, under its own name
    for key in eng.programs.keys:
        assert key in keys.values()
    assert keys["sample_2"] == ("sample", 2)


def test_dump_covers_k_step_and_verify_keys(params, tmp_path):
    eng = _engine(params, "slot")
    sched = ContinuousBatchingScheduler(eng, multi_step=2)
    for p in ([1, 2, 3], [4, 5]):
        sched.submit(p, GenerationConfig(max_new_tokens=6, temperature=0.0))
    sched.run()
    eng.verify(np.zeros((2, 3), np.int64), attn_window=16)
    kinds = {k[0] for k in eng.programs.keys}
    assert {"decode_k", "verify", "prefill_slots"} <= kinds
    written = dump.dump_engine_programs(eng, str(tmp_path), prefill_bucket=16)
    for key in eng.programs.keys:
        name = next(n for n, k in dump.engine_program_keys(eng, 16).items() if k == key)
        assert f"{name}.ops.txt" in written
    assert dump.program_name(("decode_k", 2, 2, 16)) == "decode_k_2_2_16"
    assert dump.program_name(("decode", 2, 16, ("top_k", 5))) == "decode_2_16_top_k_5"


def test_program_equals_the_engine_path_and_jax(params, jparams):
    eng = _engine(params, "slot")
    progs = dump.engine_program_args(eng, 16)
    fn, args, key = progs["prefill"]
    assert key == ("prefill", 2, 16, 16, True) and len(args) == 2
    got = dump.run_engine_program(eng, "prefill", 16)[0]
    # the engine's own prefill of the same block (zero tokens, the whole bucket)
    want = eng.prefill([[0] * 16, [0] * 16])
    assert torch.equal(got, want)
    # JAX's prefill program on its own example args (zeros, the whole bucket)
    jeng = JEngine(jget_config("tiny-llama"), jparams, max_batch=2, max_seq_len=64)
    jfn, jargs, jkw = jengine_program_args(jeng, 16)["prefill"]
    jlogits = np.asarray(jax.tree_util.tree_leaves(jfn(*jargs, **jkw))[0])
    np.testing.assert_allclose(got.numpy(), jlogits.reshape(got.shape), atol=1e-4, rtol=1e-4)
    # the decode step and the sampler run on their example args
    logits, tok = dump.run_engine_program(eng, "decode_w32", 16)
    assert logits.shape == (2, CFG.vocab_size) and tok.shape == (2,)
    (first,) = dump.run_engine_program(eng, "sample_1", 16)
    assert first.shape == (1,)
    with pytest.raises(KeyError):
        dump.run_engine_program(eng, "nope", 16)


def test_reinject_raises_off_the_card(params, tmp_path):
    eng = _engine(params, "slot")
    src = tmp_path / "dequant_gemv_qs.cu"
    src.write_text("// a copy\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        dump.reinject_engine_program(eng, "decode_w32", "dequant_gemv_qs", str(src), 16)
    with pytest.raises(KeyError):
        dump._source("no_such_kernel")
    assert dump._source("gemv_qs") == dump._source("dequant_gemv_qs") == "dequant_gemv_qs"


@pytest.mark.parametrize("names, want", [
    (["lead", "lead", "at::cuda::spin_kernel(long)", "k1", "k2", "at::cuda::spin_kernel(long)"],
     ["k1", "k2"]),
    # kernels before the first mark are the window's lead-in
    (["k0", "spin_kernel", "k1", "spin_kernel"], ["k1"]),
    (["spin_kernel", "spin_kernel"], []),
    (["k1", "k2", "spin_kernel"], None),
    ([], None),
])
def test_between_marks(names, want):
    assert dump.between_marks(names) == want


def test_cli_debug_flags(tmp_path, capsys):
    outdir = str(tmp_path / "d")
    base = ["--model", "tiny-llama", "--random-weights", "--device", "cpu"]
    cli.main(base + ["--debug-dump-dir", outdir])
    out = capsys.readouterr().out
    assert f"wrote {outdir}/prefill.ops.txt" in out and "decode_w" in out
    assert "prefill_slot.ops.txt" in os.listdir(outdir)
    with pytest.raises(SystemExit):
        cli.main(base + ["--debug-load-kernel", "prefill=foo.cu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(base + ["--debug-load-kernel", f"prefill:dequant_gemv_qs={tmp_path}/x.cu"])
