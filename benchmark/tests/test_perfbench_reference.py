"""The plain reference against the port on the CPU, at tiny sizes of both
families, from the same draws: the reference works the int4 weights out
again itself and must land on the port's logits."""

import pytest
import torch

from conftest import tiny_cell

CELLS = {"moss": "moss16b-q4bf16.chat-b1", "gpt_neox": "dolly3b-q4f16hs.serve-chat"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_reference_quantizer_is_the_ports(dtype):
    from harness import weights
    from mlc_llm_tpu_torch.quant import quantize, resolve_spec
    from mlc_llm_tpu_torch.quant.groupwise import dequantize
    from reference.quant import int4_asym
    import dataclasses

    w = torch.randn((192, 160), generator=torch.Generator().manual_seed(3)) * 0.05
    spec = dataclasses.replace(resolve_spec("q4bf16_pair"), dtype=dtype)
    want = dequantize(quantize(w, spec), torch.float32)
    assert torch.equal(int4_asym(w, dtype), want)


@pytest.mark.parametrize("family", ["moss", "gpt_neox"])
def test_reference_matches_the_port(family):
    from harness import spec
    from mlc_llm_tpu_torch.models.transformer import forward, init_kv_cache

    dense = spec.load_arch("dense")
    Reference = dense.Reference

    cell = tiny_cell(CELLS[family])
    model, dep = cell.model, cell.deployment
    seed = 2**31 + 99
    cfg, params = dense.build_params(model, dep, seed, "cpu")
    toks = torch.randint(0, model["vocab_size"], (1, 96), generator=torch.Generator().manual_seed(1))
    cache = init_kv_cache(cfg, 1, 128, torch.float32, device="cpu")
    got, _ = forward(params, cfg, toks, cache, last_only=False)
    ref = Reference(model, dep, seed, "cpu").logits([toks[0].tolist()], [list(range(96))])[0]
    scale = ref.abs().max()
    err = (got[0].float() - ref).abs().max() / scale
    # the port computes in bf16 / f16 (rounding each layer's activations)
    assert err < 3e-2, float(err)
    # and its greedy tokens sit at the reference's best, up to rounding
    from harness import check

    gap = check.readings([ref], [got[0].argmax(-1).tolist()])["max_gap"]
    assert gap < 0.05 * float(scale)


def test_fp8_control_reads_further_from_the_reference():
    from harness import check, spec

    Reference = spec.load_arch("dense").Reference

    cell = tiny_cell(CELLS["moss"], hidden_size=256, intermediate_size=1024, num_heads=2,
                     num_kv_heads=2)
    model, dep = cell.model, cell.deployment
    seq = torch.randint(0, 256, (120,), generator=torch.Generator().manual_seed(5)).tolist()
    want = [list(range(120))]
    ref = Reference(model, dep, 4, "cpu").logits([seq], want)
    ctrl = Reference(model, dep, 4, "cpu", precision="fp8").logits([seq], want)
    assert check.readings(ref, check.control_tokens(ref))["max_gap"] == 0.0
    assert check.readings(ref, check.control_tokens(ctrl))["error_scale"] > \
        check.readings(ref, check.control_tokens(ref))["error_scale"]


def test_bf16_rounds_between_f32_and_fp8():
    from harness import spec

    Reference = spec.load_arch("dense").Reference

    cell = tiny_cell(CELLS["gpt_neox"], hidden_size=256, intermediate_size=1024, num_heads=4,
                     num_kv_heads=4)
    model, dep = cell.model, cell.deployment
    seq = torch.randint(0, 256, (64,), generator=torch.Generator().manual_seed(6)).tolist()
    want = [list(range(64))]
    ref = Reference(model, dep, 8, "cpu").logits([seq], want)[0]
    err = {p: float((Reference(model, dep, 8, "cpu", precision=p).logits([seq], want)[0]
                     - ref).abs().max()) for p in ("bf16", "fp8")}
    assert 0.0 < err["bf16"] < err["fp8"], err
    with pytest.raises(ValueError):
        Reference(model, dep, 8, "cpu", precision="int4")
