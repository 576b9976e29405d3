"""HuggingFace weights -> the port's param tree, quantized on the way.

The counterpart of ``mlc_llm_tpu/models/hf_loader.py``, with the same
family remaps:

- Llama: separate projections; q/k/v and gate/up are concatenated;
- GPT-NeoX: the fused query_key_value (weight and bias) is laid out per
  head as [nh, 3, d, H] and split into q/k/v;
- MOSS: the fused qkv_proj is interleaved with mp_num = 4 in q/v/k
  order; plain GPT-J checkpoints (separate q/k/v) are accepted too.

Every HF Linear weight [out, in] is transposed to the engine's [k, n]
layout and group-quantized one tensor at a time on `device`, from its
f32 values (the JAX loader reads the state dict as f32 NumPy). The
embedding is stored transposed [H, V] when quantized. The input is an HF
module (its ``state_dict()``) or a plain mapping of names to tensors, so
the loader runs without ``transformers``. Each quantized weight takes its
layout from ``spec_for_k``, the embedding included; the JAX loader
quantizes the embedding without it and so raises where the hidden size
gives a group count that the layout cannot split (tiny configs). Where it
does not raise, both give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch

from ..ops import resolve_device
from ..quant.groupwise import quantize, torch_dtype
from ..quant.spec import QuantSpec, resolve_spec, spec_for_k
from .config import ModelConfig
from .layers import make_rotary_tables
from .transformer import _stack

Params = Dict[str, Any]


class _Weights:
    """The state dict's tensors, each fetched to the device as f32."""

    def __init__(self, sd: Mapping[str, Any], device: torch.device):
        self.sd, self.device = sd, device

    def __contains__(self, name):
        return name in self.sd

    def __getitem__(self, name) -> torch.Tensor:
        t = self.sd[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(t)
        return t.detach().to(self.device).float()


def _maybe_quant(w_kn: torch.Tensor, spec: QuantSpec):
    if spec.is_quantized:
        return quantize(w_kn, spec_for_k(spec, w_kn.shape[0]))
    return w_kn.to(torch_dtype(spec.dtype)).contiguous()


def params_from_hf(hf_model, cfg: ModelConfig, quant, device="cuda") -> Params:
    """HF causal LM (or its state dict) -> params on `device`."""
    spec = resolve_spec(quant)
    sd = hf_model.state_dict() if hasattr(hf_model, "state_dict") else hf_model
    w = _Weights(sd, resolve_device(device))
    loaders = {"llama": _load_llama, "gpt_neox": _load_neox, "moss": _load_moss}
    if cfg.family not in loaders:
        raise ValueError(f"unknown family {cfg.family}")
    return loaders[cfg.family](w, cfg, spec)


def _stack_layers(layers):
    return {key: _stack([lp[key] for lp in layers]) for key in layers[0]}


def _common(cfg: ModelConfig, spec: QuantSpec, w: _Weights, embed, layers, final_w, final_b,
            head_w, head_b) -> Params:
    dtype = torch_dtype(spec.dtype)
    embed_vh = w[embed]
    embed_p = _maybe_quant(embed_vh.T, spec) if spec.is_quantized else embed_vh.to(dtype)
    del embed_vh
    head_spec = spec
    if cfg.fp32_lm_head:
        head_spec = (dataclasses.replace(spec, dtype="float32") if spec.is_quantized
                     else resolve_spec("f32"))
    params: Params = {
        "embed": {"w": embed_p},
        "layers": _stack_layers(layers),
        "final_ln": {"w": w[final_w].to(dtype)},
        "lm_head": {"w": _maybe_quant(w[head_w].T, head_spec)},
    }
    if final_b is not None:
        params["final_ln"]["b"] = w[final_b].to(dtype)
    if head_b is not None and head_b in w:
        params["lm_head"]["b"] = w[head_b].to(torch.float32 if cfg.fp32_lm_head else dtype)
    cos, sin = make_rotary_tables(cfg.head_dim, cfg.rotary_pct, cfg.rotary_base,
                                  cfg.max_seq_len, cfg.rotary_style, device=w.device)
    params["rotary"] = {"cos": cos, "sin": sin}
    return params


def _load_llama(w: _Weights, cfg: ModelConfig, spec: QuantSpec) -> Params:
    dtype = torch_dtype(spec.dtype)
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        qkv = torch.cat([w[f"{p}.self_attn.{x}_proj.weight"] for x in "qkv"])
        gate_up = torch.cat([w[f"{p}.mlp.gate_proj.weight"], w[f"{p}.mlp.up_proj.weight"]])
        layers.append({
            "ln1_w": w[f"{p}.input_layernorm.weight"].to(dtype),
            "ln2_w": w[f"{p}.post_attention_layernorm.weight"].to(dtype),
            "wqkv": _maybe_quant(qkv.T, spec),
            "wo": _maybe_quant(w[f"{p}.self_attn.o_proj.weight"].T, spec),
            "w_in": _maybe_quant(gate_up.T, spec),
            "w_out": _maybe_quant(w[f"{p}.mlp.down_proj.weight"].T, spec),
        })
        del qkv, gate_up
    return _common(cfg, spec, w, "model.embed_tokens.weight", layers,
                   "model.norm.weight", None, "lm_head.weight", None)


def _load_neox(w: _Weights, cfg: ModelConfig, spec: QuantSpec) -> Params:
    dtype = torch_dtype(spec.dtype)
    nh, d, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    layers = []
    for i in range(cfg.num_layers):
        p = f"gpt_neox.layers.{i}"
        # the fused [3H, H] weight and [3H] bias, laid out [nh, 3, d, ...]
        wqkv = w[f"{p}.attention.query_key_value.weight"].reshape(nh, 3, d, H)
        wqkv = torch.cat([wqkv[:, j].reshape(nh * d, H) for j in range(3)])
        bqkv = w[f"{p}.attention.query_key_value.bias"].reshape(nh, 3, d)
        bqkv = torch.cat([bqkv[:, j].reshape(nh * d) for j in range(3)])
        layers.append({
            "ln1_w": w[f"{p}.input_layernorm.weight"].to(dtype),
            "ln1_b": w[f"{p}.input_layernorm.bias"].to(dtype),
            "ln2_w": w[f"{p}.post_attention_layernorm.weight"].to(dtype),
            "ln2_b": w[f"{p}.post_attention_layernorm.bias"].to(dtype),
            "wqkv": _maybe_quant(wqkv.T, spec),
            "bqkv": bqkv.to(dtype),
            "wo": _maybe_quant(w[f"{p}.attention.dense.weight"].T, spec),
            "bo": w[f"{p}.attention.dense.bias"].to(dtype),
            "w_in": _maybe_quant(w[f"{p}.mlp.dense_h_to_4h.weight"].T, spec),
            "b_in": w[f"{p}.mlp.dense_h_to_4h.bias"].to(dtype),
            "w_out": _maybe_quant(w[f"{p}.mlp.dense_4h_to_h.weight"].T, spec),
            "b_out": w[f"{p}.mlp.dense_4h_to_h.bias"].to(dtype),
        })
        del wqkv
    return _common(cfg, spec, w, "gpt_neox.embed_in.weight", layers,
                   "gpt_neox.final_layer_norm.weight", "gpt_neox.final_layer_norm.bias",
                   "embed_out.weight", None)


def split_moss_qkv(w_fused: torch.Tensor, H: int):
    """De-interleave MOSS's fused qkv [3H, ...] (mp_num = 4 blocks, each
    in q/v/k order) into separate q, k, v [H, ...]."""
    mp = 4
    blocks = w_fused.reshape(mp, 3 * H // mp, -1)
    per = H // mp
    q, v, k = (blocks[:, j * per:(j + 1) * per].reshape(H, -1) for j in range(3))
    return q, k, v


def _load_moss(w: _Weights, cfg: ModelConfig, spec: QuantSpec) -> Params:
    dtype = torch_dtype(spec.dtype)
    H = cfg.hidden_size
    layers = []
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}"
        if f"{p}.attn.qkv_proj.weight" in w:  # a MOSS checkpoint
            wqkv = torch.cat(split_moss_qkv(w[f"{p}.attn.qkv_proj.weight"], H))
        else:  # the plain GPT-J layout
            wqkv = torch.cat([w[f"{p}.attn.{x}_proj.weight"] for x in "qkv"])
        layers.append({
            "ln1_w": w[f"{p}.ln_1.weight"].to(dtype),
            "ln1_b": w[f"{p}.ln_1.bias"].to(dtype),
            "wqkv": _maybe_quant(wqkv.T, spec),
            "wo": _maybe_quant(w[f"{p}.attn.out_proj.weight"].T, spec),
            "w_in": _maybe_quant(w[f"{p}.mlp.fc_in.weight"].T, spec),
            "b_in": w[f"{p}.mlp.fc_in.bias"].to(dtype),
            "w_out": _maybe_quant(w[f"{p}.mlp.fc_out.weight"].T, spec),
            "b_out": w[f"{p}.mlp.fc_out.bias"].to(dtype),
        })
        del wqkv
    return _common(cfg, spec, w, "transformer.wte.weight", layers,
                   "transformer.ln_f.weight", "transformer.ln_f.bias",
                   "lm_head.weight", "lm_head.bias")
