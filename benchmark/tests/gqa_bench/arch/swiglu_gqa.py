"""A Llama-style block with grouped-query attention, which the harness
knows nothing of: RMSNorm before each branch, the sequential residual, a
SwiGLU MLP, rotary "rotate half" on every channel, no biases, and fewer
K/V heads than query heads (each serves nh / nkv of them). The port runs
it as its ``llama`` family. It lives beside the tests to show that a new
block is new files only: this module, a configuration that names it, the
mixes and the metrics.

Draws: wqkv [H, (nh + 2 nkv) d] with its columns [q | k | v], wo [nh d,
H], w_in [H, 2 F] with its columns [gate | up], w_out [F, H], embedding
[V, H] and lm head [H, V]; std sqrt(2 / (5 H)) on the input side, 2 / (L
sqrt(H)) on the output side; norm scales 1 + 0.1 N.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from harness import program, weights
from harness.roofline import (DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS, product_bound,
                              quantized_bytes)
from reference.model import Plain, exact_f32, rms_norm, rotary
from reference.quant import int4_asym

LAYER_LEAVES = ("wqkv", "wo", "w_in", "w_out")
NORMS = ("ln1_w", "ln2_w")


def _dims(m: dict):
    H, nh, nkv = m["hidden_size"], m["num_heads"], m["num_kv_heads"]
    return H, nh, nkv, H // nh


def leaves(model: dict) -> Dict[str, weights.Leaf]:
    H, nh, nkv, d = _dims(model)
    F, V, L = model["intermediate_size"], model["vocab_size"], model["num_layers"]
    small, wang = math.sqrt(2.0 / (5.0 * H)), 2.0 / (L * math.sqrt(H))
    layers = tuple(range(L))
    return {"wqkv": weights.Leaf("wqkv", H, (nh + 2 * nkv) * d, small, layers),
            "wo": weights.Leaf("wo", nh * d, H, wang, layers),
            "w_in": weights.Leaf("w_in", H, 2 * F, small, layers),
            "w_out": weights.Leaf("w_out", F, H, wang, layers),
            "embed": weights.Leaf("embed", V, H, small),
            "lm_head": weights.Leaf("lm_head", H, V, small)}


def norm_scales(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Each layer's two RMSNorm scales [L, H] and the final one [H], f32."""
    H, L = model["hidden_size"], model["num_layers"]
    shapes = {"ln1_w": (L, H), "ln2_w": (L, H), "final_w": (H,)}
    return {k: 1.0 + 0.1 * weights.normal(seed, k, shp, device) for k, shp in shapes.items()}


def build_params(model: dict, deployment: dict, seed: int, device):
    from mlc_llm_tpu_torch.models.layers import make_rotary_tables
    from mlc_llm_tpu_torch.quant import quantize, resolve_spec, spec_for_k
    from mlc_llm_tpu_torch.quant.groupwise import torch_dtype

    cfg = program.model_config(model)
    spec = resolve_spec(deployment["quantization"])
    dtype = torch_dtype(spec.dtype)
    lv = leaves(model)
    layers = {k: program.stack_quantized((weights.draw(lv[k], seed, l, device)
                                          for l in lv[k].layers),
                                         len(lv[k].layers), quantize, spec_for_k(spec, lv[k].k))
              for k in LAYER_LEAVES}
    norms = norm_scales(model, seed, device)
    layers.update({k: norms[k].to(dtype) for k in NORMS})
    H = cfg.hidden_size
    embed = quantize(weights.draw(lv["embed"], seed, -1, device).T, spec_for_k(spec, H))
    head = quantize(weights.draw(lv["lm_head"], seed, -1, device), spec_for_k(spec, H))
    cos, sin = make_rotary_tables(cfg.head_dim, cfg.rotary_pct, cfg.rotary_base,
                                  cfg.max_seq_len, cfg.rotary_style, device=device)
    return cfg, {"embed": {"w": embed}, "layers": layers,
                 "final_ln": {"w": norms["final_w"].to(dtype)}, "lm_head": {"w": head},
                 "rotary": {"cos": cos, "sin": sin}}


class Reference(Plain):
    """The block in f32, layer by layer."""

    def _layer(self, h, W: Dict[str, torch.Tensor], w1, w2):
        H, nh, nkv, d = _dims(self.m)
        eps, base, lo = self.m["norm_eps"], self.m.get("rotary_base", 10000.0), self._lo
        S = h.shape[0]
        q, k, v = self._mm(lo(rms_norm(h, w1, eps)), W["wqkv"]).split(
            [nh * d, nkv * d, nkv * d], dim=-1)
        q = lo(rotary(q.reshape(S, nh, d), d, base, "neox")).transpose(0, 1)
        k = lo(rotary(k.reshape(S, nkv, d), d, base, "neox")).transpose(0, 1)
        v = lo(v.reshape(S, nkv, d)).transpose(0, 1)
        h = lo(h + self._mm(self._causal(q, k, v, d), W["wo"]))
        gate, up = self._mm(lo(rms_norm(h, w2, eps)), W["w_in"]).chunk(2, dim=-1)
        return lo(h + self._mm(lo(gate * torch.sigmoid(gate) * up), W["w_out"]))

    @torch.no_grad()
    def logits(self, segments: Sequence[Sequence[int]],
               wanted: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        m, dev, seed = self.m, self.device, self.seed
        lv = leaves(m)
        with exact_f32():
            emb = int4_asym(weights.draw(lv["embed"], seed, -1, dev).T, self.act)
            hs = [self._lo(emb[:, torch.as_tensor(list(s), dtype=torch.long, device=dev)].T
                           .contiguous()) for s in segments]
            del emb
            norms = norm_scales(m, seed, dev)
            for layer in range(m["num_layers"]):
                W = {k: int4_asym(weights.draw(lv[k], seed, layer, dev), self.act)
                     for k in LAYER_LEAVES}
                hs = [self._layer(h, W, norms["ln1_w"][layer], norms["ln2_w"][layer])
                      for h in hs]
            head = int4_asym(weights.draw(lv["lm_head"], seed, -1, dev), self.head_dtype)
            return [self._mm(self._lo(rms_norm(
                h[torch.as_tensor(list(w), dtype=torch.long, device=dev)], norms["final_w"],
                m["norm_eps"])), head, head=True) for h, w in zip(hs, wanted)]


@dataclasses.dataclass(frozen=True)
class Work:
    """2 k n operations a row of each product, 4 d a (position, query
    head) pair of attention; int4 weights read once, K and V of the nkv
    heads a position."""

    products: Tuple[Tuple[int, int], ...]   # a layer's (k, n)
    layers: int
    hidden: int
    vocab: int
    heads: int
    kv_heads: int
    head_dim: int
    act: str
    kv: str

    def _weight_bytes(self, k, n):
        return quantized_bytes(k, n, self.act, 4, 32, True)

    def products_bound_s(self, m: int, head_m: int) -> float:
        total = sum(self.layers * max(product_bound(m, k, n, self._weight_bytes(k, n),
                                                    self.act, self.act, self.act))
                    for k, n in self.products)
        if head_m:
            total += max(product_bound(head_m, self.hidden, self.vocab,
                                       self._weight_bytes(self.hidden, self.vocab),
                                       self.act, "float32", self.act))
        return total

    def step_least_s(self, rows: Iterable[Tuple[int, int]], head_rows: int) -> float:
        rows = list(rows)
        tokens = sum(n for _, n in rows)
        cached = sum(c for c, _ in rows) + tokens
        attn = sum(n * c + n * (n + 1) // 2 for c, n in rows)
        flops = (2.0 * self.layers * sum(k * n for k, n in self.products) * tokens
                 + 2.0 * self.hidden * self.vocab * head_rows
                 + 4.0 * self.head_dim * self.heads * self.layers * attn)
        nbytes = (self.layers * sum(self._weight_bytes(k, n) for k, n in self.products)
                  + self._weight_bytes(self.hidden, self.vocab)
                  + 2.0 * self.layers * self.kv_heads * self.head_dim * DTYPE_BYTES[self.kv]
                  * cached)
        return max(flops / PEAK_FLOPS[self.act], nbytes / HBM_BYTES_PER_S)


def work(model: dict, deployment: dict) -> Work:
    H, nh, nkv, d = _dims(model)
    lv = leaves(model)
    return Work(tuple((lv[k].k, lv[k].n) for k in LAYER_LEAVES), model["num_layers"], H,
                model["vocab_size"], nh, nkv, d, deployment["compute_dtype"],
                deployment["kv_dtype"])
