"""The dense GPT-NeoX and MOSS (GPT-J-style) block: the architecture of a
configuration that names none.

Draws. Each layer holds four products, wqkv [H, (nh + 2 nkv) d] with its
columns [q | k | v], each head-major, wo [nh d, H], w_in [H, F] (2 F for
a gated MLP) and w_out [F, H]; the embedding [V, H] and the lm head
[H, V] sit outside the layers. Scales follow GPT-NeoX's initialisation
(``small_init`` and ``wang_init`` of its ``init_functions.py``): std
sqrt(2 / (5 H)) for the embedding, the input-side products and the lm
head, 2 / (L sqrt(H)) for the output-side products (wo, w_out). It keeps
a deep random stack well conditioned (trained weights are), where a flat
0.02 at these widths makes every layer amplify the roundings of the one
before. Norm scales are 1 + 0.1 N and their shifts and the biases 0.02 N,
all layers' of one kind in one call.

The plain reference follows the published blocks. GPT-NeoX
(``use_parallel_residual``): h + attn(LN1(h)) + mlp(LN2(h)), exact GELU,
rotary "rotate half" on the first ``rotary_pct`` of each head, biases on
every product, the lm head without bias. MOSS / GPT-J: one LayerNorm
feeding both branches, h + attn(LN(h)) + mlp(LN(h)), tanh GELU, rotary on
interleaved pairs of the first ``rotary_dim`` channels, no attention
biases, an lm head with bias. Attention is causal softmax(q k^T / sqrt(D))
v.

The work count: 2 k n operations a row of each of the four products and
of the lm head, 4 D a (position, query head) pair of attention; every
weight read once as int4 codes in groups of 32 with a scale and a minimum;
K and V of every head a position.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from harness import program, weights
from harness.roofline import (DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS, product_bound,
                              quantized_bytes)
from reference.model import Plain, exact_f32, layer_norm, rotary
from reference.quant import int4_asym

BIG = ("wqkv", "wo", "w_in", "w_out")


# ---- draws

def shapes(model: dict) -> Dict[str, tuple]:
    """(k, n) of each layer's products, as the port's tree holds them."""
    H, F = model["hidden_size"], model["intermediate_size"]
    nh, nkv = model["num_heads"], model["num_kv_heads"]
    d = H // nh
    gated = model.get("act") == "silu_gated"
    return {"wqkv": (H, (nh + 2 * nkv) * d), "wo": (nh * d, H),
            "w_in": (H, 2 * F if gated else F), "w_out": (F, H)}


def stds(model: dict) -> Dict[str, float]:
    H, L = model["hidden_size"], model["num_layers"]
    small = math.sqrt(2.0 / (5.0 * H))
    wang = 2.0 / (L * math.sqrt(H))
    return {"wqkv": small, "w_in": small, "wo": wang, "w_out": wang, "embed": small,
            "lm_head": small}


def leaves(model: dict) -> Dict[str, weights.Leaf]:
    """The drawn matrices: the four of every layer, the embedding [V, H]
    and the lm head [H, V]."""
    H, V, L = model["hidden_size"], model["vocab_size"], model["num_layers"]
    std = stds(model)
    out = {leaf: weights.Leaf(leaf, k, n, std[leaf], tuple(range(L)))
           for leaf, (k, n) in shapes(model).items()}
    out["embed"] = weights.Leaf("embed", V, H, std["embed"])
    out["lm_head"] = weights.Leaf("lm_head", H, V, std["lm_head"])
    return out


def small_leaves(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Norm scales (1 + 0.1 N) and shifts, biases (0.02 N), in f32: the
    per-layer ones stacked [L, n], then final_ln_w, final_ln_b and the lm
    head's bias where the family has them."""
    H, L = model["hidden_size"], model["num_layers"]
    n_qkv = shapes(model)["wqkv"][1]
    n_in = shapes(model)["w_in"][1]
    want = {"ln1_w": (L, H), "ln1_b": (L, H)}
    if not model.get("single_norm"):
        want.update(ln2_w=(L, H), ln2_b=(L, H))
    if model.get("qkv_bias"):
        want["bqkv"] = (L, n_qkv)
    if model.get("out_bias"):
        want["bo"] = (L, H)
    if model.get("mlp_bias"):
        want.update(b_in=(L, n_in), b_out=(L, H))
    want.update(final_ln_w=(H,), final_ln_b=(H,))
    if model.get("lm_head_bias"):
        want["lm_head_b"] = (model["vocab_size"],)
    out = {}
    for name, shp in want.items():
        z = weights.normal(seed, name, shp, device)
        out[name] = 1.0 + 0.1 * z if name.endswith("_w") else 0.02 * z
    return out


# ---- the port's parameter tree

def build_params(model: dict, deployment: dict, seed: int, device):
    """The port's parameter tree from the seed's draws: every product
    quantized by the port's quantizer in the deployment's preset (the
    embedding stored transposed [H, V], as the port's q4 trees hold it),
    norms and biases in the compute type, the rotary tables the port makes."""
    from mlc_llm_tpu_torch.models.layers import make_rotary_tables
    from mlc_llm_tpu_torch.quant import quantize, resolve_spec, spec_for_k
    from mlc_llm_tpu_torch.quant.groupwise import torch_dtype

    cfg = program.model_config(model)
    spec = resolve_spec(deployment["quantization"])
    dtype = torch_dtype(spec.dtype)
    lv = leaves(model)
    layers = {}
    for leaf in BIG:
        lf = lv[leaf]
        layers[leaf] = program.stack_quantized(
            (weights.draw(lf, seed, l, device) for l in lf.layers), len(lf.layers), quantize,
            spec_for_k(spec, lf.k))
    small = small_leaves(model, seed, device)
    for name, t in small.items():
        if t.dim() == 2:
            layers[name] = t.to(dtype)
    head_spec = (dataclasses.replace(spec, dtype="float32") if cfg.fp32_lm_head else spec)
    H = cfg.hidden_size
    emb = weights.draw(lv["embed"], seed, -1, device)
    embed = quantize(emb.T, spec_for_k(spec, H))
    del emb
    head = quantize(weights.draw(lv["lm_head"], seed, -1, device), spec_for_k(head_spec, H))
    cos, sin = make_rotary_tables(cfg.head_dim, cfg.rotary_pct, cfg.rotary_base,
                                  cfg.max_seq_len, cfg.rotary_style, device=device)
    params = {"embed": {"w": embed}, "layers": layers,
              "final_ln": {"w": small["final_ln_w"].to(dtype), "b": small["final_ln_b"].to(dtype)},
              "lm_head": {"w": head}, "rotary": {"cos": cos, "sin": sin}}
    if "lm_head_b" in small:
        params["lm_head"]["b"] = small["lm_head_b"].to(
            torch.float32 if cfg.fp32_lm_head else dtype)
    return cfg, params


# ---- the plain reference

def gelu(x, kind: str):
    if kind == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if kind == "gelu_new":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    raise ValueError(f"the reference has no activation {kind!r}")


class Reference(Plain):
    """The block in f32, layer by layer, with no kernel, cache or batching
    of the program (the fp8 and bf16 controls: ``reference.model``)."""

    def _attention(self, qkv: torch.Tensor) -> torch.Tensor:
        m = self.m
        S = qkv.shape[0]
        nh, nkv = m["num_heads"], m["num_kv_heads"]
        d = m["hidden_size"] // nh
        q, k, v = qkv.split([nh * d, nkv * d, nkv * d], dim=-1)
        rd = int(d * m.get("rotary_pct", 1.0))
        base = m.get("rotary_base", 10000.0)
        q = self._lo(rotary(q.reshape(S, nh, d), rd, base, m["rotary_style"])).transpose(0, 1)
        k = self._lo(rotary(k.reshape(S, nkv, d), rd, base, m["rotary_style"])).transpose(0, 1)
        v = self._lo(v.reshape(S, nkv, d)).transpose(0, 1)
        return self._causal(q, k, v, d)

    def _layer(self, h, W: Dict[str, torch.Tensor], sm: Dict[str, torch.Tensor]):
        m = self.m
        eps = m.get("norm_eps", 1e-5)
        lo = self._lo
        x1 = lo(layer_norm(h, sm["ln1_w"], sm["ln1_b"], eps))
        qkv = self._mm(x1, W["wqkv"])
        if "bqkv" in sm:
            qkv = lo(qkv + sm["bqkv"])
        attn = self._mm(self._attention(qkv), W["wo"])
        if "bo" in sm:
            attn = lo(attn + sm["bo"])

        def mlp(x):
            y = self._mm(x, W["w_in"])
            if "b_in" in sm:
                y = lo(y + sm["b_in"])
            y = self._mm(lo(gelu(y, m["act"])), W["w_out"])
            return lo(y + sm["b_out"]) if "b_out" in sm else y

        if m.get("single_norm"):
            return lo(h + attn + mlp(x1))
        if m.get("parallel_residual"):
            return lo(h + attn + mlp(lo(layer_norm(h, sm["ln2_w"], sm["ln2_b"], eps))))
        h = lo(h + attn)
        return lo(h + mlp(lo(layer_norm(h, sm["ln2_w"], sm["ln2_b"], eps))))

    @torch.no_grad()
    def logits(self, segments: Sequence[Sequence[int]],
               wanted: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """f32 logits [len(wanted[i]), V] at positions wanted[i] of each
        token segment (a segment starts at position 0)."""
        m, dev, seed = self.m, self.device, self.seed
        lv = leaves(m)
        with exact_f32():
            emb = int4_asym(weights.draw(lv["embed"], seed, -1, dev).T, self.act)  # [H, V]
            toks = [torch.as_tensor(list(s), dtype=torch.long, device=dev) for s in segments]
            hs = [self._lo(emb[:, t].T.contiguous()) for t in toks]
            del emb
            small = small_leaves(m, seed, dev)
            for layer in range(m["num_layers"]):
                W = {leaf: int4_asym(weights.draw(lv[leaf], seed, layer, dev), self.act)
                     for leaf in BIG}
                sm = {k: v[layer] for k, v in small.items() if v.dim() == 2}
                hs = [self._layer(h, W, sm) for h in hs]
                del W
            head = int4_asym(weights.draw(lv["lm_head"], seed, -1, dev), self.head_dtype)
            eps = m.get("norm_eps", 1e-5)
            out = []
            for h, want in zip(hs, wanted):
                x = self._lo(layer_norm(
                    h[torch.as_tensor(list(want), dtype=torch.long, device=dev)],
                    small["final_ln_w"], small["final_ln_b"], eps))
                y = self._mm(x, head, head=True)
                if "lm_head_b" in small:
                    y = y + small["lm_head_b"]
                out.append(y)
            return out


# ---- the work count

@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the formulas need of a configuration as it is run."""

    hidden: int
    ffn: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    gated: bool            # w_in holds gate and up (2 * ffn columns)
    act_dtype: str         # the layers' compute dtype
    head_dtype: str        # the lm head's activation and scale dtype
    kv_dtype: str          # the KV cache's element type
    bits: int = 4          # weight code width
    group: int = 32        # group length along k
    asym: bool = True      # a minimum beside each scale

    @classmethod
    def of(cls, model: dict, deployment: dict) -> "Shapes":
        d = model["hidden_size"] // model["num_heads"]
        act = deployment["compute_dtype"]
        return cls(hidden=model["hidden_size"], ffn=model["intermediate_size"],
                   layers=model["num_layers"], heads=model["num_heads"],
                   kv_heads=model["num_kv_heads"], head_dim=d, vocab=model["vocab_size"],
                   gated=model.get("act") == "silu_gated", act_dtype=act,
                   head_dtype="float32" if model.get("fp32_lm_head") else act,
                   kv_dtype=deployment["kv_dtype"])

    def step_least_s(self, rows: Iterable[Tuple[int, int]], head_rows: int) -> float:
        return step_least_s(self, rows, head_rows)

    def products_bound_s(self, m: int, head_m: int) -> float:
        return products_bound_s(self, m, head_m)


def work(model: dict, deployment: dict) -> Shapes:
    return Shapes.of(model, deployment)


def layer_products(s: Shapes) -> List[Tuple[str, int, int]]:
    """(name, k, n) of one layer's weight products."""
    qkv = (s.heads + 2 * s.kv_heads) * s.head_dim
    return [("wqkv", s.hidden, qkv), ("wo", s.heads * s.head_dim, s.hidden),
            ("w_in", s.hidden, 2 * s.ffn if s.gated else s.ffn), ("w_out", s.ffn, s.hidden)]


def weight_bytes(s: Shapes, k: int, n: int, scale_dtype: str) -> float:
    """Logical stored bytes of a quantized [k, n] weight."""
    return quantized_bytes(k, n, scale_dtype, s.bits, s.group, s.asym)


def layer_weight_bytes(s: Shapes) -> float:
    """One layer's."""
    return sum(weight_bytes(s, k, n, s.act_dtype) for _, k, n in layer_products(s))


def head_weight_bytes(s: Shapes) -> float:
    return weight_bytes(s, s.hidden, s.vocab, s.head_dtype)


def layer_params(s: Shapes) -> int:
    """One layer's."""
    return sum(k * n for _, k, n in layer_products(s))


def products_bound_s(s: Shapes, m: int, head_m: int) -> float:
    """Least seconds of one forward's weight products, each bounded alone:
    the L layers' four at m rows and the lm head at head_m rows (0: none)."""
    total = 0.0
    for _, k, n in layer_products(s):
        total += s.layers * max(product_bound(m, k, n, weight_bytes(s, k, n, s.act_dtype),
                                              s.act_dtype, s.act_dtype, s.act_dtype))
    if head_m:
        total += max(product_bound(head_m, s.hidden, s.vocab, head_weight_bytes(s),
                                   s.head_dtype, "float32", s.head_dtype))
    return total


def kv_bytes_per_token(s: Shapes) -> float:
    """K and V of one position over every layer."""
    return 2.0 * s.layers * s.kv_heads * s.head_dim * DTYPE_BYTES[s.kv_dtype]


def step_least_s(s: Shapes, rows: Iterable[Tuple[int, int]], head_rows: int) -> float:
    """Least seconds of one forward that appends rows = [(context, new
    tokens)] (context: positions already cached; new: real tokens this
    forward adds) and runs the lm head on head_rows rows: the larger of its
    operations at the compute type's peak and its bytes at the HBM peak.
    Operations: 2 x the L layers' params a new token, 2 x hidden x vocab a head row,
    and causal attention, 4 D (context + j + 1) a query head of new token j
    in every layer. Bytes: every weight once (head included), the context's
    K/V read once, the new tokens' K/V written once."""
    tokens, attn_pos, ctx = 0, 0, 0
    for c, n in rows:
        tokens += n
        ctx += c
        attn_pos += n * c + n * (n + 1) // 2
    flops = (2.0 * s.layers * layer_params(s) * tokens + 2.0 * s.hidden * s.vocab * head_rows
             + 4.0 * s.head_dim * s.heads * s.layers * attn_pos)
    nbytes = (s.layers * layer_weight_bytes(s) + head_weight_bytes(s)
              + kv_bytes_per_token(s) * (ctx + tokens))
    return max(flops / PEAK_FLOPS[s.act_dtype], nbytes / HBM_BYTES_PER_S)
