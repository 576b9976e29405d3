"""The model's inputs: float weights drawn from the run's seed.

Each large matrix is drawn on its own from (seed, leaf, layer), so the
program's set-up and the reference can each draw exactly the layer they
need, in f32, on the device, in one call a matrix; the small leaves
(norms, biases) of all layers come in one call a leaf kind. The same seed
on the same device gives the same values on both sides.

Scales follow GPT-NeoX's initialisation (``small_init`` and ``wang_init``
of its ``init_functions.py``): std sqrt(2 / (5 H)) for the embedding, the
input-side products and the lm head, 2 / (L sqrt(H)) for the output-side
products (wo, w_out). It keeps a deep random stack well conditioned
(trained weights are), where a flat 0.02 at these widths makes every
layer amplify the roundings of the one before.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import numpy as np
import torch

BIG = ("wqkv", "wo", "w_in", "w_out")


def leaf_seed(seed: int, leaf: str, layer: int = -1) -> int:
    words = np.random.SeedSequence(
        [int(seed) % 2**64, zlib.crc32(leaf.encode()), layer + 1]).generate_state(2)
    return int(words[0]) << 31 ^ int(words[1])


def _gen(seed: int, leaf: str, layer: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, leaf, layer) % 2**63)
    return g


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


def layer_matrix(model: dict, seed: int, leaf: str, layer: int, device) -> torch.Tensor:
    """Layer `layer`'s [k, n] f32 weight `leaf` (one of BIG)."""
    k, n = shapes(model)[leaf]
    g = _gen(seed, leaf, layer, device)
    return torch.randn((k, n), generator=g, device=device) * stds(model)[leaf]


def embedding(model: dict, seed: int, device) -> torch.Tensor:
    """[V, H] f32."""
    g = _gen(seed, "embed", -1, device)
    return torch.randn((model["vocab_size"], model["hidden_size"]), generator=g,
                       device=device) * stds(model)["embed"]


def lm_head(model: dict, seed: int, device) -> torch.Tensor:
    """[H, V] f32."""
    g = _gen(seed, "lm_head", -1, device)
    return torch.randn((model["hidden_size"], model["vocab_size"]), generator=g,
                       device=device) * stds(model)["lm_head"]


def small_leaves(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Norm scales (1 + 0.1 N) and shifts, biases (0.02 N), in f32: the
    per-layer ones stacked [L, n], then final_ln_w, final_ln_b and the lm
    head's bias where the family has them."""
    H, L = model["hidden_size"], model["num_layers"]
    k_qkv, n_qkv = shapes(model)["wqkv"]
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
        z = torch.randn(shp, generator=_gen(seed, name, -1, device), device=device)
        out[name] = 1.0 + 0.1 * z if name.endswith("_w") else 0.02 * z
    return out
