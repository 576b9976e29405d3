"""The model's inputs: float weights drawn from the run's seed.

Each matrix is drawn on its own from (seed, leaf, layer[, index]), so the
program's set-up and the reference can each draw exactly the matrix they
need, in f32, on the device, in one call a matrix; `index` numbers the
matrices of one leaf within a layer (an expert layer's experts), so that
no more than one of them exists in f32 at a time. The same seed on the
same device gives the same values on both sides, whatever order they are
drawn in. Which leaves a model has, their shapes and their scales are
its architecture's (``arch/<name>.py``).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A drawn matrix: [k, n] f32 of standard deviation `std`, one in each
    of `layers` (-1: outside the layers), `count` of them a layer when
    indexed (0: one, drawn without an index)."""

    name: str
    k: int
    n: int
    std: float
    layers: Sequence[int] = (-1,)
    count: int = 0


def leaf_seed(seed: int, leaf: str, layer: int = -1, index: Optional[int] = None) -> int:
    entropy = [int(seed) % 2**64, zlib.crc32(leaf.encode()), layer + 1]
    if index is not None:
        entropy.append(index + 1)
    words = np.random.SeedSequence(entropy).generate_state(2)
    return int(words[0]) << 31 ^ int(words[1])


def _gen(seed: int, leaf: str, layer: int, device,
         index: Optional[int] = None) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, leaf, layer, index) % 2**63)
    return g


def draw(leaf: Leaf, seed: int, layer: int, device, index: Optional[int] = None) -> torch.Tensor:
    """Layer `layer`'s [k, n] f32 matrix of `leaf` (its `index`-th, when
    the leaf is indexed)."""
    g = _gen(seed, leaf.name, layer, device, index)
    return torch.randn((leaf.k, leaf.n), generator=g, device=device) * leaf.std


def normal(seed: int, name: str, shape: Sequence[int], device) -> torch.Tensor:
    """A standard normal f32 tensor of `shape` in one call, for the small
    leaves (norms, biases) of all layers together."""
    return torch.randn(tuple(shape), generator=_gen(seed, name, -1, device), device=device)
