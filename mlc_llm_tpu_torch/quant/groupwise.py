"""Group-wise encode/decode in PyTorch.

The counterpart of ``mlc_llm_tpu/quant/groupwise.py``: the same codes,
scales and minima, bit for bit, in the same storage layouts:

- ``u32`` / ``u16`` words ``[k_words // epw, n]``: ``epw`` codes of
  ``nbit`` bits per word, LSB first, each group padded to a whole number
  of words (int4: 8 per u32 in the pair, hsplit or qsplit order; int3: 10
  per u32 or 5 per u16; fp4: 8 per u32);
- ``i8`` planes ``[k_pad, n]`` holding ``code - max_int`` (int8);
- ``u4`` planes ``[k_pad, n]`` (``q4bf16_plane``): one code a byte, as
  ``torch.uint8``. That is the byte layout ml_dtypes gives JAX's
  ``uint4`` on the host and the bytes JAX's checkpoints hold; ``nbytes``
  counts half a byte a code, as JAX's does. No kernel reads u4 (JAX's
  ``dequant_matmul_supported`` takes u32, u16 and i8 only): a u4 matmul
  dequantizes and multiplies.

Groups run along k; columns are lane-padded (``pad_cols``). u32 words
live as ``torch.int32`` and u16 words as ``torch.int16`` holding the same
bits: torch's unsigned types lack most operators. Right shifts on signed
types are arithmetic, so every shift is followed by a mask.

fp4 codes are sign | 3-bit exponent, ``±2^(e-7)`` and 0 when e == 0, with
the group absmax as the scale.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .spec import QuantSpec, resolve_spec

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}
_WORD_DTYPES = {"u32": torch.int32, "u16": torch.int16}


def torch_dtype(name) -> torch.dtype:
    """Spec dtype name (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


def pad_cols(n: int) -> int:
    """Packed column count: the JAX layout pads large-n weights to 1024
    lanes and small-n weights to 128 (kept so checkpoints convert 1:1)."""
    mult = 1024 if n >= 4096 else 128
    return -(-n // mult) * mult


def words_per_group(spec: QuantSpec) -> int:
    """Stored rows per group: words for u32/u16, elements for i8."""
    if spec.storage == "i8":
        return spec.group_size
    return -(-spec.group_size // spec.elems_per_word)


@dataclasses.dataclass
class QuantizedTensor:
    """A packed group-quantized 2-D weight, flat or layer-stacked.

    data:  words [KW, N] (or [L, KW, N]): int32 (u32 bits) or int16 (u16
           bits); or a plane [K, N]: int8 for i8 storage, uint8 codes
           for u4.
    scale: [G, N] (or [L, G, N]) in the compute dtype.
    zero:  group minima like scale (asym), else None.
    shape: the LOGICAL (k, n).
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    spec: QuantSpec
    shape: Tuple[int, int]

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def n_groups(self) -> int:
        return self.scale.shape[-2]

    def nbytes(self) -> int:
        """Stored bytes: data (half a byte a u4 code, as JAX counts its
        uint4 plane), scales and minima."""
        data = (self.data.numel() // 2 if self.spec.storage == "u4"
                else self.data.numel() * self.data.element_size())
        return data + sum(t.numel() * t.element_size()
                          for t in (self.scale, self.zero) if t is not None)

    def map(self, fn) -> "QuantizedTensor":
        """Apply fn to every tensor field (device moves, layer slices)."""
        return QuantizedTensor(
            data=fn(self.data), scale=fn(self.scale),
            zero=None if self.zero is None else fn(self.zero),
            spec=self.spec, shape=self.shape)


def _f32_to_f4(x: torch.Tensor) -> torch.Tensor:
    """f32 -> 4-bit (sign | 3-bit exponent) code, round to nearest: the
    JAX quantizer's bit recipe (exponent rounded up by the mantissa MSB)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    m_h = (u >> 22) & 1
    e_f32 = (u >> 23) & 0xFF
    s = u >> 31
    e_f4 = torch.where(e_f32 > 120, torch.clamp(e_f32 - 120 + m_h, max=7),
                       (e_f32 == 120).to(torch.int64))
    return (s << 3) | e_f4


def _f4_to_float(code: torch.Tensor, dtype) -> torch.Tensor:
    """4-bit (sign|exp3) code -> float: ±2^(e-7), 0 when e == 0."""
    code = code.to(torch.int32)
    e = code & 7
    mag = torch.where(e == 0, torch.zeros((), dtype=torch.float32),
                      torch.exp2((e - 7).to(torch.float32)))
    return torch.where((code >> 3) == 1, -mag, mag).to(dtype)


def _interleave(codes: torch.Tensor, layout: str) -> torch.Tensor:
    """Element-order codes [K, n] -> nibble-slot order (see spec.layout)."""
    K, n = codes.shape
    if layout == "hsplit":
        kh = K // 2
        lo = codes[:kh].reshape(kh // 4, 4, n)
        hi = codes[kh:].reshape(kh // 4, 4, n)
        return torch.stack([lo, hi], dim=2).reshape(K, n)
    if layout == "qsplit":
        # slot e = 4h + f of word r holds element f*(K/4) + 2r + h
        return codes.reshape(4, K // 8, 2, n).permute(1, 2, 0, 3).reshape(K, n)
    return codes


def _restore(codes: torch.Tensor, layout: str) -> torch.Tensor:
    """Inverse of _interleave: nibble-slot order -> element order."""
    K, n = codes.shape
    if layout == "hsplit":
        a = codes.reshape(K // 8, 4, 2, n)
        kh = K // 2
        return torch.cat([a[:, :, 0].reshape(kh, n),
                          a[:, :, 1].reshape(kh, n)], dim=0)
    if layout == "qsplit":
        return codes.reshape(K // 8, 2, 4, n).permute(2, 0, 1, 3).reshape(K, n)
    return codes


def _pack_words(codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """[k_pad, n] codes -> [k_pad // epw, n] words (LSB first) as int32
    (u32 bits) or int16 (u16 bits)."""
    epw = spec.elems_per_word
    k_pad, n = codes.shape
    codes = _interleave(codes, spec.layout).to(torch.int64)
    codes = codes.reshape(k_pad // epw, epw, n)
    shifts = (torch.arange(epw, device=codes.device) * spec.nbit)[None, :, None]
    # codes occupy disjoint bit ranges, so the sum is a bitwise or
    words = (codes << shifts).sum(dim=1)
    half = 2**31 if spec.storage == "u32" else 2**15
    # the unsigned bit pattern as a signed word (two's complement)
    words = torch.where(words >= half, words - 2 * half, words)
    return words.to(_WORD_DTYPES[spec.storage])


def _unpack_words(words: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """[rows, n] int32/int16 words -> [rows * epw, n] int32 codes
    (element order). Fields never straddle the word, so an arithmetic
    shift followed by the field mask gives the unsigned field."""
    epw = spec.elems_per_word
    rows, n = words.shape
    shifts = torch.arange(epw, device=words.device, dtype=torch.int32) * spec.nbit
    codes = (words.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & ((1 << spec.nbit) - 1)
    return _restore(codes.reshape(rows * epw, n), spec.layout)


def _recip(c: int) -> torch.Tensor:
    return torch.tensor(1.0 / c, dtype=torch.float32)


def quantize(w: torch.Tensor, spec) -> QuantizedTensor:
    """Quantize a [k, n] weight (groups along k); same math as the JAX
    quantizer: f32 statistics, scales/minima stored in the compute dtype,
    round half to even."""
    spec = resolve_spec(spec)
    if not spec.is_quantized:
        raise ValueError("cannot quantize with mode='none'")
    if w.ndim != 2:
        raise ValueError(f"quantize expects a 2-D [k, n] weight, got shape {tuple(w.shape)}")
    k, n = w.shape
    g = spec.group_size
    k_pad = -(-k // g) * g
    n_groups = k_pad // g
    if spec.layout in ("hsplit", "qsplit"):
        parts = 2 if spec.layout == "hsplit" else 4
        if n_groups % parts != 0:
            raise ValueError(
                f"{spec.layout} layout needs a group count divisible by "
                f"{parts}: k={k} gives {n_groups} groups of {g}; use "
                "spec_for_k for per-shape layout fallback")
    dtype = torch_dtype(spec.dtype)
    w = w.to(torch.float32)
    if k_pad != k:
        w = torch.nn.functional.pad(w, (0, 0, 0, k_pad - k))
    wg = w.reshape(n_groups, g, n)
    # the JAX quantizer is jitted, and XLA divides by a constant as a
    # multiply by its f32 reciprocal: the f32 scales match it bit for bit
    if spec.sym:
        absmax = torch.clamp(wg.abs().amax(dim=1), min=1e-4)
        scale_st = (absmax if spec.mode == "fp4" else absmax * _recip(spec.max_int)).to(dtype)
        scaled = wg / scale_st.float()[:, None, :]
        if spec.mode == "fp4":
            codes = _f32_to_f4(scaled)
        else:
            codes = torch.clamp(torch.round(scaled) + spec.max_int, 0, 2 * spec.max_int)
        zero_st = None
    else:
        levels = (1 << spec.nbit) - 1
        gmin = wg.amin(dim=1)
        gmax = wg.amax(dim=1)
        scale_st = ((gmax - gmin) * _recip(levels)).to(dtype)
        zero_st = gmin.to(dtype)
        safe = torch.clamp(scale_st.float(), min=1e-10)
        codes = torch.round((wg - zero_st.float()[:, None, :]) / safe[:, None, :])
        codes = torch.clamp(codes, 0, levels)
    codes = codes.to(torch.int32).reshape(k_pad, n)
    if spec.storage == "u4":
        data = codes.to(torch.uint8)
    elif spec.storage == "i8":
        data = (codes - spec.max_int).to(torch.int8)
    else:
        # pad k to a whole number of words per group
        slots = words_per_group(spec) * spec.elems_per_word
        if slots != g:
            codes = torch.nn.functional.pad(
                codes.reshape(n_groups, g, n), (0, 0, 0, slots - g)).reshape(-1, n)
        data = _pack_words(codes, spec)
    n_pad = pad_cols(n)
    if n_pad != n:
        cols = (0, n_pad - n)
        data = torch.nn.functional.pad(data, cols)
        scale_st = torch.nn.functional.pad(scale_st, cols)
        if zero_st is not None:
            zero_st = torch.nn.functional.pad(zero_st, cols)
    return QuantizedTensor(data=data, scale=scale_st, zero=zero_st,
                           spec=spec, shape=(k, n))


def pad_quantized_groups(qt: QuantizedTensor, mult: int = 32) -> QuantizedTensor:
    """Zero-pad k so the group count becomes a multiple of `mult`.

    Logical shape is unchanged; padded groups have zero scale and zero
    minimum, and the activations are zero there, so every path stays
    exact. Word storage only (u32/u16), as in JAX; i8 and u4 planes stay
    as they are. Split layouts map elements by TOTAL k, so they are padded
    at the code level and repacked, one layer at a time (flat [KW, N] or
    stacked [L, KW, N])."""
    spec = qt.spec
    if not spec.is_quantized or spec.storage not in ("u32", "u16"):
        return qt
    dg = (-qt.n_groups) % mult
    if dg == 0:
        return qt

    def padrows(a, rows):
        if a is None:
            return None
        pad = [0, 0] * a.ndim
        pad[3] = rows  # axis -2, trailing edge
        return torch.nn.functional.pad(a, pad)

    if spec.layout in ("hsplit", "qsplit"):
        def repack(d2):
            codes = _unpack_words(d2, spec).to(torch.uint8)
            codes = torch.nn.functional.pad(codes, (0, 0, 0, dg * spec.group_size))
            return _pack_words(codes, spec)

        data = (torch.stack([repack(d) for d in qt.data])
                if qt.data.ndim == 3 else repack(qt.data))
    else:
        data = padrows(qt.data, dg * words_per_group(spec))
    return QuantizedTensor(data=data, scale=padrows(qt.scale, dg),
                           zero=padrows(qt.zero, dg), spec=spec, shape=qt.shape)


def to_pair_layout(qt: QuantizedTensor) -> QuantizedTensor:
    """Repack a split-packed (hsplit/qsplit) tensor into the pair element
    order, exactly: the same codes and scales, only the element -> bit
    slot map changes. The split maps are global in k (hsplit pairs q with
    K/2 + q; qsplit spreads a word over four quarters), so a contiguous
    split of k (row-parallel sharding) is shard-local only in the pair
    order. Flat [KW, N] or stacked [L, KW, N] (one layer at a time); any
    other tensor is returned as it is."""
    spec = qt.spec
    if spec.layout not in ("hsplit", "qsplit"):
        return qt
    pair = dataclasses.replace(spec, layout="pair")

    def repack(d2):
        return _pack_words(_unpack_words(d2, spec).to(torch.uint8), pair)

    data = (torch.stack([repack(d) for d in qt.data]) if qt.data.ndim == 3
            else repack(qt.data))
    return QuantizedTensor(data=data, scale=qt.scale, zero=qt.zero, spec=pair, shape=qt.shape)


def _codes(qt: QuantizedTensor) -> torch.Tensor:
    """Storage -> per-element integer codes [k_stored, n] (int32)."""
    spec = qt.spec
    if spec.storage == "u4":
        return qt.data.to(torch.int32)
    if spec.storage == "i8":
        return qt.data.to(torch.int32) + spec.max_int
    return _unpack_words(qt.data, spec)


def dequantize(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Decode a flat tensor to a dense [k, n] array: ``q*s + z`` (asym),
    ``(q - max_int)*s`` (sym int) or ``f4(q)*s`` (fp4), each op rounded
    in the output dtype."""
    spec = qt.spec
    out_dtype = torch_dtype(dtype or spec.dtype)
    k, n = qt.shape
    g = spec.group_size
    G = qt.n_groups
    codes = _codes(qt)  # [k_stored, n_stored] (columns may be lane-padded)
    n_stored = codes.shape[1]
    # words are packed per group: the first g of each group's slots are real
    codes = codes.reshape(G, -1, n_stored)[:, :g]
    scale = qt.scale.to(out_dtype)[:, None, :]
    if spec.mode == "fp4":
        w = _f4_to_float(codes, out_dtype) * scale
    elif spec.sym:
        w = (codes - spec.max_int).to(out_dtype) * scale
    else:
        w = codes.to(out_dtype) * scale + qt.zero.to(out_dtype)[:, None, :]
    return w.reshape(G * g, n_stored)[:k, :n]


def take_dequantize(qt: QuantizedTensor, indices: torch.Tensor,
                    dtype=None) -> torch.Tensor:
    """Fused gather + dequant for a quantized embedding stored transposed
    as [hidden, vocab]: gathers columns, returns [*indices.shape, hidden]."""
    flat = indices.reshape(-1)
    sub = QuantizedTensor(
        data=qt.data[:, flat], scale=qt.scale[:, flat],
        zero=None if qt.zero is None else qt.zero[:, flat],
        spec=qt.spec, shape=(qt.shape[0], flat.shape[0]))
    dense = dequantize(sub, dtype)  # [hidden, num_indices]
    return dense.T.reshape(*indices.shape, qt.shape[0])
