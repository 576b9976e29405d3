"""The norms, and one norm site of the decoder in one launch (kernel 9).

``rms_norm`` and ``layer_norm`` are the JAX package's
(``mlc_llm_tpu/models/layers.py``): f32 statistics, the result in the
input dtype. A norm site of the decoder is the residual sum that ends a
layer (or its first half, under the sequential residual) and the norm(s)
that read it: ``residual_norm`` takes the residual h, 0-2 terms (the
attention and MLP outputs, each with its optional row-parallel bias) and
1 or 2 norm parameter sets (ln1 and ln2 of a parallel-residual layer read
the same h), and returns h' and the normalised rows.

On CPU tensors it runs ``residual_norm_plain``, the op chain the decoder
ran before the kernel: ``t + bias`` and ``h + t`` in the dtype, the clamp,
then each norm. On CUDA tensors it launches ``csrc/residual_norm.cu`` or
raises: the same rounding points, the sums in the kernel's order
(``launch_plan``). ``residual_norm_supported`` is the shape gate the
kernel holds a CUDA site to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import check_launch, load_kernel

# the kernel's element types (csrc/residual_norm.cu enum DType)
NORM_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
NORM_KINDS = ("layernorm", "rmsnorm")
MAX_THREADS = 512  # rn::kMaxThreads
VPTS = (1, 2, 4)  # 16-byte vectors a thread, the kernel's instantiations

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_ARGS = {"mlc_residual_norm": [_P] * 12 + [_L] * 3 + [_I] * 5 + [_F] * 2 + [_I] * 3 + [_P]}


def rms_norm(x, w, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layer_norm(x, w, b, eps: float):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def _vec(dtype) -> int:
    """Elements of dtype a 16-byte vector."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def launch_plan(H: int, dtype) -> Tuple[int, int]:
    """(VPT, threads) of a row of H elements of dtype: VPT 16-byte vectors
    a thread (the least of VPTS that keeps the block at MAX_THREADS),
    threads a multiple of 32. Thread t owns vectors t, t + threads, ...,
    t + (VPT - 1) * threads. Shapes only."""
    nvec = -(-H // _vec(dtype))
    vpt = next((v for v in VPTS if -(-nvec // v) <= MAX_THREADS), VPTS[-1])
    threads = -(-nvec // vpt)
    return vpt, -(-threads // 32) * 32


def residual_norm_supported(H: int, dtype) -> bool:
    """The kernel takes rows of H elements of dtype: bf16, f16 or f32, H a
    whole number of 16-byte vectors, and at most MAX_THREADS threads of
    VPTS[-1] vectors."""
    if dtype not in NORM_TYPES:
        return False
    vec = _vec(dtype)
    return H > 0 and H % vec == 0 and H <= MAX_THREADS * VPTS[-1] * vec


def residual_norm_plain(h, terms: Sequence = (), biases: Sequence = (), norms: Sequence = (),
                        eps: float = 1e-5, kind: str = "layernorm",
                        clamp: Optional[float] = None):
    """The op chain: each term plus its bias in the dtype, added to h in
    order, h clamped to +-clamp (None: not), then each norm of h. Returns
    (h', [normalised rows])."""
    for t, b in zip(terms, biases):
        if b is not None:
            t = t + b.to(t.dtype)
        h = h + t
    if clamp is not None:
        h = h.clamp(-clamp, clamp)
    if kind == "rmsnorm":
        return h, [rms_norm(h, w, eps) for w, _ in norms]
    return h, [layer_norm(h, w, b, eps) for w, b in norms]


def _check_args(h, terms, biases, norms, kind, clamp) -> list:
    """Raise on arguments neither path takes (the kernel reads h and the
    terms as rows at one stride, ``row_stride``, so the CPU path asks for
    that too); returns the [H] parameters given."""
    H = h.shape[-1]
    if kind not in NORM_KINDS:
        raise ValueError(f"residual_norm: kind {kind!r} is not one of {NORM_KINDS}")
    if clamp is not None and not clamp > 0:
        raise ValueError(f"residual_norm: clamp {clamp} is not positive")
    if clamp is not None and not terms:
        # the clamp bounds the residual sum; with no term there is none
        raise ValueError("residual_norm: a clamp is given with no terms")
    if len(terms) > 2 or len(biases) != len(terms) or not 1 <= len(norms) <= 2:
        raise ValueError(f"residual_norm: 0-2 terms with one bias slot each and 1-2 norms, got "
                         f"{len(terms)} terms, {len(biases)} biases, {len(norms)} norms")
    for t in terms:
        if t.shape != h.shape or t.dtype != h.dtype:
            raise ValueError(f"residual_norm: a term {t.dtype}{list(t.shape)} differs from h "
                             f"{h.dtype}{list(h.shape)}")
    for t in (h, *terms):
        if row_stride(t) is None:
            raise ValueError(f"residual_norm: a tensor of shape {list(t.shape)} and strides "
                             f"{t.stride()} is not rows of contiguous elements")
    params = [b for b in biases if b is not None] + [p for w, b in norms for p in (w, b)
                                                     if p is not None]
    for w, b in norms:
        if (b is None) != (kind == "rmsnorm"):
            raise ValueError(f"residual_norm: a {kind} takes "
                             f"{'no shift' if kind == 'rmsnorm' else 'a shift'}")
    for p in params:
        if p.shape != (H,) or not p.is_contiguous():
            raise ValueError(f"residual_norm: a parameter of shape {list(p.shape)}, strides "
                             f"{p.stride()}, not a contiguous [{H}]")
    return params


def row_stride(t) -> Optional[int]:
    """The stride between t's rows when t [..., H] is rows of H contiguous
    elements at one stride, apart and in order (a column slice of a wider
    buffer is), else None."""
    if t.dim() == 0 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return None
    stride = expect = None
    for d in range(t.dim() - 2, -1, -1):
        if t.shape[d] == 1:
            continue
        if expect is None:
            stride = expect = t.stride(d)
        elif t.stride(d) != expect:
            return None
        expect *= t.shape[d]
    if stride is None:
        return t.shape[-1]
    return stride if stride >= t.shape[-1] else None


def _check_card(h, terms, params):
    H = h.shape[-1]
    if not residual_norm_supported(H, h.dtype):
        raise NotImplementedError(
            f"residual_norm: the CUDA kernel does not take rows of {H} {h.dtype} elements "
            "(residual_norm_supported)")
    for t in (h, *terms, *params):
        if t.device != h.device:
            raise ValueError("residual_norm: tensors on different devices")
        if t.dtype != h.dtype:
            raise NotImplementedError(
                f"residual_norm: the CUDA kernel takes parameters in h's dtype {h.dtype}, "
                f"got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError("residual_norm: every tensor must be 16-byte aligned")
    vec = _vec(h.dtype)
    if any(row_stride(t) % vec for t in (h, *terms)):
        raise ValueError("residual_norm: a row stride of h or a term is not whole 16-byte "
                         "vectors")


@functools.lru_cache(maxsize=None)
def _bound_in(clamp: float, dtype) -> float:
    """clamp as torch.clamp applies it to a tensor of dtype: rounded to it."""
    return float(torch.tensor(clamp, dtype=dtype))


def residual_norm(h, terms: Sequence = (), biases: Sequence = (), norms: Sequence = (),
                  eps: float = 1e-5, kind: str = "layernorm", clamp: Optional[float] = None):
    """One norm site: h [..., H] plus 0-2 terms of h's shape and dtype
    (biases: one [H] bias or None a term), clamped to +-clamp (None: not),
    then 1 or 2 norms (norms: (w, b) pairs, b None for "rmsnorm") of the
    result with eps. Returns (h', [one [..., H] tensor a norm]), h' being h
    itself when no term is given. CPU tensors run residual_norm_plain;
    CUDA tensors launch the kernel or raise."""
    terms, biases, norms = list(terms), list(biases), list(norms)
    params = _check_args(h, terms, biases, norms, kind, clamp)
    if h.device.type == "cpu":
        return residual_norm_plain(h, terms, biases, norms, eps, kind, clamp)
    _check_card(h, terms, params)
    H = h.shape[-1]
    R = h.numel() // H
    h_out = torch.empty(h.shape, dtype=h.dtype, device=h.device) if terms else h
    outs = [torch.empty(h.shape, dtype=h.dtype, device=h.device) for _ in norms]
    if R == 0:
        return h_out, outs
    vpt, threads = launch_plan(H, h.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    pad = [None, None]
    t0, t1 = ([ptr(t) for t in terms] + pad)[:2]
    tb0, tb1 = ([ptr(b) for b in biases] + pad)[:2]
    (w0, b0), (w1, b1) = ([(ptr(w), ptr(b)) for w, b in norms] + [(None, None)])[:2]
    o0, o1 = ([ptr(o) for o in outs] + pad)[:2]
    lib = load_kernel("residual_norm", _ARGS)
    hs, ts0, ts1 = ([row_stride(t) for t in (h, *terms)] + [H, H])[:3]
    err = lib.mlc_residual_norm(
        h.data_ptr(), t0, t1, tb0, tb1, w0, b0, w1, b1, ptr(h_out) if terms else None, o0, o1,
        hs, ts0, ts1, R, H, len(terms), len(norms), int(kind == "rmsnorm"), float(eps),
        _bound_in(clamp, h.dtype) if clamp is not None else 0.0, NORM_TYPES[h.dtype], vpt,
        threads, torch.cuda.current_stream(h.device).cuda_stream)
    check_launch(err, "residual_norm")
    residual_norm.launches += 1
    return h_out, outs


residual_norm.launches = 0
