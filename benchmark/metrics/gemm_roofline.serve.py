"""Kernel layer, serving: the admissions' layer weight products at the
rows their kernels are handed (the bucket) against the device time of the
tensor-core GEMM kernels in the traced admission replays, in percent."""
from harness import readers

KERNELS = r"wg.*gemm_kernel|int4k.*reduce_kernel|tf32_split_kernel|pair_offsets_kernel"


def read(ctx):
    s = ctx.shapes
    return readers.kernel_roofline(
        ctx, ["prefill_slots"], KERNELS,
        lambda r: s.products_bound_s(r.key[1] * r.key[2], 0))
