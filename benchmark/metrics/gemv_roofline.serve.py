"""Kernel layer, serving: the b8 decode weight products' least time
(the architecture's work count, at the 8 rows the kernels compute) over the device
time of their kernels in the traced decode replays, in percent."""
from harness import readers

KERNELS = r"gs.*stream_kernel|wg.*gemm_kernel|int4k.*reduce_kernel|gp_f32_prologue"


def read(ctx):
    s, B = ctx.shapes, ctx.batch
    return readers.kernel_roofline(
        ctx, ["decode", "decode_k"], KERNELS,
        lambda r: r.steps * s.products_bound_s(B, B))
