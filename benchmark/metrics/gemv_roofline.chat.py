"""Kernel layer, chat: the decode weight products' least time (each
product's bytes or operations, the architecture's work count) over the device time
of the kernels that compute them in the traced decode replays, in percent.
The products' kernels: the weight-streaming GEMV at m = 1 and the
tensor-core path at m >= 2, with its split-k reduction."""
from harness import readers

KERNELS = r"gs.*stream_kernel|wg.*gemm_kernel|int4k.*reduce_kernel|gp_f32_prologue"


def read(ctx):
    s, B = ctx.shapes, ctx.batch
    return readers.kernel_roofline(
        ctx, ["decode", "decode_k"], KERNELS,
        lambda r: r.steps * s.products_bound_s(B, B))
