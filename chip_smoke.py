"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the last line):

1. card identity (nvidia-smi name and power limit), then the kernels are
   built from csrc/ with nvcc, one process per source, all at once
   (build seconds printed);
2. kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at the Vicuna-7B q4bf16 shapes of the main paths
   (GEMV at m=1 and m=8, GEMM at m=128 and m=2048 and on the flat lm head
   at m=128; paged flash-decode at batch 8 over mixed lengths, bf16 and
   int8 KV), with kernel, plain, bound and library times;
3. parity phase: a 2-layer Vicuna-7B at full width, the same params
   through forward on the card (kernels) and on the CPU (plain versions),
   logits compared for a 64-token prefill and 4 decode steps; then on the
   card, 8 slots of mixed prompt lengths, the paged cache against the slot
   cache (bf16) and int8 paged KV against bf16 paged KV, for a prefill and
   4 decode steps;
4. chat phase: full-depth Vicuna-7B q4bf16 on random weights through
   InferenceEngine and ChatSession (slot cache, batch 1), 3 greedy turns
   of 32 new tokens, with the launch counters held to the counts the path
   implies;
5. serve phase: the same model behind SchedulerServer
   (ContinuousBatchingScheduler over InferenceEngine(kv_layout="paged",
   max_batch=8, max_seq_len=2048, page_size=128)); 16 requests from a
   seed submitted by RemoteScheduler over localhost, with TTFT, decode
   rates, step wall and launch counts; then a shorter in-process run
   with int8 KV under kv_layout="auto", which must resolve to paged;
6. one JSON line of kernels, the card line, and the final ok line.

Every launch counter is set to 0 just before a path is driven and read
just after; launches made to compare a kernel with its plain version do
not count. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from mlc_llm_tpu_torch.engine import GenerationConfig, InferenceEngine
from mlc_llm_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from mlc_llm_tpu_torch.engine.session import ChatConfig, ChatSession
from mlc_llm_tpu_torch.models import (
    forward,
    get_config,
    init_kv_cache,
    init_paged_kv_cache,
    init_random_params,
)
from mlc_llm_tpu_torch.models.transformer import tree_map
from mlc_llm_tpu_torch.ops import build_kernels
from mlc_llm_tpu_torch.ops import dequant_matmul as dm
from mlc_llm_tpu_torch.ops import paged_attention as pa
from mlc_llm_tpu_torch.parallel.wire import RemoteScheduler, SchedulerServer
from mlc_llm_tpu_torch.quant import QuantizedTensor, pad_quantized_groups, quantize
from mlc_llm_tpu_torch.quant.groupwise import dequantize
from mlc_llm_tpu_torch.tokenizer import ByteTokenizer

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s and bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
KERNEL_TOL = 1e-2      # atol and rtol, kernel vs its plain version
# card (kernels) vs CPU (plain versions) logits, as a share of the largest
# |logit|. Activations are bf16 between ops; a bf16 rounding that goes the
# other way after an f32 sum in another order (0.4%) is amplified by the
# random full-width layers (gain 0.02*sqrt(4096) = 1.3 per matmul). On an
# H100 one decode step differed by 4.2% of max |logit| card vs CPU in
# this phase; a wrong layout, group or scale differs by ~100%.
LOGIT_RTOL = 1e-1
# int8 against bf16 KV, same share: an absmax/127 code steps by ~1/40 of a
# row's spread where bf16 rounds each value by 1/256 of itself, so int8 KV
# moves the logits several times as far as the bf16 roundings above
INT8_LOGIT_RTOL = 2e-1
VICUNA = get_config("vicuna-v1-7b")
SHAPES = [  # (name, k, n) of the main path's quantized matmuls
    ("wqkv", 4096, 12288),
    ("wo", 4096, 4096),
    ("w_in", 4096, 22016),
    ("w_out", 11008, 4096),
    ("lm_head", 4096, 32000),
]
SOURCES = {
    "gemv_qs": ("mlc_llm_tpu_torch/csrc/dequant_gemv_qs.cu",
                "mlc_llm_tpu/ops/pallas/dequant_matmul.py:1430"),
    "gemm_qs": ("mlc_llm_tpu_torch/csrc/dequant_gemm_qs.cu",
                "mlc_llm_tpu/ops/pallas/dequant_matmul.py:1670"),
    "paged_flash_decode": ("mlc_llm_tpu_torch/csrc/paged_flash_decode.cu",
                           "mlc_llm_tpu/ops/pallas/paged_attention.py:145"),
}
# the serve phase's paged pool and the kernel phase's paged shapes
PAGE_SIZE, SERVE_BATCH, SERVE_SEQ = 128, 8, 2048
PAGED_LENGTHS = [1, 127, 128, 511, 1023, 1024, 1536, 2047]
PAGED_WINDOW = 16  # pages: SERVE_SEQ / PAGE_SIZE
PAGED_HEAD_BLOCK = 8


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def reset_counters():
    dm.gemv_qs.launches = dm.gemm_qs.launches = pa.paged_flash_decode.launches = 0


def read_counters():
    return {"gemv_qs": dm.gemv_qs.launches, "gemm_qs": dm.gemm_qs.launches,
            "paged_flash_decode": pa.paged_flash_decode.launches}


def time_ms(fn, flush, reps: int) -> float:
    """Mean device time of fn over reps launches (CUDA events). Before
    each launch a pass over `flush` evicts the 50 MB L2, and a ~1 ms device
    spin keeps the device busy while the host enqueues fn, so the events
    hold no host time. The flush READS the buffer: a write would leave the
    L2 full of dirty lines whose write-back slows the timed kernel."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.sum()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def bound(m: int, k: int, n: int, groups: int, out_bytes: int):
    """Least time (ms) for y[m,n] = x[m,k] @ dequant(W): every input read
    once (x bf16, int4 words, bf16 scale and zero), the output written
    once, against the bf16 tensor-core rate for 2*m*k*n operations."""
    nbytes = m * k * 2 + k * n // 2 + 2 * groups * n * 2 + m * n * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_bound(lengths, ps: int, hkv: int, hq: int, d: int, int8: bool, window: int):
    """Least time (ms) of one paged decode step of one layer: the pages
    the slots' lengths reach, read once (K and V, plus their f32 scales in
    int8), q read and the output written once (bf16), the page table and
    lengths; against the bf16 rate for 4*D operations per (position,
    query head) (the score and the PV dots)."""
    pages = sum(q_pos // ps + 1 for q_pos in lengths)
    elem = 1 if int8 else 2
    nbytes = pages * ps * hkv * d * elem * 2
    if int8:
        nbytes += pages * ps * hkv * 4 * 2
    nbytes += len(lengths) * hq * d * 2 * 2 + len(lengths) * (window + 1) * 4
    positions = sum(q_pos + 1 for q_pos in lengths)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * positions * hq * d / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stack(qts):
    return QuantizedTensor(data=torch.stack([q.data for q in qts]),
                           scale=torch.stack([q.scale for q in qts]),
                           zero=torch.stack([q.zero for q in qts]),
                           spec=qts[0].spec, shape=qts[0].shape)


def matmul_rows(gen, flush):
    rows = []
    for name, k, n in SHAPES:
        flat = name == "lm_head"
        qts = [pad_quantized_groups(quantize(
            torch.randn((k, n), generator=gen, device="cuda") * 0.02, "q4bf16"))
            for _ in range(1 if flat else 2)]
        # layer weights stacked [2, KW, N], read at layer 1; the lm head flat
        one = qts[-1]
        w, layer = (one, None) if flat else (stack(qts), 1)
        words, scale, zero = w.data, w.scale, w.zero
        wl = (one.data, one.scale, one.zero)
        K, N, G = one.data.shape[0] * 8, one.data.shape[1], one.scale.shape[0]
        # the library yardstick multiplies by the whole stored [K, N] weight
        dense = dequantize(QuantizedTensor(*wl, spec=one.spec, shape=(K, N)), torch.bfloat16)
        out_dtype = torch.float32 if flat else torch.bfloat16
        # the flat lm head at m=128 is the flat int4 GEMM (TPU kernel table row 3)
        cases = [("gemv_qs", 1), ("gemv_qs", 8), ("gemm_qs", 128)]
        if not flat:
            cases += [("gemm_qs", 2048)]
        for kname, m in cases:
            x = torch.zeros((m, K), dtype=torch.bfloat16, device="cuda")
            x[:, :k] = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            kern = getattr(dm, kname)
            plain = getattr(dm, kname + "_plain")

            def run_kernel():
                return kern(x, words, scale, zero, layer=layer, out_dtype=out_dtype)

            def run_plain():
                return plain(x, *wl, out_dtype)

            def run_library():
                return torch.matmul(x, dense)

            got, want = run_kernel(), run_plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL)
            reps = 20 if m <= 128 else 5
            b_ms, b_by = bound(m, K, N, G, 4 if flat else 2)
            row = dict(kernel=kname, shape=name, m=m, k=K, n=N, max_abs_err=err,
                       ms=time_ms(run_kernel, flush, reps),
                       plain_ms=time_ms(run_plain, flush, min(reps, 5)),
                       library_ms=time_ms(run_library, flush, reps),
                       bound_ms=b_ms, bound_by=b_by)
            print(f"  {kname} {name} m={m} K={K} N={N}: max_abs_err={err:.3g} "
                  f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")
            if not ok:
                fail(f"{kname} {name} m={m} disagrees with its plain version (max {err})")
            rows.append(row)
        del w, dense
    return rows


def paged_rows(gen, flush, lengths=PAGED_LENGTHS, window=PAGED_WINDOW):
    """paged_flash_decode at the serve phase's Vicuna-7B shapes: Hkv 32,
    D 128, hb 8 (G 4), ps 128, by default 8 slots of mixed lengths and a
    16-page window (one slot per entry of `lengths`).
    The library yardstick is scaled_dot_product_attention over the same
    window ALREADY GATHERED to contiguous [B, H, W, D] bf16 K/V (int8:
    dequantized), masked to each slot's length: no single PyTorch call
    attends a paged pool."""
    rows = []
    B, D, hkv, hq = len(lengths), VICUNA.head_dim, VICUNA.num_kv_heads, VICUNA.num_heads
    hb, ps, L = PAGED_HEAD_BLOCK, PAGE_SIZE, 2
    G, P = hkv // hb, B * window + 1
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
             .reshape(B, window) + 1).int().cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, hq, 1, D), generator=gen, device="cuda").to(torch.bfloat16)
    W = window * ps
    mask = (torch.arange(W, device="cuda")[None, :] <= lens[:, None].long())[:, None, None, :]
    for int8 in (False, True):
        shape = (G, L, P, ps, hb * D)
        if int8:
            kp, vp = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                    dtype=torch.int8) for _ in range(2))
            ks = torch.rand((G, L, P, hb, ps), generator=gen, device="cuda") * 0.02 + 1e-3
            vs = torch.rand((G, L, P, ps, hb), generator=gen, device="cuda") * 0.02 + 1e-3
        else:
            kp, vp = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            ks = vs = None

        def run_kernel():
            return pa.paged_flash_decode(q, kp, vp, ks, vs, table, lens, 1,
                                         num_pages_window=window, head_dim=D)

        def run_plain():
            return pa.paged_flash_decode_plain(q, kp, vp, ks, vs, table, lens, 1,
                                               num_pages_window=window, head_dim=D)

        # contiguous K/V of the window for the yardstick, [B, H, W, D]
        def gathered(pages, sc, k_side):
            x = pages[:, 1][:, table.long()].float()  # [G, B, np, ps, hb*D]
            if sc is not None:
                s = sc[:, 1][:, table.long()]  # k [G,B,np,hb,ps]; v [G,B,np,ps,hb]
                s = s.transpose(-1, -2) if k_side else s
                x = x.reshape(G, B, window, ps, hb, D) * s[..., None]
            x = x.reshape(G, B, window, ps, hb, D).permute(1, 0, 4, 2, 3, 5)
            return x.reshape(B, hkv, W, D).to(torch.bfloat16).contiguous()

        kc, vc = gathered(kp, ks, True), gathered(vp, vs, False)

        def run_library():
            return torch.nn.functional.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)

        got, want = run_kernel(), run_plain()
        lib = run_library()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=KERNEL_TOL, rtol=KERNEL_TOL)
        b_ms, b_by = paged_bound(lengths, ps, hkv, hq, D, int8, window)
        kv = "int8" if int8 else "bf16"
        row = dict(kernel="paged_flash_decode", shape=f"vicuna b{B} {kv} KV", m=B, k=W, n=hq,
                   max_abs_err=err, ms=time_ms(run_kernel, flush, 20),
                   plain_ms=time_ms(run_plain, flush, 5),
                   library_ms=time_ms(run_library, flush, 20), bound_ms=b_ms, bound_by=b_by)
        print(f"  paged_flash_decode {kv} B={B} lengths={lengths} window={W}: "
              f"max_abs_err={err:.3g} (library vs plain {lib_err:.3g}) ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})")
        if not ok:
            fail(f"paged_flash_decode {kv} disagrees with its plain version (max {err})")
        rows.append(row)
        del kp, vp, ks, vs, kc, vc
    return rows


def kernel_phase():
    print("== kernel phase (torch.backends.cuda.matmul.allow_tf32 = False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    rows = matmul_rows(gen, flush) + paged_rows(gen, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


def pad_params(params):
    return tree_map(lambda x: pad_quantized_groups(x) if isinstance(x, QuantizedTensor)
                    else x, params)


def card_vs_cpu(cfg, params):
    cpu = tree_map(lambda x: x.map(lambda t: t.cpu()) if isinstance(x, QuantizedTensor)
                   else x.cpu(), params)
    toks = torch.randint(3, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(1))
    caches = {"cuda": init_kv_cache(cfg, 1, 128, device="cuda"),
              "cpu": init_kv_cache(cfg, 1, 128, device="cpu")}
    for step in range(5):
        logits = {}
        for dev, p in (("cuda", params), ("cpu", cpu)):
            lg, caches[dev] = forward(p, cfg, toks.to(dev), caches[dev], attn_window=128)
            logits[dev] = lg.float().cpu()
        if not torch.isfinite(logits["cuda"]).all() or logits["cuda"].shape != (1, cfg.vocab_size):
            fail("card logits not finite or of the wrong shape")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        scale = logits["cpu"].abs().max().item()
        print(f"  card vs CPU, {'prefill 64' if step == 0 else f'decode {step}'}: "
              f"max |logit diff| = {err:.4g}, max |logit| = {scale:.4g}, ratio {err / scale:.4g}")
        if err > LOGIT_RTOL * scale:
            fail(f"card logits differ from the CPU's by {err} > {LOGIT_RTOL} * {scale}")
        toks = logits["cpu"].argmax(-1, keepdim=True)
        # each decode step starts both sides from the card's cache, so a
        # step is held on its own error, not on the prefill's amplified
        caches["cpu"].k.copy_(caches["cuda"].k)
        caches["cpu"].v.copy_(caches["cuda"].v)


def paged_vs_slot(cfg, params):
    """8 slots of mixed prompt lengths, prefill + 4 decode steps, on the
    card: bf16 paged logits against slot logits (LOGIT_RTOL), int8 paged
    against bf16 paged (INT8_LOGIT_RTOL). The paged decode runs kernel 7."""
    B, ps = SERVE_BATCH, PAGE_SIZE
    lens = [5, 100, 127, 128, 129, 300, 700, 1000]
    S = 1024  # the prefill bucket
    rng = np.random.default_rng(1)
    toks = np.zeros((B, S), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, cfg.vocab_size, n)
    table = np.arange(1, B * PAGED_WINDOW + 1, dtype=np.int32).reshape(B, PAGED_WINDOW)
    caches = {"slot": init_kv_cache(cfg, B, SERVE_SEQ, device="cuda")}
    for name, dt in (("paged", torch.bfloat16), ("paged int8", torch.int8)):
        c = init_paged_kv_cache(cfg, B, B * PAGED_WINDOW + 1, ps, PAGED_WINDOW, dtype=dt,
                                device="cuda")
        c.set_page_table(table)
        caches[name] = c
    x = torch.from_numpy(toks).cuda()
    seq_lens = torch.tensor(lens)
    reset_counters()
    for step in range(5):
        logits = {}
        for name, c in caches.items():
            lg, _ = forward(params, cfg, x, c, seq_lens=seq_lens if step == 0 else None,
                            attn_window=S if step == 0 else SERVE_SEQ)
            logits[name] = lg.float().cpu()
            if not torch.isfinite(logits[name]).all() or logits[name].shape != (B, cfg.vocab_size):
                fail(f"{name} logits not finite or of the wrong shape")
        scale = logits["slot"].abs().max().item()
        what = f"prefill {lens}" if step == 0 else f"decode {step}"
        for name, ref, tol in (("paged", "slot", LOGIT_RTOL),
                               ("paged int8", "paged", INT8_LOGIT_RTOL)):
            err = (logits[name] - logits[ref]).abs().max().item()
            print(f"  {name} vs {ref}, {what}: max |logit diff| = {err:.4g}, "
                  f"max |logit| = {scale:.4g}, ratio {err / scale:.4g}")
            if err > tol * scale:
                fail(f"{name} logits differ from {ref} by {err} > {tol} * {scale}")
        x = logits["slot"].argmax(-1, keepdim=True).cuda()
    got = read_counters()["paged_flash_decode"]
    if got != 2 * 4 * cfg.num_layers:  # two paged caches x 4 decode steps x L
        fail(f"paged_flash_decode launched {got} times in the parity decode steps")


def parity_phase():
    print("== parity phase: 2-layer Vicuna-7B width")
    cfg = VICUNA.replace(num_layers=2)
    params = pad_params(init_random_params(cfg, "q4bf16", seed=1, device="cuda"))
    card_vs_cpu(cfg, params)
    paged_vs_slot(cfg, params)
    del params
    torch.cuda.empty_cache()


def chat_phase(params):
    print("== chat phase: vicuna-v1-7b q4bf16, 32 layers, slot cache, batch 1")
    engine = InferenceEngine(VICUNA, params, max_batch=1,
                             max_seq_len=min(VICUNA.max_seq_len, 768 * 2), device="cuda")
    lg = engine.prefill([[VICUNA.bos_token_id] + list(b"Hello")])
    if lg.shape != (1, VICUNA.vocab_size) or not torch.isfinite(lg).all():
        fail("full-depth prefill logits not finite or of the wrong shape")
    engine.reset()
    engine.stats.reset()
    session = ChatSession(engine, ByteTokenizer(), VICUNA,
                          ChatConfig(temperature=0.0, max_gen_len=32, max_window_size=768))
    prompts = ["Hello! Who are you?", "Name three colors.", "Thanks, bye."]
    reset_counters()
    ttft = []
    for prompt in prompts:
        before = engine.stats.prefill_time
        reply = session.ask(prompt)
        ttft.append((engine.stats.prefill_time - before) * 1e3)
        print(f"  USER: {prompt!r} -> {len(reply)} chars")
    launches = read_counters()
    steps = engine.stats.decode_tokens
    print(f"  prefill ms per turn (TTFT less sampling): {[round(t, 2) for t in ttft]}; "
          f"decode {engine.stats.decode_tps:.2f} tok/s over {steps} steps")
    # per prefill: the 4 layer weights x L layers on the GEMM, the lm head
    # (last position only, m=1) on the GEMV; per decode step: 4L + 1 GEMVs
    per_layer = 4 * VICUNA.num_layers
    want = {"gemm_qs": per_layer * len(prompts), "gemv_qs": (per_layer + 1) * steps + len(prompts),
            "paged_flash_decode": 0}
    print(f"  launches: {launches} (want {want})")
    if steps == 0 or launches != want:
        fail("launch counts do not match the chat path")
    return launches


def serve_requests():
    """16 requests from a seed: prompt lengths 16-1500, 32 new tokens,
    every fourth one sampled (T 0.7, top-p 0.95, its own seed)."""
    rng = np.random.default_rng(2)
    out = []
    for i in range(16):
        n = int(rng.integers(16, 1501))
        prompt = [int(t) for t in rng.integers(3, VICUNA.vocab_size, n)]
        sampled = i % 4 == 3
        out.append((prompt, GenerationConfig(max_new_tokens=32,
                                             temperature=0.7 if sampled else 0.0,
                                             top_p=0.95, seed=i)))
    return out


def serve_phase(params):
    print(f"== serve phase: vicuna-v1-7b q4bf16, 32 layers, paged KV (page {PAGE_SIZE}), "
          f"max_batch {SERVE_BATCH}, max_seq_len {SERVE_SEQ}, SchedulerServer + RemoteScheduler")
    engine = InferenceEngine(VICUNA, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             kv_layout="paged", page_size=PAGE_SIZE, device="cuda")
    sched = ContinuousBatchingScheduler(engine, seed=0)
    admitted = []
    prefill_slot = engine._prefill_slot

    def counted_prefill(*a, **kw):
        admitted.append(1)
        return prefill_slot(*a, **kw)

    engine._prefill_slot = counted_prefill
    server = SchedulerServer(sched).start()
    client = RemoteScheduler(("127.0.0.1", server.port), timeout=600)
    try:
        work = serve_requests()
        first_at = {}
        lock = threading.Lock()

        def on_token(i):
            def cb(_tok):
                with lock:
                    first_at.setdefault(i, time.perf_counter())
            return cb

        reset_counters()
        engine.decode_forwards = 0
        engine.stats.reset()
        t0 = time.perf_counter()
        reqs = [(client.submit(p, g, on_token=on_token(i)), time.perf_counter())
                for i, (p, g) in enumerate(work)]
        if not client.wait_all(900):
            fail(f"serve: requests did not complete (server error: {server.error})")
        wall = time.perf_counter() - t0
        launches = read_counters()
        st = client.stats()
    finally:
        client.close()
        server.stop()
    if server.error is not None:
        fail(f"serve: the scheduler failed:\n{server.error}")
    lens = [len(r.output) for r, _ in reqs]
    if any(r.error for r, _ in reqs) or min(lens) < 1 or max(lens) > 32:
        fail(f"serve: bad completions {lens} {[r.error for r, _ in reqs]}")
    if sum(lens) < 0.9 * 16 * 32:  # a stop token ends a request early only by chance
        fail(f"serve: only {sum(lens)} tokens generated")
    ttft = sorted((first_at[i] - t_sub) * 1e3 for i, (_, t_sub) in enumerate(reqs))
    forwards = engine.decode_forwards
    L, per_layer, n_pre = VICUNA.num_layers, 4 * VICUNA.num_layers, len(admitted)
    want = {"paged_flash_decode": L * forwards, "gemm_qs": per_layer * n_pre,
            "gemv_qs": (per_layer + 1) * forwards + n_pre}
    p50 = float(np.percentile(ttft, 50))
    p99 = float(np.percentile(ttft, 99))
    out = dict(
        requests=16, tokens=sum(lens), tokens_per_request=lens, wall_s=wall,
        ttft_p50_ms=p50, ttft_p99_ms=p99,
        aggregate_tok_s=sum(lens) / wall,
        server_decode_tok_s=st["decode_tokens"] / st["decode_time"],
        decode_forwards=forwards, step_wall_ms=st["decode_time"] / forwards * 1e3,
        prefill_s=st["prefill_time"], admissions=n_pre)
    print(f"  {json.dumps(out)}")
    print(f"  launches: {launches} (want {want})")
    if forwards == 0 or launches != want:
        fail("launch counts do not match the serve path")
    return launches, out


def int8_auto_phase(params):
    print("== int8 KV under kv_layout='auto' (in-process scheduler, 8 requests)")
    engine = InferenceEngine(VICUNA, params, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                             cache_dtype=torch.int8, kv_layout="auto", page_size=PAGE_SIZE,
                             device="cuda")
    if engine.kv_layout != "paged" or engine.cache.k_pages.dtype != torch.int8:
        fail(f"kv_layout='auto' with int8 KV resolved to {engine.kv_layout}")
    sched = ContinuousBatchingScheduler(engine, seed=0)
    reset_counters()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, g) for p, g in serve_requests()[:8]]
    sched.run()
    wall = time.perf_counter() - t0
    got = read_counters()["paged_flash_decode"]
    print(f"  kv_layout={engine.kv_layout}, {sum(len(r.output) for r in reqs)} tokens in "
          f"{wall:.2f} s, decode {engine.stats.decode_tps:.2f} tok/s, "
          f"paged_flash_decode launches {got} (want {VICUNA.num_layers * engine.decode_forwards})")
    if not all(r.done and r.output for r in reqs):
        fail("int8 auto run: a request did not complete")
    if engine.decode_forwards == 0 or got != VICUNA.num_layers * engine.decode_forwards:
        fail("int8 auto run: paged_flash_decode launches do not match its decode forwards")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    t0 = time.perf_counter()
    build_kernels(["dequant_gemv_qs", "dequant_gemm_qs", "paged_flash_decode"],
                  extra_flags=("-Xptxas", "-v"))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    rows = kernel_phase()
    parity_phase()
    t0 = time.perf_counter()
    params = init_random_params(VICUNA, "q4bf16", seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"full-depth params in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    chat = chat_phase(params)
    torch.cuda.empty_cache()
    serve, serve_stats = serve_phase(params)
    torch.cuda.empty_cache()
    int8_auto_phase(params)

    # per kernel: its main-path shape (GEMV: w_in at decode m=1; GEMM: w_in
    # at prefill m=128; paged: bf16 KV at b8); every shape is in "shapes".
    # launches: the serve path's counts, and each path's in launches_by_path
    kernels = []
    tops = {"gemv_qs": ("w_in", 1), "gemm_qs": ("w_in", 128),
            "paged_flash_decode": ("vicuna b8 bf16 KV", SERVE_BATCH)}
    for kname, (shape, m) in tops.items():
        mine = [r for r in rows if r["kernel"] == kname]
        top = next(r for r in mine if r["shape"] == shape and r["m"] == m)
        src, replaces = SOURCES[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=serve[kname], launches_by_path={"chat": chat[kname], "serve": serve[kname]},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            shapes=[{k: r[k] for k in ("shape", "m", "k", "n", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by", "library_ms")}
                    for r in mine]))
    if not all(math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print(json.dumps({"serve": serve_stats}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
