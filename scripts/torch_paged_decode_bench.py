"""Times the paged flash-decode kernel over a sweep of batch and lengths.

    python scripts/torch_paged_decode_bench.py

For each case, at Vicuna-7B's attention shapes (32 kv-heads, head dim
128, head block 8, page 128, a 16-page window) and in bf16 and int8 KV:
the kernel's time, its bound (the bytes of the pages the lengths reach),
its plain version's time, the library yardstick (scaled_dot_product_attention
over the window already gathered to contiguous K/V) and the kernel's max
abs error against its plain version (exits non-zero above 1e-2). Uses chip_smoke.py's timing (CUDA
events, L2 flushed by a read before each launch). Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mlc_llm_tpu_torch.ops import build_kernels  # noqa: E402

CASES = [  # (name, lengths): one slot per entry
    ("b8 mixed", chip_smoke.PAGED_LENGTHS),
    ("b8 x 1024", [1024] * 8),
    ("b1 x 2047", [2047]),
    ("b16 x 512", [512] * 16),
]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    build_kernels(["paged_flash_decode"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    for name, lengths in CASES:
        print(f"== {name}")
        chip_smoke.paged_rows(gen, flush, lengths)  # fails on a disagreement


if __name__ == "__main__":
    main()
