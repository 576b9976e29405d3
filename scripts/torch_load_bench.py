"""Time the port's checkpoint load onto the GPU, for comparing two trees
on one card.

    python scripts/torch_load_bench.py --build DIR
    python scripts/torch_load_bench.py --load DIR [--tree TREE] [--label L]
                                       [--stage-mb N] [--reps 3]

--build writes a random Vicuna-7B q4bf16 checkpoint (seed 0) into DIR with
this tree's `build --random --device cuda`. --load times
`load_params(DIR, device="cuda")` of the tree at TREE (default: this one;
an unpacked parent, say) `--reps` times and prints one JSON line: the
bytes, each load's seconds and GB/s, the card's name and power limit.
--stage-mb sets the pinned staging buffers' size, --threads the reader
threads and --piece-mb the bytes of one read (a tree with the native
reader; the parent's loader has none of them). --breakdown times the native loader's two halves apart: the
threads filling the staging buffers with every leaf's bytes (no copy),
pinning the two buffers, and copying a full buffer to the card as often
as the leaves' bytes fill it (no read). The files were just written or
read, so every load is a warm read from the page cache (nothing here
drops the cache).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", metavar="DIR")
    ap.add_argument("--load", metavar="DIR")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="change")
    ap.add_argument("--stage-mb", type=int, default=None)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--piece-mb", type=int, default=None)
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.build:
        from mlc_llm_tpu_torch import build

        built = build.main(["--model", "vicuna-v1-7b", "--random", "--quantization", "q4bf16",
                            "-o", args.build, "--device", "cuda"])
        print(json.dumps(dict(built={k: v for k, v in built.items() if k != "meta"}, card=card)))
        return
    from mlc_llm_tpu_torch.utils import checkpoint

    if args.stage_mb is not None:
        checkpoint.STAGE_BYTES = args.stage_mb << 20
    if args.threads is not None:
        checkpoint.READ_THREADS = args.threads
    if args.piece_mb is not None:
        checkpoint.PIECE_BYTES = args.piece_mb << 20
    if args.breakdown:
        return breakdown(args, checkpoint, torch, card)
    with open(os.path.join(args.load, "manifest.json")) as f:
        nbytes = json.load(f)["total_bytes"]
    torch.zeros(1, device="cuda")  # the CUDA context, outside the timing
    secs = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        params, _ = checkpoint.load_params(args.load, device="cuda")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        del params
        torch.cuda.empty_cache()
    print(json.dumps(dict(label=args.label, tree=args.tree, stage_mb=args.stage_mb,
                          threads=args.threads, piece_mb=args.piece_mb, bytes=nbytes, load_s=secs, gb_s=[nbytes / s / 1e9 for s in secs],
                          module=checkpoint.__file__, card=card)))


def breakdown(args, checkpoint, torch, card):
    """The native loader's reads and copies timed apart (see the module
    doc), each `--reps` times."""
    with open(os.path.join(args.load, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for e in manifest["leaves"].values():
        path = os.path.join(args.load, e["file"])
        n = os.path.getsize(path)
        leaves.append((path, torch.empty(n, dtype=torch.uint8)))  # sized stand-ins, unread
    total = sum(t.numel() for _, t in leaves)
    size = min(checkpoint.STAGE_BYTES, total)
    out = dict(stage_mb=size >> 20, threads=checkpoint.READ_THREADS, bytes=total, card=card)
    torch.zeros(1, device="cuda")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        ring = [torch.empty(size, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        out.setdefault("pin_s", []).append(time.perf_counter() - t0)
        chunks = checkpoint._stage_chunks(leaves, size)
        t0 = time.perf_counter()
        for i, chunk in enumerate(chunks):
            checkpoint._fill(ring[i % 2], chunk)
        read_s = time.perf_counter() - t0
        dev = torch.empty(size, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, chunk in enumerate(chunks):
            n = sum(c[2] for c in chunk)
            dev[:n].copy_(ring[i % 2][:n], non_blocking=True)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        out.setdefault("read_gb_s", []).append(total / read_s / 1e9)
        out.setdefault("copy_gb_s", []).append(total / copy_s / 1e9)
        del ring, dev
    print(json.dumps(out))


if __name__ == "__main__":
    main()
