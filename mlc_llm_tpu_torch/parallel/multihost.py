"""Multi-host serving helpers, the counterpart of
``mlc_llm_tpu/parallel/multihost.py``.

Ported so far: ``process_local_slots``, which the host coordinator
(``parallel/coordinator.py``) uses to give each process's scheduler its
own contiguous range of continuous-batching slots. The process count and
index come from ``torch.distributed``'s default process group when one
is initialized (its world size and rank), else 1 and 0. The rest of the
JAX module (the pod mesh and its parameter shardings) belongs to
tensor-parallel sharding and is not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch.distributed as dist


def process_local_slots(total_slots: int) -> range:
    """Partition continuous-batching slots across processes: each owns a
    contiguous range (the last one takes the remainder); requests never
    migrate between them. The processes are the default process group's
    ranks when it is initialized, else this one alone."""
    pc, pid = 1, 0
    if dist.is_available() and dist.is_initialized():
        pc, pid = dist.get_world_size(), dist.get_rank()
    per = total_slots // pc
    start = pid * per
    end = start + per if pid < pc - 1 else total_slots
    return range(start, end)
