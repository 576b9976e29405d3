"""Multi-host serving over ``torch.distributed``, the counterpart of
``mlc_llm_tpu/parallel/multihost.py``.

- ``initialize()`` brings up the default process group (the coordinator
  from the arguments or ``MLC_COORDINATOR`` as ``host:port``); with one
  process and no coordinator it does nothing, as JAX's does. The backend
  is the caller's: ``"nccl"`` for one rank a card, ``"gloo"`` for the CPU
  or for several ranks on one card (NCCL refuses two ranks on one device).
- ``make_pod_mesh()`` builds a ("dcn", "dp", "tp") DeviceMesh: "tp" spans
  the ranks of one host (its collectives stay on the host's links), "dcn"
  spans hosts. Weights take the "tp" rules only, so they are replicated
  over "dcn" (``pod_param_specs``, ``shard_params_pod``) and decode
  all-reduces never cross hosts; requests are data-parallel across hosts.
- ``process_local_slots`` gives each process's scheduler its own
  contiguous range of continuous-batching slots (the host coordinator,
  ``parallel/coordinator.py``).

JAX's ``recommended_xla_flags`` (XLA's latency-hiding scheduler and async
collective fusion on TPU pods) has no counterpart: nothing here compiles
through XLA, and the port's collectives are the forward's explicit
``all_reduce`` calls.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from ..models.config import ModelConfig
from .sharding import param_specs, shard_params


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None, *,
               backend: str) -> None:
    """``torch.distributed.init_process_group`` over TCP at the coordinator
    ``host:port`` (an argument, else ``MLC_COORDINATOR``), with
    `num_processes` ranks of which this is `process_id`, on `backend`
    ("nccl" or "gloo"). A no-op when the group already exists, or with one
    process and no coordinator."""
    if dist.is_initialized():
        return
    coord = coordinator_address or os.environ.get("MLC_COORDINATOR")
    if coord is None and num_processes in (None, 1):
        return
    if coord is None:
        raise ValueError("initialize: several processes need a coordinator host:port "
                         "(argument or MLC_COORDINATOR)")
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=num_processes or 1, rank=process_id or 0)


def make_pod_mesh(tp: Optional[int] = None, dp: int = 1, dcn: int = 1,
                  device_type: str = "cuda"):
    """A ("dcn", "dp", "tp") DeviceMesh over the default process group, tp
    varying fastest, so consecutive ranks (one host's, under a launcher
    that numbers a host's ranks together) form a tp group. tp defaults to
    world // (dcn * dp); dcn * dp * tp must be the world size (JAX's
    default dcn is its process count, one per host; here every rank is a
    process, so dcn is given)."""
    world = dist.get_world_size()
    tp = tp or world // (dcn * dp)
    if dcn * dp * tp != world:
        raise ValueError(f"dcn ({dcn}) * dp ({dp}) * tp ({tp}) != world size ({world})")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dcn, dp, tp), mesh_dim_names=("dcn", "dp", "tp"))


def pod_param_specs(params, mesh):
    """The tp rules' specs; "dcn" appears in none, so weights are
    replicated over it."""
    return param_specs(params, mesh)


def shard_params_pod(params, mesh, cfg: ModelConfig):
    """This rank's shards over the pod mesh: the tp rules, replicated over
    "dcn" and "dp"."""
    return shard_params(params, mesh, cfg)


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
