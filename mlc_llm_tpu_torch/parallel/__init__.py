"""Tensor- and data-parallel sharding over a ``torch.distributed``
DeviceMesh (``parallel/sharding.py``, ``parallel/multihost.py``), and
serving across hosts: the request wire (``parallel/wire.py``) and the
host coordinator (``parallel/coordinator.py``).

The counterpart of ``mlc_llm_tpu/parallel``: weights and KV cache
tensor-sharded over "tp", batch over "dp". JAX's collectives are placed
by GSPMD from sharding annotations; the port's forward makes them
explicitly on each rank's shards (``models/transformer.py``).
"""

from .sharding import (
    cache_shardings,
    make_mesh,
    paged_cache_shardings,
    param_specs,
    shard_cache,
    shard_paged_cache,
    shard_params,
)

__all__ = [
    "make_mesh",
    "param_specs",
    "shard_params",
    "cache_shardings",
    "shard_cache",
    "paged_cache_shardings",
    "shard_paged_cache",
]
