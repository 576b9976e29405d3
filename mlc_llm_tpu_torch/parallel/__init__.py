"""Serving across hosts: the request wire (``parallel/wire.py``), the host
coordinator (``parallel/coordinator.py``) and each process's slot range
(``parallel/multihost.py``).

The counterpart of ``mlc_llm_tpu/parallel``. Tensor-parallel sharding and
the rest of the multi-host module are not ported yet (ROADMAP.md queue 1,
its sharding item).
"""
