"""Serving across hosts: the request wire (``parallel/wire.py``).

The counterpart of ``mlc_llm_tpu/parallel``. Tensor-parallel sharding,
multi-host slots and the host coordinator are not ported yet
(ROADMAP.md queue 1, items 9-10).
"""
