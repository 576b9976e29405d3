"""Model families: one generic pre-norm decoder parameterized by ModelConfig."""

from .config import ModelConfig, MODEL_REGISTRY, get_config
from .paged_cache import PagedKVCache, init_paged_kv_cache
from .transformer import (
    KVCache,
    forward,
    forward_block,
    forward_decode,
    forward_verify,
    init_kv_cache,
    init_random_params,
)

__all__ = [
    "ModelConfig",
    "MODEL_REGISTRY",
    "get_config",
    "forward",
    "forward_block",
    "forward_decode",
    "forward_verify",
    "init_random_params",
    "KVCache",
    "init_kv_cache",
    "PagedKVCache",
    "init_paged_kv_cache",
]
