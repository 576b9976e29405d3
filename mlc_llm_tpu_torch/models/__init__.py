"""Model families: one generic pre-norm decoder parameterized by ModelConfig."""

from .config import ModelConfig, MODEL_REGISTRY, get_config
from .paged_cache import PagedKVCache, init_paged_kv_cache
from .transformer import forward, init_random_params, KVCache, init_kv_cache

__all__ = [
    "ModelConfig",
    "MODEL_REGISTRY",
    "get_config",
    "forward",
    "init_random_params",
    "KVCache",
    "init_kv_cache",
    "PagedKVCache",
    "init_paged_kv_cache",
]
