"""The storage substrate (counterpart of ``repro.store``): the tiered leaf
store (device-resident int8/fp16/int4/binary codes, exact fp32 payload out
of core behind a granule LRU and an async prefetch pool) and the two-stage
scan -> rerank search over it. ``repro``'s remote object stores and
streaming build are not yet ported."""

from repro_torch.store.cache import GranuleCache, PrefetchHandle, PrefetchPool
from repro_torch.store.leaf_store import (
    BACKENDS,
    ExactSource,
    LeafStore,
    dequantize,
    quantize,
)
from repro_torch.store.two_stage import search_two_stage

__all__ = [
    "BACKENDS",
    "ExactSource",
    "GranuleCache",
    "LeafStore",
    "PrefetchHandle",
    "PrefetchPool",
    "dequantize",
    "quantize",
    "search_two_stage",
]
