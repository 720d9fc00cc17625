"""The storage substrate (counterpart of ``repro.store``): the tiered leaf
store (device-resident int8/fp16/int4/binary codes, exact fp32 payload out
of core behind a granule LRU and an async prefetch pool) and the two-stage
scan -> rerank search over it. The out-of-core tier runs on host arrays,
on-disk memmaps, or a pluggable remote object store (``remote``);
``streaming`` builds an index shard by shard over a dataset that never fits
in memory."""

from repro_torch.store.cache import GranuleCache, PrefetchHandle, PrefetchPool
from repro_torch.store.leaf_store import (
    BACKENDS,
    ExactSource,
    LeafStore,
    dequantize,
    quantize,
)
from repro_torch.store.remote import (
    LocalFSStore,
    RemoteSource,
    RemoteStore,
    RemoteStoreError,
    SimulatedObjectStore,
    make_remote,
    open_store,
    upload_payload,
)
from repro_torch.store.streaming import build_streaming
from repro_torch.store.two_stage import search_two_stage

__all__ = [
    "BACKENDS",
    "ExactSource",
    "GranuleCache",
    "LeafStore",
    "LocalFSStore",
    "PrefetchHandle",
    "PrefetchPool",
    "RemoteSource",
    "RemoteStore",
    "RemoteStoreError",
    "SimulatedObjectStore",
    "build_streaming",
    "dequantize",
    "make_remote",
    "open_store",
    "quantize",
    "search_two_stage",
    "upload_payload",
]
