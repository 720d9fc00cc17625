"""Data substrate (counterpart of ``repro.data``): seeded synthetic
datasets and training batches (numpy only, bit-identical to
``repro.data.synthetic`` for the same seed), and the stateless step ->
batch pipeline with host prefetch."""

from repro_torch.data.synthetic import (
    dataset_names,
    dense_embed,
    geo_clusters,
    lm_tokens,
    make_dataset,
    recsys_batch,
    sparse_highdim,
    tfidf_like,
)
from repro_torch.data.pipeline import BatchPipeline

__all__ = [
    "BatchPipeline",
    "dataset_names",
    "dense_embed",
    "geo_clusters",
    "lm_tokens",
    "make_dataset",
    "recsys_batch",
    "sparse_highdim",
    "tfidf_like",
]
