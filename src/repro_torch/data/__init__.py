"""Seeded synthetic datasets (numpy only), bit-identical to
``repro.data.synthetic`` for the same seed."""

from repro_torch.data.synthetic import (
    dataset_names,
    dense_embed,
    geo_clusters,
    make_dataset,
    sparse_highdim,
    tfidf_like,
)

__all__ = [
    "dataset_names",
    "dense_embed",
    "geo_clusters",
    "make_dataset",
    "sparse_highdim",
    "tfidf_like",
]
