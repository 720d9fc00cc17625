"""Seeded synthetic datasets (numpy only), bit-identical to
``repro.data.synthetic`` for the same seed.

  geo_clusters    — Municipalities surrogate: mainland blob + two far island
                    blobs in (lat, lon) radians; outlier structure + Haversine
  sparse_highdim  — MNIST surrogate: 10-class blobs in 784-d, ~80% zeros
  dense_embed     — GLOVE surrogate: anisotropic Gaussian mixture in 100-d
  tfidf_like      — NYtimes surrogate: sparse non-negative log-normal

and the model-zoo training batches, pure functions of ``(seed, step)``:

  lm_tokens       — Zipf-distributed token batch (LM training)
  recsys_batch    — CTR batch with a planted logistic structure
"""

from __future__ import annotations

import numpy as np


def geo_clusters(n: int = 8130, seed: int = 0) -> np.ndarray:
    """[n, 2] (lat, lon) in radians: Spain-like mainland + 2 island outliers."""
    rng = np.random.default_rng(seed)
    n_main = int(n * 0.9)
    n_bal = int(n * 0.04)
    n_can = n - n_main - n_bal
    deg = np.pi / 180.0
    main = rng.normal([40.0, -3.5], [2.2, 2.8], size=(n_main, 2))
    bal = rng.normal([39.5, 2.9], [0.35, 0.45], size=(n_bal, 2))
    can = rng.normal([28.3, -16.5], [0.5, 1.2], size=(n_can, 2))
    out = np.concatenate([main, bal, can]) * deg
    rng.shuffle(out)
    return out.astype(np.float32)


def sparse_highdim(n: int = 69000, d: int = 784, n_classes: int = 10,
                   density: float = 0.2, seed: int = 0) -> np.ndarray:
    """[n, d] non-negative, ~(1-density) zeros, 10 class blobs (MNIST-like)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 255, size=(n_classes, d))
    support = rng.random((n_classes, d)) < density
    labels = rng.integers(0, n_classes, n)
    x = np.abs(centers[labels] + rng.normal(0, 40, size=(n, d)))
    x = np.clip(x, 0, 255) * support[labels]
    return x.astype(np.float32)


def dense_embed(n: int = 200_000, d: int = 100, n_comp: int = 64,
                seed: int = 0) -> np.ndarray:
    """[n, d] anisotropic Gaussian mixture (GLOVE-embedding-like)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2.0, size=(n_comp, d))
    scales = rng.uniform(0.3, 1.2, size=(n_comp, d))
    comp = rng.integers(0, n_comp, n)
    x = centers[comp] + rng.normal(size=(n, d)) * scales[comp]
    return x.astype(np.float32)


def tfidf_like(n: int = 50_000, d: int = 256, density: float = 0.15,
               seed: int = 0) -> np.ndarray:
    """[n, d] sparse non-negative log-normal doc vectors (NYtimes-like):
    length varies over two orders of magnitude, so cosine >> euclidean."""
    rng = np.random.default_rng(seed)
    n_topics = 24
    topics = rng.dirichlet(np.full(d, 0.05), size=n_topics)
    doc_topic = rng.integers(0, n_topics, n)
    length = np.exp(rng.normal(3.0, 1.0, size=(n, 1)))
    x = rng.poisson(topics[doc_topic] * length * d).astype(np.float32)
    mask = rng.random((n, d)) < density
    x = x * mask
    idf = np.log((n + 1) / (1.0 + (x > 0).sum(0)))
    return (x * idf).astype(np.float32)


_DATASETS = {
    "geo_clusters": geo_clusters,
    "sparse_highdim": sparse_highdim,
    "dense_embed": dense_embed,
    "tfidf_like": tfidf_like,
}


def make_dataset(name: str, n: int | None = None, seed: int = 0) -> np.ndarray:
    fn = _DATASETS[name]
    return fn(n=n, seed=seed) if n else fn(seed=seed)


def dataset_names() -> list[str]:
    return sorted(_DATASETS)


# ---------------------------------------------------------------------------
# Model-zoo training data
# ---------------------------------------------------------------------------


def lm_tokens(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    """Zipf-distributed token batch for LM training; pure fn of step."""
    rng = np.random.default_rng((seed, step))
    toks = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
    return dict(tokens=toks[:, :-1].astype(np.int32),
                labels=toks[:, 1:].astype(np.int32))


def recsys_batch(step: int, batch: int, cfg, seed: int = 0) -> dict:
    """Synthetic CTR batch with a planted logistic structure (learnable)."""
    rng = np.random.default_rng((seed, step))
    out: dict = {}
    if cfg.kind == "din":
        target = rng.integers(0, cfg.table_rows, batch)
        seq = rng.integers(0, cfg.table_rows, (batch, cfg.seq_len))
        lens = rng.integers(1, cfg.seq_len + 1, batch)
        mask = (np.arange(cfg.seq_len)[None, :] < lens[:, None])
        # clicks carry a deterministic per-item component (learnable via the
        # item embedding); the history/attention path stays exercised in
        # the forward pass
        y = (target % 2).astype(np.float32)
        out.update(target=target.astype(np.int32), seq=seq.astype(np.int32),
                   seq_mask=mask.astype(np.float32))
    else:
        sparse = rng.integers(0, cfg.table_rows, (batch, cfg.n_sparse))
        w = np.sin(np.arange(cfg.n_sparse) + 1.0)
        z = ((sparse % 5 - 2) * w).sum(1) / np.sqrt(cfg.n_sparse)
        if cfg.n_dense:
            dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
            z = z + dense[:, 0]
            out["dense"] = dense
        y = (rng.random(batch) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
        out["sparse"] = sparse.astype(np.int32)
    out["labels"] = y
    return out
