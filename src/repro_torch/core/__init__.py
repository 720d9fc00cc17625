"""PDASC core in PyTorch (counterpart of ``repro.core``).

  distances — arbitrary-dissimilarity registry
  kmedoids  — batched PAM / FasterPAM-style clustering
  kmeans    — batched masked Lloyd's k-means (method="kmeans", IVF-Flat)
  msa       — Multilevel Structure Algorithm (build)
  nsa       — Neighbours Search Algorithm (dense and beam search)
  index     — PDASCIndex user-facing API
  radius    — CDF radius estimation + per-level radii
  reference_impl — the literal NSA oracle and the index invariants
  distributed — sharded build / search / global top-k merge
"""

from repro_torch.core import distances
from repro_torch.core.index import PDASCIndex
from repro_torch.core.msa import PDASCIndexData, PDASCLevel, build_index
from repro_torch.core.nsa import SearchResult, search_beam, search_dense

__all__ = [
    "distances",
    "PDASCIndex",
    "PDASCIndexData",
    "PDASCLevel",
    "build_index",
    "SearchResult",
    "search_beam",
    "search_dense",
]
