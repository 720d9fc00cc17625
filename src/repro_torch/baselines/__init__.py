"""Comparison baselines: ``exact.py``, the brute-force ground truth, and
``ivf_flat.py``, the k-means inverted-file index."""

from repro_torch.baselines.exact import exact_knn
from repro_torch.baselines.ivf_flat import SUPPORTED, IVFFlatIndex

__all__ = ["IVFFlatIndex", "SUPPORTED", "exact_knn"]
