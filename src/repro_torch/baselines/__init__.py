"""Comparison baselines: ``exact.py``, the brute-force ground truth."""

from repro_torch.baselines.exact import exact_knn

__all__ = ["exact_knn"]
