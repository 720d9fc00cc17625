"""Comparison baselines for the paper's recall protocol (§4.4):
``exact.py``, the brute-force ground truth; ``ivf_flat.py``, the k-means
inverted-file index (the FLANN stand-in); and ``nndescent.py``, the
NN-Descent k-NN graph (the PyNNDescent stand-in, any distance)."""

from repro_torch.baselines.exact import exact_knn
from repro_torch.baselines.ivf_flat import SUPPORTED, IVFFlatIndex
from repro_torch.baselines.nndescent import NNDescentIndex

__all__ = ["IVFFlatIndex", "NNDescentIndex", "SUPPORTED", "exact_knn"]
