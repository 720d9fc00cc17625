"""Hand-written CUDA kernels for PDASC's hot spots on Hopper, and their
plain PyTorch versions.

  pairwise.py — batched [G,m,d]x[G,n,d]->[G,m,n] distances (csrc/pairwise.cu)
  topk.py     — fused gather+distance+top-k rank (csrc/rank.cu) and
                brute-force k-NN (csrc/knn.cu)
  kmedoids.py — FasterPAM swap-sweep deltas (csrc/swap.cu)
  ops.py      — dispatch: CUDA kernel for CUDA tensors, ref.py on the CPU
  ref.py      — plain PyTorch versions defining each kernel's contract
  _build.py   — nvcc build and ctypes loading of csrc/*.cu
"""

from repro_torch.kernels.ops import (
    DEFAULT,
    KernelConfig,
    knn,
    launch_counts,
    pairwise_distance,
    rank_candidates,
    rank_gathered,
    reset_launch_counts,
    resolve_form,
    swap_deltas,
)

__all__ = [
    "DEFAULT",
    "KernelConfig",
    "knn",
    "launch_counts",
    "pairwise_distance",
    "rank_candidates",
    "rank_gathered",
    "reset_launch_counts",
    "resolve_form",
    "swap_deltas",
]
