"""PDASC in PyTorch with hand-written CUDA kernels for Hopper (H100).

A port of ``repro`` (the JAX/Pallas package) that mirrors its layout module
for module: ``repro_torch.core.msa`` is the counterpart of
``repro.core.msa``, and so on. It imports neither JAX nor ``repro``.

Entry points (``PDASCIndex.build``, ``PDASCIndex.load``, ``exact_knn``) run
on ``device="cuda"`` unless the caller passes ``device="cpu"``. On a CUDA
tensor every kernel-backed op launches its CUDA kernel (built from
``repro_torch/csrc`` on first use) or raises; on a CPU tensor it runs the
plain PyTorch version in ``repro_torch.kernels.ref``.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
