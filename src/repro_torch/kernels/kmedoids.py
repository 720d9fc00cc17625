"""CUDA FasterPAM swap-sweep kernel (``csrc/swap.cu``), the counterpart of
``repro.kernels.kmedoids.swap_deltas_pallas``.

``swap_deltas_cuda`` computes ``dTD[G, k, g] = S[G, None, g] + T[G, k, g]``
for a whole slab of groups in one call (a kernel that orders each group's
rows by slot, then the sweep, and past ~760 slots a pass that adds S); its
plain version is ``ref.swap_deltas_ref``. The sum order is fixed, so the
result is the same from run to run. Every ``g`` fits the sweep: a block
stages its rows' caches 1,024 at a time and, where the whole ``[k, 64]`` T
tile does not fit, holds 256 slots and walks only their rows
(:func:`swap_geometry`). ``k`` is capped at :data:`SWAP_MAX_K` = 14,527 by
the order kernel, which keeps 4 groups' ``k + 1`` slot counts (16 bytes a
slot) in one block's 227 KB (:func:`check_swap_shape`).
"""

from __future__ import annotations

import ctypes

import torch

from typing import NamedTuple

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"swap_launch": [_P] * 11 + [_I] * 3 + [_P]}
_SMEM_LIMIT = 227 * 1024
_BN, _STAGES, _ROWS = 64, 4, 16  # swap.cu's column tile and row ring
_CHUNK = 1024  # rows whose caches a block stages at once
_KB = 256  # slots a block once all k do not fit
_ORDER_WARPS = 4  # swap.cu's order kernel: groups (warps) a block
# the order kernel's shared slot counts, int32[_ORDER_WARPS][k + 1], cap k
SWAP_MAX_K = _SMEM_LIMIT // (4 * _ORDER_WARPS) - 1


class SwapGeometry(NamedTuple):
    """The sweep's grid: ``col_tiles`` 64-column tiles x groups x
    ``slot_blocks`` ranges of ``kb`` slots; ``smem`` bytes a block."""

    kb: int
    slot_blocks: int
    col_tiles: int
    smem: int


def swap_smem_bytes(g: int, kb: int) -> int:
    """Shared memory of one ``swap.cu`` sweep block holding ``kb`` slots:
    the ``[kb, 64]`` T tile, the 4 x 16-row ring, the S row, and the
    ordered caches (16 bytes) and row index (4 bytes) of up to 1,024 rows."""
    rows = min(-(-g // _ROWS) * _ROWS, _CHUNK)
    return 4 * (kb * _BN + _STAGES * _ROWS * _BN + _BN) + 20 * rows


def swap_geometry(g: int, k: int) -> SwapGeometry:
    """The sweep's launch geometry for groups of ``g`` points and ``k``
    slots (``swap.cu``'s ``slot_block``): one block holds every slot where
    they fit, else 256 a block."""
    if k < 1 or g < 1:
        raise ValueError(f"swap_deltas_cuda: needs g >= 1 and k >= 1, got "
                         f"g={g}, k={k}")
    kb = k if swap_smem_bytes(g, k) <= _SMEM_LIMIT else _KB
    return SwapGeometry(kb=kb, slot_blocks=-(-k // kb),
                        col_tiles=-(-g // _BN), smem=swap_smem_bytes(g, kb))


def order_smem_bytes(k: int) -> int:
    """Shared memory of one ``swap.cu`` order-kernel block: the ``k + 1``
    int32 slot counts of each of its 4 groups."""
    return 4 * _ORDER_WARPS * (k + 1)


def check_swap_shape(g: int, k: int) -> None:
    """Raise for the ``(g, k)`` the kernels cannot run: ``k < 1``, ``k`` past
    :data:`SWAP_MAX_K` (the order kernel's slot counts outgrow 227 KB), or
    more slot blocks than a grid axis holds."""
    if order_smem_bytes(k) > _SMEM_LIMIT:
        raise ValueError(
            f"swap_deltas_cuda: k={k} medoids exceed the order kernel's "
            f"limit of {SWAP_MAX_K} (its {_ORDER_WARPS} x (k + 1) int32 slot "
            f"counts must fit 227 KB of shared memory); use fewer medoids "
            f"per group")
    if swap_geometry(g, k).slot_blocks > 65535:
        raise ValueError(f"swap_deltas_cuda: k={k} needs more than 65,535 "
                         f"slot blocks")


def swap_deltas_cuda(
    D: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor, n1: torch.Tensor,
    valid: torch.Tensor, k: int,
) -> torch.Tensor:
    """``D [G, g, g]`` fp32, ``d1/d2 [G, g]`` fp32, ``n1 [G, g]`` int32,
    ``valid [G, g]`` bool, all contiguous CUDA. Returns ``[G, k, g]``."""
    global launches
    G, g, g2 = D.shape
    if g != g2:
        raise ValueError(f"D must be [G, g, g], got {tuple(D.shape)}")
    for t, dt in ((d1, torch.float32), (d2, torch.float32), (n1, torch.int32),
                  (valid, torch.bool)):
        if t.shape != (G, g) or t.dtype != dt:
            raise ValueError("swap_deltas_cuda: caches must be [G, g] "
                             "(d1/d2 fp32, n1 int32, valid bool)")
    for t in (D, d1, d2, n1, valid):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("swap_deltas_cuda takes contiguous CUDA tensors")
    if D.dtype != torch.float32:
        raise ValueError("swap_deltas_cuda takes fp32 D")
    if G > 65535:
        raise ValueError(f"swap_deltas_cuda: G={G} groups exceed a grid axis")
    check_swap_shape(g, k)
    nz = swap_geometry(g, k).slot_blocks
    dev = D.device
    out = torch.empty((G, k, g), device=dev, dtype=torch.float32)
    perm = torch.empty((G, g), device=dev, dtype=torch.int32)
    rc = torch.empty((G, g, 4), device=dev, dtype=torch.float32)
    off = torch.empty((G, k + 1), device=dev, dtype=torch.int32)
    nv = torch.empty(G, device=dev, dtype=torch.int32)
    Sp = torch.empty((G, nz, g) if nz > 1 else (1,), device=dev,
                     dtype=torch.float32)
    lib = _build.load("swap", _SIGNATURES)
    err = lib.swap_launch(
        D.data_ptr(), d1.data_ptr(), d2.data_ptr(), n1.data_ptr(),
        valid.data_ptr(), out.data_ptr(), perm.data_ptr(), rc.data_ptr(),
        off.data_ptr(), nv.data_ptr(), Sp.data_ptr(), G, g, k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "swap")
    launches += 1
    return out
