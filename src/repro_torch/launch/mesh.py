"""Device meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

One rank per process, SPMD style: every rank builds the same mesh over the
current process group, and :class:`~torch.distributed.device_mesh.DeviceMesh`
makes each dim's sub-group once, when the mesh is made. Code that
communicates over a named axis reads that cached group
(``mesh.get_group(axis)``); nothing creates a group per call.

Axes, as in ``repro``:
  data   — PDASC database shards (the sub-index each rank builds)
  model  — query fan-out; the database is replicated over it
  pod    — a slow outer axis, merged last

``device_type`` is the device the mesh's groups communicate on. Ranks that
share one card cannot use NCCL (it refuses two ranks on one device), so the
default is ``"cpu"``: the ``gloo`` groups exchange host tensors, while each
rank's index and kernels stay on its card (``core.distributed`` stages the
merge's ``[B, k]`` pairs through the host).

:func:`make_production_mesh` returns a :class:`MeshShape`: the names and
sizes of ``repro``'s production meshes, (16, 16) or (2, 16, 16), with no
process group behind them. The cells (``launch/steps.py``) record their
specs over it and the dry-run (``launch/dryrun.py``) costs them per rank.
The helpers below take a ``MeshShape`` or a ``DeviceMesh``.

The roofline constants are the H100 SXM's (H100 80GB HBM3, 700 W, as
``nvidia-smi`` names the card): NVIDIA's spec-sheet figures, not measured.
``repro``'s TPU v5e constants are not carried over.
"""

from __future__ import annotations

import dataclasses
import math

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# H100 SXM (H100 80GB HBM3, 700 W) spec-sheet figures, per card; not measured
DEVICE_NAME = "H100 80GB HBM3, 700 W"
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80e9  # B
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, CUDA cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, tensor cores, dense
PEAK_FLOPS_3XTF32 = PEAK_FLOPS_TF32 / 3  # fp32-accurate: three TF32 products
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, tensor cores, dense
NVLINK_BW = 450e9  # B/s a direction


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's named dims and sizes, with no devices or process group
    behind it (``jax.sharding.AbstractMesh``'s counterpart)."""

    mesh_dim_names: tuple
    shape: tuple

    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """``repro``'s production mesh as a :class:`MeshShape`: ``("data",
    "model")`` (16, 16), or ``("pod", "data", "model")`` (2, 16, 16)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``MeshShape`` or ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def make_mesh(shape, axes, *, device_type: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` with named dims ``axes`` over the current process
    group (its world size must equal the product of ``shape``). Rank r sits
    at the row-major position r, as ``jax.make_mesh`` places devices."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def set_mesh(mesh: DeviceMesh):
    """Context manager installing ``mesh`` as the ambient mesh (the
    ``DeviceMesh``'s own context)."""
    return mesh


def batch_axes_of(mesh) -> tuple:
    """DP/FSDP axes: every axis except ``model``."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def all_axes_of(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)
