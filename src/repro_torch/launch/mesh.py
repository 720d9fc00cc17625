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

Not carried over: ``repro``'s ``make_production_mesh`` (a 256- or
512-device TPU mesh for the side workloads' dry-run) and its TPU hardware
constants.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


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


def batch_axes_of(mesh: DeviceMesh) -> tuple:
    """DP/FSDP axes: every axis except ``model``."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def all_axes_of(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names)
