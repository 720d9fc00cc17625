"""Architecture configs (counterpart of ``repro.configs``): one module per
ported arch. Resolve with ``repro_torch.configs.get_arch("<id>")``; list
with ``arch_ids()``; enumerate the cells with ``all_cells()``."""

from repro_torch.configs.base import (
    ArchDef,
    ShapeSpec,
    all_cells,
    arch_ids,
    get_arch,
    register_arch,
)

__all__ = [
    "ArchDef",
    "ShapeSpec",
    "all_cells",
    "arch_ids",
    "get_arch",
    "register_arch",
]
