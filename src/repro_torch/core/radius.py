"""Search-radius estimation for NSA (counterpart of ``repro.core.radius``).

* :func:`estimate_radius` — the paper's CDF approach: sample pairwise
  distances, take a quantile.
* :func:`per_level_radii` — per-level radii grown by the quantile of each
  level's prototype-to-parent distances (the paper's future-work item).

Sampling uses an explicit ``torch.Generator`` (a CPU generator, seed 0 when
omitted); its numbers differ from ``jax.random``'s for the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import distances as dist_lib
from repro_torch.core.msa import PDASCIndexData

Tensor = torch.Tensor


def sample_pairwise(data: Tensor, dist, *, n_pairs: int = 4096,
                    generator: Optional[torch.Generator] = None) -> Tensor:
    """Distances of ``n_pairs`` random (i, j) pairs — a CDF sample."""
    dist = dist_lib.get(dist)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    n = data.shape[0]
    i = torch.randint(0, n, (n_pairs,), generator=gen).to(data.device)
    j = torch.randint(0, n, (n_pairs,), generator=gen).to(data.device)
    return dist.point(data[i].float(), data[j].float())


def estimate_radius(data: Tensor, dist, *, quantile: float = 0.05,
                    n_pairs: int = 4096,
                    generator: Optional[torch.Generator] = None) -> float:
    """CDF-quantile radius: ``quantile=0.05`` keeps roughly the closest 5%
    of pairwise distances inside the search frontier."""
    d = sample_pairwise(data, dist, n_pairs=n_pairs, generator=generator)
    return float(torch.quantile(d, quantile))


def per_level_radii(index: PDASCIndexData, dist, *, base_radius: float,
                    quantile: float = 0.5) -> tuple[float, ...]:
    """Level l's radius is ``base_radius`` plus the ``quantile`` of each
    level-l prototype's distance to its parent; the leaf's is
    ``base_radius``."""
    dist = dist_lib.get(dist)
    radii = [float(base_radius)]
    for l in range(1, len(index.levels)):
        lv = index.levels[l - 1]
        up = index.levels[l]
        parent = torch.clamp(lv.parent.long(), 0, up.points.shape[0] - 1)
        d = dist.point(lv.points, up.points[parent])
        d = torch.where(lv.valid & (lv.parent >= 0), d,
                        torch.full((), float("nan"), device=d.device))
        radii.append(float(base_radius + torch.nanquantile(d, quantile)))
    return tuple(radii)
