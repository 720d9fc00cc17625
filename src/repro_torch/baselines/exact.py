"""Exact brute-force k-NN — the ground truth every recall is measured
against (counterpart of ``repro.baselines.exact``). Kernel forms go through
``ops.knn`` (the fused CUDA k-NN kernel on the card); other distances go
through the registry in query chunks."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def exact_knn(queries, database, *, distance="euclidean", k: int = 10,
              chunk: int = 2048, device="cuda"):
    """``(dists [q, k] ascending, ids [q, k] int32)`` under any registered
    distance, computed on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    Q, DB = tensor(queries), tensor(database)
    if kops.resolve_form(distance) is not None:
        return kops.knn(Q, DB, distance, k=k)
    dist = dist_lib.get(distance)
    outs = [kref.topk_smallest(dist_lib.pairwise_chunked(dist, Q[i:i + chunk], DB), k)
            for i in range(0, Q.shape[0], chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
