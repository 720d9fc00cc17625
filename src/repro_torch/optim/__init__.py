"""Optimisation substrate of the port (counterpart of ``repro.optim``).

  adamw.py       — AdamW + LR schedules + global-norm clipping
  accumulate.py  — gradients of a tree, microbatch gradient accumulation
  compression.py — gradient compression for slow links: top-k
                   sparsification with error feedback, PowerSGD low-rank
"""

from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
)
from repro_torch.optim.accumulate import accumulate_gradients, value_and_grad

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "accumulate_gradients",
    "value_and_grad",
]
