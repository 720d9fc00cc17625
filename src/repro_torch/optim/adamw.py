"""AdamW (decoupled weight decay) + schedules + clipping on trees of
tensors (counterpart of ``repro.optim.adamw``; not ``torch.optim.AdamW``,
whose schedule and clipping differ).

Moments live in fp32 regardless of the parameter dtype; the update runs
in fp32 and is cast back to the parameter dtype (the mixed-precision
master-weight pattern). The update is functional: it returns new params
and a new state and leaves its inputs as they were. Every scalar (the
step, the learning rate, the gradient norm) stays a device tensor, so a
step never waits on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch._spec import PSpec, ShapeDtype
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0  # 0 disables
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: Tensor  # int32[]
    mu: Any  # tree like params (fp32)
    nu: Any  # tree like params (fp32)


def adamw_init(params) -> OptState:
    """Step 0 and fp32 zero moments, on the params' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def opt_state_shapes(param_shapes) -> OptState:
    """The state's :class:`~repro_torch._spec.ShapeDtype` tree (nothing
    allocated): an int32 step and fp32 moments shaped as the params."""
    z = tree_map(lambda p: ShapeDtype(tuple(p.shape), torch.float32),
                 param_shapes)
    return OptState(step=ShapeDtype((), torch.int32), mu=z,
                    nu=tree_map(lambda s: s, z))


def opt_state_specs(param_specs) -> OptState:
    """The state's specs: the step replicated, the moments as the
    params."""
    return OptState(step=PSpec(), mu=param_specs,
                    nu=tree_map(lambda s: s, param_specs))


def global_norm(tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def cosine_schedule(cfg: AdamWConfig, step) -> Tensor:
    """The learning rate at ``step`` (an int or a tensor): linear warmup,
    then cosine / linear decay to ``min_lr_frac``, or constant."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog)
        )
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * prog
    else:
        decay = torch.ones_like(s)
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, decay)


def adamw_update(grads, state: OptState, params, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    with torch.no_grad():
        if cfg.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            gnorm = global_norm(grads)
        step = state.step + 1
        lr = cosine_schedule(cfg, step)
        b1, b2 = cfg.b1, cfg.b2
        s = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=s.device), s)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=s.device), s)

        def upd(g, m, v, p):
            g32 = g.float()
            p32 = p.float()
            m = m.mul(b1).add_(g32, alpha=1 - b1)
            v = v.mul(b2).addcmul_(g32, g32, value=1 - b2)
            denom = (v / c2).sqrt_().add_(cfg.eps)
            delta = (m / c1).div_(denom)
            del denom
            if cfg.weight_decay:
                delta.add_(p32, alpha=cfg.weight_decay)
            return (p32 - delta.mul_(lr)).to(p.dtype), m, v

        out = [upd(*leaves) for leaves in zip(
            tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
            tree_leaves(params))]
        new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                               for i in range(3))
    return new_p, OptState(step=step, mu=new_m, nu=new_v), {
        "grad_norm": gnorm, "lr": lr,
    }
