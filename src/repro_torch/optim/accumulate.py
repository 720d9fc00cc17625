"""Gradients of a loss over a tree of params, and microbatch accumulation
(counterpart of ``repro.optim.accumulate``).

``accumulate_gradients`` splits a global batch into ``n_micro`` slices
along axis 0 and sums their gradients in fp32. Memory: one microbatch of
activations at a time; the optimizer sees the mean gradient, so training
semantics are identical to the unaccumulated step (linearity of grad).
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_fn, params, batch):
    """``((loss, aux), grads)`` of ``loss_fn(params, batch) -> (loss,
    aux)``, the grads a tree like ``params`` (``jax.value_and_grad(...,
    has_aux=True)``'s result). ``params`` are left as they were; loss and
    aux come back detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True)
    leaves = [torch.zeros_like(p) if g is None else g
              for g, p in zip(grads, tree_leaves(live))]
    aux = tree_map(lambda a: a.detach() if torch.is_tensor(a) else a, aux)
    return (loss.detach(), aux), tree_unflatten(params, leaves)


def accumulate_gradients(loss_fn, params, batch, n_micro: int):
    """Returns (loss, aux_of_last_micro, grads) with grads averaged.

    loss_fn(params, microbatch) -> (loss, aux). Every array in ``batch``
    must have a leading axis divisible by ``n_micro``."""
    if n_micro <= 1:
        (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        return loss, aux, grads

    def micro(i):
        def take(x):
            m = x.shape[0] // n_micro
            return x[i * m:(i + 1) * m]
        return tree_map(take, batch)

    loss_sum = 0.0
    g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(n_micro):
        (loss, aux), g = value_and_grad(loss_fn, params, micro(i))
        g_sum = tree_map(lambda a, b: a + b.float(), g_sum, g)
        loss_sum = loss_sum + loss
    grads = tree_map(lambda g, p: (g / n_micro).to(p.dtype), g_sum, params)
    return loss_sum / n_micro, aux, grads
