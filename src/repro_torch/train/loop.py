"""Fault-tolerant training loop (counterpart of ``repro.train.loop``).

* **checkpoint/restart** — restores ``(params, opt_state)`` from the newest
  complete checkpoint onto the template's devices, then replays the
  *stateless* data pipeline from that step. Async + atomic saves every
  ``ckpt_every`` steps and on exit/signal.
* **signal safety** — SIGTERM/SIGINT stop the loop after the current step
  and save a final checkpoint.
* **NaN sentinel** — a non-finite loss aborts the run, and no checkpoint
  holds a state whose loss was not read finite: the checkpoint of step
  ``s`` (the state after step ``s``'s update) is written only once step
  ``s``'s loss has been read, so ``latest`` stays the last good step.
  ``repro``'s loop saves the state in hand at exit under the last good
  step's label, which after a NaN holds the corrupted update.
* **no sync point in a step** — metrics are read one step late: each
  step's scalars are copied to pinned host memory without blocking and
  read, behind a CUDA event, after the next step has been enqueued, so
  the loop never calls ``.item()`` on the step it has just launched. A
  checkpoint step reads its own loss at once: the save copies the state
  to the host there anyway.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, save_checkpoint


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 10
    keep: int = 3


class _Pending:
    """One step's scalar metrics on their way to the host."""

    def __init__(self, metrics: dict):
        self.host, self.event = {}, None
        for name, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.is_cuda and v.numel() == 1:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v.detach(), non_blocking=True)
                self.host[name] = buf
                if self.event is None:
                    self.event = torch.cuda.Event()
            else:
                self.host[name] = v
        if self.event is not None:
            self.event.record()

    def loss(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        v = self.host.get("loss", np.nan)
        return float(v.detach() if isinstance(v, torch.Tensor) else v)


def train_loop(
    step_fn: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
    params,
    opt_state,
    make_batch: Callable[[int], dict],  # stateless: step -> batch tree
    cfg: TrainLoopConfig,
    *,
    log_fn: Callable[[int, dict], None] = None,
):
    """Runs to ``total_steps``; returns (params, opt_state, history)."""
    start = 0
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep) if cfg.ckpt_dir else None
    if mgr is not None:
        restored, step = mgr.restore_or_none((params, opt_state))
        if restored is not None:
            params, opt_state = restored
            start = step + 1
            print(f"[train] restored checkpoint @ step {step}")

    stop = {"now": False}

    def _handler(signum, frame):
        stop["now"] = True

    old_handlers = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:  # not main thread (tests)
            pass

    history = []
    pending = None  # (step, _Pending) read with a 1-step delay
    done = start - 1  # the step whose update the state in hand holds
    last_good = start - 1  # the newest step whose loss was read finite
    t0 = time.time()

    def read(pstep, pmet):
        nonlocal last_good
        loss = pmet.loss()
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite loss at step {pstep}; last good ckpt "
                f"step {last_good}"
            )
        history.append((pstep, loss))
        last_good = pstep
        if pstep % cfg.log_every == 0:
            msg = dict(step=pstep, loss=loss,
                       sps=round((pstep - start + 1) / (time.time() - t0), 2))
            (log_fn or (lambda s, m: print(f"[train] {m}")))(pstep, msg)

    try:
        for step in range(start, cfg.total_steps):
            batch = make_batch(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            done = step

            if pending is not None:
                read(*pending)
            pending = (step, _Pending(metrics))

            if mgr is not None and step > start and step % cfg.ckpt_every == 0:
                read(*pending)  # only a state whose loss was read finite
                pending = None
                mgr.save_async(step, (params, opt_state))
            if stop["now"]:
                print(f"[train] signal received; checkpointing @ {step}")
                break
        # flush the delayed metric
        if pending is not None:
            read(*pending)
    finally:
        if mgr is not None:
            mgr.wait()
            # the state in hand is saved only if its own loss was good
            if last_good == done >= 0 and mgr.last_saved != done:
                save_checkpoint(cfg.ckpt_dir, done, (params, opt_state),
                                keep=cfg.keep)
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return params, opt_state, history
