"""Training driver (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 200 --batch 8 --seq 256 --ckpt /tmp/run1

Wires together: config registry -> model loss (``transformer.loss_fn``
for an lm arch, on ``lm_tokens`` batches of ``--seq`` tokens;
``recsys.loss_fn`` for a recsys arch) -> stateless data -> AdamW -> the
fault-tolerant train loop with checkpoint/restart. ``--smoke``
uses the arch's reduced config so the whole thing runs on the CPU
(``--device cpu``); the default device is ``cuda``.

``--heartbeat <path>`` is touched every step: an external supervisor
relaunches a rank whose file goes stale, and the restart resumes from
``latest`` with an identical data stream (the batches are pure functions
of ``(seed, step)``).

``--deterministic`` runs under ``torch.use_deterministic_algorithms(True)``
(with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless it is set): on the card
the embedding backward otherwise sums duplicate ids with atomics, so a
restarted run would match an uninterrupted one only to rounding. TF32
stays off (PyTorch's default: matmul precision "highest").

On CUDA the last lines print ms a step and the peak device memory.

Not here yet: a ``--mesh`` beyond ``1x1`` (ROADMAP item 9d-2); GNN archs are
driven from the examples, as in ``repro``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data import lm_tokens, recsys_batch
from repro_torch.data.pipeline import place
from repro_torch.kernels import ops
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               value_and_grad)
from repro_torch.train import TrainLoopConfig, train_loop


def _parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256, help="lm: tokens a row")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--mesh", default="1x1", help="DATAxMODEL (1x1 for now)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--smoke", action="store_true",
                   help="use the arch's reduced config (CPU-friendly)")
    p.add_argument("--heartbeat", default=None,
                   help="path to touch every step (supervisor watchdog)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic algorithms (restart checks on CUDA)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the driver; returns ``{"history", "params", "opt_state",
    "step_ms"}`` (the CLI prints the same)."""
    args = _parse(argv)
    arch = get_arch(args.arch)
    if arch.family not in ("lm", "recsys"):
        raise SystemExit(f"launch.train drives lm/recsys archs; "
                         f"{args.arch} is {arch.family} — see examples/")
    if tuple(int(x) for x in args.mesh.split("x")) != (1, 1):
        raise SystemExit(f"launch.train: --mesh {args.mesh}: only 1x1 runs "
                         f"for now")
    dev = resolve_device(args.device)
    was_det = torch.are_deterministic_algorithms_enabled()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        return _run(args, arch, dev)
    finally:
        torch.use_deterministic_algorithms(was_det)


def _run(args, arch, dev) -> dict:
    cfg = arch.smoke_fn() if args.smoke else arch.config_fn()
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if arch.family == "lm":
        sh = tfm.ShardingConfig()
        init_params = tfm.init_params

        def loss_fn(p, b):
            return tfm.loss_fn(p, b, cfg, sh)

        def batch_of(s):
            return lm_tokens(s, args.batch, args.seq, cfg.vocab,
                             seed=args.seed)
        shape = f"batch {args.batch} x seq {args.seq}"
    else:
        init_params = rec_lib.init_params

        def loss_fn(p, b):
            return rec_lib.loss_fn(p, b, cfg)

        def batch_of(s):
            return recsys_batch(s, args.batch, cfg, seed=args.seed)
        shape = f"batch {args.batch}"

    def init_state():
        params = init_params(cfg, gen, device=dev)
        return params, adamw_init(params)

    def step_fn(params, opt_state, batch):
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        new_p, new_o, m = adamw_update(grads, opt_state, params, ocfg)
        return new_p, new_o, {"loss": loss, **m}

    hb = args.heartbeat
    starts: list = []  # host clock at each step's batch

    def make_batch(s):
        starts.append(time.perf_counter())
        if hb:
            with open(hb, "w") as f:
                f.write(str(time.time()))
        return place(batch_of(s), dev)

    def log_fn(step, msg):
        print(f"[train] {msg}", flush=True)

    tl_cfg = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                             ckpt_every=args.ckpt_every)
    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the initial state goes straight in: a reference kept here would hold
    # a third copy of params and moments on the card through the run
    params, opt_state, hist = train_loop(
        step_fn, *init_state(), make_batch, tl_cfg, log_fn=log_fn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gaps = [b - a for a, b in zip(starts[1:], starts[2:])]
    step_ms = 1e3 * sum(gaps) / len(gaps) if gaps else None
    if hist:
        print(f"[train] done: step {hist[-1][0]} loss {hist[-1][1]:.4f} "
              f"(first {hist[0][1]:.4f})", flush=True)
    if dev.type == "cuda":
        print(f"[train] peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB "
              f"(max_memory_allocated, params and optimizer state "
              f"included)", flush=True)
    print(f"[train] {cfg.name} {shape} on {dev}: "
          f"{'n/a' if step_ms is None else f'{step_ms:.3f}'} ms a step "
          f"(host clock between batches, from the second step; metrics "
          f"read one step late); kernel launches "
          f"{json.dumps(ops.launch_counts())}", flush=True)
    return dict(history=hist, params=params, opt_state=opt_state,
                step_ms=step_ms)


if __name__ == "__main__":
    main()
