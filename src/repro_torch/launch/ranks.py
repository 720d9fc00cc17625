"""Run one function in P rank processes on one machine, each in its own
``gloo`` process group rank (the launcher the sharded paths are tested and
driven with).

    outs = run_ranks("my_module:fn", 4, workdir=tmp, kwargs=dict(n=10))
    # fn(rank, world, n=10) ran once per rank; outs[r] is rank r's return

Each rank is a fresh ``python -m repro_torch.launch.ranks`` subprocess, so
a parent that already holds a CUDA context never forks one. The group
initialises through ``file://`` under ``workdir`` (no TCP port, so
concurrent launches cannot collide), with the launch's timeout as the
collectives' timeout, and one intra-op thread (ranks share the host's
cores). ``target`` is ``"package.module:function"`` or
``"path/to/file.py:function"``. Arguments and results travel as
``torch.save`` files under ``workdir``. Any rank that exits non-zero, or
the launch outliving ``timeout``, kills every rank and raises with the
failing rank's output.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import subprocess
import sys
import time
import uuid
from typing import Optional

import torch

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(target: str, world: int, *, workdir: str,
              kwargs: Optional[dict] = None, timeout: float = 600.0) -> list:
    """Run ``target(rank, world, **kwargs)`` in ``world`` rank processes;
    returns the ranks' return values, in rank order."""
    run = os.path.join(os.path.abspath(workdir), f"ranks-{uuid.uuid4().hex}")
    os.makedirs(run)
    torch.save(kwargs or {}, os.path.join(run, "args.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(os.path.join(run, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.ranks", target,
                 str(rank), str(world), run, str(timeout)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        pending = set(range(world))
        while pending:
            for rank in sorted(pending):
                rc = procs[rank].poll()
                if rc is None:
                    continue
                pending.discard(rank)
                if rc != 0:
                    raise RuntimeError(
                        f"rank {rank} of {world} ({target}) exited {rc}:\n"
                        + _tail(run, rank))
            if pending and time.monotonic() > deadline:
                raise RuntimeError(
                    f"ranks {sorted(pending)} of {world} ({target}) still "
                    f"running after {timeout} s:\n" + _tail(run, min(pending)))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    return [torch.load(os.path.join(run, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _tail(run: str, rank: int, nbytes: int = 6000) -> str:
    with open(os.path.join(run, f"rank{rank}.log"), errors="replace") as f:
        return f.read()[-nbytes:]


def _resolve(target: str):
    where, fn = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"_rank_target_{uuid.uuid4().hex}", where)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, fn)


def _main(argv) -> None:
    import torch.distributed as dist

    target, rank, world, run, timeout = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(run, "pg"), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        out = _resolve(target)(rank, world, **torch.load(
            os.path.join(run, "args.pt"), weights_only=False))
        tmp = os.path.join(run, f"rank{rank}.pt.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(run, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
