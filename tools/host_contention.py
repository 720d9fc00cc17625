#!/usr/bin/env python3
"""What serving threads in one process cost each other, on one GPU.

    python3 tools/host_contention.py [--n 1000000] [--calls 30]

Builds the main path's index as chip_smoke.py does (``dense_embed``,
d = 100, gl = 256, euclidean, radius quantile 0.35, ``group_chunk``
1024, on the card) and times plan calls of ``Query(k=10, beam=32)`` on
the first 8 of its 1,000 held-out queries, each call's ids copied to the
host, as a replica's engine makes them:

* from 1, 2 and 4 threads at once (chip_smoke.py's host-contention line);
* from 4 threads that take one lock around each call;
* from 1 thread beside a thread that spins in pure Python.

Prints one JSON object: plan calls a second for each variant, the card's
name and power limit. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))


def rate(call, threads: int, calls: int, lock=None) -> float:
    """Calls a second of ``call`` from ``threads`` threads, ``calls`` each
    (under ``lock`` when given)."""
    def work():
        for _ in range(calls):
            if lock is None:
                call()
            else:
                with lock:
                    call()

    pool = [threading.Thread(target=work) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600)
    return threads * calls / (time.perf_counter() - t0)


def beside_spinner(call, calls: int) -> float:
    """Calls a second of ``call`` from one thread while another spins."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    spinner = threading.Thread(target=spin)
    spinner.start()
    try:
        return rate(call, 1, calls)
    finally:
        stop.set()
        spinner.join(timeout=60)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--calls", type=int, default=30)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.index import PDASCIndex
    from repro_torch.data import make_dataset
    from repro_torch.query import Query

    full = make_dataset("dense_embed", n=args.n + 1000, seed=0)
    idx = PDASCIndex.build(full[:args.n], gl=256, distance="euclidean",
                           radius_quantile=0.35, group_chunk=1024,
                           device="cuda")
    plan = idx.plan(Query(k=10, beam=32))
    x = torch.from_numpy(full[args.n:args.n + 8]).cuda()

    def call():
        plan(x).ids.cpu()

    call()
    out = {f"{t} threads": rate(call, t, args.calls) for t in (1, 2, 4)}
    out["4 threads, one lock"] = rate(call, 4, args.calls, threading.Lock())
    out["1 thread beside a spinner"] = beside_spinner(
        call, max(1, args.calls // 6))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"n": args.n, "plan_calls_per_s": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
