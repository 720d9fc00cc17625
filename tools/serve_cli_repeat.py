#!/usr/bin/env python3
"""The serve CLI phases of chip_smoke.py, (f) and (i), several times over,
on one GPU.

    python3 tools/serve_cli_repeat.py [--repeats 3] [--n 200000 100000]

Builds the port's kernels, then for each ``--n`` runs chip_smoke.py's
``phase_serve_cli`` on (f)'s paths (the beam index, single-engine and
replicated) and (i)'s (the remote payload tier, single and replicated)
``--repeats`` times, each CLI as a subprocess with chip_smoke.py's
arguments but that ``--n``. Every CLI prints its build seconds and its
warm-up search's seconds; the script prints one JSON object with those
readings per path and ``--n``, each run's exit, and the card's name and
power limit, and exits 1 if any run failed. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def seconds(lines: list, pattern: str):
    """The first number that ``pattern`` captures in ``lines``."""
    for ln in lines:
        m = re.search(pattern, ln)
        if m:
            return float(m.group(1))
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--n", type=int, nargs="+", default=[200_000])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.SRC)
    cs.phase_build()
    base = list(cs.SERVE_CLI)
    out, failed = {}, 0
    for n in args.n:
        cs.SERVE_CLI = [str(n) if i and base[i - 1] == "--n" else a
                        for i, a in enumerate(base)]
        for paths, tag in ((cs.SERVE_CLI_PATHS, "serve-cli"),
                           (cs.SERVE_CLI_REMOTE_PATHS, "serve-cli-remote")):
            for r in range(args.repeats):
                try:
                    got = cs.phase_serve_cli(paths, f"{tag} n={n} #{r}")
                except cs.CheckFailed as e:
                    failed += 1
                    cs.log(f"[repeat] n={n} {tag} #{r} failed: {e}")
                    out.setdefault(f"{tag} n={n}", []).append(
                        dict(failed=str(e)[-2000:]))
                    continue
                for name, res in got.items():
                    out.setdefault(f"{name} n={n}", []).append(dict(
                        secs=res["secs"],
                        build_s=seconds(res["lines"],
                                        r"built on \S+ in ([0-9.]+)s"),
                        warmup_s=seconds(res["lines"],
                                         r"warm-up search ([0-9.]+)s")))
    print(json.dumps(dict(runs=out, failed=failed, card=cs.nvidia_smi())))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
