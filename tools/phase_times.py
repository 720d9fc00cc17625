#!/usr/bin/env python3
"""Seconds per phase of a script that tags its log lines, as chip_smoke.py
does (``[main] ...``, ``[dist] ...``).

    python3 tools/phase_times.py --log OUT.log [--json OUT.json] -- \\
        python3 chip_smoke.py

Runs the command, passes its standard output through line by line, and
writes each line to ``--log`` behind the seconds since the start at which
it arrived. The time between one line and the next is put down to the
later line's tag: the script logs a phase's result once its work is done,
so a stretch of silence belongs to the line that ends it. A tag that comes
back later (``serve-cli`` twice) adds up. At the end it prints one JSON
object, ``{"total_s": ..., "phases": {tag: seconds, ...}}`` in the order
the tags first came, writes it to ``--json`` too, and exits with the
command's code.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

TAG = re.compile(r"^\[([^\]]+)\]")


def phase_of(line: str) -> str:
    """The line's tag; untagged lines (the JSON lines, the card's name)
    are ``other``."""
    m = TAG.match(line)
    return m.group(1) if m else "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--json", default=None)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given")
    phases: dict = {}
    t0 = last = time.perf_counter()
    with open(args.log, "w") as log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True, bufsize=1) as proc:
        for line in proc.stdout:
            now = time.perf_counter()
            tag = phase_of(line)
            phases[tag] = phases.get(tag, 0.0) + (now - last)
            last = now
            sys.stdout.write(line)
            log.write(f"{now - t0:10.3f} {line}")
        rc = proc.wait()
    out = {"total_s": time.perf_counter() - t0, "rc": rc,
           "phases": {k: round(v, 3) for k, v in phases.items()}}
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
