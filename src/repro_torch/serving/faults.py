"""Deterministic fault-injection harness for the replicated serving tier
(counterpart of ``repro.serving.faults``; DESIGN.md §3.10).

Every fault a replica can exhibit is described by a :class:`FaultSpec`
window in **per-replica dispatch-count space**, not wall-clock time: the
N-th handler dispatch on replica ``r`` either runs clean or hits the fault,
regardless of machine speed or scheduling jitter. A :class:`FaultPlan` is a
frozen set of specs; ``plan.injector(replica_id)`` hands each replica its
own :class:`FaultInjector`, which the :class:`~repro_torch.serving.replicated
.Replica` wraps around its batch handler. Health probes dispatch through
the same handler, so they advance the same counter — a wedged replica
"recovers" after a deterministic number of (failed) probe dispatches, which
is what makes ejection → half-open → readmission testable without sleeping
through real outage clocks.

Fault kinds:

``latency``
    every dispatch in the window sleeps ``delay_s`` before serving — a slow
    replica (tail-latency spike); requests still succeed.
``error``
    every dispatch in the window raises :class:`InjectedFault` — an error
    burst (bad deploy, poisoned shard); the router's retry path absorbs it.
``wedge``
    every dispatch in the window sleeps ``delay_s`` (default far past any
    caller deadline) before serving — a wedged worker: callers hedge away,
    queued requests miss their deadlines, health probes time out until the
    window's dispatches are spent.
``crash``
    the first dispatch in the window raises :class:`ReplicaCrashed`; the
    replica set tears the engine down (simulated process death) and every
    dispatch until the window closes keeps crashing on restart attempts.
    After the window the replica restarts clean and catches up on the
    write log.

Seeded generation: :meth:`FaultPlan.generate` derives a reproducible random
schedule from a seed (``numpy.random.default_rng`` — no wall-clock
randomness anywhere), and :meth:`FaultPlan.parse` builds one from a compact
CLI string (``launch/serve.py --faults``, ``benchmarks/bench_serve.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

KINDS = ("latency", "error", "wedge", "crash")

# Default sleep for a wedged dispatch: far past any sane caller deadline.
DEFAULT_WEDGE_S = 0.75


class InjectedFault(RuntimeError):
    """A fault-plan error burst (the injected analogue of a handler bug)."""


class ReplicaCrashed(RuntimeError):
    """A fault-plan crash: the replica's engine must be torn down."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault window on one replica.

    ``start`` / ``duration`` are in per-replica handler *dispatches* (batch
    calls, probes included): dispatches ``start <= i < start + duration``
    hit the fault. ``delay_s`` is the injected latency for ``latency`` /
    ``wedge`` kinds.
    """

    kind: str
    replica: int
    start: int
    duration: int
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.start < 0 or self.duration < 1:
            raise ValueError(
                f"fault window needs start >= 0, duration >= 1 "
                f"(got start={self.start}, duration={self.duration})"
            )
        if self.kind == "wedge" and self.delay_s == 0.0:
            object.__setattr__(self, "delay_s", DEFAULT_WEDGE_S)

    @property
    def end(self) -> int:
        return self.start + self.duration

    def covers(self, dispatch: int) -> bool:
        return self.start <= dispatch < self.end


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, deterministic schedule of :class:`FaultSpec` windows."""

    specs: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    def for_replica(self, replica: int) -> tuple:
        return tuple(s for s in self.specs if s.replica == replica)

    def injector(self, replica: int) -> "FaultInjector":
        return FaultInjector(self.for_replica(replica))

    def max_dispatch(self) -> int:
        """The dispatch count after which every window has closed."""
        return max((s.end for s in self.specs), default=0)

    # -- construction ---------------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Compact CLI syntax: ``kind:rR@START+DURATION[:DELAY_S]``, ``;``
        or ``,`` separated, e.g. ``wedge:r1@20+8`` or
        ``latency:r0@10+30:0.05;error:r2@40+5``."""
        specs = []
        for part in text.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                kind, rest = part.split(":", 1)
                fields = rest.split(":")
                loc = fields[0]
                delay = float(fields[1]) if len(fields) > 1 else 0.0
                rep, window = loc.split("@")
                rep = int(rep.lstrip("r"))
                start, duration = (int(v) for v in window.split("+"))
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad fault spec {part!r} (want kind:rR@START+DURATION"
                    f"[:DELAY_S], e.g. wedge:r1@20+8): {e}"
                ) from None
            specs.append(FaultSpec(kind=kind.strip(), replica=rep,
                                   start=start, duration=duration,
                                   delay_s=delay))
        return cls(specs=tuple(specs))

    @classmethod
    def generate(cls, *, seed: int, n_replicas: int, n_faults: int = 4,
                 horizon: int = 200, kinds: tuple = KINDS,
                 max_duration: int = 12,
                 delay_s: float = 0.05) -> "FaultPlan":
        """A reproducible random schedule: ``n_faults`` windows drawn from a
        seeded generator. Same seed, same plan — never wall-clock random."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            specs.append(FaultSpec(
                kind=kind,
                replica=int(rng.integers(n_replicas)),
                start=int(rng.integers(horizon)),
                duration=int(rng.integers(1, max_duration + 1)),
                delay_s=float(delay_s),
            ))
        return cls(specs=tuple(specs))


class FaultInjector:
    """Per-replica fault application: call :meth:`on_dispatch` at the top of
    every handler dispatch. Thread-safe (the replica's engine worker and the
    router's probe path may race on restart)."""

    def __init__(self, specs: tuple):
        self.specs = tuple(specs)
        self._lock = threading.Lock()
        self._dispatch = 0

    @property
    def dispatches(self) -> int:
        return self._dispatch

    def active(self, dispatch: Optional[int] = None) -> Optional[FaultSpec]:
        """The spec covering a dispatch index (default: the next one)."""
        d = self._dispatch if dispatch is None else dispatch
        for s in self.specs:
            if s.covers(d):
                return s
        return None

    def on_dispatch(self) -> None:
        """Advance the dispatch counter and apply whatever fault covers it:
        sleep (latency / wedge) or raise (error / crash)."""
        with self._lock:
            d = self._dispatch
            self._dispatch += 1
            spec = self.active(d)
        if spec is None:
            return
        if spec.kind in ("latency", "wedge"):
            time.sleep(spec.delay_s)
        elif spec.kind == "error":
            raise InjectedFault(
                f"injected error (replica r{spec.replica}, dispatch {d}, "
                f"window {spec.start}+{spec.duration})"
            )
        else:  # crash
            raise ReplicaCrashed(
                f"injected crash (replica r{spec.replica}, dispatch {d}, "
                f"window {spec.start}+{spec.duration})"
            )
