"""Per-request distributed tracing (counterpart of ``repro.obs.trace``;
DESIGN.md §3.11).

A :class:`Trace` is created at the serving edge (``Router.search`` or a
bare ``engine.submit``) for a deterministic 1-in-N sample of requests
(:class:`TraceSampler` keys on the request *sequence number*, so a given
workload samples the same requests on every run). It records a tree of
:class:`Span` nodes — queue wait, batch wait, hedge/retry attempt legs,
plan execution, scan/rerank stages, granule fetches — each with a wall
duration (``time.perf_counter``), free-form attributes, and a *self time*
(duration minus direct children) so the tree's self-times partition the
request's wall clock.

Deeper layers never see the Trace itself. They cooperate through two
decoupled mechanisms:

* an explicit ``span=`` argument on the request path (router attempt →
  ``Replica.submit`` → ``engine.submit``) carrying the parent span for
  *per-request* children (queue wait, batch wait);
* a **thread-local active span set** for *shared* work: one executed
  batch serves many requests, of which several may be sampled, so the
  engine worker activates the set of their execute-spans around the
  handler call and :func:`span` mirrors every child into each of them.
  When no trace is active, :func:`span` returns a shared no-op context
  manager — the unsampled hot path costs one thread-local read.

Export: ``trace.to_dict()`` (JSON-ready) and ``trace.render()`` (a text
flamegraph: one line per span, indented, with duration/self-time and
attrs). Completed traces land in a bounded :class:`TraceBuffer`;
``buffer.exemplar(latency)`` picks the retained trace closest to a target
latency (bench_serve uses the measured p99).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Iterable, List, Optional

from repro_torch.obs import names as names_lib
from repro_torch.obs import metrics as metrics_lib

_now = time.perf_counter

_trace_ids = itertools.count(1)


class Span:
    """One timed node in a trace tree. Not thread-safe per-instance —
    a span is owned by the thread that created it (the tree as a whole is
    assembled from per-thread owned spans; the Trace is read only after
    ``finish``)."""

    __slots__ = ("name", "attrs", "t0", "t1", "children")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.t0 = _now()
        self.t1: Optional[float] = None
        self.children: List["Span"] = []

    def child(self, name: str, **attrs) -> "Span":
        s = Span(name, **attrs)
        self.children.append(s)
        return s

    def end(self, **attrs) -> None:
        if self.t1 is None:
            self.t1 = _now()
        if attrs:
            self.attrs.update(attrs)

    @property
    def duration(self) -> float:
        return ((self.t1 if self.t1 is not None else _now()) - self.t0)

    @property
    def self_time(self) -> float:
        return self.duration - sum(c.duration for c in self.children)

    def to_dict(self) -> dict:
        return dict(
            name=self.name,
            t0=self.t0,
            duration=self.duration,
            self_time=self.self_time,
            attrs={k: _jsonable(v) for k, v in self.attrs.items()},
            children=[c.to_dict() for c in self.children],
        )

    def walk(self) -> Iterable["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class Trace:
    """A sampled request: one root span + identity. ``finish()`` closes the
    root and hands the trace to its buffer (if any)."""

    __slots__ = ("trace_id", "seq", "root", "_buffer", "_finished")

    def __init__(self, name: str, *, seq: int = 0,
                 buffer: Optional["TraceBuffer"] = None, **attrs):
        self.trace_id = next(_trace_ids)
        self.seq = seq
        self.root = Span(name, **attrs)
        self._buffer = buffer
        self._finished = False

    def finish(self, **attrs) -> None:
        if self._finished:
            return
        self._finished = True
        self.root.end(**attrs)
        if self._buffer is not None:
            self._buffer.add(self)

    @property
    def duration(self) -> float:
        return self.root.duration

    def to_dict(self) -> dict:
        return dict(trace_id=self.trace_id, seq=self.seq,
                    root=self.root.to_dict())

    def to_json(self, *, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def render(self) -> str:
        """Text flamegraph: one line per span, indented by depth, with
        total/self millisecond times and the span's attributes."""
        lines = [f"trace #{self.trace_id} seq={self.seq} "
                 f"({self.duration * 1e3:.2f} ms)"]
        total = max(self.duration, 1e-12)

        def emit(span: Span, depth: int) -> None:
            attrs = " ".join(f"{k}={_jsonable(v)}"
                             for k, v in sorted(span.attrs.items()))
            bar = "#" * max(1, int(round(20 * span.duration / total)))
            lines.append(
                f"{'  ' * depth}{span.name:<{max(1, 28 - 2 * depth)}} "
                f"{span.duration * 1e3:9.3f}ms "
                f"self={span.self_time * 1e3:8.3f}ms "
                f"|{bar:<20}| {attrs}".rstrip()
            )
            for c in span.children:
                emit(c, depth + 1)

        emit(self.root, 0)
        return "\n".join(lines)


class TraceBuffer:
    """Bounded ring of completed traces (newest kept)."""

    def __init__(self, maxlen: int = 64):
        self.maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._traces: List[Trace] = []

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._traces.append(trace)
            if len(self._traces) > self.maxlen:
                del self._traces[: len(self._traces) - self.maxlen]
        metrics_lib.counter(names_lib.TRACE_FINISHED).inc()

    def traces(self) -> List[Trace]:
        with self._lock:
            return list(self._traces)

    def to_dicts(self) -> List[dict]:
        """Every retained trace as a plain dict (oldest first)."""
        return [t.to_dict() for t in self.traces()]

    def to_json(self, *, indent: Optional[int] = None) -> str:
        """The full buffer as a JSON document — the ``--trace-dump``
        format, and the ``repro_torch.obs.report`` CLI's trace input:
        ``{"traces": [trace.to_dict(), ...]}``."""
        return json.dumps({"traces": self.to_dicts()}, indent=indent)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def exemplar(self, latency_s: Optional[float] = None) -> Optional[Trace]:
        """The retained trace whose duration is closest to ``latency_s``
        (e.g. a measured p99); the slowest trace when no target is given."""
        with self._lock:
            if not self._traces:
                return None
            if latency_s is None:
                return max(self._traces, key=lambda t: t.duration)
            return min(self._traces,
                       key=lambda t: abs(t.duration - latency_s))


class TraceSampler:
    """Deterministic 1-in-N sampling by request sequence number.

    ``every_n <= 0`` disables sampling entirely. ``sample(seq)`` returns a
    new Trace exactly when ``seq % every_n == 0`` — reruns of the same
    workload sample the same requests, so tests reproduce span trees
    exactly.
    """

    def __init__(self, every_n: int = 0, *,
                 buffer: Optional[TraceBuffer] = None):
        self.every_n = int(every_n)
        self.buffer = buffer if buffer is not None else TraceBuffer()

    def should_sample(self, seq: int) -> bool:
        return self.every_n > 0 and seq % self.every_n == 0

    def sample(self, name: str, seq: int, **attrs) -> Optional[Trace]:
        if not self.should_sample(seq):
            return None
        metrics_lib.counter(names_lib.TRACE_SAMPLED).inc()
        return Trace(name, seq=seq, buffer=self.buffer, **attrs)


# ---------------------------------------------------------------------------
# Thread-local active span set + the `span()` helper
# ---------------------------------------------------------------------------

_local = threading.local()


def active_spans() -> tuple:
    """The spans mirrored by :func:`span` on this thread (empty = off)."""
    return getattr(_local, "spans", ())


class _ActiveCM:
    """Context manager installing a set of parent spans as this thread's
    active set (restoring the previous set on exit)."""

    __slots__ = ("spans", "_prev")

    def __init__(self, spans: tuple):
        self.spans = spans

    def __enter__(self):
        self._prev = getattr(_local, "spans", ())
        _local.spans = self.spans
        return self.spans

    def __exit__(self, *exc):
        _local.spans = self._prev
        return False


def activate(spans) -> _ActiveCM:
    """Install ``spans`` (an iterable of Span) as the thread's active set
    for the duration of the ``with`` block. The engine worker wraps each
    handler call in ``activate([...execute spans...])`` so stage spans
    recorded by the handler mirror into every sampled request of the batch.
    """
    return _ActiveCM(tuple(spans))


class _NullSpanCM:
    """Shared no-op for the unsampled path: no allocation, no timing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def end(self, **attrs):  # duck-types Span enough for call sites
        pass


_NULL = _NullSpanCM()


class _SpanCM:
    """Context manager that opens one mirrored child per active parent
    span, re-activates the children as the nested set (so spans opened
    inside nest correctly), and ends them on exit."""

    __slots__ = ("name", "attrs", "children", "_prev")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        parents = getattr(_local, "spans", ())
        self.children = tuple(p.child(self.name, **self.attrs)
                              for p in parents)
        self._prev = parents
        _local.spans = self.children
        return self.children[0] if self.children else None

    def __exit__(self, *exc):
        for c in self.children:
            c.end()
        _local.spans = self._prev
        return False


def span(name: str, **attrs):
    """Open a child span under every active parent on this thread.

    Usage at an instrumented stage::

        with obs.span("scan", rows=n, kind="device"):
            ... stage work ...

    Returns the no-op manager when nothing is active, so the unsampled
    hot path pays a single thread-local read.
    """
    if not getattr(_local, "spans", ()):
        return _NULL
    return _SpanCM(name, attrs)


def is_tracing() -> bool:
    """True when the current thread has an active span set — use to gate
    trace-only work (e.g. ``block_until_ready`` for device timings)."""
    return bool(getattr(_local, "spans", ()))
