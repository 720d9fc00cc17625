"""Process-wide metrics registry (counterpart of ``repro.obs.metrics``;
the port keeps its own registry; DESIGN.md §3.11).

Three instrument kinds, all thread-safe and lock-light (one small lock per
series, held only for the arithmetic — no lock spans an export):

* **Counter** — monotonic float, ``inc(v)``;
* **Gauge** — instantaneous float, ``set(v)`` / ``inc`` / ``dec``;
* **Histogram** — fixed log-spaced buckets (factor 2 by default), counts +
  sum + min/max, with a ``percentile(q)`` estimate that interpolates inside
  the winning bucket. Fixed buckets keep ``observe`` allocation-free and
  make concurrent snapshots trivially consistent-enough (a snapshot may
  straddle one in-flight observation; it can never be torn mid-bucket).

Series are labelled: ``registry.counter(name, replica="r0")`` — each
distinct ``(name, labels)`` pair is one series, created on first touch and
cached by the caller-facing handle lookup. The **default registry**
(:func:`registry`) is strict: names must come from the documented catalogue
(``obs/names.py``) — instrumented call sites cannot invent undocumented
names. ``MetricsRegistry(strict=False)`` relaxes that to the naming regex
(tests, experiments).

``snapshot()`` returns a plain nested dict (JSON-ready);
:func:`to_prometheus` / :func:`to_json` render it; :class:`MetricsDumper`
writes it periodically to a file or stdout. ``set_enabled(False)`` turns
every instrument into a no-op (the overhead-guard baseline).
"""

from __future__ import annotations

import bisect
import json
import math
import sys
import threading
import time
from typing import Optional, TextIO, Union

from repro_torch.obs import names as names_lib

# Default histogram bucket upper bounds: factor-2 log spacing from 1 µs to
# ~137 s (28 finite buckets + the +Inf overflow). Wide enough for
# microsecond kernel stages and multi-second compactions alike.
DEFAULT_BUCKETS = tuple(1e-6 * 2 ** i for i in range(28))


class _Series:
    """Base: one labelled time series. ``kind``/``name``/``labels`` are
    frozen at creation; the value side is guarded by a per-series lock."""

    __slots__ = ("name", "labels", "_lock", "_registry")

    kind = "abstract"

    def __init__(self, name: str, labels: tuple, registry: "MetricsRegistry"):
        self.name = name
        self.labels = labels  # sorted tuple of (key, value) strings
        self._lock = threading.Lock()
        self._registry = registry


class Counter(_Series):
    __slots__ = ("value",)

    kind = "counter"

    def __init__(self, name, labels, registry):
        super().__init__(name, labels, registry)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value += v

    def snapshot(self):
        with self._lock:
            return self.value


class Gauge(_Series):
    __slots__ = ("value",)

    kind = "gauge"

    def __init__(self, name, labels, registry):
        super().__init__(name, labels, registry)
        self.value = 0.0

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def snapshot(self):
        with self._lock:
            return self.value


class Histogram(_Series):
    __slots__ = ("bounds", "counts", "sum", "count", "min", "max")

    kind = "histogram"

    def __init__(self, name, labels, registry, bounds=DEFAULT_BUCKETS):
        super().__init__(name, labels, registry)
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        # counts[i] = observations with v <= bounds[i] (non-cumulative per
        # bucket here; cumulated at export); counts[-1] is the +Inf bucket.
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
        v = float(v)
        if not math.isfinite(v):
            # A NaN/inf observation would poison sum/min/max (and NaN
            # compares false everywhere, so it would land in bucket 0).
            # Swallow it: a broken caller must not corrupt the series.
            return
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from the bucket counts:
        find the bucket holding the q-th observation and interpolate
        linearly inside it (the estimate is off by at most one bucket
        width — a factor of the log spacing; tests compare against numpy).
        """
        with self._lock:
            counts = list(self.counts)
            total = self.count
            lo_seen, hi_seen = self.min, self.max
        if total == 0:
            return math.nan
        target = q * total
        acc = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else 0.0
            hi = self.bounds[i] if i < len(self.bounds) else hi_seen
            # clamp the edge buckets to the really-seen range
            lo = max(lo, lo_seen if acc == 0.0 else lo)
            hi = min(hi, hi_seen)
            if hi < lo:
                lo = hi
            if acc + c >= target:
                frac = (target - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
        return hi_seen

    def snapshot(self):
        with self._lock:
            return dict(
                buckets=list(self.bounds),
                counts=list(self.counts),
                sum=self.sum,
                count=self.count,
                min=(None if self.count == 0 else self.min),
                max=(None if self.count == 0 else self.max),
            )


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Series factory + snapshot surface. See the module docstring."""

    def __init__(self, *, strict: bool = True):
        self.strict = strict
        self.enabled = True
        self._lock = threading.Lock()  # guards series *creation* only
        self._series: dict = {}  # (name, label_key) -> series
        self._kinds: dict = {}  # name -> kind (one kind per name)

    # -- instrument factories ------------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, "counter", labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, "gauge", labels)

    def histogram(self, name: str, bounds=DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, "histogram", labels, bounds=bounds)

    def _get(self, name: str, kind: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        s = self._series.get(key)  # racy fast path: dicts never lose keys
        if s is not None:
            if s.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {s.kind}, "
                    f"requested as a {kind}"
                )
            return s
        with self._lock:
            s = self._series.get(key)
            if s is not None:
                return s
            names_lib.check(name)
            if self.strict:
                cat = names_lib.CATALOGUE.get(name)
                if cat is None:
                    raise ValueError(
                        f"metric {name!r} is not in the documented catalogue "
                        f"(obs/names.py) — add it there, or use a "
                        f"strict=False registry"
                    )
                if cat[0] != kind:
                    raise ValueError(
                        f"metric {name!r} is documented as a {cat[0]}, "
                        f"requested as a {kind}"
                    )
            seen = self._kinds.get(name)
            if seen is not None and seen != kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {seen}, "
                    f"requested as a {kind}"
                )
            self._kinds[name] = kind
            s = _KINDS[kind](name, key[1], self, **kw)
            self._series[key] = s
            return s

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain nested dict: ``{name: {"kind": ..., "help": ...,
        "series": [{"labels": {...}, "value"| "hist": ...}, ...]}}``.
        Values are consistent per series (each is read under its lock)."""
        with self._lock:
            series = list(self._series.values())
        out: dict = {}
        for s in sorted(series, key=lambda s: (s.name, s.labels)):
            entry = out.setdefault(s.name, dict(
                kind=s.kind,
                help=names_lib.CATALOGUE.get(s.name, ("", ""))[1],
                series=[],
            ))
            row: dict = {"labels": dict(s.labels)}
            if s.kind == "histogram":
                row["hist"] = s.snapshot()
            else:
                row["value"] = s.snapshot()
            entry["series"].append(row)
        return out

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)

    def reset(self) -> None:
        """Drop every series (tests; a fresh process-equivalent state)."""
        with self._lock:
            self._series.clear()
            self._kinds.clear()


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------


def _escape_label_value(v) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote and newline must be backslash-escaped inside
    the quoted value."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    # HELP lines escape backslash and newline (quotes are legal there).
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def _fmt_val(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def to_prometheus(snapshot: dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` in the Prometheus text
    exposition format (histograms as cumulative ``_bucket``/``_sum``/
    ``_count`` families)."""
    lines = []
    for name, entry in sorted(snapshot.items()):
        lines.append(
            f"# HELP {name} {_escape_help(entry.get('help', ''))}".rstrip())
        lines.append(f"# TYPE {name} {entry['kind']}")
        for row in entry["series"]:
            labels = row["labels"]
            if entry["kind"] != "histogram":
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_val(row['value'])}"
                )
                continue
            h = row["hist"]
            acc = 0
            for bound, c in zip(
                list(h["buckets"]) + [math.inf], h["counts"]
            ):
                acc += c
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(labels, {'le': _fmt_val(bound)})} {acc}"
                )
            lines.append(f"{name}_sum{_fmt_labels(labels)} "
                         f"{_fmt_val(h['sum'])}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {h['count']}")
    return "\n".join(lines) + "\n"


def to_json(snapshot: dict, *, indent: Optional[int] = None) -> str:
    """Render a snapshot as JSON (the snapshot is already a plain dict)."""
    return json.dumps(snapshot, indent=indent, sort_keys=True)


class MetricsDumper:
    """Periodically write the registry snapshot to a file or stream.

    ``path`` of ``"-"`` dumps Prometheus text to stdout; a ``.prom`` path
    writes Prometheus text, anything else JSON. The file is rewritten whole
    each period (the node-exporter textfile pattern). ``dump()`` forces one
    write; ``close()`` stops the thread and writes a final snapshot.
    """

    def __init__(self, reg: MetricsRegistry, path: str = "-",
                 period_s: float = 10.0):
        self.reg = reg
        self.path = path
        self.period_s = float(period_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.period_s > 0:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _render(self) -> str:
        snap = self.reg.snapshot()
        if self.path == "-" or self.path.endswith(".prom"):
            return to_prometheus(snap)
        return to_json(snap, indent=1)

    def dump(self, stream: Optional[TextIO] = None) -> None:
        text = self._render()
        if stream is not None:
            stream.write(text)
        elif self.path == "-":
            sys.stdout.write(text)
            sys.stdout.flush()
        else:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            import os

            os.replace(tmp, self.path)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.dump()
            except Exception:  # noqa: BLE001 — telemetry must never kill
                pass  # the process it observes

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self.dump()
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# The process-wide default registry
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry(strict=True)


def registry() -> MetricsRegistry:
    """The process-wide default registry every instrumented layer uses."""
    return _DEFAULT


def counter(name: str, **labels) -> Counter:
    return _DEFAULT.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _DEFAULT.gauge(name, **labels)


def histogram(name: str, bounds=DEFAULT_BUCKETS, **labels) -> Histogram:
    return _DEFAULT.histogram(name, bounds, **labels)


def snapshot() -> dict:
    return _DEFAULT.snapshot()


def reset() -> None:
    _DEFAULT.reset()


def set_enabled(on: bool) -> None:
    """Globally enable/disable the default registry's instruments (the
    overhead-guard baseline: disabled instruments return immediately)."""
    _DEFAULT.enabled = bool(on)


def timed(hist: Histogram):
    """Context manager observing its block's wall duration into ``hist``."""
    return _Timed(hist)


class _Timed:
    __slots__ = ("hist", "t0")

    def __init__(self, hist: Histogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0)
        return False
