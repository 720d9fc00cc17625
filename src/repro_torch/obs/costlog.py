"""Plan-execution cost recorder (counterpart of ``repro.obs.costlog``;
DESIGN.md §3.12).

For traced (sampled) executions the serving tier appends one JSONL record
joining the *plan features* (``SearchPlan.describe()``: pipeline, beam
schedule, rerank width, index code format / point count, kernel config)
with the *measured costs* from the request's span tree (per-stage wall
and self times, candidate/survivor/granule counts) — this file IS the
calibration dataset for the ``execution="auto"`` cost model (ROADMAP
open item): each line is one (features, costs) training example.

Record schema (``"v": 1``) — every line is a JSON object with:

  ``v``            schema version (int, currently 1)
  ``seq``          request sequence number of the traced request
  ``latency_s``    end-to-end traced duration (root span)
  ``outcome``      root-span outcome attr ("ok" / "error" / ...)
  ``pipeline``, ``effective_pipeline``
                   from ``plan.describe()``
  ``query``        resolved execution-relevant Query fields (k, beam,
                   rerank_width, exact_rerank, ...)
  ``index``        ``{"n_points", "n_levels", "code_format", "store",
                   "payload_released"}`` — the capability-side features
  ``kernel``       the stamped kernel config dict (or None)
  ``spans``        ``{span_name: {"total_s", "self_s", "count"}}``
                   aggregated over the span tree
  ``counts``       summed numeric span attrs that carry work sizes
                   (``candidates``, ``survivors``, ``granules``,
                   ``rows``, ``batch``)
  plus any extra key the caller passes (``replica``, ``degraded``, ...).

``load(path)`` reads the file back into a list of dicts, skipping blank
lines, so the calibration consumer and the bench can assert on it.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import names as names_lib

SCHEMA_VERSION = 1

# Span attrs that carry per-stage work sizes worth summing into features.
_COUNT_ATTRS = ("candidates", "survivors", "granules", "rows", "batch")


def _walk(span_dict: dict):
    yield span_dict
    for c in span_dict.get("children", ()):
        yield from _walk(c)


def build_record(trace, describe: Optional[dict] = None,
                 extra: Optional[dict] = None) -> dict:
    """One cost record from a finished trace (``obs.Trace`` or its
    ``to_dict()`` form) plus the served plan's ``describe()`` dict."""
    td = trace if isinstance(trace, dict) else trace.to_dict()
    root = td["root"]
    spans: dict = {}
    counts: dict = {}
    for s in _walk(root):
        agg = spans.setdefault(
            s["name"], {"total_s": 0.0, "self_s": 0.0, "count": 0})
        agg["total_s"] += float(s["duration"])
        agg["self_s"] += float(s["self_time"])
        agg["count"] += 1
        for key in _COUNT_ATTRS:
            v = s.get("attrs", {}).get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                counts[key] = counts.get(key, 0) + v
    for agg in spans.values():
        agg["total_s"] = round(agg["total_s"], 9)
        agg["self_s"] = round(agg["self_s"], 9)
    rec = dict(
        v=SCHEMA_VERSION,
        seq=td.get("seq"),
        latency_s=round(float(root["duration"]), 9),
        outcome=root.get("attrs", {}).get("outcome"),
        spans=spans,
        counts=counts,
    )
    if describe:
        caps = describe.get("capabilities", {}) or {}
        rec.update(
            pipeline=describe.get("pipeline"),
            effective_pipeline=describe.get("effective_pipeline"),
            query=describe.get("query"),
            kernel=describe.get("kernel"),
            index=dict(
                n_points=describe.get("index", {}).get("n_points"),
                n_levels=caps.get("n_levels"),
                code_format=describe.get("index", {}).get("code_format"),
                store=caps.get("store"),
                payload_released=caps.get("payload_released"),
            ),
        )
    if extra:
        rec.update(extra)
    return rec


class CostLog:
    """Append-only JSONL writer for plan-execution cost records.

    Thread-safe; one line per :meth:`record` call, flushed per record so a
    crashed process loses at most the in-flight line. Open lazily — a
    CostLog constructed but never fed creates no file.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._f = None
        self._n = 0
        self._m_records = metrics_lib.counter(names_lib.PLAN_COST_RECORDS)

    def record(self, trace, describe: Optional[dict] = None,
               **extra) -> dict:
        rec = build_record(trace, describe, extra)
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "a")
            self._f.write(line + "\n")
            self._f.flush()
            self._n += 1
        self._m_records.inc()
        return rec

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def load(path: str) -> list[dict]:
    """Read a cost log back: one dict per non-blank line."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# the package-level (repro_torch.obs) export name — "load" is too generic there
load_costlog = load
