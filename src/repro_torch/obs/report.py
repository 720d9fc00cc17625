"""Dashboard + offline observability report (counterpart of
``repro.obs.report``; DESIGN.md §3.12).

Two surfaces over the same snapshot math:

* :class:`Dashboard` — a live terminal view for ``launch/serve.py
  --dash``: a background thread redraws QPS, latency percentiles, engine
  occupancy/queue depth, the online recall estimate, SLO budget state and
  per-replica health every period.
* ``python -m repro_torch.obs.report`` — an offline CLI turning a
  ``MetricsDumper`` JSON dump (plus, optionally, a ``--trace-dump`` JSON
  export) into a static text or HTML report. Exits non-zero on an empty
  or malformed dump — CI runs it against the bench_serve smoke's metrics
  dump as a freshness check on the whole telemetry pipeline.

Everything here consumes plain snapshot/trace *dicts* (never live
registry objects), so the offline and live paths share the renderers.
"""

from __future__ import annotations

import argparse
import html as html_lib
import json
import math
import sys
import threading
import time
from typing import Optional, TextIO

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import names as names_lib


class ReportError(ValueError):
    """The metrics/trace input is empty or malformed."""


# ---------------------------------------------------------------------------
# Snapshot math (dict-side mirrors of the Histogram helpers)
# ---------------------------------------------------------------------------


def percentile_from_hist(hist: dict, q: float) -> float:
    """``Histogram.percentile`` over a snapshot's ``hist`` dict."""
    counts = hist["counts"]
    bounds = hist["buckets"]
    total = hist["count"]
    if not total:
        return math.nan
    lo_seen = hist.get("min") or 0.0
    hi_seen = hist.get("max") or 0.0
    target = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i] if i < len(bounds) else hi_seen
        lo = max(lo, lo_seen if acc == 0.0 else lo)
        hi = min(hi, hi_seen)
        if hi < lo:
            lo = hi
        if acc + c >= target:
            frac = (target - acc) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        acc += c
    return hi_seen


def hist_summary(hist: dict) -> dict:
    n = hist["count"]
    return dict(
        count=n,
        mean=(hist["sum"] / n if n else None),
        p50=(percentile_from_hist(hist, 0.50) if n else None),
        p99=(percentile_from_hist(hist, 0.99) if n else None),
        max=hist.get("max"),
    )


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) \
        + "}"


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != v:
            return "nan"
        if v and (abs(v) < 1e-3 or abs(v) >= 1e6):
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


# ---------------------------------------------------------------------------
# Report building (offline + dashboard share this)
# ---------------------------------------------------------------------------


def validate_snapshot(snapshot) -> dict:
    """Check the loaded dump looks like a registry snapshot with at least
    one series; raises :class:`ReportError` otherwise."""
    if not isinstance(snapshot, dict) or not snapshot:
        raise ReportError("metrics dump is empty or not a JSON object")
    n = 0
    for name, entry in snapshot.items():
        if not isinstance(entry, dict) or "kind" not in entry \
                or "series" not in entry:
            raise ReportError(
                f"metrics dump entry {name!r} is not a snapshot series "
                f"(missing kind/series)")
        n += len(entry["series"])
    if n == 0:
        raise ReportError("metrics dump contains no series")
    return snapshot


def _tier_values(snapshot: dict, name: str) -> dict:
    """``tier`` label -> summed value for one counter/gauge family."""
    entry = snapshot.get(name)
    out: dict = {}
    if entry is None or entry["kind"] == "histogram":
        return out
    for row in entry["series"]:
        tier = row["labels"].get("tier", "")
        out[tier] = out.get(tier, 0.0) + row["value"]
    return out


def store_cache_summary(snapshot: dict) -> dict:
    """Per-tier cache effectiveness derived from the ``store_cache_*``
    series (DESIGN.md §3.13): hit ratio, resident bytes, in-flight dedup
    hits, plus the prefetch pool's drop count. Empty when the snapshot has
    no cache traffic."""
    hits = _tier_values(snapshot, names_lib.STORE_CACHE_HITS)
    misses = _tier_values(snapshot, names_lib.STORE_CACHE_MISSES)
    resident = _tier_values(snapshot, names_lib.STORE_CACHE_RESIDENT)
    dedup = _tier_values(snapshot, names_lib.STORE_CACHE_INFLIGHT_DEDUP)
    tiers: dict = {}
    for tier in sorted(set(hits) | set(misses)):
        h = hits.get(tier, 0.0)
        m = misses.get(tier, 0.0)
        if not h and not m:
            continue
        tiers[tier] = dict(
            hits=int(h), misses=int(m),
            hit_ratio=h / (h + m),
            resident_bytes=int(resident.get(tier, 0.0)),
            inflight_dedup=int(dedup.get(tier, 0.0)),
        )
    if not tiers:
        return {}
    return dict(
        tiers=tiers,
        prefetch_drops=int(_series_value(
            snapshot, names_lib.STORE_PREFETCH_DROPS)),
    )


def build_report(snapshot: dict, traces: Optional[list] = None) -> dict:
    """Structured report dict from a snapshot (+ optional trace dicts):
    per-subsystem series tables, histogram summaries, and trace stats."""
    validate_snapshot(snapshot)
    subsystems: dict = {}
    for name in sorted(snapshot):
        entry = snapshot[name]
        sub = names_lib.subsystem(name)
        bucket = subsystems.setdefault(sub, [])
        for row in entry["series"]:
            item = dict(name=name, kind=entry["kind"],
                        labels=row["labels"])
            if entry["kind"] == "histogram":
                item["summary"] = hist_summary(row["hist"])
            else:
                item["value"] = row["value"]
            bucket.append(item)
    report = dict(
        n_names=len(snapshot),
        n_series=sum(len(v["series"]) for v in snapshot.values()),
        subsystems=subsystems,
    )
    cache = store_cache_summary(snapshot)
    if cache:
        report["store_cache"] = cache
    if traces is not None:
        durations = [t["root"]["duration"] for t in traces]
        slowest = max(traces, key=lambda t: t["root"]["duration"]) \
            if traces else None
        report["traces"] = dict(
            n=len(traces),
            slowest_ms=(round(max(durations) * 1e3, 3) if durations
                        else None),
            slowest=slowest,
        )
    return report


def render_trace_dict(td: dict) -> str:
    """Text flamegraph from a ``Trace.to_dict()`` export (the offline
    twin of ``Trace.render``)."""
    root = td["root"]
    total = max(root["duration"], 1e-12)
    lines = [f"trace #{td.get('trace_id', '?')} seq={td.get('seq', '?')} "
             f"({root['duration'] * 1e3:.2f} ms)"]

    def emit(span: dict, depth: int) -> None:
        attrs = " ".join(f"{k}={v}" for k, v in
                         sorted(span.get("attrs", {}).items()))
        bar = "#" * max(1, int(round(20 * span["duration"] / total)))
        lines.append(
            f"{'  ' * depth}{span['name']:<{max(1, 28 - 2 * depth)}} "
            f"{span['duration'] * 1e3:9.3f}ms "
            f"self={span['self_time'] * 1e3:8.3f}ms "
            f"|{bar:<20}| {attrs}".rstrip())
        for c in span.get("children", ()):
            emit(c, depth + 1)

    emit(root, 0)
    return "\n".join(lines)


def render_text(report: dict) -> str:
    lines = [f"observability report — {report['n_names']} metric names, "
             f"{report['n_series']} series",
             "=" * 64]
    for sub in sorted(report["subsystems"]):
        lines.append(f"\n[{sub}]")
        for item in report["subsystems"][sub]:
            label = f"{item['name']}{_fmt_labels(item['labels'])}"
            if item["kind"] == "histogram":
                s = item["summary"]
                lines.append(
                    f"  {label:<58} n={s['count']:<7} "
                    f"mean={_fmt_num(s['mean'])} p50={_fmt_num(s['p50'])} "
                    f"p99={_fmt_num(s['p99'])} max={_fmt_num(s['max'])}")
            else:
                lines.append(
                    f"  {label:<58} {_fmt_num(item['value'])}")
    cache = report.get("store_cache")
    if cache:
        lines.append("\n[store cache]")
        for tier, t in sorted(cache["tiers"].items()):
            lines.append(
                f"  tier={tier or '-'}: hit_ratio={t['hit_ratio']:.3f} "
                f"({t['hits']} hits / {t['misses']} misses) "
                f"resident={t['resident_bytes']}B "
                f"dedup={t['inflight_dedup']}")
        lines.append(f"  prefetch drops={cache['prefetch_drops']}")
    tr = report.get("traces")
    if tr:
        lines.append(f"\n[traces] retained={tr['n']} "
                     f"slowest={_fmt_num(tr['slowest_ms'])}ms")
        if tr.get("slowest"):
            lines.append(render_trace_dict(tr["slowest"]))
    return "\n".join(lines) + "\n"


def render_html(report: dict) -> str:
    esc = html_lib.escape
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        "<title>observability report</title>",
        "<style>body{font-family:monospace;margin:2em;}"
        "table{border-collapse:collapse;margin-bottom:1.5em;}"
        "td,th{border:1px solid #999;padding:2px 8px;text-align:left;}"
        "th{background:#eee;}h2{margin-bottom:4px;}</style></head><body>",
        f"<h1>observability report</h1>"
        f"<p>{report['n_names']} metric names, {report['n_series']} "
        f"series</p>",
    ]
    for sub in sorted(report["subsystems"]):
        parts.append(f"<h2>{esc(sub)}</h2><table>"
                     "<tr><th>series</th><th>kind</th><th>value</th>"
                     "<th>n</th><th>mean</th><th>p50</th><th>p99</th>"
                     "<th>max</th></tr>")
        for item in report["subsystems"][sub]:
            label = f"{item['name']}{_fmt_labels(item['labels'])}"
            if item["kind"] == "histogram":
                s = item["summary"]
                cells = ["", str(s["count"]), _fmt_num(s["mean"]),
                         _fmt_num(s["p50"]), _fmt_num(s["p99"]),
                         _fmt_num(s["max"])]
            else:
                cells = [_fmt_num(item["value"]), "", "", "", "", ""]
            parts.append(
                f"<tr><td>{esc(label)}</td><td>{esc(item['kind'])}</td>"
                + "".join(f"<td>{esc(c)}</td>" for c in cells) + "</tr>")
        parts.append("</table>")
    cache = report.get("store_cache")
    if cache:
        parts.append("<h2>store cache</h2><table>"
                     "<tr><th>tier</th><th>hit ratio</th><th>hits</th>"
                     "<th>misses</th><th>resident bytes</th>"
                     "<th>dedup</th></tr>")
        for tier, t in sorted(cache["tiers"].items()):
            parts.append(
                f"<tr><td>{esc(tier or '-')}</td>"
                f"<td>{t['hit_ratio']:.3f}</td><td>{t['hits']}</td>"
                f"<td>{t['misses']}</td><td>{t['resident_bytes']}</td>"
                f"<td>{t['inflight_dedup']}</td></tr>")
        parts.append(f"</table><p>prefetch drops="
                     f"{cache['prefetch_drops']}</p>")
    tr = report.get("traces")
    if tr:
        parts.append(f"<h2>traces</h2><p>retained={tr['n']} "
                     f"slowest={_fmt_num(tr['slowest_ms'])}ms</p>")
        if tr.get("slowest"):
            parts.append(
                f"<pre>{esc(render_trace_dict(tr['slowest']))}</pre>")
    parts.append("</body></html>")
    return "".join(parts)


# ---------------------------------------------------------------------------
# Live terminal dashboard (launch/serve.py --dash)
# ---------------------------------------------------------------------------


def _series_value(snap: dict, name: str) -> float:
    entry = snap.get(name)
    if entry is None:
        return 0.0
    if entry["kind"] == "histogram":
        return float(sum(r["hist"]["count"] for r in entry["series"]))
    return float(sum(r["value"] for r in entry["series"]))


def _hist_merged(snap: dict, name: str) -> Optional[dict]:
    """Across-label merge of one histogram family (same bounds)."""
    entry = snap.get(name)
    if entry is None or entry["kind"] != "histogram" \
            or not entry["series"]:
        return None
    rows = [r["hist"] for r in entry["series"]]
    base = rows[0]
    merged = dict(
        buckets=list(base["buckets"]),
        counts=[sum(r["counts"][i] for r in rows
                    if len(r["counts"]) == len(base["counts"]))
                for i in range(len(base["counts"]))],
        sum=sum(r["sum"] for r in rows),
        count=sum(r["count"] for r in rows),
        min=min((r["min"] for r in rows if r["min"] is not None),
                default=None),
        max=max((r["max"] for r in rows if r["max"] is not None),
                default=None),
    )
    return merged if merged["count"] else None


def render_dashboard(snap: dict, *, prev: Optional[dict] = None,
                     dt: Optional[float] = None, quality=None, slo=None,
                     router=None, width: int = 78) -> str:
    """One dashboard frame from a registry snapshot (+ optional live
    helpers: a RecallEstimator, an SLOTracker, a Router)."""
    lines = [f"── serve dashboard {'─' * max(0, width - 19)}"]
    served = _series_value(snap, names_lib.ROUTER_REQUESTS) \
        or _series_value(snap, names_lib.ENGINE_REQUESTS)
    qps = None
    if prev is not None and dt:
        prev_served = _series_value(prev, names_lib.ROUTER_REQUESTS) \
            or _series_value(prev, names_lib.ENGINE_REQUESTS)
        qps = max(0.0, served - prev_served) / dt
    lat = _hist_merged(snap, names_lib.ROUTER_LATENCY) \
        or _hist_merged(snap, names_lib.ENGINE_HANDLER_TIME)
    parts = [f"served={int(served)}"]
    if qps is not None:
        parts.append(f"qps={qps:.1f}")
    if lat:
        parts.append(
            f"p50={percentile_from_hist(lat, 0.5) * 1e3:.1f}ms "
            f"p99={percentile_from_hist(lat, 0.99) * 1e3:.1f}ms")
    occ = _hist_merged(snap, names_lib.ENGINE_BATCH_OCCUPANCY)
    if occ:
        parts.append(f"occupancy={occ['sum'] / occ['count']:.2f}")
    depth = _series_value(snap, names_lib.ENGINE_QUEUE_DEPTH)
    parts.append(f"queue={int(depth)}")
    lines.append("  " + "  ".join(parts))
    lines.append(
        "  " + "  ".join(
            f"{label}={int(_series_value(snap, cname))}"
            for cname, label in (
                (names_lib.ROUTER_RETRIES, "retries"),
                (names_lib.ROUTER_HEDGES, "hedges"),
                (names_lib.ROUTER_DEGRADED, "degraded"),
                (names_lib.ROUTER_REJECTS, "rejects"),
                (names_lib.QUALITY_SAMPLED, "shadowed"),
            )))
    cache = store_cache_summary(snap)
    if cache:
        lines.append("  cache: " + "  ".join(
            f"{tier or '-'}={t['hit_ratio']:.2f} "
            f"({t['resident_bytes'] // 1024}KiB)"
            for tier, t in sorted(cache["tiers"].items()))
            + f"  prefetch_drops={cache['prefetch_drops']}")
    if quality is not None:
        est = quality.estimate()
        if est["queries"]:
            lines.append(
                f"  recall@k≈{est['recall']:.3f} "
                f"[{est['wilson_lo']:.3f}, {est['wilson_hi']:.3f}] "
                f"over {est['queries']} shadow samples")
        else:
            lines.append("  recall@k: no shadow samples yet")
    if slo is not None:
        for obj, st in sorted(slo.status().items()):
            flag = " ALERT" if st["alerting"] else ""
            lines.append(
                f"  slo[{obj}] sli={_fmt_num(st['sli'])} "
                f"burn={st['burn_slow']:.2f}/{st['burn_fast']:.2f} "
                f"budget_left={st['budget_remaining']:.2f} "
                f"n={st['n']}{flag}")
    if router is not None:
        states = router.health_states()
        lines.append("  replicas: " + "  ".join(
            f"r{rid}={state}" for rid, state in sorted(states.items())))
    lines.append("─" * width)
    return "\n".join(lines)


class Dashboard:
    """Background thread redrawing :func:`render_dashboard` every period.

    Writes ANSI home+clear before each frame when ``clear=True`` (the
    interactive default); with ``clear=False`` frames are appended —
    usable on dumb pipes and in tests.
    """

    def __init__(self, registry=None, *, period_s: float = 1.0,
                 quality=None, slo=None, router=None,
                 stream: Optional[TextIO] = None, clear: bool = True):
        self.reg = registry if registry is not None \
            else metrics_lib.registry()
        self.period_s = float(period_s)
        self.quality = quality
        self.slo = slo
        self.router = router
        self.stream = stream if stream is not None else sys.stdout
        self.clear = clear
        self._prev: Optional[dict] = None
        self._prev_t: Optional[float] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="obs-dashboard")
        self._thread.start()

    def frame(self) -> str:
        snap = self.reg.snapshot()
        now = time.perf_counter()
        dt = (now - self._prev_t) if self._prev_t is not None else None
        text = render_dashboard(snap, prev=self._prev, dt=dt,
                                quality=self.quality, slo=self.slo,
                                router=self.router)
        self._prev, self._prev_t = snap, now
        return text

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                text = self.frame()
                if self.clear:
                    self.stream.write("\x1b[H\x1b[2J")
                self.stream.write(text + "\n")
                self.stream.flush()
            except Exception:  # noqa: BLE001 — telemetry never kills serving
                pass

    def close(self, *, final_frame: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        if final_frame:
            try:
                self.stream.write(self.frame() + "\n")
                self.stream.flush()
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.obs.report
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a MetricsDumper JSON dump (+ optional trace "
                    "JSON) as a static text/HTML observability report.")
    p.add_argument("--metrics", required=True, metavar="PATH",
                   help="MetricsDumper JSON output (a registry snapshot)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="a --trace-dump JSON export "
                        '({"traces": [...]}) to include')
    p.add_argument("--format", choices=["text", "html"], default=None,
                   help="output format (default: by --out extension, "
                        "else text)")
    p.add_argument("--out", default="-", metavar="PATH",
                   help="output path ('-' = stdout)")
    args = p.parse_args(argv)

    try:
        with open(args.metrics) as f:
            snapshot = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"report: cannot read metrics dump {args.metrics}: {e}",
              file=sys.stderr)
        return 2
    traces = None
    if args.trace:
        try:
            with open(args.trace) as f:
                tr = json.load(f)
            traces = tr["traces"] if isinstance(tr, dict) else tr
        except (OSError, json.JSONDecodeError, KeyError) as e:
            print(f"report: cannot read trace dump {args.trace}: {e}",
                  file=sys.stderr)
            return 2
    try:
        report = build_report(snapshot, traces)
    except ReportError as e:
        print(f"report: {e}", file=sys.stderr)
        return 2
    fmt = args.format or ("html" if args.out.endswith(".html") else "text")
    text = render_html(report) if fmt == "html" else render_text(report)
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"report: wrote {fmt} report ({report['n_series']} series) "
              f"to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
