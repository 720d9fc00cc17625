"""Declarative SLO tracking with multi-rate error-budget burn alerts
(counterpart of ``repro.obs.slo``; DESIGN.md §3.12).

An :class:`SLOSpec` names up to three objectives over a rolling window:

* **latency** — a p99 target: at most ``latency_budget`` (default 1%) of
  requests may exceed ``latency_p99_s``;
* **availability** — at most ``1 - availability`` of requests may fail
  (caller-visible error, deadline, admission reject);
* **recall** — at most ``recall_budget`` (default 10%) of shadow-sampled
  recall estimates (``obs.quality``) may fall below ``recall_floor``.

:class:`SLOTracker` keeps a bounded per-objective ring of (timestamp,
good/bad) events and, on :meth:`evaluate`, computes the SLI and the
*burn rate* — the fraction of the error budget consumed, per unit budget
— over two windows: the full ``window_s`` (slow, confident) and a short
``window_s * fast_window_frac`` (fast, reactive). The multi-rate rule
(the SRE-workbook shape): alert only when BOTH windows burn faster than
``burn_threshold`` — the slow window stops one latency spike from
paging, the fast window clears the alert promptly once the burn stops.

Alert edges are surfaced the same way the router's health transitions
are: a counter (``slo_alerts_total``, labelled objective), gauge series
for SLI / burn / budget-remaining per objective, and a bounded
:meth:`events` log with the numbers that fired the edge.

The tracker is wired into the router (``Router(..., slo=...)``): every
request completion records latency + success, the shadow recall
estimator feeds ``record_recall``, and the router's prober thread calls
``maybe_evaluate`` so evaluation never costs the request path anything.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import names as names_lib


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declarative SLO: targets + windowing + the alert rule. Objectives
    whose target is None are not tracked."""

    name: str = "serve"
    latency_p99_s: Optional[float] = None   # p99 latency target
    latency_budget: float = 0.01            # p99 => 1% may exceed it
    availability: Optional[float] = 0.999   # fraction of requests that
    recall_floor: Optional[float] = None    # must succeed / clear floor
    recall_budget: float = 0.10
    window_s: float = 60.0                  # slow (confident) window
    fast_window_frac: float = 1.0 / 12.0    # fast window = window_s/12
    burn_threshold: float = 2.0             # alert when BOTH windows
    min_samples: int = 8                    # exceed this burn rate
    events_maxlen: int = 1024

    def budgets(self) -> dict:
        """objective -> error budget (allowed bad fraction per window)."""
        out = {}
        if self.latency_p99_s is not None:
            out["latency"] = max(self.latency_budget, 1e-9)
        if self.availability is not None:
            out["availability"] = max(1.0 - self.availability, 1e-9)
        if self.recall_floor is not None:
            out["recall"] = max(self.recall_budget, 1e-9)
        return out


class SLOTracker:
    """See the module docstring. Thread-safe; all methods are O(window)."""

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self._lock = threading.Lock()
        # objective -> deque[(t, ok: bool)]
        self._rings: dict = {obj: collections.deque()
                             for obj in spec.budgets()}
        self._active: dict = {obj: False for obj in self._rings}
        self._events: collections.deque = collections.deque(
            maxlen=spec.events_maxlen)
        self._t0 = time.time()
        self._last_eval = 0.0
        self._m_alerts = {
            obj: metrics_lib.counter(names_lib.SLO_ALERTS, objective=obj)
            for obj in self._rings
        }
        self._m_evals = metrics_lib.counter(names_lib.SLO_EVALUATIONS)

    # -- feeds (hot path: one deque append per objective) ---------------------

    def record_request(self, latency_s: float, ok: bool) -> None:
        now = time.time()
        with self._lock:
            if "availability" in self._rings:
                self._rings["availability"].append((now, ok))
            if "latency" in self._rings:
                good = ok and latency_s <= self.spec.latency_p99_s
                self._rings["latency"].append((now, good))
            self._prune(now)

    def record_recall(self, recall: float) -> None:
        if "recall" not in self._rings:
            return
        now = time.time()
        with self._lock:
            self._rings["recall"].append(
                (now, recall >= self.spec.recall_floor))
            self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.spec.window_s
        for ring in self._rings.values():
            while ring and ring[0][0] < horizon:
                ring.popleft()

    # -- evaluation ------------------------------------------------------------

    def _window_stats(self, ring, now: float, window: float):
        horizon = now - window
        n = bad = 0
        for t, good in ring:
            if t >= horizon:
                n += 1
                bad += not good
        return n, bad

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass: recompute every objective's SLI and burn
        rates, update the gauge series, and fire/clear multi-rate alerts.
        Returns :meth:`status`."""
        spec = self.spec
        now = time.time() if now is None else now
        fast_w = spec.window_s * spec.fast_window_frac
        fired = []
        with self._lock:
            self._prune(now)
            for obj, budget in spec.budgets().items():
                ring = self._rings[obj]
                n_slow, bad_slow = self._window_stats(ring, now,
                                                      spec.window_s)
                n_fast, bad_fast = self._window_stats(ring, now, fast_w)
                sli = 1.0 - (bad_slow / n_slow) if n_slow else 1.0
                burn_slow = ((bad_slow / n_slow) / budget) if n_slow \
                    else 0.0
                burn_fast = ((bad_fast / n_fast) / budget) if n_fast \
                    else 0.0
                metrics_lib.gauge(names_lib.SLO_SLI, objective=obj
                                  ).set(sli)
                metrics_lib.gauge(names_lib.SLO_BURN, objective=obj,
                                  window="slow").set(burn_slow)
                metrics_lib.gauge(names_lib.SLO_BURN, objective=obj,
                                  window="fast").set(burn_fast)
                metrics_lib.gauge(names_lib.SLO_BUDGET, objective=obj
                                  ).set(max(0.0, 1.0 - burn_slow))
                burning = (burn_slow > spec.burn_threshold
                           and burn_fast > spec.burn_threshold
                           and n_fast >= spec.min_samples)
                if burning and not self._active[obj]:
                    self._active[obj] = True
                    self._m_alerts[obj].inc()
                    self._events.append(dict(
                        t=round(now - self._t0, 4), event="burn_alert",
                        objective=obj, burn_slow=round(burn_slow, 3),
                        burn_fast=round(burn_fast, 3), sli=round(sli, 4),
                        n=n_slow,
                    ))
                    fired.append(obj)
                elif not burning and self._active[obj]:
                    self._active[obj] = False
                    self._events.append(dict(
                        t=round(now - self._t0, 4), event="burn_clear",
                        objective=obj, burn_slow=round(burn_slow, 3),
                        burn_fast=round(burn_fast, 3), sli=round(sli, 4),
                        n=n_slow,
                    ))
            self._last_eval = now
        self._m_evals.inc()
        return self.status()

    def maybe_evaluate(self, min_interval_s: float = 0.25
                       ) -> Optional[dict]:
        """Rate-limited :meth:`evaluate` — the prober-thread entry point."""
        with self._lock:
            if time.time() - self._last_eval < min_interval_s:
                return None
        return self.evaluate()

    # -- read side -------------------------------------------------------------

    def events(self) -> list:
        """Snapshot of the bounded alert/clear event log (oldest first)."""
        with self._lock:
            return list(self._events)

    def alert_counts(self) -> dict:
        """objective -> number of burn alerts fired so far."""
        with self._lock:
            c = collections.Counter(
                e["objective"] for e in self._events
                if e["event"] == "burn_alert")
        return dict(c)

    def status(self) -> dict:
        """Per-objective summary for dashboards/benches: samples in
        window, SLI, slow/fast burn, budget remaining, alert active."""
        spec = self.spec
        now = time.time()
        fast_w = spec.window_s * spec.fast_window_frac
        out = {}
        with self._lock:
            for obj, budget in spec.budgets().items():
                ring = self._rings[obj]
                n_slow, bad_slow = self._window_stats(ring, now,
                                                      spec.window_s)
                n_fast, bad_fast = self._window_stats(ring, now, fast_w)
                burn_slow = ((bad_slow / n_slow) / budget) if n_slow \
                    else 0.0
                burn_fast = ((bad_fast / n_fast) / budget) if n_fast \
                    else 0.0
                out[obj] = dict(
                    n=n_slow,
                    sli=round(1.0 - (bad_slow / n_slow), 4) if n_slow
                    else None,
                    burn_slow=round(burn_slow, 3),
                    burn_fast=round(burn_fast, 3),
                    budget_remaining=round(max(0.0, 1.0 - burn_slow), 3),
                    alerting=self._active[obj],
                )
        return out
