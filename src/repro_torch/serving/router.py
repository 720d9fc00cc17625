"""Fault-tolerant request router over a :class:`~repro_torch.serving.replicated
.ReplicaSet` (counterpart of ``repro.serving.router``; DESIGN.md §3.10).

The router is the caller-facing front of the replicated serving tier. Per
request it runs a small state machine:

    ADMIT ──▶ DISPATCH ──▶ WAIT ──▶ done
      │          │           ├─ attempt failed ──▶ backoff ──▶ DISPATCH
      │          │           └─ hedge timer ──▶ second DISPATCH, first wins
      └─ over the queue limit: degrade (cheaper Query) or reject (Overloaded)

* **Admission control** — a bounded in-flight budget (``queue_limit``).
  Past the degradation watermark requests are rewritten onto the *degraded*
  query plan (``repro_torch.query.degraded`` — narrower beam, scan-only two-stage
  — compiled through the same plan layer, served by the engine's
  ``extra_handlers`` lane) and tagged ``degraded=True``; past the hard
  limit they are rejected with :class:`Overloaded`. Shedding early keeps
  queues short, so accepted requests keep meeting their deadlines.
* **Load-aware dispatch** — least-outstanding-requests with
  power-of-two-choices: sample two healthy replicas (seeded RNG), send to
  the one with fewer requests in flight. P2C gets most of the balance of
  full least-loaded without a global scan or herding on stale signals.
* **Deadlines** — every request carries a budget; the remaining budget is
  threaded into the engine (``submit(deadline_s=...)``) so an expired
  request is dropped from the queue instead of wasting a batch slot, and
  the router raises :class:`~repro_torch.serving.engine.DeadlineExceeded` to the
  caller only when retries and hedges could not beat the clock.
* **Bounded retries, exponential backoff + jitter** — a failed attempt
  (injected error, crash, replica down, queue drop) retries on another
  replica up to ``max_retries`` times, waiting ``backoff_base_s * 2^i``
  (capped, ± seeded jitter) so a recovering replica is not stampeded.
* **Tail-latency hedging** — when the primary attempt is still running
  after a p99-derived delay (estimated online from completed latencies),
  the request is re-issued to a second replica; the first result wins and
  the loser is cancelled (the engine skips it at batch assembly). The
  loser, if still incomplete, counts a health failure — that is exactly
  the signal that ejects a wedged replica that never errors, only stalls.
* **Health checking** — consecutive failures eject a replica from the
  dispatch pool (a crash ejects immediately and tears its engine down). A
  background prober revisits ejected replicas after an exponentially
  growing cooldown: half-open state admits one probe (restarting a dead
  engine first, which replays the write log it missed); success readmits,
  failure re-ejects. The full lifecycle — eject, half-open probes,
  readmission — lands in the bounded event log (``router.events()``)
  with from/to states and per-edge transition counters in ``repro_torch.obs``,
  for the fault harness to assert on.
* **Telemetry** (DESIGN.md §3.11) — counters/histograms for every decision
  above land in the process-wide ``repro_torch.obs`` registry, and with
  ``RouterConfig.trace_every = N`` every N-th request (deterministic by
  request seq) records a full span tree — attempt legs, queue/batch waits,
  plan stages, granule fetches — retained in ``router.traces``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import random
import threading
import time
from typing import NamedTuple, Optional

import numpy as np

from repro_torch import obs
from repro_torch.obs import names as mnames
from repro_torch.serving.engine import Cancelled, DeadlineExceeded
from repro_torch.serving.faults import ReplicaCrashed
from repro_torch.serving.replicated import ReplicaDown, ReplicaSet


class Overloaded(RuntimeError):
    """Admission control rejected the request (in-flight budget exhausted)."""


class ReplicaUnavailable(RuntimeError):
    """No replica could accept the request (all down)."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router knobs. All time budgets in seconds; ``seed`` drives every
    random draw (replica sampling, backoff jitter) — the router never
    consults wall-clock randomness."""

    deadline_s: float = 1.0          # per-request end-to-end budget
    max_retries: int = 2             # re-dispatches after the first attempt
    backoff_base_s: float = 0.01     # retry i waits base * 2^i ...
    backoff_cap_s: float = 0.25      # ... capped here ...
    backoff_jitter: float = 0.5      # ... +/- this fraction, seeded
    hedge: bool = True               # tail-latency hedging on/off
    hedge_min_s: float = 0.02        # floor (and cold-start value) for the
    hedge_quantile: float = 0.99     # p99-derived hedge delay
    queue_limit: int = 256           # hard admission limit (in-flight)
    degrade_at: float = 0.75         # degrade past this fraction of limit
    eject_failures: int = 3          # consecutive failures -> ejection
    probe_cooldown_s: float = 0.2    # half-open cooldown (doubles per fail)
    probe_timeout_s: float = 0.3     # a probe slower than this failed
    probe_interval_s: float = 0.05   # prober thread wake period
    seed: int = 0
    # Telemetry (DESIGN.md §3.11): trace 1 request in N, keyed on the
    # router's request sequence number (deterministic; 0 disables), and
    # bound the in-memory event log (oldest entries evicted).
    trace_every: int = 0
    events_maxlen: int = 4096
    # Quality observability (DESIGN.md §3.12): shadow-sample 1 served
    # request in N (same seq-keyed scheme as trace_every; 0 disables) and
    # re-answer it exactly off the hot path — the router builds its own
    # ``obs.RecallEstimator`` over the replica set unless one is passed in.
    shadow_every: int = 0


class RouterResult(NamedTuple):
    dists: np.ndarray
    ids: np.ndarray
    replica: int        # replica that produced the winning result
    degraded: bool      # served on the degraded (cheaper) plan
    retries: int        # re-dispatches this request needed
    hedged: bool        # a hedge twin was issued
    latency_s: float


class _Health:
    __slots__ = ("state", "consec", "ejected_at", "probe_attempts")

    def __init__(self):
        self.state = "healthy"  # "healthy" | "ejected" | "half_open"
        self.consec = 0
        self.ejected_at = 0.0
        self.probe_attempts = 0


class RouterRequest:
    """One admitted request: holds the live engine attempts and drives the
    retry/hedge state machine from the caller's :meth:`wait`."""

    def __init__(self, router: "Router", payload, kind: str,
                 deadline: float, *, seq: int = 0, trace=None):
        self.router = router
        self.payload = payload
        self.kind = kind
        self.t0 = time.time()
        self.deadline = deadline
        self.attempts: list = []  # live (replica, engine Request) pairs
        self.retries = 0
        self.hedged = False
        self.seq = seq
        self.trace = trace  # obs.Trace for the sampled 1-in-N, else None
        self._evt = threading.Event()  # poked by any attempt completing
        self._released = False

    def _notify(self, _req) -> None:
        self._evt.set()

    def wait(self, timeout: Optional[float] = None) -> RouterResult:
        try:
            return self.router._drive(self, timeout)
        finally:
            self.router._release(self)

    # engine-side completion check helpers -----------------------------------

    def live(self):
        return [(r, q) for r, q in self.attempts if not q._event.is_set()]

    def finished(self):
        return [(r, q) for r, q in self.attempts if q._event.is_set()]


class Router:
    """See the module docstring. Construct over a :class:`ReplicaSet`;
    callers use :meth:`search` (sync) or :meth:`submit` + ``wait()``."""

    def __init__(self, replica_set: ReplicaSet,
                 config: Optional[RouterConfig] = None, *,
                 quality=None, slo=None, costlog=None):
        self.set = replica_set
        self.cfg = config or RouterConfig()
        # Quality/SLO/cost observability (DESIGN.md §3.12), all optional:
        # ``quality`` is an obs.RecallEstimator (built here when
        # cfg.shadow_every > 0 and none is passed), ``slo`` an
        # obs.SLOTracker fed from every request completion and evaluated
        # by the prober thread, ``costlog`` an obs.CostLog appended for
        # each traced (sampled) request.
        self.slo = slo
        self.costlog = costlog
        self._own_quality = False
        if quality is None and self.cfg.shadow_every > 0:
            from repro_torch.obs.quality import RecallEstimator

            quality = RecallEstimator(replica_set,
                                      every_n=self.cfg.shadow_every)
            self._own_quality = True
        self.quality = quality
        if (self.quality is not None and self.slo is not None
                and self.quality.on_sample is None):
            # the shadow worker feeds the SLO recall objective
            self.quality.on_sample = \
                lambda recall, pipeline, leg: self.slo.record_recall(recall)
        self._pipelines: dict = {}  # kind -> effective_pipeline label
        self._rng = random.Random(self.cfg.seed)
        self._lock = threading.Lock()
        self._health = {r.id: _Health() for r in replica_set.replicas}
        self._inflight = 0
        self._t0 = time.time()
        # Bounded event log: deque drops the oldest entries, so a long-
        # lived router cannot grow without bound; read via events().
        self._events: collections.deque = collections.deque(
            maxlen=self.cfg.events_maxlen)
        self.stats = collections.Counter()
        self._lat = collections.deque(maxlen=512)
        self._seq = itertools.count()
        # Deterministic 1-in-N request tracing; completed traces land in
        # self.traces (bounded), exemplar via self.traces.exemplar(p99).
        self._sampler = obs.TraceSampler(self.cfg.trace_every)
        self.traces = self._sampler.buffer
        self._m_requests = obs.counter(mnames.ROUTER_REQUESTS)
        self._m_rejects = obs.counter(mnames.ROUTER_REJECTS)
        self._m_degraded = obs.counter(mnames.ROUTER_DEGRADED)
        self._m_retries = obs.counter(mnames.ROUTER_RETRIES)
        self._m_hedges = obs.counter(mnames.ROUTER_HEDGES)
        self._m_hedge_wins = obs.counter(mnames.ROUTER_HEDGE_WINS)
        self._m_deadline = obs.counter(mnames.ROUTER_DEADLINE_EXCEEDED)
        self._m_latency = obs.histogram(mnames.ROUTER_LATENCY)
        self._stop = threading.Event()
        self._prober = threading.Thread(target=self._probe_loop, daemon=True)
        self._prober.start()

    # -- public surface -------------------------------------------------------

    def search(self, payload, *, deadline_s: Optional[float] = None,
               timeout: Optional[float] = None) -> RouterResult:
        return self.submit(payload, deadline_s=deadline_s).wait(timeout)

    def submit(self, payload, *,
               deadline_s: Optional[float] = None) -> RouterRequest:
        """Admit + first dispatch. Raises :class:`Overloaded` past the hard
        in-flight limit; past the degradation watermark (and with a
        degraded query configured) the request is served on the cheaper
        plan instead and tagged."""
        cfg = self.cfg
        kind = "search"
        with self._lock:
            if self._inflight >= cfg.queue_limit:
                self.stats["rejected"] += 1
                self._m_rejects.inc()
                self._log("reject", None, f"inflight={self._inflight}")
                if self.slo is not None:
                    self.slo.record_request(0.0, ok=False)
                raise Overloaded(
                    f"router over capacity ({self._inflight} in flight >= "
                    f"queue_limit={cfg.queue_limit})"
                )
            if (self.set.degraded_query is not None
                    and self._inflight >= cfg.degrade_at * cfg.queue_limit):
                kind = "degraded"
                self.stats["degraded"] += 1
                self._m_degraded.inc()
                self._log("degrade", None, f"inflight={self._inflight}")
            self._inflight += 1
            self.stats["requests"] += 1
            seq = next(self._seq)
        self._m_requests.inc()
        budget = cfg.deadline_s if deadline_s is None else deadline_s
        trace = self._sampler.sample("request", seq, kind=kind)
        rr = RouterRequest(self, payload, kind, time.time() + budget,
                           seq=seq, trace=trace)
        try:
            self._dispatch(rr, leg="primary")
        except BaseException:
            self._release(rr)
            raise
        return rr

    def close(self, *, close_replicas: bool = False) -> None:
        self._stop.set()
        self._prober.join(timeout=5.0)
        if self._own_quality and self.quality is not None:
            self.quality.close()
        if close_replicas:
            self.set.close()

    def health_states(self) -> dict:
        """replica id -> current health state ("healthy" | "ejected" |
        "half_open") — the dashboard's per-replica view."""
        with self._lock:
            return {rid: h.state for rid, h in self._health.items()}

    def events(self) -> list:
        """Snapshot of the bounded in-memory event log (oldest first).
        Each entry: ``{"t": ..., "event": ..., "replica": ..., "detail":
        ...}``; ejections/readmissions also carry ``from``/``to`` health
        states so the fault harness can assert exact sequences."""
        with self._lock:
            return list(self._events)

    def event_counts(self) -> dict:
        with self._lock:
            c = collections.Counter(e["event"] for e in self._events)
        return dict(c)

    def hedge_delay(self) -> float:
        """The p99-derived hedge delay (estimated online; floor/cold-start
        value ``hedge_min_s``)."""
        with self._lock:
            lat = list(self._lat)
        if len(lat) < 20:
            return self.cfg.hedge_min_s
        return max(self.cfg.hedge_min_s,
                   float(np.quantile(lat, self.cfg.hedge_quantile)))

    # -- dispatch + health ----------------------------------------------------

    def _log(self, event: str, replica: Optional[int], detail: str = "",
             **extra):
        # callers hold self._lock
        self._events.append(dict(
            t=round(time.time() - self._t0, 4), event=event,
            replica=replica, detail=detail, **extra,
        ))

    def _transition(self, rid: int, frm: str, to: str, event: str,
                    detail: str = "") -> None:
        """Record one health state-machine edge: the per-edge counter
        (labelled from/to) plus an event-log entry carrying the states.
        Callers hold self._lock and have already set ``h.state = to``."""
        self.stats[f"transition_{frm}_{to}"] += 1
        obs.counter(mnames.ROUTER_HEALTH_TRANSITIONS,
                    **{"replica": str(rid), "from": frm, "to": to}).inc()
        self._log(event, rid, detail, **{"from": frm, "to": to})

    def _pick(self, exclude: set):
        """Least-outstanding with power-of-two-choices over healthy
        replicas; falls back to any alive replica (better a long shot than
        a guaranteed error), None when nothing is alive."""
        with self._lock:
            healthy = [r for r in self.set.replicas
                       if r.id not in exclude and r.alive
                       and self._health[r.id].state == "healthy"]
            if not healthy:
                healthy = [r for r in self.set.replicas
                           if r.id not in exclude and r.alive]
            if not healthy:
                healthy = [r for r in self.set.replicas if r.alive]
            if not healthy:
                return None
            if len(healthy) == 1:
                return healthy[0]
            a, b = self._rng.sample(healthy, 2)
        return a if a.outstanding <= b.outstanding else b

    def _dispatch(self, rr: RouterRequest, *, leg: str = "primary") -> None:
        """Submit one attempt for ``rr``; walks picks past dead replicas.
        ``leg`` tags the attempt ("primary" | "retry" | "hedge") for the
        dispatch counters, the hedge-win accounting and the trace span."""
        exclude = {r.id for r, _ in rr.attempts}
        for _ in range(max(len(self.set.replicas), 1)):
            rep = self._pick(exclude)
            if rep is None:
                raise ReplicaUnavailable("no live replica to dispatch to")
            remaining = rr.deadline - time.time()
            if remaining <= 0:
                raise DeadlineExceeded("request deadline exhausted before "
                                       "dispatch")
            span = None
            if rr.trace is not None:
                span = rr.trace.root.child(
                    "attempt", replica=rep.id, leg=leg)
            try:
                req = rep.submit(rr.payload, kind=rr.kind,
                                 deadline_s=remaining, on_done=rr._notify,
                                 span=span)
            except ReplicaDown:
                if span is not None:
                    span.end(error="ReplicaDown")
                self._on_failure(rep.id, "down")
                exclude.add(rep.id)
                continue
            req._leg = leg
            obs.counter(mnames.ROUTER_DISPATCHES,
                        replica=str(rep.id), leg=leg).inc()
            rr.attempts.append((rep, req))
            return
        raise ReplicaUnavailable("every dispatch candidate refused the "
                                 "request")

    def _on_success(self, rid: int) -> None:
        with self._lock:
            h = self._health[rid]
            h.consec = 0
            if h.state == "half_open":
                h.state = "healthy"
                h.probe_attempts = 0
                self._transition(rid, "half_open", "healthy", "readmit")

    def _on_failure(self, rid: int, reason: str, *,
                    crashed: bool = False) -> None:
        obs.counter(mnames.ROUTER_FAILURES, replica=str(rid)).inc()
        with self._lock:
            h = self._health[rid]
            h.consec += 1
            self.stats["failures"] += 1
            if h.state == "half_open":
                h.state = "ejected"
                h.ejected_at = time.time()
                h.probe_attempts += 1
                self._transition(rid, "half_open", "ejected", "probe_fail",
                                 reason)
            elif h.state == "healthy" and (
                    crashed or h.consec >= self.cfg.eject_failures):
                h.state = "ejected"
                h.ejected_at = time.time()
                self._transition(rid, "healthy", "ejected", "eject", reason)

    def _handle_error(self, rr: RouterRequest, rep, err) -> None:
        """Health bookkeeping for one failed attempt."""
        if isinstance(err, ReplicaCrashed):
            # simulated process death: tear the engine down so subsequent
            # dispatches see the replica as down, eject immediately
            self.set.kill(rep.id)
            self._on_failure(rep.id, "crash", crashed=True)
            with self._lock:
                self._log("crash", rep.id, str(err))
        else:
            self._on_failure(rep.id, type(err).__name__)

    # -- the per-request state machine (caller thread) ------------------------

    def _drive(self, rr: RouterRequest, timeout: Optional[float]
               ) -> RouterResult:
        cfg = self.cfg
        hard_stop = None if timeout is None else time.time() + timeout
        hedge_at = (rr.t0 + self.hedge_delay()
                    if cfg.hedge and len(self.set.replicas) > 1 else None)
        backoff_until = None
        last_err: Optional[BaseException] = None
        while True:
            # 1) collect finished attempts
            for rep, req in rr.finished():
                rr.attempts.remove((rep, req))
                if req.error is None:
                    if req.span is not None:
                        req.span.end(outcome="won")
                    self._on_success(rep.id)
                    if getattr(req, "_leg", "primary") == "hedge":
                        self.stats["hedge_wins"] += 1
                        self._m_hedge_wins.inc()
                    # winner: cancel the losers; a loser still incomplete is
                    # the stall signal that ejects wedged replicas
                    for lrep, lreq in list(rr.attempts):
                        if not lreq._event.is_set():
                            lreq.cancel()
                            if lreq.span is not None:
                                lreq.span.end(outcome="cancelled")
                            self._on_failure(lrep.id, "hedge_loss")
                    lat = time.time() - rr.t0
                    with self._lock:
                        self._lat.append(lat)
                        self.stats["successes"] += 1
                    self._m_latency.observe(lat)
                    if rr.trace is not None:
                        rr.trace.finish(
                            outcome="ok", replica=rep.id,
                            degraded=(rr.kind == "degraded"),
                            retries=rr.retries, hedged=rr.hedged)
                    dists, ids = req.result
                    ids = np.asarray(ids)
                    self._observe_success(rr, rep, lat, ids)
                    return RouterResult(
                        dists=np.asarray(dists), ids=ids,
                        replica=rep.id, degraded=(rr.kind == "degraded"),
                        retries=rr.retries, hedged=rr.hedged, latency_s=lat,
                    )
                if req.span is not None:
                    req.span.end(error=type(req.error).__name__)
                if isinstance(req.error, Cancelled):
                    continue  # our own cancel racing the worker: not a fault
                last_err = req.error
                self._handle_error(rr, rep, req.error)
                if rr.retries < cfg.max_retries and backoff_until is None:
                    # schedule a jittered exponential backoff, then retry
                    base = min(cfg.backoff_cap_s,
                               cfg.backoff_base_s * (2 ** rr.retries))
                    with self._lock:
                        jit = 1.0 + cfg.backoff_jitter * (
                            2.0 * self._rng.random() - 1.0)
                    backoff_until = time.time() + base * jit
            now = time.time()
            # 2) deadline / caller-timeout checks
            if now >= rr.deadline or (hard_stop is not None
                                      and now >= hard_stop):
                for rep, req in rr.live():
                    req.cancel()
                    if req.span is not None:
                        req.span.end(outcome="deadline")
                    self._on_failure(rep.id, "deadline")
                with self._lock:
                    self.stats["deadline_exceeded"] += 1
                self._m_deadline.inc()
                if self.slo is not None:
                    self.slo.record_request(now - rr.t0, ok=False)
                if now >= rr.deadline:
                    raise DeadlineExceeded(
                        f"request missed its {cfg.deadline_s * 1e3:.0f}ms "
                        f"deadline after {rr.retries} retries"
                    ) from last_err
                raise TimeoutError("router wait() timeout") from last_err
            # 3) retry when its backoff matured
            if backoff_until is not None and now >= backoff_until:
                backoff_until = None
                rr.retries += 1
                with self._lock:
                    self.stats["retries"] += 1
                    self._log("retry", None, f"n={rr.retries}")
                self._m_retries.inc()
                try:
                    self._dispatch(rr, leg="retry")
                except (ReplicaUnavailable, DeadlineExceeded) as e:
                    last_err = e
                    if not rr.live():
                        raise
            # 4) no live attempt and no retry pending -> the error is final
            if not rr.live() and backoff_until is None:
                if self.slo is not None:
                    self.slo.record_request(time.time() - rr.t0, ok=False)
                if last_err is not None:
                    raise last_err
                raise ReplicaUnavailable("request has no live attempts")
            # 5) hedge when the primary stalls past the p99-derived delay
            if (hedge_at is not None and not rr.hedged and now >= hedge_at
                    and len(rr.live()) == 1):
                rr.hedged = True
                with self._lock:
                    self.stats["hedges"] += 1
                    self._log("hedge", rr.live()[0][0].id,
                              f"after {now - rr.t0:.3f}s")
                self._m_hedges.inc()
                try:
                    self._dispatch(rr, leg="hedge")
                except (ReplicaUnavailable, DeadlineExceeded):
                    pass  # hedging is opportunistic, never fatal
            # 6) sleep until the next actionable moment
            wake = [rr.deadline]
            if hard_stop is not None:
                wake.append(hard_stop)
            if backoff_until is not None:
                wake.append(backoff_until)
            if hedge_at is not None and not rr.hedged:
                wake.append(hedge_at)
            rr._evt.clear()
            rr._evt.wait(max(0.0, min(wake) - time.time()))

    # -- quality / SLO / cost hooks (DESIGN.md §3.12) --------------------------

    def _observe_success(self, rr: RouterRequest, rep, lat: float,
                         ids) -> None:
        """Feed a served request into the SLO tracker, the shadow recall
        estimator, and (when traced) the cost log. Telemetry never kills a
        request: failures here are swallowed, not raised."""
        try:
            if self.slo is not None:
                self.slo.record_request(lat, ok=True)
            if self.quality is not None:
                self.quality.observe(
                    rr.seq, rr.payload, ids,
                    pipeline=self._pipeline_label(rr.kind),
                    leg="degraded" if rr.kind == "degraded" else "normal")
            if self.costlog is not None and rr.trace is not None:
                self.costlog.record(
                    rr.trace, self._describe_for(rr.kind),
                    replica=rep.id, degraded=(rr.kind == "degraded"),
                    retries=rr.retries, hedged=rr.hedged)
        except Exception:
            pass

    def _describe_for(self, kind: str):
        """The served plan's ``describe()`` for a request kind, resolved
        against the live epoch; None when no replica can answer."""
        try:
            q = (self.set.degraded_query if kind == "degraded"
                 else self.set.query)
            if q is None:
                return None
            idx = self.set.live_index()
            return idx.plan(q).describe()
        except Exception:
            return None

    def _pipeline_label(self, kind: str) -> str:
        label = self._pipelines.get(kind)
        if label is None:
            d = self._describe_for(kind)
            label = (d or {}).get("effective_pipeline") or "unknown"
            self._pipelines[kind] = label
        return label

    def _release(self, rr: RouterRequest) -> None:
        if rr._released:
            return
        rr._released = True
        if rr.trace is not None:
            # idempotent: the winner path already finished it with
            # outcome="ok"; error/deadline exits finish it here
            rr.trace.finish(outcome="error")
        with self._lock:
            self._inflight -= 1

    # -- health prober (background thread) ------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.cfg.probe_interval_s):
            try:
                self._probe_once()
            except Exception:
                pass  # the prober must survive anything a probe throws
            if self.slo is not None:
                try:
                    self.slo.maybe_evaluate()
                except Exception:
                    pass  # SLO evaluation must never kill the prober

    def _probe_once(self) -> None:
        """Half-open probing: for each ejected replica past its cooldown,
        restart it if dead (replaying the write log it missed), send one
        probe, readmit on success / re-eject with a doubled cooldown on
        failure. Called by the prober thread (and directly by tests)."""
        cfg = self.cfg
        now = time.time()
        for rep in self.set.replicas:
            with self._lock:
                h = self._health[rep.id]
                if h.state != "ejected":
                    continue
                cooldown = cfg.probe_cooldown_s * (
                    2 ** min(h.probe_attempts, 6))
                if now - h.ejected_at < cooldown:
                    continue
                h.state = "half_open"
                self._transition(rep.id, "ejected", "half_open", "half_open",
                                 f"probe #{h.probe_attempts + 1}")
            if not rep.alive:
                try:
                    self.set.restart(rep.id)
                    with self._lock:
                        self._log("restart", rep.id,
                                  f"replayed to seq={rep.applied_seq}")
                except Exception as e:  # noqa: BLE001 — restart failed
                    self._on_failure(rep.id, f"restart: {e}")
                    continue
            try:
                req = rep.submit(rep.probe_payload(),
                                 deadline_s=cfg.probe_timeout_s)
            except ReplicaDown:
                self._on_failure(rep.id, "down")
                continue
            if req.done(cfg.probe_timeout_s) and req.error is None:
                self._on_success(rep.id)
            else:
                req.cancel()
                err = req.error
                if isinstance(err, ReplicaCrashed):
                    self.set.kill(rep.id)
                self._on_failure(
                    rep.id,
                    type(err).__name__ if err is not None else "probe_timeout",
                )
