"""Online recall estimation by shadow sampling (counterpart of
``repro.obs.quality``; DESIGN.md §3.12).

The serving tier reports latency but is blind to the quality it delivers:
degraded scan-only answers, tombstone churn and int4/binary payloads all
silently move recall. :class:`RecallEstimator` measures it continuously,
on live traffic:

* **Deterministic 1-in-N sampling** — ``observe(seq, ...)`` picks exactly
  the requests with ``seq % every_n == 0``, the same seq-keyed scheme the
  tracer uses, so a replayed workload shadows the same queries.
* **Off the hot path** — a sampled query (payload + the ids the tier
  served) is copied onto a bounded queue; when the queue is full the
  sample is *dropped* (and counted), never blocking the serving thread.
  A single daemon worker re-answers each sample exactly: the reference
  point set comes from ``online.live_dataset`` — which reads the store's
  ``ExactSource`` payload when the dense copy has been released — and the
  exact answer from the ``baselines.exact`` brute-force k-NN over it.
  The reference set is uploaded once to the index's device and kept there
  until the live set changes, so a sample costs one ``ops.knn`` launch at
  one query (on the card: the fused CUDA k-NN kernel), not a copy of the
  whole live set.
* **Wilson intervals** — recall@k is k Bernoulli trials per sample
  (each true neighbour either was or was not in the served ids), so the
  estimate carries a 95% Wilson score interval. Published per
  ``(pipeline, leg)``: ``quality_recall_ratio`` (per-sample histogram),
  ``quality_recall_mean_ratio`` and the ``_wilson_lo/_wilson_hi`` bounds,
  plus shadow accounting (sampled/answered/dropped/errors/pending/lag).

The ``leg`` label separates degraded-mode serves from normal ones — a
wedged tier answering on the scan-only plan shows up as a recall dip on
the ``degraded`` leg, not just a latency blip.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import names as names_lib

# Linear buckets suit a [0, 1] ratio far better than the default
# microseconds-to-minutes log spacing.
RECALL_BUCKETS = tuple(round(i / 20, 2) for i in range(1, 21))


def wilson(successes: float, trials: float, z: float = 1.96
           ) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion.

    Unlike the normal approximation it behaves at p near 0/1 and small n
    (recall estimates live exactly there: p close to 1, tens of samples).
    Returns the trivial ``(0, 1)`` when there are no trials yet.
    """
    if trials <= 0:
        return (0.0, 1.0)
    p = successes / trials
    z2 = z * z
    denom = 1.0 + z2 / trials
    centre = (p + z2 / (2.0 * trials)) / denom
    half = z * math.sqrt(
        p * (1.0 - p) / trials + z2 / (4.0 * trials * trials)) / denom
    return (max(0.0, centre - half), min(1.0, centre + half))


def _resolve_index(source):
    """The live index behind ``source``: a bare index, an
    ``online.EpochHandle`` (``.current``), a ``serving.ReplicaSet``
    (``.live_index()``), or a zero-arg callable returning any of those."""
    if callable(source) and not hasattr(source, "current") \
            and not hasattr(source, "live_index"):
        source = source()
    if hasattr(source, "live_index"):
        source = source.live_index()
    if hasattr(source, "current"):
        source = source.current
    return source


class _LegStats:
    __slots__ = ("queries", "trials", "successes")

    def __init__(self):
        self.queries = 0
        self.trials = 0
        self.successes = 0


class RecallEstimator:
    """Shadow-sample served queries and estimate online recall@k.

    ``source`` names the live index (see :func:`_resolve_index`);
    ``every_n`` is the deterministic sampling rate (0 disables —
    ``observe`` becomes a cheap no-op); ``on_sample`` is an optional
    callback ``(recall, pipeline, leg)`` invoked from the worker thread
    for each answered sample (the router wires the SLO tracker's recall
    feed through it).
    """

    def __init__(self, source, *, every_n: int = 16,
                 queue_max: int = 512,
                 on_sample: Optional[Callable] = None):
        self.source = source
        self.every_n = int(every_n)
        self.on_sample = on_sample
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(queue_max)))
        self._lock = threading.Lock()
        self._stats: dict[tuple[str, str], _LegStats] = {}
        self._pending = 0
        self._ref_key = None
        self._ref = None  # (vectors [m, d] f32 on the index's device, ids)
        self._m_sampled = metrics_lib.counter(names_lib.QUALITY_SAMPLED)
        self._m_answered = metrics_lib.counter(names_lib.QUALITY_ANSWERED)
        self._m_dropped = metrics_lib.counter(names_lib.QUALITY_DROPPED)
        self._m_errors = metrics_lib.counter(names_lib.QUALITY_ERRORS)
        self._m_pending = metrics_lib.gauge(names_lib.QUALITY_PENDING)
        self._m_lag = metrics_lib.histogram(names_lib.QUALITY_LAG)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="recall-shadow")
        self._worker.start()

    # -- hot path --------------------------------------------------------------

    def should_sample(self, seq: int) -> bool:
        return self.every_n > 0 and seq % self.every_n == 0

    def observe(self, seq: int, payload, served_ids, *,
                pipeline: str = "", leg: str = "normal") -> bool:
        """Offer one served query. Returns True when it was enqueued for
        shadow re-answering. The payload and ids are copied (the caller's
        arrays may be reused); a full queue drops the sample."""
        if not self.should_sample(seq):
            return False
        self._m_sampled.inc()
        item = (
            np.array(payload, np.float32, copy=True),
            np.asarray(served_ids).reshape(-1).copy(),
            str(pipeline), str(leg), time.perf_counter(),
        )
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self._m_dropped.inc()
            return False
        with self._lock:
            self._pending += 1
            self._m_pending.set(self._pending)
        return True

    # -- worker ----------------------------------------------------------------

    def _reference(self):
        """The exact reference set ``(vectors, ids)``, cached until the
        live set changes (epoch swap, delta write, delete): the vectors as
        a tensor on the index's device, the ids on the host."""
        idx = _resolve_index(self.source)
        key = (id(idx), getattr(idx, "epoch", 0), idx.n_points)
        if key != self._ref_key:
            import torch

            from repro_torch.online import live_dataset

            self._ref = None  # free the old epoch's copy before the upload
            vecs, ids = live_dataset(idx)
            self._ref = (torch.from_numpy(vecs).to(idx.device), ids)
            self._ref_key = key
        return idx, self._ref

    def _answer(self, payload, served_ids, pipeline, leg, t_enq) -> None:
        import torch

        from repro_torch.baselines.exact import exact_knn

        k = int(served_ids.shape[0])
        idx, (ref_vecs, ref_ids) = self._reference()
        q = torch.from_numpy(payload[None]).to(ref_vecs.device)
        _, gt = exact_knn(q, ref_vecs, distance=idx.distance, k=k,
                          device=ref_vecs.device)
        gt_ids = set(int(x) for x in ref_ids[gt[0].cpu().numpy()])
        served = set(int(x) for x in served_ids if x >= 0)
        recall = len(served & gt_ids) / max(k, 1)
        with self._lock:
            st = self._stats.setdefault((pipeline, leg), _LegStats())
            st.queries += 1
            st.trials += k
            st.successes += len(served & gt_ids)
            successes, trials = st.successes, st.trials
        labels = dict(pipeline=pipeline, leg=leg)
        metrics_lib.histogram(names_lib.QUALITY_RECALL,
                              RECALL_BUCKETS, **labels).observe(recall)
        lo, hi = wilson(successes, trials)
        metrics_lib.gauge(names_lib.QUALITY_RECALL_MEAN,
                          **labels).set(successes / trials)
        metrics_lib.gauge(names_lib.QUALITY_RECALL_LO, **labels).set(lo)
        metrics_lib.gauge(names_lib.QUALITY_RECALL_HI, **labels).set(hi)
        self._m_lag.observe(time.perf_counter() - t_enq)
        self._m_answered.inc()
        if self.on_sample is not None:
            self.on_sample(recall, pipeline, leg)

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            try:
                self._answer(*item)
            except Exception:  # noqa: BLE001 — telemetry never kills serving
                self._m_errors.inc()
            finally:
                with self._lock:
                    self._pending -= 1
                    self._m_pending.set(self._pending)

    # -- read side -------------------------------------------------------------

    def estimate(self, *, pipeline: Optional[str] = None,
                 leg: Optional[str] = None) -> dict:
        """The aggregated estimate over every ``(pipeline, leg)`` matching
        the filters: ``{"queries", "trials", "successes", "recall",
        "wilson_lo", "wilson_hi"}`` (``recall`` is None with no samples).
        """
        queries = trials = successes = 0
        with self._lock:
            for (p, lg), st in self._stats.items():
                if pipeline is not None and p != pipeline:
                    continue
                if leg is not None and lg != leg:
                    continue
                queries += st.queries
                trials += st.trials
                successes += st.successes
        lo, hi = wilson(successes, trials)
        return dict(
            queries=queries, trials=trials, successes=successes,
            recall=(successes / trials if trials else None),
            wilson_lo=lo, wilson_hi=hi,
        )

    def legs(self) -> list[tuple[str, str]]:
        with self._lock:
            return sorted(self._stats)

    def reset_stats(self) -> None:
        """Drop the accumulated estimate (keep the worker running) — used
        between a calibration pass and the measured pass."""
        with self._lock:
            self._stats.clear()

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every enqueued sample has been answered (True) or
        the timeout passed (False)."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.005)
        with self._lock:
            return self._pending == 0

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout=timeout)
