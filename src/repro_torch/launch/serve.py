"""Serving entry point: PDASC ANN search behind the batching engine
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset dense_embed \
        --n 20000 --gl 256 --distance cosine --queries 512 --batch 64

Builds a PDASC index on ``--device`` (``cuda`` unless ``--device cpu``),
wraps its search plan in ``repro_torch.serving.BatchingEngine`` (fixed
batch, max-wait batching), fires synthetic query traffic at it, and
reports latency percentiles + recall against exact ground truth.

``--churn N`` interleaves N live writes (upserts + deletes through
``submit_upsert`` / ``submit_delete``) into the query stream — the online
substrate demo (DESIGN.md §3.7): writes apply between batches via an
``online.EpochHandle``, compaction swaps epochs under traffic, and the
final recall is measured against exact ground truth over the *post-churn*
live point set.

``--replicas N`` (N > 1) serves through the replicated fault-tolerant tier
instead (DESIGN.md §3.10): N replicas behind the retry/hedge/backoff
``Router``, writes fanned out through the shared write log. ``--faults``
takes a deterministic fault plan (``kind:rR@START+DURATION[:DELAY]``,
``;``-separated — e.g. ``"wedge:r1@20+8;error:r2@40+5"``) injected into the
replica batch handlers; the run reports caller-visible errors (expected:
zero), retries, hedges and the health event log alongside the latency
percentiles.

Quality & SLO observability (DESIGN.md §3.12): ``--shadow-sample N``
re-answers 1 served query in N exactly on a background worker and prints
the online recall estimate (with its Wilson interval) at exit;
``--cost-log PATH`` appends one JSONL cost record per traced request
(requires ``--trace-sample``); ``--slo-p99-ms`` / ``--slo-recall-floor``
attach an SLO tracker with multi-rate burn alerts (replicated path);
``--dash`` renders a live terminal dashboard while serving; and
``--trace-dump PATH`` writes the retained sampled traces as JSON at exit
(both serve paths — feed it to ``python -m repro_torch.obs.report``).

Remote payload tier: ``--mode two_stage --store remote`` keeps int8 codes on
the device and moves the exact payload into a simulated object store
(``--remote-latency-ms``, ``--remote-bandwidth-mbps``) behind a host LRU of
``--remote-cache-granules`` and ``--remote-prefetch-workers`` prefetch
threads.

Kernel knobs: ``--wpq/--qpb`` (the rank and scan kernels' warps a query and
queries a block) and ``--bq/--splits`` (the knn kernel's query tile and DB
splits), each 0 for the kernel's own heuristic, and ``--row-chunk`` go to
the search as one ``KernelConfig`` (the port's counterparts of ``repro``'s
``--bm/--bn/--bd/--bq``; see ``kernels/ops.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.baselines.exact import exact_knn
from repro_torch.core.index import PDASCIndex
from repro_torch.data import make_dataset
from repro_torch.kernels.ops import KernelConfig
from repro_torch.online import EpochHandle, live_dataset
from repro_torch.query import Query
from repro_torch.serving import BatchingEngine, QueryHandler

# a build slab holds [slab, gl, gl] distances: about 2^26 of them (1,024
# groups at gl 256). The index does not depend on the slab; larger slabs
# launch fewer, larger kernels.
_SLAB_ENTRIES = 1 << 26


def _parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--dataset", default="dense_embed")
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--gl", type=int, default=256)
    p.add_argument("--distance", default="euclidean")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=4.0)
    p.add_argument("--radius-quantile", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the index lives and the search runs "
                        "(cuda, or cpu for the plain PyTorch versions)")
    p.add_argument("--mode", default="beam",
                   choices=["beam", "dense", "beam_vmap", "two_stage"])
    p.add_argument("--beam", type=int, default=32)
    # Storage substrate (DESIGN.md §3.6): mode=two_stage serves from the
    # tiered leaf store — quantised payload resident, exact fp32 out of core
    # (memmapped at --store-path if given), dense leaf array released.
    p.add_argument("--store", default="int8",
                   choices=["int8", "fp16", "remote"],
                   help="payload tier: int8/fp16 quantised resident codes "
                        "with a host/memmap exact tier, or 'remote' — int8 "
                        "codes with the exact tier in a simulated object "
                        "store (DESIGN.md §3.13)")
    p.add_argument("--store-block", type=int, default=1024)
    p.add_argument("--store-path", default=None)
    # Remote payload tier: the simulated object store's performance
    # envelope and the host cache in front of it.
    p.add_argument("--remote-latency-ms", type=float, default=0.0,
                   help="simulated object store per-op latency "
                        "(--store remote)")
    p.add_argument("--remote-bandwidth-mbps", type=float, default=None,
                   help="simulated object store transfer bandwidth "
                        "(--store remote; default: unlimited)")
    p.add_argument("--remote-cache-granules", type=int, default=256,
                   help="host LRU capacity in front of the remote tier "
                        "(--store remote)")
    p.add_argument("--remote-prefetch-workers", type=int, default=2,
                   help="async prefetch pool size (--store remote)")
    p.add_argument("--rerank-width", type=int, default=128)
    # Online substrate (DESIGN.md §3.7): interleave live writes with search
    # traffic; the EpochHandle compacts + swaps epochs between batches.
    p.add_argument("--churn", type=int, default=0,
                   help="number of upsert/delete writes interleaved into "
                        "the query stream (0 = frozen index)")
    p.add_argument("--churn-delete-frac", type=float, default=0.3)
    p.add_argument("--delta-capacity", type=int, default=1024)
    p.add_argument("--compact-delta-fill", type=float, default=0.5)
    p.add_argument("--compact-tombstone-ratio", type=float, default=0.2)
    # Replicated serving tier (DESIGN.md §3.10).
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through N replicas behind the fault-tolerant "
                        "router (1 = the single-engine path)")
    p.add_argument("--faults", default=None,
                   help="deterministic fault plan, e.g. "
                        "'wedge:r1@20+8;error:r2@40+5' "
                        "(kind:rR@START+DURATION[:DELAY_S], kinds: "
                        "latency/error/wedge/crash; windows in per-replica "
                        "handler dispatches)")
    p.add_argument("--deadline-ms", type=float, default=2000.0,
                   help="router per-request deadline (replicated path)")
    # Telemetry (DESIGN.md §3.11).
    p.add_argument("--metrics-dump", default=None, metavar="PATH",
                   help="periodically dump the repro_torch.obs metrics snapshot "
                        "to PATH ('-' = stdout at exit; .prom extension = "
                        "Prometheus text, anything else JSON)")
    p.add_argument("--trace-sample", type=int, default=0, metavar="N",
                   help="trace 1 request in N (deterministic by request "
                        "seq; 0 = off) and print the slowest sampled "
                        "trace as a text flamegraph at exit")
    p.add_argument("--trace-dump", default=None, metavar="PATH",
                   help="write every retained sampled trace as JSON to "
                        "PATH at exit (needs --trace-sample; readable by "
                        "python -m repro_torch.obs.report --trace PATH)")
    # Quality & SLO observability (DESIGN.md §3.12).
    p.add_argument("--shadow-sample", type=int, default=0, metavar="N",
                   help="shadow-sample 1 served query in N and re-answer "
                        "it exactly off the hot path; prints the online "
                        "recall estimate with its Wilson interval at exit "
                        "(0 = off)")
    p.add_argument("--cost-log", default=None, metavar="PATH",
                   help="append one JSONL plan-cost record per traced "
                        "request to PATH (needs --trace-sample)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="SLO latency target: at most 1%% of requests may "
                        "take longer (replicated path)")
    p.add_argument("--slo-recall-floor", type=float, default=None,
                   help="SLO recall floor for shadow-sampled estimates "
                        "(needs --shadow-sample; replicated path)")
    p.add_argument("--slo-window-s", type=float, default=30.0,
                   help="SLO rolling-window length in seconds")
    p.add_argument("--dash", action="store_true",
                   help="render a live terminal dashboard (QPS, latency, "
                        "recall estimate, SLO budget, replica health) "
                        "while serving")
    # The kernel layer's knobs (forwarded as a KernelConfig to the search;
    # 0 = the kernel's heuristic for the call's shape).
    kd = KernelConfig()
    p.add_argument("--wpq", type=int, default=kd.wpq,
                   help="rank / scan kernels: warps a query (0 = heuristic)")
    p.add_argument("--qpb", type=int, default=kd.qpb,
                   help="rank / scan kernels: queries a block "
                        "(0 = heuristic)")
    p.add_argument("--bq", type=int, default=kd.bq,
                   help="knn kernel: queries a block, 16/32/64/128 "
                        "(0 = heuristic)")
    p.add_argument("--splits", type=int, default=kd.splits,
                   help="knn kernel: DB splits (0 = heuristic)")
    p.add_argument("--row-chunk", type=int, default=kd.row_chunk)
    return p.parse_args(argv)


def _serve_replicated(args, idx, kernel, train, test):
    """The --replicas path: N replicas behind the fault-tolerant router."""
    from repro_torch.query import degraded
    from repro_torch.serving import FaultPlan, ReplicaSet, Router, RouterConfig

    query = Query(k=args.k, execution=args.mode, beam=args.beam,
                  rerank_width=args.rerank_width, with_stats=False,
                  kernel=kernel)
    plan = FaultPlan.parse(args.faults) if args.faults else None
    replica_set = ReplicaSet(
        idx, query, n_replicas=args.replicas, batch_size=args.batch,
        max_wait_ms=args.max_wait_ms, degraded_query=degraded(query),
        fault_plan=plan, delta_capacity=args.delta_capacity,
        epoch_kwargs=dict(delta_fill=args.compact_delta_fill,
                          tombstone_ratio=args.compact_tombstone_ratio),
    )
    slo = None
    if args.slo_p99_ms is not None or args.slo_recall_floor is not None:
        slo = obs.SLOTracker(obs.SLOSpec(
            latency_p99_s=(args.slo_p99_ms / 1e3
                           if args.slo_p99_ms is not None else None),
            recall_floor=args.slo_recall_floor,
            window_s=args.slo_window_s,
        ))
    costlog = obs.CostLog(args.cost_log) if args.cost_log else None
    router = Router(replica_set, RouterConfig(
        deadline_s=args.deadline_ms / 1e3, seed=args.seed,
        trace_every=args.trace_sample, shadow_every=args.shadow_sample),
        slo=slo, costlog=costlog)
    print(f"[serve] replicated tier: {args.replicas} replicas"
          + (f", faults={args.faults}" if plan else ", fault-free"))
    dash = None
    try:
        # warm-up: the kernels build on first use, so it is not held to
        # the request deadline
        t0 = time.time()
        router.search(test[0], deadline_s=600.0)
        print(f"[serve] warm-up search {time.time() - t0:.3f}s")
        if args.dash:
            dash = obs.Dashboard(quality=router.quality, slo=slo,
                                 router=router)
        lat, errors, retries, hedges, degraded_n = _drive_replicated(
            args, router, replica_set, train, test)
        est = None
        if router.quality is not None:
            router.quality.drain()
            est = router.quality.estimate()
        if slo is not None:
            slo.evaluate()
    finally:
        if dash is not None:
            dash.close()
        router.close(close_replicas=True)
    if args.trace_dump:
        with open(args.trace_dump, "w") as f:
            f.write(router.traces.to_json(indent=1))
        print(f"[serve] wrote {len(router.traces)} traces "
              f"to {args.trace_dump}")

    lat_ms = np.array(lat) * 1e3
    counts = router.event_counts()
    print(f"[serve] {args.queries} queries over {args.replicas} replicas: "
          f"errors={errors} p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p99={np.percentile(lat_ms, 99):.1f}ms "
          f"retries={retries} hedges={hedges} degraded={degraded_n}")
    print(f"[serve] health events: {counts or '{}'}")
    if est is not None:
        rec = est["recall"]
        print(f"[serve] online recall estimate: "
              + (f"{rec:.3f} [{est['wilson_lo']:.3f}, "
                 f"{est['wilson_hi']:.3f}] over {est['queries']} shadow "
                 f"samples" if rec is not None else "no samples answered"))
    if slo is not None:
        print(f"[serve] SLO status: {slo.status()}")
        for ev in slo.events():
            print(f"[serve]   slo event: {ev}")
    if costlog is not None:
        costlog.close()
        print(f"[serve] wrote {len(costlog)} cost records "
              f"to {args.cost_log}")
    if args.trace_sample:
        ex = router.traces.exemplar()
        if ex is not None:
            print(f"[serve] slowest sampled trace "
                  f"({len(router.traces)} retained):")
            print(ex.render())


def _drive_replicated(args, router, replica_set, train, test):
    """The replicated path's query stream, with ``--churn`` writes fanned
    out through the replica set; caller-visible errors are counted."""
    rng = np.random.default_rng(args.seed)
    q_rows = rng.integers(0, len(test), args.queries)
    write_every = (args.queries // args.churn) if args.churn else 0
    upserted: list[int] = []
    lat, errors, retries, hedges, degraded_n = [], 0, 0, 0, 0
    for j, i in enumerate(q_rows):
        if write_every and j % write_every == 0 and j // write_every < \
                args.churn:
            if upserted and rng.random() < args.churn_delete_frac:
                replica_set.delete(
                    np.array([upserted.pop(rng.integers(len(upserted)))]))
            else:
                vec = train[rng.integers(len(train))] + rng.normal(
                    0, 0.01, train.shape[1]).astype(np.float32)
                upserted.extend(int(x) for x in replica_set.upsert(vec))
        t0 = time.time()
        try:
            res = router.search(test[i])
        except Exception as e:  # noqa: BLE001 — counted, run continues
            errors += 1
            print(f"[serve] query {j} failed: {type(e).__name__}: {e}")
            continue
        lat.append(time.time() - t0)
        retries += res.retries
        hedges += int(res.hedged)
        degraded_n += int(res.degraded)
    return lat, errors, retries, hedges, degraded_n


def main(argv=None):
    args = _parse(argv)
    # Periodic metrics dumper (DESIGN.md §3.11): rewrites PATH whole every
    # few seconds while serving; closed (with a final snapshot) at exit.
    dumper = None
    if args.metrics_dump:
        dumper = obs.MetricsDumper(obs.registry(), args.metrics_dump,
                                   period_s=5.0)
    data = make_dataset(args.dataset, n=args.n, seed=args.seed)
    n_train = int(args.n * 0.95)
    train, test = data[:n_train], data[n_train:]
    print(f"[serve] building PDASC index on {train.shape} "
          f"({args.distance}, gl={args.gl})", flush=True)
    try:
        idx = _build(args, train)
        kernel = KernelConfig(wpq=args.wpq, qpb=args.qpb, bq=args.bq,
                              splits=args.splits, row_chunk=args.row_chunk)
        if args.replicas > 1:
            _serve_replicated(args, idx, kernel, train, test)
        else:
            _serve_single(args, idx, kernel, train, test)
    finally:
        if dumper is not None:
            dumper.close()


def _build(args, train):
    t0 = time.time()
    store_kw = {}
    remote = args.mode == "two_stage" and args.store == "remote"
    if args.mode == "two_stage":
        # --store remote keeps int8 codes resident; the exact tier moves to
        # the object store after the build (make_remote below)
        store_kw = dict(store="int8" if remote else args.store,
                        store_block=args.store_block,
                        store_path=None if remote else args.store_path)
    idx = PDASCIndex.build(train, gl=args.gl, distance=args.distance,
                           radius_quantile=args.radius_quantile,
                           group_chunk=max(1, _SLAB_ENTRIES // args.gl ** 2),
                           device=args.device, **store_kw)
    if remote:
        from repro_torch.store import SimulatedObjectStore, make_remote

        obj = SimulatedObjectStore(latency_ms=args.remote_latency_ms,
                                   bandwidth_mbps=args.remote_bandwidth_mbps)
        make_remote(idx, obj, cache_granules=args.remote_cache_granules,
                    prefetch_workers=args.remote_prefetch_workers)
        print(f"[serve] remote exact tier: {obj.total_bytes} bytes in "
              f"object store, latency={args.remote_latency_ms}ms, "
              f"host cache={args.remote_cache_granules} granules")
    elif args.mode == "two_stage":
        idx.release_dense_payload()  # serve within the tiered memory budget
    print(f"[serve] built on {idx.device} in {time.time()-t0:.1f}s\n"
          f"{idx.describe()}")
    print(f"[serve] memory: {idx.memory_bytes()}")
    return idx


def granule_prefetch(source, *, batch: int, beam, kernel=None):
    """The engine's between-batch prefetch hook for a two-stage index
    (``source``: the index or its ``EpochHandle``): run the (cheap) beam
    descent for the queued queries and warm the granules of their
    candidate rows on the store's prefetch pool — a superset of the rows
    the next batch's rerank will fetch. Returns the pool's waitable
    handle, which the engine's prefetch thread waits on with a bound."""
    from repro_torch.core import nsa

    def prefetch_fn(payloads):
        cur = source.current if hasattr(source, "current") else source
        rows = np.stack(payloads[:batch])
        pad = batch - len(rows)
        if pad:  # padded to the engine's batch, the shapes its kernels see
            rows = np.concatenate([rows, np.repeat(rows[-1:], pad, 0)])
        ci, _ = nsa.descend_beam(
            cur.data, torch.from_numpy(rows).to(cur.device),
            dist=cur.distance, r=cur.default_radius, beam=beam,
            max_children=cur.max_children, kernel=kernel,
        )
        return cur.store.prefetch_rows_async(
            ci[:len(payloads)].cpu().numpy())

    return prefetch_fn


def _serve_single(args, idx, kernel, train, test):
    """The single-engine path (optionally churned by live writes)."""
    handle = None
    if args.churn > 0:
        idx.enable_mutations(delta_capacity=args.delta_capacity)
        handle = EpochHandle(
            idx, delta_fill=args.compact_delta_fill,
            tombstone_ratio=args.compact_tombstone_ratio,
        )

    # The declarative surface (DESIGN.md §3.8): the whole serving config is
    # one Query; the engine handler resolves the epoch snapshot per batch
    # and reuses the cached plan until the capability fingerprint changes.
    query = Query(k=args.k, execution=args.mode, beam=args.beam,
                  rerank_width=args.rerank_width, kernel=kernel)
    handler = QueryHandler(handle if handle is not None else idx, query)
    print(f"[serve] plan:\n{handler.plan().explain()}")

    prefetch_fn = None
    if args.mode == "two_stage" and idx.store.exact.wants_prefetch:
        prefetch_fn = granule_prefetch(handle if handle is not None else idx,
                                       batch=args.batch, beam=args.beam,
                                       kernel=kernel)

    engine = BatchingEngine(
        handler, batch_size=args.batch, max_wait_ms=args.max_wait_ms,
        pad_payload=np.zeros(train.shape[1], np.float32),
        prefetch_fn=prefetch_fn,
        write_handler=handle.apply_writes if handle is not None else None,
    )
    # Deterministic 1-in-N tracing on the single-engine path: the Trace is
    # created at submit time (there is no router in front), the engine
    # records queue/batch/execute spans under its root.
    sampler = obs.TraceSampler(args.trace_sample)
    # Shadow recall estimation + cost recording (DESIGN.md §3.12): no
    # router here, so the query loop feeds both directly from the query loop.
    est = None
    if args.shadow_sample:
        est = obs.RecallEstimator(handle if handle is not None else idx,
                                  every_n=args.shadow_sample)
    try:
        _drive_single(args, idx, handle, handler, engine, sampler, est,
                      train, test)
    finally:
        if est is not None:
            est.close()


def _drive_single(args, idx, handle, handler, engine, sampler, est, train,
                  test):
    """The single-engine path's query stream (with ``--churn`` writes
    through the engine), then recall against exact ground truth."""
    costlog = obs.CostLog(args.cost_log) if args.cost_log else None
    dash = obs.Dashboard(quality=est) if args.dash else None
    rng = np.random.default_rng(args.seed)
    q_rows = rng.integers(0, len(test), args.queries)
    # writes interleave only with the head of the stream: the tail quarter
    # is scored against the final live set, so it must see no further
    # mutations (and at most one write per head query slot)
    tail = max(args.queries // 4, 1)
    head = args.queries - tail
    churn = min(args.churn, head)
    if churn < args.churn:
        print(f"[serve] clamping --churn {args.churn} -> {churn} "
              f"(one write per query slot ahead of the scored tail)")
    write_every = (head // churn) if churn else 0
    upserted_ids: list[int] = []
    lat, results = [], []
    try:
        # warm-up: the kernels build on first use
        t0 = time.time()
        engine.submit(test[0]).wait(timeout=600)
        print(f"[serve] warm-up search {time.time() - t0:.3f}s")
        for j, i in enumerate(q_rows):
            if (write_every and j < head and j % write_every == 0
                    and j // write_every < churn):
                # interleave one write: mostly upserts (train-like vectors),
                # a fraction deletes of previously upserted ids
                if upserted_ids and rng.random() < args.churn_delete_frac:
                    victim = upserted_ids.pop(
                        rng.integers(len(upserted_ids)))
                    # wait like the upsert path does: a dropped write error
                    # here would silently leave the victim live while still
                    # counting in the writes stat
                    engine.submit_delete(np.array([victim])).wait(timeout=60)
                else:
                    vec = train[rng.integers(len(train))] + rng.normal(
                        0, 0.01, train.shape[1]).astype(np.float32)
                    req_w = engine.submit_upsert(vec)
                    upserted_ids.extend(
                        int(x) for x in req_w.wait(timeout=60))
            tr = sampler.sample("request", j, kind="search")
            t0 = time.time()
            req = engine.submit(test[i], span=tr.root if tr else None)
            _, ids = req.wait(timeout=60)
            lat.append(time.time() - t0)
            results.append(ids)
            if est is not None and est.should_sample(j):
                est.observe(
                    j, test[i], ids,
                    pipeline=handler.describe()["effective_pipeline"])
            if tr is not None:
                tr.finish(outcome="ok")
                if costlog is not None:
                    costlog.record(tr, handler.describe())
    finally:
        engine.close()
        if dash is not None:
            dash.close()
    # recall vs exact — over the *live* post-churn point set when churning
    if handle is not None:
        base_vecs, base_ids = live_dataset(handle.current)
    else:
        base_vecs, base_ids = train, np.arange(len(train))
    _, gt = exact_knn(test[q_rows], base_vecs, distance=args.distance,
                      k=args.k, device=idx.device)
    gt = base_ids[gt.cpu().numpy()]
    lat = np.array(lat) * 1e3
    if handle is not None:
        # churned stream: score recall on the tail queries — all writes were
        # scheduled ahead of the tail, so these really were served against
        # the final live set the ground truth was computed over
        pairs = list(zip(results[-tail:], gt[-tail:]))
    else:
        pairs = list(zip(results, gt))
    rec = np.mean([
        len(set(r[r >= 0]) & set(g)) / args.k for r, g in pairs
    ])
    line = (f"[serve] {args.queries} queries: recall@{args.k}={rec:.3f} "
            f"p50={np.percentile(lat, 50):.1f}ms "
            f"p99={np.percentile(lat, 99):.1f}ms "
            f"mean_batch_occupancy={engine.mean_occupancy:.2f}")
    if handle is not None:
        line += (f" writes={engine.stats['writes']} "
                 f"epoch_swaps={handle.swaps} "
                 f"epoch={handle.current.epoch}")
    print(line)
    if est is not None:
        est.drain()
        e = est.estimate()
        print(f"[serve] online recall estimate: "
              + (f"{e['recall']:.3f} [{e['wilson_lo']:.3f}, "
                 f"{e['wilson_hi']:.3f}] over {e['queries']} shadow "
                 f"samples" if e["recall"] is not None
                 else "no samples answered"))
    if costlog is not None:
        costlog.close()
        print(f"[serve] wrote {len(costlog)} cost records "
              f"to {args.cost_log}")
    if args.trace_sample:
        ex = sampler.buffer.exemplar()
        if ex is not None:
            print(f"[serve] slowest sampled trace "
                  f"({len(sampler.buffer)} retained):")
            print(ex.render())
    if args.trace_dump:
        with open(args.trace_dump, "w") as f:
            f.write(sampler.buffer.to_json(indent=1))
        print(f"[serve] wrote {len(sampler.buffer)} traces "
              f"to {args.trace_dump}")


if __name__ == "__main__":
    main()
