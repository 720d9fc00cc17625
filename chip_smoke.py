#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PDASC (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Build the five CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together); print the build seconds and the
   card's name and power limit.
2. Kernel parity: each kernel against its plain PyTorch version on the
   card, over every form, shapes that are not multiples of any tile,
   masked rows and ``k = w``. pairwise at G = 1, 3 and a 1024-group slab
   whose last group is part padding, m and n of 1, 37, 129 and 300, d = 1,
   3, 13, 100 and 1536, X the same tensor as Y and not, and on integer
   data bit for bit (sqeuclidean); rank at w = 1, 31, 33, 384 and 4096
   with k = 1, 10 and w, d = 3, 100 and 1536, one table row in two slots
   (lower slot first); knn at d = 3 and 100, q = 1 and 129, k = 1024, on a
   DB of copied rows (lower ids first among copies), on near-duplicate rows
   at the largest d its wgmma route admits (~1,224, where it accumulates
   longest), and on its streaming route (d = 1536 and 4096 in every form,
   k = 33, 100 and 1024, and the largest k it admits, its states in device
   memory, at d = 100 and 1536); swap_deltas also at g = 300, k = 1 and
   with every row of one slot masked, and past g = 1,456 at (g, k) =
   (1,457, 728), (2,048, 1,024) and (4,096, 2,048) (its slot-split
   layout); pairwise also at [1024, 256, 100] x [1024, 128, 100] (X not
   Y: the k-means relabel); rank and scan at k = 1 through the ops with a
   ``slot_valid`` mask that kills every slot of one query (the online
   routing); the scan kernel over every form x
   {int8, fp16, int4, binary}, ragged shapes, w = 1, a ``slot_valid``
   mask, and d = 3, 13, 100 and 101 at w = 384 with k = 1, 10, 128 and
   w, a row with fewer unmasked slots than k and one table row in two
   slots (lower slot first). Every kernel's repeat call must be
   bit-identical.
   Then the card's build against the port's CPU build: integer-valued
   dense_embed-shaped data (n = 20,000, d = 100, values in [0, 64)),
   gl = 256, euclidean, pam, no shuffle, equal level by level, and each
   level's fp64 sum of its points' distances to their medoids within rtol
   1e-6; a real-valued 50,000-row slice with level-0 TD within 1%.
3. The main path at a real size: ``dense_embed`` (a GloVe-100-sized
   surrogate), n = 1,000,000, d = 100, built with gl = 256, euclidean,
   ``method="pam"``; 1,000 held-out queries through
   ``idx.plan(Query(k=10))`` (beam 32); recall@10 against ``exact_knn`` on
   the card; the card's search held against the port's CPU search on the
   same index for 256 queries. Launch counts are zeroed just before and
   read just after; every kernel must have launched.
   Then the storage path on the same index: an int8 store (block 256,
   exact payload in a memmapped file), ``release_dense_payload()``, and
   ``idx.plan(Query(k=10))``, which must resolve to ``two_stage``; the
   1,000 queries through it with launch counts zeroed just before and
   read just after (scan and rank must launch), recall@10 held to the beam
   recall minus 0.01, the ∞ rerank width held bit-equal to the beam
   result, the card held against the port's CPU two-stage on 256 queries;
   payload bytes per vector; fp16, int4 and binary stores through
   ``search_two_stage``; a profile of one two-stage call.
4. Each kernel's device time (CUDA events around replays of a CUDA graph
   of its calls: no host gaps; rank and scan also without the graph,
   host gaps included) at the main path's shapes, beside its plain
   version and one PyTorch library call or composition that computes the
   same function (CUDA events around back-to-back calls), and its bound:
   the larger of bytes over 3.35 TB/s and operations over the peak of
   the fastest route the work can take at its precision (the H100 SXM's
   published peaks): 67 TFLOP/s fp32 on the CUDA cores, or for the Gram
   forms of knn and pairwise the lesser time of that and 3xTF32 on the
   tensor cores (495 TFLOP/s TF32 / 3). pairwise and knn also in l1
   (their CUDA-core routes), knn also on its streaming route at [1000,
   100,000, 1536, 10] and in l1 at [1000, 100,000, 3072, 10] (one plain
   and one library call there); rank also summed over one beam search's
   launches (from the profile). The scan kernel at the storage path's
   shapes in each of its four code formats.
   Then k-means and its users: ``method="kmeans"`` at n = 1M, gl = 256
   (the port's own ``check_index_invariants``, level TDs all 0, recall@10
   beside the pam build's); pam at gl = 2048 (k = 1024) on 200,000 rows
   (swap_deltas's split slots on the build path); IVF-Flat at 1M with
   n_cells = n // 256 and n_probe = 8 (build s, query s, recall@10).
   Then the online tiers on a copy of the 1M index (``from_arrays`` of
   its arrays): 2,048 upserts of resident rows + N(0, 0.05) noise in 16
   batches of 128, 256 replacements, 1,024 resident deletes and 256
   deletes of upserted ids through ``EpochHandle.apply_writes``;
   ``needs_compaction()`` true; 1,000 queries through
   ``plan(Query(k=10))`` with the delta leg and the tombstone mask: no
   deleted id, an upserted vector finds itself first, card == CPU on 256
   queries, recall@10 within 0.02 of a fresh build on the live set;
   ``compact(scope="affected")`` and ``"full"``: invariants, untouched
   groups bit-identical, the share of changed groups, the dense exact
   search equal to exact_knn over the live set as sets; writes/s, q/s
   under churn and frozen, both compaction times. After the store phase
   the same stream at 1/8 its size on the released int8 index: routing
   by the scan at k = 1, two-stage under the mask, an affected compaction
   whose ``LeafStore.rebuild`` writes a fresh file and keeps the
   unchanged blocks' codes (the share re-quantised printed). Launch
   counts are zeroed before each of these phases and read after it:
   every kernel of the phase's path must have launched.
   Serving and observability, between the online and store phases on the
   clean 1M index and its 1,000 queries, ``Query(k=10, beam=32)``:
   (a) ``serve-engine``: ``BatchingEngine`` (batch 32, max_wait 4 ms,
   ``launch/serve.py``'s defaults) over ``QueryHandler``; a closed loop of
   the 1,000 queries from 8 threads (q/s, p50, p99, mean occupancy), every
   answer bit-equal to its row of ``idx.plan(query)(test)``; 1,000
   open-loop Poisson arrivals at 0.6x the closed-loop rate (p50, p99,
   p999); the device busy share of ~1 s of that open loop. (b)
   ``serve-churn``: the engine with ``EpochHandle.apply_writes`` over a
   ``from_arrays`` copy (delta capacity 4,096, compaction at half): 4,096
   searches and 2,560 writes (upserts of resident rows + N(0, 0.01)
   noise, every fifth a delete of an id upserted earlier), more upserts
   if no swap tripped; an upserted vector searched right after its
   upsert comes back first; no deleted id is served after its delete; the
   tail quarter equals the final epoch's plan bit for bit; p99 with the
   swap stall and the swap's seconds. (c) ``serve-replicated``:
   ``bench_serve.py``'s tier (4 replicas, batch 8, max_wait 1 ms, its
   ``RouterConfig``) adding under 5% of the index's resident bytes; a
   fault-free run (600 open-loop requests at 0.6x the closed-loop
   saturation, tracing 1 in 4, shadow recall 1 in 16): 0 errors, answers
   on the full plan equal to the single plan's rows, the shadow estimate
   within 0.05 of the offline recall; each sampled query through the knn
   wrapper at b = 1 against the estimator's device reference (the live n,
   the worker's own launch shape) held to ``knn_ref``, and the estimate
   equal to the recall of the sampled requests against those answers and
   against the ground truth's rows (up to near-ties at the 10th place);
   the plan calls/s of 1, 2 and 4 threads; the p99 exemplar's span tree whole
   (children inside parents, self-times summing to the wall time); 64
   upserts and 16 deletes through the replica set (4 live sets equal),
   ``kill(3)`` + ``restart(3)`` (converges); then a fresh tier with
   ``wedge:r1@6+5:0.5``: 0 errors, ``eject`` and ``readmit``. (d)
   ``serve-replicated-swap``: the fault-free traffic goes on while
   batches of upserts carry all 4 replicas past half their delta: the
   window's errors, deadline misses, router events and p99 are printed;
   the replicas' live sets must converge, and answers after the swap
   equal their replica's new epoch. After the store phase, (e)
   ``serve-two-stage``: the engine over the released int8 index's
   two-stage plan with ``launch/serve.py``'s prefetch hook, 1,000
   requests, 1 in 4 traced (each trace holds descend, scan, rerank and
   granule_fetch), answers bit-equal to the plan's rows; the registry's
   snapshot (>= 25 series over >= 5 subsystems, engine, router, plan,
   store and online non-zero), its Prometheus text parsed, and ``python
   -m repro_torch.obs.report`` over it and the traces; throughput with
   the registry on and off, printed. Each of these windows zeroes the
   launch counts just before its work and requires its kernels after.
5. Recall against the record: dense_embed n = 7,800, gl = 256, euclidean,
   beam 32 must reach recall@10 >= 0.85.
6. The quickstart on the card: euclidean, manhattan, chebyshev and cosine
   with beam; haversine and jaccard with dense.
7. (f) The serve CLI as subprocesses: ``python -m
   repro_torch.launch.serve`` at n = 200,000 (256 queries) on the
   single-engine path (``--churn 64``) and the replicated one
   (``--replicas 3 --faults wedge:r1@20+8:0.4 --churn 12``), both with
   tracing, shadow recall and a metrics dump: exit 0, a recall line,
   ``errors=0`` on the replicated path.
8. (g) The distributed deployment: ``dense_embed`` n = 1,024,000 (+ the
   1,000 held-out queries, seed 0) written to ``.npy`` under ``build/``;
   4 rank processes on the one card (``launch.ranks.run_ranks``: ``gloo``
   through ``file://``, started after the kernels are built), mesh
   ``(4,)`` ``("data",)``; each rank reads its 256,000 rows, runs
   ``build_sharded`` (gl 256, euclidean, pam, group_chunk 1024) and the
   dense and beam-32 ``compile_sharded_plan`` plans twice (radius: a
   single build's on all rows); the butterfly and all-gather merges
   (bit-equal, and equal over both axes of a ``(2, 2)`` ``("data",
   "model")`` mesh on the same ranks); ``exact_knn_sharded``, held to one
   process's ``exact_knn`` on the full table as sets up to near-ties, and
   the recall of both plans against it; 1,280 deletes through
   ``route_writes`` + ``local_slot_valid`` (no deleted id returned); the
   sharded int8 payload scan (block 256) held to one process's
   ``ops.scan_quantized`` over a single index's replicated descent. Every
   rank's results are bit-identical; each rank zeroes its launch counts
   around each window (``dist-*`` in ``WINDOW_KERNELS``) and every window
   must launch its kernels in every rank; each rank's device busy share
   of one beam call (``torch.profiler``).
9. (h) The remote payload tier: ``bench_store.py --scenario remote``'s
   knobs at full width: the main path's 1,000,000 rows streamed in shards
   of 65,536 (the last 16,960) by ``PDASCIndex.build_streaming`` (gl 256,
   int8 block 256, kmeans, radius quantile 0.35) into a
   ``SimulatedObjectStore`` (0.2 ms a op, parallelism 8), served
   two-stage (beam 32, rerank 128, cache 64 granules) on the main path's
   1,000 queries; bench_store's bars: the remote tier holds the whole
   exact payload (every leaf slot), codes + scales + host cache <= 0.40 x
   the dense payload, recall within 0.02 of the same index served from
   memory; a v5 save through a ``LocalFSStore`` under ``build/`` and a
   load answer bit-equal; one error window of a fault plan surfaces as
   ``RemoteStoreError`` naming the injected fault, and then passes.
10. (i) The serve CLI with ``--mode two_stage --store remote`` at n =
   200,000 (128 queries) on both paths: exit 0, ``errors=0`` replicated.
11. (j) The launch-geometry autotuner, with its cache pointed at a fresh
   file under ``build/``: ``autotune.tune`` for every op at the main
   path's shapes (pairwise's build slab [1024, 256, 256, 100]; rank's
   leaf [1000, 384, 100, 10]; knn [1000, 1,000,000, 100, 10]; swap's
   sweep (g, k) = (256, 128) over 1,024 groups; the scan at [1000, 384,
   100, 128] in int8, float16, int4 and binary). Every candidate's output
   is held to the plain version before its time counts, and compared bit
   for bit with the heuristic's; per op the candidates, the heuristic's
   geometry and median ms and the winner's are printed with the card's
   name and power limit. A second ``tune`` must answer from the cache
   without timing anything. Then the 1M index is rebuilt with the swap
   winner's ``kb`` and searched with ``KernelConfig(auto=True)`` (plan and
   ``ops.knn``), launch counts in the ``autotune`` window: ids equal to the
   main path's up to near-ties where the swap winner is the heuristic's
   geometry, else recall within 0.01 of it; the auto plan equal to the
   default plan on the rebuilt index up to near-ties. The earlier phases
   keep ``KernelConfig()``.
12. (k) NN-Descent at bench_recall.py's setting: ``train[:4000]``,
   ``n_neighbors=15``, ``iters=5``; 200 held-out queries (of its 1,000)
   with ``n_seeds=24``, ``max_steps=40``: build s, us a query, recall@10
   against ``exact_knn``; the card's graph equal to the CPU's on integer
   data.
13. (l) The recsys family at full width (``config()`` of wide-deep,
   xdeepfm, din and autoint; weights from seeded CUDA generators): each
   at ``serve_p99`` (batch 512; no kernel of the port launches in the
   ``recsys-serve`` window), logits finite and the card equal to the
   port's CPU on 64 rows; ``retrieval_cand`` through ``retrieval_step``
   (one user against 1,000,000 x 64 candidates, k = 100: one launch of
   knn.cu's dot form an arch in the ``recsys-retrieval`` window), held to
   ``knn_ref``, its kernel ms by graph replay beside ``knn_ref`` and
   ``torch.topk(u @ C.T, 100)`` (the knn row's ``retrieval`` entry of the
   kernels line); ``python -m repro_torch.launch.train --arch wide-deep
   --batch 65536 --steps 5`` (loss finite, ms a step); din's ``--ckpt``
   restart at batch 65,536 under ``--deterministic`` (6 steps against 3
   and 3 resumed: every array of the last checkpoint bit-equal). The
   trainers' printed launch counts are the ``recsys-train`` window. (g)
   also runs ``retrieval_step`` over its 4 ranks (din user, each rank its
   250,000 candidate rows, the butterfly over "data"; ``dist-retrieval``),
   held to one process's answer and to ``knn_ref``.
14. (m) The transformer family (weights from CUDA generator seeds, bf16
   compute over fp32 masters). stablelm-1.6b ``config()`` at full width
   and depth: ``prefill_step`` at prefill_32k's 32,768 tokens (batch 1;
   one call after a 2,048-token warm-up: ms, peak memory, logits finite);
   a 4 x 2,048 prompt's cache copied into ``cache_shapes(cfg, 4, 32768)``
   (decode_32k's length) and 32 greedy ``decode_step``s (ms a step,
   tokens/s); under fp32, a 2 x 64 prompt's prefill logits and cache
   equal to 64 decode steps' (the rule); bf16 against fp32 on the same
   weights, relative L2 of the last logits <= 0.1; the card against the
   port's CPU on a 2-layer fp32 cut (hidden, prefill logits, one decode
   step, loss). deepseek-moe-16b ``config()`` at full width cut to 4
   layers: prefill 2 x 4,096 (C = 960; the dropped share of dispatched
   slots), 16 greedy decode steps, one ``loss_fn`` backward at 1 x 1,024
   (every gradient finite), the card against the CPU on a 2-layer fp32
   cut (hidden, logits, aux, loss); a profile (device busy share, top
   ops) of one stablelm decode step and one deepseek prefill. Then
   ``python -m repro_torch.launch.train
   --arch stablelm-1.6b --seq 4096 --batch 1 --steps 5`` (train_4k's
   sequence): loss finite, ms a step, peak memory. The windows
   ``lm-prefill``, ``lm-decode``, ``lm-train``, ``moe-prefill``,
   ``moe-decode`` and ``moe-train`` must count no launch of the port's
   kernels (the transformer is library calls).
15. (n) The GNN family: the EGNN at ``config()``'s width (4 layers,
   d_hidden 64; weights from CUDA generator seeds, data from numpy
   seeds). ``molecule``: 128 molecules of 30 atoms, each graph from
   ``knn_graph(method="exact", k=2)`` (60 edges, within the shape's 64;
   one knn launch a molecule in ``gnn-molecule-graph``); the card's
   ``graph_reg_loss`` equal to the CPU's on the same weights and batch;
   20 AdamW steps on a rotation-invariant target, the loss must fall.
   ``minibatch_lg``: 232,965 3-D points, ``knn_graph(method="exact",
   k=492)`` (114.6 M edges; one knn launch in ``gnn-graph``; the kernel's
   ids for 1,000 random rows held to the plain knn of those rows, its ms
   beside the bound and ``torch.topk(torch.cdist(...))`` over query blocks:
   the knn row's ``knn_graph`` entry), the self-edge mask and
   ``CSRGraph.from_edge_list`` timed; the PDASC route at k = 15 over
   every point (``gnn-pdasc``: pairwise and swap_deltas), its edge
   overlap with the exact graph's first 15 a row above 0.7; 3 AdamW
   steps through the egnn ``minibatch_lg`` cell (``launch/steps.py``, its
   32 subgraphs cut to 4, on a (1, 1) ``MeshShape``), each on 4 sampled
   subgraphs (fanouts (15, 10), 1,024 seeds; ``sample_subgraph`` gathers
   their features, coordinates and labels on the host) stacked as the
   cell's arguments and run as one disjoint graph, the loss the mean of
   the subgraphs' ``node_class_loss`` with remat (``gnn-train`` and
   ``gnn-molecule-train`` count no launch); the card's loss on one
   subgraph equal to the CPU's; two backward passes bit-compared with
   deterministic algorithms off and on (``index_add_``'s atomics); the
   second must be bit-equal.
16. (o) The cells (``launch/steps.py``) and the dry-run
   (``launch/dryrun.py``). All 42 cells on both production meshes
   ((16, 16) and (2, 16, 16) ``MeshShape``s) through ``run_cell`` on the
   meta device, in this process: one line a cell, every one ``ok``. Then
   on a ``gloo`` world of one (``HashStore``, a (1, 1) ``DeviceMesh``,
   destroyed at the end of the phase): pdasc ``build_1m`` through its cell
   at full width (``dense_embed`` 2^20 x 100, gl 1,024, pam, the config's
   knobs; pairwise and swap_deltas must launch in ``cells-build``; the
   index's invariants), its leaves' shapes equal to the dry-run's
   analytic ``search_1m`` arguments; ``search_1m`` in the ``base`` (dense)
   and ``opt-beam`` variants on 4,096 held-out queries, k = 10: each
   window's launches printed, two calls bit-equal, the answers equal to
   the port's one-process dense (or beam) search on the same index up to
   near-ties, recall@10 against ``exact_knn``; the build's seconds, the
   searches' ms (second call) and peak GB, each beside the dry-run's
   ``step_time_lower_bound_s`` of the same cell on a (1, 1)
   ``MeshShape``. wide-deep's ``retrieval_cand`` (1,000,448 padded
   candidates, knn launching once; the top-100 held to ``knn_ref`` up to
   near-ties), ``serve_p99`` and ``train_batch`` (two steps) through
   ``cell.step`` at full width on tensors made in the cells' argument
   shapes. The LM cells run on the meta device only ((m) drives the
   transformer). Then the script's whole time.

Tolerance rule (as in tests/test_torch_*.py): fp32 results agree within
rtol = 1e-5 and atol = 1e-5 * max(1, max|ref|); l2 distances are compared
squared (near-zero distances amplify the Gram form's cancellation error
through the square root); top-k ids agree except among entries whose
distances lie within that tolerance of each other. TF32 is off for every
matrix product (``allow_tf32 = False``, matmul precision "highest").

The last three lines are the kernels' JSON record (each kernel's
``launches`` on the main path, and under ``phase_launches`` its launches
in each phase's own run), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

N_MAIN = 1_000_000  # main-path points (GloVe-100 has 1.18M vectors)
N_QUERIES = 1000
GROUP_CHUNK = 1024  # groups per build slab (the result does not depend on it)
N_CPU_CHECK = 256
RECALL_FLOOR = 0.85  # repro on the CPU records 0.904 (BENCH_search.json)
# The card's rates, read from their one source, repro_torch.launch.mesh
# (the H100 SXM's spec sheet), by load_constants() once the checkout's src/
# is on the path: fp32 on the CUDA cores (PEAK_FP32), TF32 on the tensor
# cores (PEAK_TF32), the Gram forms' faster route of fp32 and 3xTF32 (three
# TF32 products per fp32 product; PEAK_GRAM), and the HBM rate (PEAK_BYTES).
PEAK_FP32 = PEAK_TF32 = PEAK_GRAM = PEAK_BYTES = None
BIG = 1e30
PHASE_LAUNCHES: dict = {}  # phase -> launch counts of its own run

KNN_CASES = [  # (q, n, d, k): ragged against every tile, q = 1 and 129
    (37, 1000, 13, 10), (16, 129, 100, 1), (3, 300, 5, 300), (70, 5000, 64, 32),
    (20, 1037, 3, 10), (45, 3001, 100, 16), (1, 2000, 100, 10),
    (129, 1500, 100, 10), (5, 3000, 100, 1024)]
KNN_STREAM_SHAPE = (1000, 100_000, 1536)  # timed: q, n, d (k = 10, l2)
KNN_STREAM_L1_SHAPE = (1000, 100_000, 3072)  # timed in l1 (fp32 cores)
KNN_STREAM_CASES = [  # (q, n, d, k): the streaming route (any d; k > 1024)
    (37, 3000, 1536, 10), (5, 2000, 4096, 10), (20, 3000, 1536, 1024),
    (130, 2600, 4096, 33), (150, 1900, 1536, 100), (7, 2100, 1541, 10)]
PAIRWISE_CASES = [  # (G, m, n, d, X is Y): ragged against the 128-row tile
    (1, 37, 91, 13, False), (3, 70, 65, 100, False), (1, 1, 129, 2, False),
    (2, 64, 64, 16, False), (1, 1, 37, 1, False), (3, 37, 129, 3, False),
    (1, 129, 300, 13, False), (3, 300, 1, 100, False), (1, 37, 129, 1536, False), (3, 129, 129, 100, True),
    (1, 300, 300, 1536, True), (3, 37, 37, 13, True), (1024, 256, 256, 100, True),
    (1024, 256, 128, 100, False)]  # the k-means relabel: groups x their medoids
PAIRWISE_INT_CASES = [  # (G, m, n, d, |x| <, X is Y): every sum below 2^24
    (3, 129, 300, 3, 2048, False), (2, 256, 256, 100, 64, True),
    (1, 37, 129, 1536, 64, False), (1, 300, 300, 1536, 64, True)]
RANK_CASES = [  # (b, w, d, k, n), then every RANK_WIDTHS x k in {1, 10, w}
    (5, 300, 37, 10, 500), (3, 17, 100, 17, 40), (4, 130, 8, 7, 1000),
    (9, 1, 3, 1, 5)]
RANK_WIDTHS = (1, 31, 33, 384, 4096)
RANK_DIMS = (3, 100, 1536)
SWAP_CASES = [  # (G, g, k): g = 300 is ragged against the 64-column tile;
    (3, 50, 7), (2, 256, 128), (1, 33, 1), (5, 100, 50), (2, 300, 64),
    (3, 300, 1),  # past g = 1,456: staged in chunks, then the slots split
    (2, 1457, 728), (1, 2048, 1024), (1, 4096, 2048)]
KERNELS = {
    "pairwise": ("src/repro_torch/csrc/pairwise.cu",
                 "src/repro/kernels/pairwise.py:168"),
    "rank": ("src/repro_torch/csrc/rank.cu", "src/repro/kernels/topk.py:283"),
    "knn": ("src/repro_torch/csrc/knn.cu", "src/repro/kernels/topk.py:132"),
    "swap_deltas": ("src/repro_torch/csrc/swap.cu",
                    "src/repro/kernels/kmedoids.py:113"),
    "scan": ("src/repro_torch/csrc/scan.cu",
             "src/repro/kernels/quantized.py:153"),
}
BEAM_PATH_KERNELS = ("pairwise", "rank", "knn", "swap_deltas")  # phase 3
STORE_PATH_KERNELS = ("scan", "rank")  # the two-stage call
# the new phases' windows: each zeroes the counts just before its own work
# and requires these kernels just after it
WINDOW_KERNELS = {
    "kmeans-build": ("pairwise",),  # Lloyd relabel of the snapped medoids
    "kmeans-search": ("rank",),  # beam 32 on the k-means index
    "kmeans-truth": ("knn",),  # exact_knn for its recall
    "pam-gl2048": ("pairwise", "swap_deltas"),  # the split slot blocks
    "ivf": ("pairwise",),  # IVF-Flat build and search
    "online-writes": ("rank",),  # routing: beam-1 descent, rank at k = 1
    "online-search": ("pairwise", "rank"),  # delta scan, masked leaf rank
    "online-truth": ("knn",),  # exact_knn over the live set
    "online-compact": ("pairwise", "swap_deltas"),  # both scopes
    "online-compacted": ("rank",),  # the compacted epochs' searches
    "store-churn-writes": ("rank", "scan"),  # routing through scan, k = 1
    "store-churn-search": ("pairwise", "rank", "scan"),  # two-stage + legs
    "store-churn-compact": ("pairwise", "swap_deltas"),  # + LeafStore.rebuild
    "serve-engine": ("pairwise", "rank"),  # the engine's beam batches
    "serve-churn": ("pairwise", "rank", "swap_deltas"),  # + its swap
    "serve-replicated": ("rank", "knn"),  # 4 replicas + the shadow worker
    "serve-replicated-swap": ("swap_deltas", "rank"),  # 4 compactions
    "serve-replicated-wedge": ("rank",),  # the wedged tier
    "serve-two-stage": ("scan", "rank"),  # the engine's two-stage batches
    # (g): every rank's own windows
    "dist-build": ("pairwise", "swap_deltas"),  # build_sharded
    "dist-search": ("pairwise", "rank"),  # the dense and beam plans
    "dist-truth": ("knn",),  # exact_knn_sharded
    "dist-deleted": ("rank",),  # the beam plan under slot_valid
    "dist-scan": ("scan",),  # scan_quantized_sharded
    "dist-retrieval": ("knn",),  # retrieval_step over the 4 ranks' blocks
    # (h)
    "remote-build": ("pairwise",),  # build_streaming's k-means relabels
    "remote-search": ("scan", "rank"),  # two-stage over the remote tier
    # (j): the tuned rebuild, its auto plan and the tuned exact k-NN
    "autotune": ("pairwise", "swap_deltas", "rank", "knn"),
    # (l): the recsys family; its gathers, einsums and MLPs are library
    # calls, its retrieval top-k is knn.cu's dot form
    "recsys-serve": (),  # the four serve_p99 forwards
    "recsys-retrieval": ("knn",),  # retrieval_step, 1M candidates each
    "recsys-train": (),  # the trainer subprocesses' own counts, summed
    # (m): the transformer family is library calls: these windows must
    # count no launch of the port's kernels
    "lm-prefill": (),  # stablelm-1.6b prefill at 32,768 tokens
    "lm-decode": (),  # its greedy decode over a 32,768-slot cache
    "lm-train": (),  # the launch.train subprocess's own counts
    "moe-prefill": (),  # deepseek-moe-16b prefill, 2 x 4,096
    "moe-decode": (),  # its greedy decode
    "moe-train": (),  # one loss_fn backward
    # (n): the GNN's graphs come from knn.cu (exact) or the PDASC index;
    # the EGNN itself is library calls
    "gnn-molecule-graph": ("knn",),  # knn_graph, one launch a molecule
    "gnn-molecule-train": (),  # 20 AdamW steps of graph_reg_loss
    "gnn-graph": ("knn",),  # knn_graph at k = 492 over 232,965 points
    "gnn-pdasc": ("pairwise", "swap_deltas"),  # the build + dense plan
    "gnn-train": (),  # node_class_loss steps on sampled subgraphs
    # (o): the cells (launch/steps.py) on a gloo world of one
    "cells-build": ("pairwise", "swap_deltas"),  # pdasc build_1m
    "cells-truth": ("knn",),  # exact_knn for the search's recall
    "cells-search-base": ("pairwise",),  # search_1m, dense: one a level
    "cells-search-opt-beam": ("pairwise", "rank"),  # search_1m, beam 32
    "cells-retrieval": ("knn",),  # wide-deep retrieval_cand
    "cells-serve": (),  # wide-deep serve_p99: library calls
    "cells-train": (),  # wide-deep train_batch: library calls
}
SYMBOLS = {  # each kernel's __global__ functions
    "pairwise": ("pairwise_kernel",), "rank": ("rank_kernel",),
    "knn": ("knn_kernel", "knn_stream_kernel", "knn_split_kernel", "knn_merge_kernel"),
    "swap_deltas": ("swap_order_kernel", "swap_kernel", "swap_finish_kernel"),
    "scan": ("scan_kernel",)}
KERNEL_SYMBOLS = tuple(s for syms in SYMBOLS.values() for s in syms)
STORE_BLOCK = 256  # bench_store.py's full-run block size
RERANK_WIDTH = 128  # Query's default rerank_width
SCAN_FORMATS = {"int8": "dense", "fp16": "dense", "int4": "int4",
                "binary": "binary"}
SCAN_CASES = [  # (b, w, d, k, n, block): ragged shapes, then SCAN_DIMS x k
    (5, 300, 37, 10, 500, 64), (3, 17, 13, 17, 40, 8),
    (4, 130, 100, 7, 1000, 256), (9, 1, 3, 1, 5, 2)]
SCAN_DIMS = (3, 13, 100, 101)  # odd d: a padded int4 nibble, part-filled bytes
SCAN_WIDTH = 384  # the two-stage path's leaf candidate width
N_BIG_GL = 200_000  # rows of the gl = 2048 build
IVF_PROBE = 8  # bench_recall.py: n_cells = n // 256, n_probe = 8
CHURN = dict(upserts=2048, batch=128, replace=256, delete=1024,
             delete_upserted=256)  # the online phase's write stream
SERVE_BATCH, SERVE_WAIT_MS = 32, 4.0  # launch/serve.py's defaults
SERVE_THREADS = 8  # closed-loop submitting threads
SERVE_OPEN = 1000  # open-loop arrivals of the engine phase
# rows of the profiled builds: the profiler's cost grows with the launches
# (a profiled 1M pam build took 30 s, one at 200,000 rows 20 s; an affected
# compaction of the 1M index 25 s), so the profiles cut depth
PROFILE_ROWS = dict(pam=50_000, kmeans=20_000)
SAVE_ROWS = 50_000  # the online phase's v3 save / load (was the 1M index)
OPEN_LOAD = 0.6  # open-loop rate over closed-loop saturation (bench_serve)
SERVE_CHURN = dict(searches=4096, writes=2560, delete_every=5, noise=0.01,
                   delta_capacity=4096, delta_fill=0.5)  # configs/pdasc.py
TIER = dict(replicas=4, batch=8, wait_ms=1.0, open=600, upserts=64,
            deletes=16)  # bench_serve.py's tier, its open-loop count
WEDGE = "wedge:r1@6+5:0.5"  # BENCH_serve.json's wedged row
TRACE_EVERY, SHADOW_EVERY = 4, 16
SWAP_UPSERT_BATCH = 128  # rows per upsert through the replica set
# the serving phases' compactions take the build's slab size, as the online
# phase's do (the default slab, 8 groups, makes over a hundred at 1M)
COMPACT_KW = dict(group_chunk=GROUP_CHUNK)
N_DIST = 1_024_000  # (g): 4 ranks x 256,000 rows = 1,000 whole groups each
DIST_RANKS = 4
DIST_DELETES = 1280
REMOTE = dict(shard_rows=65_536, latency_ms=0.2,
              cache_granules=64)  # (h): bench_store.py --scenario remote
TUNE_SWAP = (256, 128)  # (j): the build's sweep (g, k), 1,024 groups a slab
TUNE_CASES = [  # (j): (op, form, dtype, key shape) at the main path's shapes
    ("pairwise", "l2", "float32", (GROUP_CHUNK, 256, 256, 100)),  # build slab
    ("rank", "l2", "float32", (N_QUERIES, SCAN_WIDTH, 100, 10)),  # leaf rank
    ("knn", "l2", "float32", (N_QUERIES, N_MAIN, 100, 10)),  # exact_knn
    ("swap", "none", "float32", TUNE_SWAP),
] + [("scan", "l2", fmt, (N_QUERIES, SCAN_WIDTH, 100, RERANK_WIDTH))
     for fmt in ("int8", "float16", "int4", "binary")]  # the two-stage scan
TUNE_REPS = 5  # timed calls a candidate (median), after one warmup
TUNE_TURNS = 10  # (j): search calls of each plan, default and auto in turns
NND_TRAIN, NND_QUERIES = 4000, 200  # (k): bench_recall.py's train[:4000];
# 200 of its 1,000 queries (the script's time)
RECSYS_ARCHS = ("wide-deep", "xdeepfm", "din", "autoint")  # (l), full width
RECSYS_CPU_ROWS = 64  # serve rows the port's CPU forward checks
RECSYS_TRAIN = ("wide-deep", 5)  # (l): arch, steps at train_batch's batch
RECSYS_RESTART = ("din", 6)  # (l): arch, steps; interrupted at half
RETRIEVAL_ARCH = "din"  # (g): the user tower of the sharded retrieval
N_RETRIEVAL = 1_000_000  # RECSYS_SHAPES["retrieval_cand"]'s candidates
LM_ARCH = "stablelm-1.6b"  # (m): full width and depth
LM_PREFILL_BATCH = 1  # prefill_32k's batch 32 cut to 1 (its cache: 206 GB)
LM_WARMUP = 2048  # tokens of the prefill warm-up call
LM_DECODE = (4, 2048, 32)  # decode_32k's batch 128 cut to 4; prompt; steps
LM_CONSIST = (2, 64)  # fp32 prefill == decode: batch, prompt tokens
LM_CPU = (2, 16, 2)  # card == the port's CPU: batch, tokens, layers (fp32)
MOE_ARCH = "deepseek-moe-16b"  # (m): full width
MOE_LAYERS = 4  # depth 28 cut to 4 (the 28-layer fp32 master is 67.5 GB)
MOE_PREFILL = (2, 4096, 16)  # batch, prompt tokens, greedy decode steps
MOE_TRAIN = (1, 1024)  # one loss_fn backward: batch, tokens
LM_TRAIN = ["--arch", LM_ARCH, "--seq", "4096", "--batch", "1", "--steps",
            "5", "--seed", "0"]  # train_4k's seq; its batch 256 cut to 1
GNN_MOLECULE_K = 2  # (n): 30 atoms x 2 = 60 edges, within the shape's 64
GNN_MOLECULE_STEPS = 20
GNN_LG_K = 492  # 232,965 x 492 = 114,618,780 edges (the shape: 114,615,892)
GNN_CHECK_ROWS = 1000  # rows of the k = 492 graph held to the plain knn
GNN_PDASC_K = 15  # tests/test_models.py's route at minibatch_lg's fanout
GNN_SUBGRAPHS = 4  # subgraphs a step: n_subgraphs 32 cut to 4 (host sampling)
GNN_STEPS = 3
GNN_LIB_BLOCK = 4096  # query rows a torch.cdist + torch.topk block
CELLS_VARIANTS = ("base", "opt-beam")  # (o): the pdasc search variants run
GNN_OPT = dict(lr=1e-2, warmup_steps=0, total_steps=100, weight_decay=0.0,
               schedule="constant")  # AdamWConfig of (n)'s molecule steps


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# tolerance rule
# ---------------------------------------------------------------------------


def atol_of(ref: np.ndarray) -> float:
    real = np.abs(ref[np.isfinite(ref) & (np.abs(ref) < BIG / 2)])
    return 1e-5 * max(1.0, float(real.max()) if real.size else 1.0)


def values_agree(out, ref, *, squared: bool = False, atol=None) -> float:
    """Max abs error of ``out`` against ``ref``; raises outside the rule
    (``atol`` overrides the rule's, taken from ``ref`` itself)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    a, b = (out * out, ref * ref) if squared else (out, ref)
    tol = (atol_of(b) if atol is None else atol) + 1e-5 * np.abs(b)
    bad = np.abs(a - b) > tol
    require(not bad.any(), f"values disagree at {int(bad.sum())} entries; "
            f"max err {float(np.abs(a - b).max())}")
    return float(np.abs(out - ref).max()) if out.size else 0.0


def topk_agree(kd, ki, rd, ri, recomputed, *, squared: bool = False,
               atol=None) -> float:
    """Kernel top-k ``(kd, ki)`` against the plain ``(rd, ri)``; also the
    plain distance of each kernel id (``recomputed``) must equal ``kd``.
    ``squared`` and ``atol`` as in ``values_agree`` (near-tied ids are then
    judged on the squared values)."""
    kd, rd, recomputed = (np.asarray(x, np.float64) for x in (kd, rd, recomputed))
    ki, ri = np.asarray(ki), np.asarray(ri)
    real = rd < BIG / 2
    require(np.array_equal(real, kd < BIG / 2), "masked entries differ")
    err = values_agree(np.where(real, kd, 0), np.where(real, rd, 0),
                       squared=squared, atol=atol)
    values_agree(np.where(real, recomputed, 0), np.where(real, kd, 0),
                 squared=squared, atol=atol)
    if squared:
        rd = rd * rd
    atol = atol_of(rd) if atol is None else atol
    for b in range(rd.shape[0]):
        row = rd[b][real[b]]
        for p in np.nonzero((ki[b] != ri[b]) & real[b])[0]:
            tied = (np.abs(row - rd[b, p]) <= atol).sum() > 1
            require(tied or p == row.size - 1,
                    f"row {b} position {p}: id {ki[b, p]} vs {ri[b, p]} "
                    f"without a near-tie")
    return err


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Time of one call of ``fn`` on the card's clock: CUDA events around
    ``iters`` back-to-back calls after ``warmup``. Where the host takes
    longer to enqueue a call than the card to run it, this measures the
    host (``kernel_ms`` does not)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 10, replays: int = 3) -> float:
    """Device time of one call of a kernel wrapper ``fn``: ``iters`` calls
    captured in a CUDA graph, CUDA events around ``replays`` replays, so no
    host gap between launches is counted (the wrappers allocate with
    ``torch.empty`` and launch on the current stream: both capture)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def load_constants() -> None:
    """The card's rates from ``repro_torch.launch.mesh``."""
    global PEAK_FP32, PEAK_TF32, PEAK_GRAM, PEAK_BYTES
    from repro_torch.launch import mesh

    PEAK_FP32, PEAK_TF32 = mesh.PEAK_FLOPS_FP32, mesh.PEAK_FLOPS_TF32
    PEAK_GRAM = max(PEAK_FP32, mesh.PEAK_FLOPS_3XTF32)
    PEAK_BYTES = mesh.HBM_BW


def bound(flops: float, nbytes: float, peak: float = None
          ) -> tuple[float, str]:
    """Least time in ms, and what bounds it: operations over ``peak`` (the
    operation rate of the fastest route the work can take at its
    precision; fp32 on the CUDA cores by default) or bytes over the HBM
    rate."""
    peak = PEAK_FP32 if peak is None else peak
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([
        len(set(ids[i][ids[i] >= 0].tolist()) & set(gt[i].tolist())) / k
        for i in range(len(gt))
    ]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] nvcc sm_90a, {len(_build.KERNELS)} kernels: {secs:.3f} s")
    return secs


def _cuda(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


def phase_parity() -> dict:
    """Every kernel against its plain version on the card; returns the max
    error per kernel over the sweep."""
    import torch
    from repro_torch.kernels import kmedoids as kmk
    from repro_torch.kernels import ref, topk

    rng = np.random.default_rng(0)
    errs = {name: 0.0 for name in KERNELS}

    for form in ref.FORMS:
        errs["pairwise"] = max(errs["pairwise"], parity_pairwise(rng, form))
        errs["rank"] = max(errs["rank"], parity_rank(rng, form))

        for q, n, d, k in KNN_CASES:
            Q = _cuda(rng.normal(size=(q, d)).astype(np.float32))
            DB = _cuda(rng.normal(size=(n, d)).astype(np.float32))
            errs["knn"] = max(errs["knn"], parity_knn(Q, DB, k, form))
        # the streaming route: widths no query tile of the other route
        # holds (l1 and chebyshev keep theirs to d = 1536), k past 1024,
        # and the largest k it admits (its states in device memory), on
        # small DBs
        kmax = topk.knn_max_k()
        for q, n, d, k in KNN_STREAM_CASES + [(3, 12_000, 100, kmax),
                                              (2, kmax + 15, 1536, kmax)]:
            if form not in ref.VPU_FORMS or d > 2000 or k > 1024:
                require(topk.knn_geometry(q, n, d, k, form).route == "stream",
                        f"knn {form} [{q}, {n}, {d}, {k}] does not stream")
            Q = _cuda(rng.normal(size=(q, d)).astype(np.float32))
            DB = _cuda(rng.normal(size=(n, d)).astype(np.float32))
            errs["knn"] = max(errs["knn"], parity_knn(Q, DB, k, form))
        if form not in ref.VPU_FORMS:
            errs["knn"] = max(errs["knn"], parity_knn_near_duplicates(form))
        # duplicated rows: equal distances come back lower id first
        src = rng.integers(0, 40, size=777)
        base = rng.normal(size=(40, 100)).astype(np.float32)
        Q = _cuda(rng.normal(size=(33, 100)).astype(np.float32))
        DB = _cuda(base[src])
        errs["knn"] = max(errs["knn"], parity_knn(Q, DB, 50, form, src))

    errs["scan"] = parity_scan(rng)
    k1 = parity_masked_k1(rng)
    errs["rank"] = max(errs["rank"], k1["rank"])
    errs["scan"] = max(errs["scan"], k1["scan"])

    for G, g, k in SWAP_CASES:
        D = _cuda(np.abs(rng.normal(size=(G, g, g))).astype(np.float32))
        d1 = _cuda(np.abs(rng.normal(size=(G, g))).astype(np.float32))
        d2 = d1 + _cuda(np.abs(rng.normal(size=(G, g))).astype(np.float32))
        n1 = _cuda(rng.integers(0, k, size=(G, g)).astype(np.int32))
        valid = _cuda(rng.random((G, g)) > 0.2)
        if k > 1:  # every row of slot 1 dropped: its T row holds no term
            valid &= n1 != 1
        out = kmk.swap_deltas_cuda(D, d1, d2, n1, valid, k)
        want = ref.swap_deltas_ref(D, d1, d2, n1, valid, k)
        errs["swap_deltas"] = max(errs["swap_deltas"], values_agree(
            out.cpu().numpy(), want.cpu().numpy()))
        again = kmk.swap_deltas_cuda(D, d1, d2, n1, valid, k)
        require(bool(torch.equal(out, again)), "swap_deltas differs run to run")
    torch.cuda.synchronize()
    log(f"[parity] all kernels agree with their plain versions: "
        f"{json.dumps(errs)}")
    return errs


def parity_pairwise(rng, form) -> float:
    """The pairwise kernel against its plain version in one form: G = 1, 3
    and a 1024-group build slab whose last group is part padding (zero
    rows, as the build pads it); m and n of 1, 37, 129, 300; d = 1, 3, 13,
    100 and 1536; X the same tensor as Y (the mirrored tiles) and not; a
    repeat call that must be bit-identical; and integer-valued inputs
    (|x| < 2^11, every sum below 2^24), where sqeuclidean must equal the
    plain version bit for bit. Returns the max error."""
    import torch
    from repro_torch.kernels import pairwise as pw, ref

    err = 0.0
    for G, m, n, d, same in PAIRWISE_CASES:
        X = _cuda(rng.normal(size=(G, m, d)).astype(np.float32))
        if G == 1024:
            X[-1, 100:] = 0.0  # the last group: 100 points and padding
        Y = X if same else _cuda(rng.normal(size=(G, n, d)).astype(np.float32))
        out = pw.pairwise_cuda(X, Y, form)
        want = torch.cat([ref.pairwise_ref(X[i:i + 32], Y[i:i + 32], form)
                          for i in range(0, G, 32)])  # slabs bound the l1 cube
        err = max(err, values_agree(out.cpu().numpy(), want.cpu().numpy(),
                                    squared=form == "l2"))
        require(bool(torch.equal(out, pw.pairwise_cuda(X, Y, form))),
                f"pairwise {form} {(G, m, n, d)} differs run to run")
    if form == "sqeuclidean":
        for G, m, n, d, hi, same in PAIRWISE_INT_CASES:
            X = _cuda(rng.integers(-hi + 1, hi, size=(G, m, d)).astype(np.float32))
            Y = X if same else _cuda(
                rng.integers(-hi + 1, hi, size=(G, n, d)).astype(np.float32))
            require(bool(torch.equal(pw.pairwise_cuda(X, Y, form),
                                     ref.pairwise_ref(X, Y, form))),
                    f"pairwise on integers {(G, m, n, d)} is not bit-equal")
    return err


def parity_rank(rng, form) -> float:
    """The rank kernel against its plain version in one form: RANK_CASES,
    then w = 1, 31, 33, 384 and 4096 with k = 1, 10 and w, d = 3, 100 and
    1536; in each an all-masked row, one table row in two slots of a row
    (the lower slot first) and a repeat call that must be bit-identical.
    Returns the max error."""
    import torch
    from repro_torch.kernels import ref, topk

    err = 0.0
    grid = [(w, k) for w in RANK_WIDTHS for k in sorted({1, min(10, w), w})]
    cases = RANK_CASES + [(6, w, RANK_DIMS[i % len(RANK_DIMS)], k, max(2 * w, 50))
                          for i, (w, k) in enumerate(grid)]
    for b, w, d, k, n in cases:
        Q = _cuda(rng.normal(size=(b, d)).astype(np.float32))
        P = _cuda(rng.normal(size=(n, d)).astype(np.float32))
        sq = (P * P).sum(-1)
        idx = _cuda(rng.integers(0, n, size=(b, w)).astype(np.int32))
        ok = _cuda(rng.random((b, w)) > 0.3)
        ok[0] = False  # an all-masked row
        if w > 1:  # row 1: slots 0 and 1 hold one table row
            idx[1, 1] = idx[1, 0]
            ok[1, :2] = True
            idx[1, 2:] = (idx[1, 0] + 1 + torch.arange(w - 2, device="cuda")) % n
        kd, ks = topk.rank_cuda(Q, P, sq, idx, ok, k, form)
        rd, rs = ref.rank_gathered_ref(Q, P, sq, idx, ok, k, form)
        picked = torch.gather(idx, 1, ks.long())
        again = ref.rowwise_ref(Q, P[picked.long()], form, sq[picked.long()])
        require(bool(((ks >= 0) & (ks < w)).all()), "rank slots outside [0, w)")
        err = max(err, topk_agree(kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(),
                                  again.cpu()))
        kd2, ks2 = topk.rank_cuda(Q, P, sq, idx, ok, k, form)
        require(bool(torch.equal(kd, kd2) and torch.equal(ks, ks2)),
                f"rank {form} w={w} k={k} differs run to run")
        if w > 1:
            row = ks[1].tolist()
            require(1 not in row or (0 in row and row.index(0) < row.index(1)),
                    f"rank {form} w={w} k={k}: slot 1 before its twin slot 0")
    return err


def parity_knn(Q, DB, k, form, src=None) -> float:
    """The knn kernel against its plain version on one case, a repeat call
    that must be bit-identical and, where ``src`` says which DB rows are
    copies of one row (``DB = base[src]``), lower ids first among copies.
    Returns the max error."""
    import torch
    from repro_torch.kernels import ref, topk

    kd, ki = topk.knn_cuda(Q, DB, k, form)
    rd, ri = ref.knn_ref(Q, DB, k, form)
    again = torch.gather(ref.pairwise_ref(Q, DB, form), 1, ki.long())
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
    kd2, ki2 = topk.knn_cuda(Q, DB, k, form)
    require(bool(torch.equal(kd, kd2) and torch.equal(ki, ki2)),
            f"knn {form} {tuple(Q.shape)} x {tuple(DB.shape)} k={k} differs "
            f"run to run")
    if src is not None:
        ids = ki.cpu().numpy()
        for b in range(ids.shape[0]):
            got = set(ids[b].tolist())
            for i in ids[b]:
                lower = np.nonzero(src[:i] == src[i])[0]
                require(got.issuperset(lower.tolist()),
                        f"knn {form}: id {i} returned, a lower copy not")
    return err


def parity_knn_near_duplicates(form) -> float:
    """knn's wgmma route at the largest d it admits at k = 10 (~1,224),
    where it accumulates longest: a DB whose first 1,500 rows are copies of
    the 37 queries plus noise of 1e-3 |x|, so every top-k lies near zero.
    There fp32's Gram form cancels terms of size |x|^2, so the values are
    held (l2 squared) to the atol of the whole plain distance matrix, the
    scale pairwise's rule takes; a copy of each query comes first. Returns
    the max error."""
    import torch
    from repro_torch.kernels import ref, topk

    q, n, k = 37, 3000, 10
    d = max(d for d in range(1000, 1400)
            if topk.knn_geometry(q, n, d, k, form).route == "wgmma")
    require(d > 1200, f"the wgmma route stops at d = {d}")
    rng = np.random.default_rng(7)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    DB = rng.normal(size=(n, d)).astype(np.float32)
    u = rng.normal(size=(n // 2, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    src = Q[np.arange(n // 2) % q]
    DB[:n // 2] = src + 1e-3 * np.linalg.norm(src, axis=1, keepdims=True) * u
    Q, DB = _cuda(Q), _cuda(DB)
    full = ref.pairwise_ref(Q, DB, form).cpu().numpy()
    squared = form == "l2"
    atol = atol_of(full * full if squared else full)
    kd, ki = topk.knn_cuda(Q, DB, k, form)
    rd, ri = ref.knn_ref(Q, DB, k, form)
    again = torch.gather(ref.pairwise_ref(Q, DB, form), 1, ki.long())
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu(),
                     squared=squared, atol=atol)
    first = ki[:, 0].cpu().numpy()
    if form != "dot":  # dot ranks by -x.y, not by nearness
        require(bool((first < n // 2).all() and (first % q == np.arange(q)).all()),
                f"knn {form} near duplicates at d={d}: a copy is not first")
    kd2, ki2 = topk.knn_cuda(Q, DB, k, form)
    require(bool(torch.equal(kd, kd2) and torch.equal(ki, ki2)),
            f"knn {form} near duplicates at d={d} differ run to run")
    log(f"[parity] knn {form} near duplicates at d={d} (wgmma route): max "
        f"err {err:.3g} (atol {atol:.3g})")
    return err


def scan_rows(Q, codes, scales, block, idx, form, fmt):
    """The plain distance of every candidate ``idx [b, w]`` of a code
    table (what the scan kernel scores), for re-checking its picks."""
    from repro_torch.kernels import ref

    return ref.rowwise_ref(
        Q, ref.dequantize_rows(codes, scales, block, idx, fmt, Q.shape[1]),
        form)


def parity_scan(rng) -> float:
    """The scan kernel against its plain version: every form x code format
    over SCAN_CASES (ragged shapes, a slot_valid mask, k = w, w = 1), then
    d = 3, 13, 100 and 101 at the path's width w = 384 (~30% unmasked, as
    on the path) with k = 1, 10, 128 and w; in each an all-masked row, a
    row with 3 unmasked slots (fewer than k), one table row in two slots of
    a row (the lower slot first), and a repeat call that must be
    bit-identical. Returns the max error."""
    import torch
    from repro_torch.kernels import quantized, ref
    from repro_torch.store import quantize

    err = 0.0
    grid = [(6, SCAN_WIDTH, d, k, 2000, 256) for d in SCAN_DIMS
            for k in (1, 10, 128, SCAN_WIDTH)]
    for backend, fmt in SCAN_FORMATS.items():
        for b, w, d, k, n, block in SCAN_CASES + grid:
            codes, scales = quantize(
                _cuda(rng.normal(size=(n, d)).astype(np.float32)), backend,
                block)
            Q = _cuda(rng.normal(size=(b, d)).astype(np.float32))
            idx = _cuda(rng.integers(0, n, size=(b, w)).astype(np.int32))
            ok = _cuda(rng.random((b, w)) > (0.7 if w == SCAN_WIDTH else 0.3))
            ok[0] = False  # an all-masked row
            if d == 13 and w != SCAN_WIDTH:  # tombstoned table rows, folded as ops does
                live = _cuda(rng.random(n) > 0.3)
                ok = ref.fold_slot_valid(idx, ok, live)
            if w == SCAN_WIDTH:
                ok[1] = False  # row 1: three unmasked, slots 0 and 1 one row
                ok[1, [0, 1, 200]] = True
                idx[1, 1] = idx[1, 0]
            for form in ref.FORMS:
                kd, ks = quantized.scan_cuda(Q, codes, scales, block, idx,
                                             ok, k, form, fmt)
                rd, rs = ref.scan_gathered_ref(Q, codes, scales, block, idx,
                                               ok, k, form, fmt)
                again = torch.gather(
                    scan_rows(Q, codes, scales, block, idx, form, fmt), 1,
                    ks.long())
                require(bool(((ks >= 0) & (ks < w)).all()),
                        "scan slots outside [0, w)")
                err = max(err, topk_agree(kd.cpu(), ks.cpu(), rd.cpu(),
                                          rs.cpu(), again.cpu()))
                kd2, ks2 = quantized.scan_cuda(Q, codes, scales, block, idx,
                                               ok, k, form, fmt)
                require(bool(torch.equal(kd, kd2) and torch.equal(ks, ks2)),
                        f"scan {form}/{backend} d={d} k={k} differs run to run")
                if w == SCAN_WIDTH:
                    row = ks[1].tolist()
                    require(1 not in row or (0 in row and row.index(0) < row.index(1)),
                            f"scan {form}/{backend} d={d} k={k}: slot 1 before "
                            f"its twin slot 0")
    return err


def parity_masked_k1(rng) -> dict:
    """rank and scan at k = 1 (the online tiers' routing) through the ops
    with a ``slot_valid`` mask that kills every slot of query 0 and a
    fifth of the table, at the path's width w = 384, d = 100, every form:
    query 0 finds nothing (``BIG``), the rest agree with the plain
    versions on the folded mask, and repeat calls are bit-identical.
    Returns the max error per kernel."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.store import quantize

    b, w, d, n = 64, SCAN_WIDTH, 100, 5000
    P = _cuda(rng.normal(size=(n, d)).astype(np.float32))
    sq = (P * P).sum(-1)
    Q = _cuda(rng.normal(size=(b, d)).astype(np.float32))
    idx = _cuda(rng.integers(0, n, size=(b, w)).astype(np.int32))
    ok = _cuda(rng.random((b, w)) > 0.3)
    live = _cuda(rng.random(n) > 0.2)
    live[idx[0].long()] = False  # every slot of query 0 is dead
    folded = ref.fold_slot_valid(idx, ok, live)
    codes, scales = quantize(P, "int8", STORE_BLOCK)
    errs = {"rank": 0.0, "scan": 0.0}
    for form in ref.FORMS:
        runs = {
            "rank": (lambda: ops.rank_gathered(Q, P, sq, idx, ok, form, k=1,
                                               slot_valid=live),
                     ref.rank_gathered_ref(Q, P, sq, idx, folded, 1, form),
                     lambda s: ref.rowwise_ref(Q, P[s], form, sq[s])),
            "scan": (lambda: ops.scan_quantized(
                Q, codes, scales, idx, ok, form, k=1, block=STORE_BLOCK,
                slot_valid=live),
                ref.scan_gathered_ref(Q, codes, scales, STORE_BLOCK, idx,
                                      folded, 1, form),
                None)}
        for name, (kernel, (rd, rs), again_of) in runs.items():
            kd, ks = kernel()
            require(float(kd[0, 0]) >= BIG / 2,
                    f"{name} {form} k=1: a dead query found slot "
                    f"{int(ks[0, 0])}")
            if again_of is None:
                again = torch.gather(scan_rows(Q, codes, scales, STORE_BLOCK,
                                               idx, form, "dense"), 1,
                                     ks.long())
            else:
                again = again_of(torch.gather(idx, 1, ks.long()).long())
            errs[name] = max(errs[name], topk_agree(
                kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(), again.cpu()))
            kd2, ks2 = kernel()
            require(bool(torch.equal(kd, kd2) and torch.equal(ks, ks2)),
                    f"{name} {form} k=1 with slot_valid differs run to run")
    log(f"[parity] rank and scan at k=1, slot_valid killing query 0: "
        f"{json.dumps(errs)}")
    return errs


def level_sums(idx) -> list:
    """fp64 sums, on the index's own device, of each clustered level's
    per-point distances to its medoid (its parent): the level TDs of a
    k-medoids build, summed without fp32's order dependence."""
    sums = []
    for l in range(idx.n_levels - 1):
        lv, up = idx.data.levels[l], idx.data.levels[l + 1]
        par = lv.parent.long().clamp(0, up.points.shape[0] - 1)
        dd = idx.distance.point(lv.points, up.points[par])
        sums.append(float(dd[lv.valid].double().sum()))
    return sums


def phase_build_parity(data: np.ndarray) -> dict:
    """The card's build against the port's CPU build. Integer-valued
    dense_embed-shaped data (the first 20,000 rows scaled to integers in
    [0, 64): every Gram sum is exact in fp32, so both devices compute the
    same distances), gl = 256, euclidean, pam, no shuffle: the level sizes
    and every level's arrays (the medoids' slots, parents and children)
    must be equal, and each level's fp64 sum of its per-point distances to
    their medoids, taken on each build's device, within rtol 1e-6 (the
    builds' fp32 level TDs sum 20,000 terms in another order each, and are
    printed only). Then a real-valued 50,000-row slice of
    the main data: level-0 TD within 1% (rounding-level near-ties in
    k-medoids may go the other way). Also ``core.build_index`` called
    without a device must build on CUDA."""
    import torch
    from repro_torch.core.index import PDASCIndex

    x = data[:20_000]
    lo, hi = float(x.min()), float(x.max())
    xi = np.clip(np.round((x - lo) / (hi - lo) * 63), 0, 63).astype(np.float32)
    kw = dict(gl=256, distance="euclidean", method="pam", shuffle=False)
    t0 = time.perf_counter()
    card = PDASCIndex.build(xi, device="cuda", **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = PDASCIndex.build(xi, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    require(card.stats.level_sizes == cpu.stats.level_sizes,
            f"integer build: level sizes {card.stats.level_sizes} on the card, "
            f"{cpu.stats.level_sizes} on the CPU")
    for l, (a, b) in enumerate(zip(card.data.levels, cpu.data.levels)):
        for f in a._fields:
            require(bool(torch.equal(getattr(a, f).cpu(), getattr(b, f))),
                    f"integer build: level {l} {f} differs card vs CPU")
    require(bool(torch.equal(card.data.leaf_ids.cpu(), cpu.data.leaf_ids)),
            "integer build: leaf ids differ card vs CPU")
    card_sums, cpu_sums = level_sums(card), level_sums(cpu)
    np.testing.assert_allclose(card_sums, cpu_sums, rtol=1e-6)
    log(f"[build-parity] integer dense_embed n={len(xi)} gl=256 euclidean "
        f"pam: card == CPU level by level, levels {card.stats.level_sizes}, "
        f"fp64 level sums card {card_sums}, CPU {cpu_sums}; fp32 TDs card "
        f"{list(card.stats.level_td)}, CPU {list(cpu.stats.level_td)} (card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s)")

    # the build's core entry point without a device runs on the card
    from repro_torch.core import build_index

    index, _ = build_index(xi[:2000], gl=256, distance="euclidean")
    require(all(lv.points.is_cuda for lv in index.levels),
            "core.build_index without a device did not build on CUDA")
    log(f"[build-parity] core.build_index without a device: built on "
        f"{index.levels[0].points.device}")

    real = data[:50_000]
    kw = dict(gl=256, distance="euclidean", method="pam", radius_quantile=0.35)
    card = PDASCIndex.build(real, device="cuda", **kw)
    cpu = PDASCIndex.build(real, device="cpu", **kw)
    td_card, td_cpu = card.stats.level_td[0], cpu.stats.level_td[0]
    rel = abs(td_card - td_cpu) / td_cpu
    log(f"[build-parity] real-valued n={len(real)}: level-0 TD card "
        f"{td_card:.6f}, CPU {td_cpu:.6f} (rel {rel:.3g}, limit 0.01)")
    require(rel <= 0.01, f"level-0 TD differs by {rel:.3g} card vs CPU")
    return dict(int_card_s=card_s, int_cpu_s=cpu_s, real_td_rel=rel)


def phase_main_path(data: np.ndarray, test: np.ndarray) -> dict:
    """The port's main path at full size; returns what later phases need."""
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.kernels import ops
    from repro_torch.query import Query

    n = data.shape[0]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    idx = PDASCIndex.build(data, gl=256, distance="euclidean",
                           radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                           device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_mem = torch.cuda.max_memory_allocated()

    plan = idx.plan(Query(k=10))
    Qc = _cuda(test)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan(Qc)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, gt = exact_knn(Qc, data, k=10, device="cuda")
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    counts = ops.launch_counts()

    rec = recall(res.ids.cpu().numpy(), gt.cpu().numpy())
    log(f"[main] dense_embed n={n} d={data.shape[1]} gl=256 euclidean pam "
        f"group_chunk={GROUP_CHUNK}: build {build_s:.3f} s, "
        f"levels {idx.stats.level_sizes}, peak device memory "
        f"{build_mem / 2**30:.3f} GiB (build) / "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (run)")
    log(f"[main] plan: {plan.explain()}")
    log(f"[main] {len(test)} queries, beam 32, k=10: {search_s:.4f} s "
        f"({len(test) / search_s:.1f} queries/s, first call), "
        f"recall@10 {rec:.4f}; exact_knn {exact_s:.4f} s")
    PHASE_LAUNCHES["main"] = counts
    log(f"[main] kernel launches on the main path: {json.dumps(counts)}")
    for name in BEAM_PATH_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} never launched on the main path")
    for beam in (64, 128, 256):
        wide = idx.plan(Query(k=10, beam=beam))(Qc)
        log(f"[main] beam {beam}: recall@10 "
            f"{recall(wide.ids.cpu().numpy(), gt.cpu().numpy()):.4f}, mean "
            f"candidates {float(wide.n_candidates.float().mean()):.0f}")
    t0 = time.perf_counter()
    res2 = plan(Qc)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    log(f"[main] second search call: {again_s:.4f} s "
        f"({len(test) / again_s:.1f} queries/s)")
    require(np.array_equal(res.ids.cpu().numpy(), res2.ids.cpu().numpy()),
            "the search is not repeatable")
    return dict(idx=idx, res=res, counts=counts, build_s=build_s,
                search_s=search_s, recall=rec, Qc=Qc, gt=gt.cpu().numpy())


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_breakdown(label: str, fn, wall_ms=None) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and print where the device
    time went: the busy share of the call's wall time (``wall_ms``, of
    the same call just run without the profiler; timed here when not
    given) and the ops that took most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if wall_ms is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only: recording every host op as well took the
    # profiled 1M build ~80 s, and a host op's device time repeats its
    # kernels' (same busy time either way on an H100)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side records only (kernels, copies); CUPTI's buffer requests
    # are the tracer's
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and _device_us(e) > 0
              and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if busy_ms == 0:  # CUPTI gave no device activity: the share is unknown
        log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy share "
            f"not measured (the profiler saw no device time)")
        return dict(wall_ms=wall_ms, busy_ms=None, kernels={})
    # the port's kernels by their symbols: device ms and launches in the call
    kernels = {}
    for sym in KERNEL_SYMBOLS:
        hits = [e for e in events if sym in e.key]
        kernels[sym] = (sum(_device_us(e) for e in hits) / 1e3,
                        sum(e.count for e in hits))
    top = sorted(events, key=_device_us, reverse=True)[:6]
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%)")
    for e in top:
        log(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    log(f"[profile]   the port's kernels (ms, launches): {json.dumps(kernels)}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=kernels)


def phase_cpu_check(main: dict) -> None:
    """The card's search against the port's CPU search on the same index."""
    from repro_torch.core.index import PDASCIndex
    from repro_torch.query import Query

    cpu = PDASCIndex.from_arrays(*main["idx"].to_arrays(), device="cpu")
    Q = main["Qc"][:N_CPU_CHECK].cpu()
    t0 = time.perf_counter()
    want = cpu.plan(Query(k=10))(Q)
    got = main["res"]
    gd = got.dists[:N_CPU_CHECK].cpu().numpy()
    gi = got.ids[:N_CPU_CHECK].cpu().numpy()
    topk_agree(gd, gi, want.dists.numpy(), want.ids.numpy(), gd)
    log(f"[cpu-check] card search == CPU search on {N_CPU_CHECK} queries "
        f"(CPU took {time.perf_counter() - t0:.1f} s)")


def phase_profile(data: np.ndarray, main: dict) -> None:
    """Device busy share and top ops of one search call, one build and one
    affected compaction (of the profiled build's index after ``CHURN`` / 16
    of writes); the search's profile is kept in ``main`` (its rank
    launches' sum)."""
    from repro_torch.core.index import PDASCIndex
    from repro_torch.online import EpochHandle
    from repro_torch.query import Query

    plan = main["idx"].plan(Query(k=10))
    main["search_profile"] = profile_breakdown(
        f"search {N_QUERIES} queries, beam 32", lambda: plan(main["Qc"]))
    n = PROFILE_ROWS["pam"]

    def build():
        return PDASCIndex.build(data[:n], gl=256, distance="euclidean",
                                radius_quantile=0.35,
                                group_chunk=GROUP_CHUNK, device="cuda")

    profile_breakdown(f"build n={n}", build)
    idx = build()
    idx.enable_mutations()
    rng = np.random.default_rng(3)
    leaf_ids = idx.data.leaf_ids[idx.data.levels[0].valid].cpu().numpy()
    w = apply_churn(EpochHandle(idx, delta_fill=1.0, tombstone_ratio=1.0),
                    *churn_ops(rng, data[:n], leaf_ids, scale=16), rng)
    profile_breakdown(f"compact(affected) n={n} after {w['n_ops']} writes",
                      lambda: idx.compact(scope="affected",
                                          group_chunk=GROUP_CHUNK))


def phase_timing(data: np.ndarray, main: dict) -> list:
    """Each kernel at the main path's shapes: kernel, plain version,
    library call and bound."""
    import torch
    from repro_torch.core import kmedoids as km, nsa
    from repro_torch.kernels import kmedoids as kmk, pairwise as pw
    from repro_torch.kernels import ref, topk

    idx, Qc = main["idx"], main["Qc"]
    rows = []

    def row(name, shape, ms, plain_ms, lib_ms, flops, nbytes, err,
            peak=PEAK_FP32):
        b_ms, b_by = bound(flops, nbytes, peak)
        src, rep = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         symbols=SYMBOLS[name],
                         launches=main["counts"][name], max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, shape=shape))
        log(f"[time] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")

    # pairwise: one build slab of level 0 (group_chunk groups of 256, d=100);
    # X is Y, as in the build
    G, g, d = GROUP_CHUNK, 256, data.shape[1]
    X = _cuda(data[:G * g].reshape(G, g, d))
    out = pw.pairwise_cuda(X, X, "l2")
    want = ref.pairwise_ref(X, X, "l2")
    err = values_agree(out.cpu().numpy(), want.cpu().numpy(), squared=True)
    row("pairwise", [G, g, g, d],
        kernel_ms(lambda: pw.pairwise_cuda(X, X, "l2")),
        time_ms(lambda: ref.pairwise_ref(X, X, "l2")),
        time_ms(lambda: torch.cdist(X, X)),
        2.0 * G * g * g * d, 4.0 * (G * g * d + G * g * g), err, PEAK_GRAM)

    # pairwise in l1 at the same shape: the CUDA-core route (one subtract
    # and one add an element); the plain version in slabs of 32 groups
    def plain_l1():
        return torch.cat([ref.pairwise_ref(X[i:i + 32], X[i:i + 32], "l1")
                          for i in range(0, G, 32)])

    err = values_agree(pw.pairwise_cuda(X, X, "l1").cpu().numpy(),
                       plain_l1().cpu().numpy())
    b_ms, b_by = bound(2.0 * G * g * g * d, 4.0 * (G * g * d + G * g * g))
    l1 = dict(ms=kernel_ms(lambda: pw.pairwise_cuda(X, X, "l1")),
              plain_ms=time_ms(plain_l1, iters=2, warmup=1),
              library_ms=time_ms(lambda: torch.cdist(X, X, p=1), iters=3),
              bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["l1"] = l1
    log(f"[time] pairwise l1 [{G}, {g}, {g}, {d}]: kernel {l1['ms']:.4f} ms, "
        f"plain {l1['plain_ms']:.4f} ms, library {l1['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")

    # swap_deltas: the first sweep of that slab (pruned BUILD medoids)
    k = g // 2
    valid = torch.ones((G, g), dtype=torch.bool, device="cuda")
    medoids = km.build_grouped_pruned(out, k, valid)
    d1, n1, d2 = km._nearest_caches(out, medoids, valid)
    sw = kmk.swap_deltas_cuda(out, d1, d2, n1, valid, k)
    err = values_agree(sw.cpu().numpy(),
                       ref.swap_deltas_ref(out, d1, d2, n1, valid, k).cpu().numpy())
    row("swap_deltas", [G, g, k],
        kernel_ms(lambda: kmk.swap_deltas_cuda(out, d1, d2, n1, valid, k)),
        time_ms(lambda: ref.swap_deltas_ref(out, d1, d2, n1, valid, k)),
        None, 7.0 * G * g * g,
        4.0 * G * g * g + 13.0 * G * g + 4.0 * G * k * g, err)
    del X, out, want, sw

    # rank: the leaf ranking of the main search (its own candidate table)
    leaf = idx.data.levels[0]
    cand_idx, cand_ok = nsa.descend_beam(
        idx.data, Qc, dist=idx.distance, r=idx.default_radius, beam=32,
        max_children=idx.max_children)
    b, w = cand_idx.shape
    kd, ks = topk.rank_cuda(Qc, leaf.points, leaf.sq_norm, cand_idx, cand_ok,
                            10, "l2")
    rd, rs = ref.rank_gathered_ref(Qc, leaf.points, leaf.sq_norm, cand_idx,
                                   cand_ok, 10, "l2")
    picked = torch.gather(cand_idx, 1, ks.long()).long()
    again = ref.rowwise_ref(Qc, leaf.points[picked], "l2", leaf.sq_norm[picked])
    err = topk_agree(kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(), again.cpu())
    n_ok = int(cand_ok.sum())

    def library_rank():  # gather, cdist, mask, top-k: PyTorch calls
        C = leaf.points[cand_idx.long()]
        D = torch.cdist(Qc[:, None], C).squeeze(1).masked_fill(~cand_ok, BIG)
        return torch.topk(D, 10, largest=False)

    row("rank", [b, w, d, 10],
        kernel_ms(lambda: topk.rank_cuda(Qc, leaf.points, leaf.sq_norm, cand_idx,
                                         cand_ok, 10, "l2")),
        time_ms(lambda: ref.rank_gathered_ref(Qc, leaf.points, leaf.sq_norm,
                                              cand_idx, cand_ok, 10, "l2")),
        time_ms(library_rank), 2.0 * n_ok * d,
        4.0 * b * d + n_ok * (4.0 * d + 4) + 5.0 * b * w + 8.0 * b * 10, err)
    rows[-1]["event_ms"] = time_ms(lambda: topk.rank_cuda(
        Qc, leaf.points, leaf.sq_norm, cand_idx, cand_ok, 10, "l2"))
    # what one beam search pays: its rank launches, from the profile
    prof = main.get("search_profile", {}).get("kernels", {})
    ms, count = prof.get("rank_kernel", (None, 0))
    rows[-1].update(per_search_ms=ms, per_search_launches=count)
    log(f"[time] rank by CUDA events around back-to-back calls (host gaps "
        f"included): {rows[-1]['event_ms']:.4f} ms")
    log(f"[time] rank over one beam search: {count} launches, "
        f"{'not measured' if ms is None else f'{ms:.4f} ms'} (profile)")

    # knn: exact_knn's call, 1000 queries against the whole dataset
    DB = _cuda(data)
    kd, ki = topk.knn_cuda(Qc, DB, 10, "l2")
    rd, ri = ref.knn_ref(Qc, DB, 10, "l2")
    again = ref.rowwise_ref(Qc, DB[ki.long()], "l2")
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
    del rd, ri
    nq, n = Qc.shape[0], DB.shape[0]
    flops, nbytes = 2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 8.0 * nq * 10
    row("knn", [nq, n, d, 10],
        kernel_ms(lambda: topk.knn_cuda(Qc, DB, 10, "l2"), iters=5),
        time_ms(lambda: ref.knn_ref(Qc, DB, 10, "l2"), iters=2, warmup=1),
        time_ms(lambda: torch.topk(torch.cdist(Qc, DB), 10, largest=False),
                iters=2, warmup=1),
        flops, nbytes, err, PEAK_GRAM)

    # knn in l1 at the same shape: the VPU route (no product, fp32 cores;
    # one subtract and one add an element)
    def plain_l1():
        return ref.topk_smallest(ref.pairwise_ref_chunked(Qc, DB, "l1", 1024),
                                 10)

    kd, ki = topk.knn_cuda(Qc, DB, 10, "l1")
    rd, ri = plain_l1()
    again = ref.rowwise_ref(Qc, DB[ki.long()], "l1")
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
    del rd, ri
    b_ms, b_by = bound(flops, nbytes)
    l1 = dict(ms=kernel_ms(lambda: topk.knn_cuda(Qc, DB, 10, "l1"), iters=3),
              plain_ms=time_ms(plain_l1, iters=1, warmup=0),
              library_ms=time_ms(lambda: torch.topk(
                  torch.cdist(Qc, DB, p=1), 10, largest=False),
                  iters=1, warmup=1),
              bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["l1"] = l1
    log(f"[time] knn l1 [{nq}, {n}, {d}, 10]: kernel {l1['ms']:.4f} ms, "
        f"plain {l1['plain_ms']:.4f} ms, library {l1['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")
    del DB, kd, ki, again

    # knn's streaming route: a 1536-d table (a text-embedding width) that
    # no wgmma query tile holds; normal data from a seed, made on the card
    gen = torch.Generator(device="cuda").manual_seed(1)
    nq, n, d = KNN_STREAM_SHAPE
    Q2 = torch.randn((nq, d), device="cuda", generator=gen)
    DB2 = torch.randn((n, d), device="cuda", generator=gen)
    require(topk.knn_geometry(nq, n, d, 10, "l2").route == "stream",
            "the 1536-d knn does not take the streaming route")
    kd, ki = topk.knn_cuda(Q2, DB2, 10, "l2")
    rd, ri = ref.knn_ref(Q2, DB2, 10, "l2")
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(),
                     ref.rowwise_ref(Q2, DB2[ki.long()], "l2").cpu())
    b_ms, b_by = bound(2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 8.0 * nq * 10,
                       PEAK_GRAM)
    stream = dict(shape=[nq, n, d, 10],
                  ms=kernel_ms(lambda: topk.knn_cuda(Q2, DB2, 10, "l2"), iters=2,
                               replays=2),
                  plain_ms=time_ms(lambda: ref.knn_ref(Q2, DB2, 10, "l2"),
                                   iters=2, warmup=1),
                  library_ms=time_ms(lambda: torch.topk(
                      torch.cdist(Q2, DB2), 10, largest=False), iters=2,
                      warmup=1),
                  bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["stream"] = stream
    log(f"[time] knn stream {stream['shape']} l2: kernel {stream['ms']:.4f} "
        f"ms, plain {stream['plain_ms']:.4f} ms, library "
        f"{stream['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max "
        f"abs err {err:.3g}")
    del Q2, DB2, kd, ki, rd, ri

    # the streaming route in l1 at a wider table: fp32 micro-tiles on the
    # CUDA cores (one subtract and one add an element); the plain version
    # in [512, 512, d] slabs and cdist(p=1) are slow here, one call each
    nq, n, d = KNN_STREAM_L1_SHAPE
    Q3 = torch.randn((nq, d), device="cuda", generator=gen)
    DB3 = torch.randn((n, d), device="cuda", generator=gen)
    require(topk.knn_geometry(nq, n, d, 10, "l1").route == "stream",
            "the 3072-d l1 knn does not take the streaming route")

    def plain_l1_stream():
        return ref.topk_smallest(ref.pairwise_ref_chunked(Q3, DB3, "l1", 512), 10)

    kd, ki = topk.knn_cuda(Q3, DB3, 10, "l1")
    t0 = time.perf_counter()
    rd, ri = plain_l1_stream()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(),
                     ref.rowwise_ref(Q3, DB3[ki.long()], "l1").cpu())
    b_ms, b_by = bound(2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 8.0 * nq * 10)
    stream_l1 = dict(shape=[nq, n, d, 10],
                     ms=kernel_ms(lambda: topk.knn_cuda(Q3, DB3, 10, "l1"), iters=2,
                                  replays=1),
                     plain_ms=plain_ms,
                     library_ms=time_ms(lambda: torch.topk(
                         torch.cdist(Q3, DB3, p=1), 10, largest=False), iters=1,
                         warmup=0),
                     bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["stream_l1"] = stream_l1
    log(f"[time] knn stream {stream_l1['shape']} l1: kernel "
        f"{stream_l1['ms']:.4f} ms, plain {plain_ms:.4f} ms (one call), library "
        f"{stream_l1['library_ms']:.4f} ms (one call), bound {b_ms:.4f} ms "
        f"({b_by}), max abs err {err:.3g}")
    return rows


def phase_store(main: dict, workdir: str) -> dict:
    """The storage path on the main path's 1M index: int8 store, release,
    the default plan (two_stage), its checks and the other code formats.
    Must run after every phase that reads the dense leaf payload."""
    import torch
    from repro_torch.core.msa import PDASCIndexData, PDASCLevel
    from repro_torch.kernels import ops
    from repro_torch.query import Query
    from repro_torch.store import LeafStore, search_two_stage

    idx, Qc, gt = main["idx"], main["Qc"], main["gt"]
    leaf = idx.data.levels[0]
    n0 = leaf.points.shape[0]

    # fp16, int4 and binary on the same leaf points, dense payload kept
    others = {}
    for backend in ("fp16", "int4", "binary"):
        st = LeafStore.create(leaf.points, backend, block=STORE_BLOCK)
        res = search_two_stage(
            idx.data, st, Qc, dist=idx.distance, k=10, r=idx.default_radius,
            beam=32, max_children=idx.max_children)
        torch.cuda.synchronize()
        rec = recall(res.ids.cpu().numpy(), gt)
        bpv = st.resident_bytes / n0
        log(f"[store] {backend}: recall@10 {rec:.4f}, payload "
            f"{bpv:.3f} bytes/vector (dense fp32 400)")
        others[backend] = dict(recall=rec, bytes_per_vector=bpv,
                               codes=st.codes, scales=st.scales)
        del st, res

    t0 = time.perf_counter()
    idx.attach_store("int8", block=STORE_BLOCK,
                     path=os.path.join(workdir, "payload.f32"))
    idx.release_dense_payload()
    torch.cuda.synchronize()
    log(f"[store] attach_store('int8', block={STORE_BLOCK}, memmap) + "
        f"release_dense_payload: {time.perf_counter() - t0:.3f} s")
    plan = idx.plan(Query(k=10))
    log(f"[store] plan: {plan.explain()}")
    require(plan.pipeline == "two_stage" and "scan_quantized" in plan.explain(),
            "the default plan of a released index is not two_stage")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = plan(Qc)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = plan(Qc)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    counts = PHASE_LAUNCHES["store"] = ops.launch_counts()
    require(torch.equal(res.ids, res2.ids), "two-stage is not repeatable")
    log(f"[store] kernel launches on the two-stage path (2 calls): "
        f"{json.dumps(counts)}")
    for name in STORE_PATH_KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the "
                f"two-stage path")

    rec = recall(res.ids.cpu().numpy(), gt)
    mem = idx.memory_bytes()
    cache = idx.store.exact.cache.stats
    log(f"[store] {len(Qc)} queries, two_stage int8, beam 32, R="
        f"{RERANK_WIDTH}: first call {first_s:.4f} s "
        f"({len(Qc) / first_s:.1f} queries/s), second {second_s:.4f} s "
        f"({len(Qc) / second_s:.1f} queries/s)")
    log(f"[store] recall@10 {rec:.4f} (beam on the same index "
        f"{main['recall']:.4f}); payload {mem['payload_bytes_per_vector']} "
        f"bytes/vector (dense fp32 400); memory_bytes {json.dumps(mem)}")
    log(f"[store] granule cache: {json.dumps(cache)}")
    require(rec >= main["recall"] - 0.01,
            f"two-stage recall {rec:.4f} < beam {main['recall']:.4f} - 0.01")

    inf = idx.plan(Query(k=10, rerank_width=None))(Qc)
    for a, b in zip(inf, main["res"]):
        require(torch.equal(a, b), "∞ rerank width differs from beam")
    log("[store] rerank_width=None (∞) == the beam result, bit for bit")

    cpu_data = PDASCIndexData(
        levels=tuple(PDASCLevel(*(t.cpu() for t in lv))
                     for lv in idx.data.levels),
        leaf_ids=idx.data.leaf_ids.cpu())
    cpu_store = dataclasses.replace(idx.store, codes=idx.store.codes.cpu(),
                                    scales=idx.store.scales.cpu())
    cpu = dataclasses.replace(idx, data=cpu_data, store=cpu_store,
                              device=torch.device("cpu"), _plan_cache=None)
    t0 = time.perf_counter()
    want = cpu.plan(Query(k=10))(Qc[:N_CPU_CHECK].cpu())
    gd = res.dists[:N_CPU_CHECK].cpu().numpy()
    topk_agree(gd, res.ids[:N_CPU_CHECK].cpu().numpy(), want.dists.numpy(),
               want.ids.numpy(), gd)
    log(f"[store] card two-stage == CPU two-stage on {N_CPU_CHECK} queries "
        f"(CPU took {time.perf_counter() - t0:.1f} s)")

    prof = profile_breakdown(f"two-stage {len(Qc)} queries, int8, R="
                             f"{RERANK_WIDTH}", lambda: plan(Qc))
    return dict(counts=counts, recall=rec, first_s=first_s,
                second_s=second_s, mem=mem, cache=dict(cache), others=others,
                profile=prof)


def phase_scan_timing(main: dict, store: dict) -> dict:
    """The scan kernel at the storage path's shapes (its own candidate
    table, k = R = 128) in each code format: kernel, plain version and
    bound. Returns the kernels-line row (int8, the path's format, with
    every format under ``formats``)."""
    import torch
    from repro_torch.core import nsa
    from repro_torch.kernels import quantized, ref

    idx, Qc = main["idx"], main["Qc"]
    cand_idx, cand_ok = nsa.descend_beam(
        idx.data, Qc, dist=idx.distance, r=idx.default_radius, beam=32,
        max_children=idx.max_children)
    b, w = cand_idx.shape
    d = Qc.shape[1]
    n_ok = int(cand_ok.sum())
    tables = {"int8": (idx.store.codes, idx.store.scales)}
    tables.update({k: (v["codes"], v["scales"])
                   for k, v in store["others"].items()})
    formats = {}
    for backend, (codes, scales) in tables.items():
        fmt = SCAN_FORMATS[backend]

        def kernel():
            return quantized.scan_cuda(Qc, codes, scales, STORE_BLOCK,
                                       cand_idx, cand_ok, RERANK_WIDTH,
                                       "l2", fmt)

        def plain():
            return ref.scan_gathered_ref(Qc, codes, scales, STORE_BLOCK,
                                         cand_idx, cand_ok, RERANK_WIDTH,
                                         "l2", fmt)

        def library():  # dequantised gathered rows, cdist, mask, top-k
            C = ref.dequantize_rows(codes, scales, STORE_BLOCK, cand_idx, fmt, d)
            D = torch.cdist(Qc[:, None], C).squeeze(1).masked_fill(~cand_ok, BIG)
            return torch.topk(D, RERANK_WIDTH, largest=False)

        kd, ks = kernel()
        rd, rs = plain()
        again = torch.gather(scan_rows(Qc, codes, scales, STORE_BLOCK,
                                       cand_idx, "l2", fmt), 1, ks.long())
        err = topk_agree(kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(), again.cpu())
        row_bytes = codes.shape[1] * codes.element_size()
        nbytes = (n_ok * row_bytes + 5.0 * b * w + 4.0 * b * d
                  + 8.0 * b * RERANK_WIDTH)
        b_ms, b_by = bound(5.0 * n_ok * d, nbytes)
        formats[backend] = dict(
            ms=kernel_ms(kernel), event_ms=time_ms(kernel), plain_ms=time_ms(plain),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, bytes_per_row=row_bytes)
        f = formats[backend]
        log(f"[time] scan {backend} [{b}, {w}, d={d}, k={RERANK_WIDTH}] "
            f"({n_ok} unmasked): kernel {f['ms']:.4f} ms (events "
            f"{f['event_ms']:.4f}), plain "
            f"{f['plain_ms']:.4f} ms, library {f['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")
    src, rep = KERNELS["scan"]
    main8 = formats["int8"]
    return dict(name="scan", route="cuda", source=src, replaces=rep,
                symbols=SYMBOLS["scan"], launches=store["counts"]["scan"],
                max_abs_err=max(f["max_abs_err"] for f in formats.values()),
                ms=main8["ms"], plain_ms=main8["plain_ms"],
                bound_ms=main8["bound_ms"], bound_by=main8["bound_by"],
                library_ms=main8["library_ms"], shape=[b, w, d, RERANK_WIDTH],
                formats=formats)


def launched(phase: str, names=None) -> dict:
    """Read the launch counts after ``phase`` (zeroed just before it),
    keep them for the kernels line, and fail for a kernel of the phase's
    path (``names``, by default its ``WINDOW_KERNELS`` entry) that never
    launched."""
    from repro_torch.kernels import ops

    names = WINDOW_KERNELS[phase] if names is None else names
    counts = ops.launch_counts()
    PHASE_LAUNCHES[phase] = counts
    log(f"[{phase}] kernel launches: {json.dumps(counts)}")
    for name in names:
        require(counts[name] > 0, f"kernel {name} never launched in {phase}")
    return counts


def start_phase() -> None:
    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()


def sync_s(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_kmeans(data: np.ndarray, test: np.ndarray, main: dict) -> dict:
    """The k-means build at the main path's size and its two users beside
    it: ``method="kmeans"`` at n = 1M, gl = 256 (invariants, level TDs of
    0, recall@10 of beam 32 beside the pam build's); a pam build at
    gl = 2048 on a 200,000-row slice (swap_deltas past g = 1,456, the
    split slots); and IVF-Flat at 1M with bench_recall.py's n_cells =
    n // 256 and n_probe = 8."""
    from repro_torch.baselines import IVFFlatIndex, exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.core.reference_impl import check_index_invariants
    from repro_torch.query import Query

    Qc = main["Qc"]
    start_phase()
    t0 = time.perf_counter()
    idx = PDASCIndex.build(data, gl=256, distance="euclidean", method="kmeans",
                           radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                           device="cuda")
    build_s = sync_s(t0)
    launched("kmeans-build")
    errs = check_index_invariants(idx.data)
    require(errs == [], f"k-means build: {errs[:5]}")
    require(all(t == 0.0 for t in idx.stats.level_td),
            f"k-means level TDs {idx.stats.level_td} are not all 0")
    start_phase()
    _, gt = exact_knn(Qc, data, k=10, device="cuda")
    gt = gt.cpu().numpy()
    launched("kmeans-truth")
    start_phase()
    res = idx.plan(Query(k=10))(Qc)
    rec = recall(res.ids.cpu().numpy(), gt)
    launched("kmeans-search")
    log(f"[kmeans] dense_embed n={len(data)} gl=256 euclidean kmeans: build "
        f"{build_s:.3f} s, levels {idx.stats.level_sizes}, invariants hold, "
        f"level TDs all 0; recall@10 beam 32 {rec:.4f} (pam build "
        f"{main['recall']:.4f})")
    del idx, res
    n = PROFILE_ROWS["kmeans"]
    profile_breakdown(
        f"k-means build n={n}",
        lambda: PDASCIndex.build(data[:n], gl=256, method="kmeans",
                                 group_chunk=GROUP_CHUNK, device="cuda"))

    big = data[:N_BIG_GL]
    start_phase()
    t0 = time.perf_counter()
    idx = PDASCIndex.build(big, gl=2048, distance="euclidean", method="pam",
                           radius_quantile=0.35, group_chunk=64,
                           device="cuda")
    big_s = sync_s(t0)
    launched("pam-gl2048")
    errs = check_index_invariants(idx.data)
    require(errs == [], f"gl=2048 build: {errs[:5]}")
    log(f"[kmeans] pam gl=2048 (k=1024) on n={len(big)}: build {big_s:.3f} "
        f"s, levels {idx.stats.level_sizes}, invariants hold")
    del idx

    n_cells = len(data) // 256
    start_phase()
    t0 = time.perf_counter()
    ivf = IVFFlatIndex.build(data, n_cells=n_cells, device="cuda")
    ivf_build_s = sync_s(t0)
    t0 = time.perf_counter()
    _, ivf_ids = ivf.search(test, k=10, n_probe=IVF_PROBE)
    ivf_query_s = sync_s(t0)
    launched("ivf")
    ivf_rec = recall(ivf_ids, gt)
    require(np.isfinite(ivf_rec) and ivf_rec > 0, "IVF-Flat found nothing")
    log(f"[kmeans] IVF-Flat n={len(data)} n_cells={n_cells} "
        f"n_probe={IVF_PROBE}: build {ivf_build_s:.3f} s, {len(test)} "
        f"queries {ivf_query_s:.4f} s ({len(test) / ivf_query_s:.1f} "
        f"queries/s), recall@10 {ivf_rec:.4f}")
    return dict(build_s=build_s, recall=rec, big_s=big_s,
                ivf_build_s=ivf_build_s, ivf_query_s=ivf_query_s,
                ivf_recall=ivf_rec)


def churn_ops(rng, data, leaf_ids, scale: int = 1):
    """The write stream of the online phases (``CHURN`` / ``scale``):
    upserts of resident rows plus N(0, 0.05) noise in batches,
    replacements of resident ids, and deletes of other resident ids.
    Returns ``(upsert ops, replacement op, resident deletes)``."""
    c = {k: v // scale for k, v in CHURN.items()}
    d = data.shape[1]
    src = rng.choice(len(data), c["upserts"], replace=False)
    new = data[src] + rng.normal(0, 0.05, size=(len(src), d)).astype(np.float32)
    ups = [("upsert", new[i:i + c["batch"]])
           for i in range(0, len(new), c["batch"])]
    ids = rng.choice(leaf_ids, c["replace"] + c["delete"], replace=False)
    rep_ids, dead = ids[:c["replace"]], ids[c["replace"]:]
    rep = data[rep_ids] + rng.normal(0, 0.05, size=(len(rep_ids), d)).astype(
        np.float32)
    return ups, ("upsert", (rep, rep_ids.astype(np.int32))), dead, c


def apply_churn(handle, ups, rep, dead, c, rng) -> dict:
    """Drive the stream through ``EpochHandle.apply_writes`` (every op must
    succeed); returns the upserted ids, the deleted ids and the time."""
    t0 = time.perf_counter()
    out = handle.apply_writes(ups + [rep])
    bad = [o for o in out if isinstance(o, Exception)]
    require(not bad, f"writes failed: {bad[:3]}")
    upserted = np.concatenate(out[:len(ups)])
    dead_up = rng.choice(upserted, c["delete_upserted"], replace=False)
    out = handle.apply_writes([("delete", dead), ("delete", dead_up)])
    require(out == [len(dead), len(dead_up)], f"deletes removed {out}")
    write_s = sync_s(t0)
    n_ops = len(upserted) + len(rep[1][1]) + len(dead) + len(dead_up)
    return dict(upserted=upserted, deleted=np.concatenate([dead, dead_up]),
                dead_up=dead_up, write_s=write_s, n_ops=n_ops)


def check_self_found(plan, idx, upserted, deleted) -> None:
    """A query equal to a live upserted vector returns its own id first."""
    import torch

    alive = np.setdiff1d(upserted, deleted)[:64]
    pos = np.nonzero(np.isin(idx.delta.ids[:idx.delta.size], alive)
                     & idx.delta.active[:idx.delta.size])[0]
    res = plan(torch.from_numpy(idx.delta.vectors[pos]).cuda())
    require(np.array_equal(res.ids[:, 0].cpu().numpy(), idx.delta.ids[pos]),
            "an upserted vector does not find itself first")


def check_exact_sets(res, gd, gt) -> None:
    """A dense exact search (radius 1e9) against exact_knn over the live
    set, as sets: an id in one and not the other must sit at the k-th
    place's distance, within the tolerance rule (l2 compared squared)."""
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    atol = atol_of(gd * gd)
    for q in range(len(gt)):
        diff = set(ids[q].tolist()) ^ set(gt[q].tolist())
        if diff:
            kth = max(float(gd[q, -1]), float(dists[q, -1])) ** 2
            near = [float(x) ** 2 for i, x in zip(ids[q], dists[q]) if i in diff]
            near += [float(x) ** 2 for i, x in zip(gt[q], gd[q]) if i in diff]
            require(all(abs(x - kth) <= atol + 1e-5 * kth for x in near),
                    f"query {q}: exact search {sorted(ids[q])} != "
                    f"exact_knn {sorted(gt[q])}")


def phase_online(main: dict, data: np.ndarray, workdir: str) -> dict:
    """The online tiers on a copy of the main 1M index (``from_arrays`` of
    its arrays, so phases 3 and 4 keep measuring the frozen index): the
    ``beam_vmap`` plan on the clean copy against the beam plan, then the
    CHURN write stream through ``EpochHandle.apply_writes`` (its swap
    policy off: this phase compacts by hand), the default plan with the
    delta leg and the tombstone mask, a save / load of a churned
    ``SAVE_ROWS``-row index (format v3) in ``workdir``, compaction of both
    scopes. Launch counts
    are read per window (``WINDOW_KERNELS``)."""
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.core.reference_impl import check_index_invariants
    from repro_torch.online import EpochHandle, live_dataset
    from repro_torch.query import Query

    Qc, gl = main["Qc"], 256
    idx = PDASCIndex.from_arrays(*main["idx"].to_arrays(), device="cuda")
    idx.enable_mutations()
    frozen = idx.plan(Query(k=10))
    fres = frozen(Qc)
    t0 = time.perf_counter()
    frozen(Qc)
    frozen_s = sync_s(t0)

    # the seed per-query beam (gathers + dist.point, no kernel of the port)
    # on the clean copy, against the batched beam plan's results
    vplan = idx.plan(Query(k=10, execution="beam_vmap"))
    require(vplan.pipeline == "beam_vmap", f"planned {vplan.pipeline}")
    Qv = Qc[:N_CPU_CHECK]
    start_phase()
    t0 = time.perf_counter()
    vres = vplan(Qv)
    vmap_s = sync_s(t0)
    vcounts = launched("online-beam-vmap", ())
    require(not any(vcounts.values()),
            f"beam_vmap launched a kernel: {vcounts}")
    vd = vres.dists.cpu().numpy()
    topk_agree(vd, vres.ids.cpu().numpy(), fres.dists[:N_CPU_CHECK].cpu().numpy(),
               fres.ids[:N_CPU_CHECK].cpu().numpy(), vd)
    # a candidate at the radius within rounding may count on one side only
    n_cand_diff = int((vres.n_candidates.cpu()
                       != fres.n_candidates[:N_CPU_CHECK].cpu()).sum())
    log(f"[online] beam_vmap plan on the clean copy, {len(Qv)} queries: "
        f"{vmap_s:.4f} s, no kernel launched, == the beam plan (ids modulo "
        f"near-ties); candidate counts differ on {n_cand_diff} queries")

    rng = np.random.default_rng(1)
    leaf_ids = idx.data.leaf_ids[idx.data.levels[0].valid].cpu().numpy()
    ups, rep, dead, c = churn_ops(rng, data, leaf_ids)
    start_phase()
    handle = EpochHandle(idx, delta_fill=1.0, tombstone_ratio=1.0)
    w = apply_churn(handle, ups, rep, dead, c, rng)
    counts = {"online-writes": launched("online-writes")}
    require(handle.current is idx and handle.swaps == 0, "the handle swapped")
    fill = idx.delta.size / idx.delta.capacity
    require(idx.needs_compaction(), f"needs_compaction() is false at delta "
            f"fill {idx.delta.size}/{idx.delta.capacity}")

    start_phase()
    plan = idx.plan(Query(k=10))
    legs = plan.describe()["online_legs"]
    require(legs["tombstone_mask"] and legs["delta"],
            f"the plan lacks an online leg: {legs}")
    res = plan(Qc)
    t0 = time.perf_counter()
    res = plan(Qc)
    churn_s = sync_s(t0)
    require(not np.isin(res.ids.cpu().numpy(), w["deleted"]).any(),
            "a deleted id surfaced under churn")
    check_self_found(plan, idx, w["upserted"], w["deleted"])
    counts["online-search"] = launched("online-search")

    cpu = PDASCIndex.from_arrays(*idx.to_arrays(), device="cpu")
    t0 = time.perf_counter()
    want = cpu.plan(Query(k=10))(Qc[:N_CPU_CHECK].cpu())
    gd = res.dists[:N_CPU_CHECK].cpu().numpy()
    topk_agree(gd, res.ids[:N_CPU_CHECK].cpu().numpy(), want.dists.numpy(),
               want.ids.numpy(), gd)
    cpu_s = time.perf_counter() - t0
    del cpu

    # save / load of a churned index: format v3 (the online tiers in its
    # mutable meta), loaded on the card with the same tiers and results;
    # SAVE_ROWS rows under a CHURN / 16 stream (the 1M churned index spent
    # 34-43 s in np.savez_compressed)
    small = PDASCIndex.build(data[:SAVE_ROWS], gl=gl, shuffle=False,
                             group_chunk=GROUP_CHUNK, device="cuda")
    small.enable_mutations()
    s_ups, s_rep, s_dead, s_c = churn_ops(
        np.random.default_rng(2), data[:SAVE_ROWS], np.arange(SAVE_ROWS), 16)
    apply_churn(EpochHandle(small, delta_fill=1.0, tombstone_ratio=1.0),
                s_ups, s_rep, s_dead, s_c, np.random.default_rng(3))
    sres = small.plan(Query(k=10))(Qc)
    path = os.path.join(workdir, "online_index")
    t0 = time.perf_counter()
    small.save(path)
    save_s = time.perf_counter() - t0
    with open(path + ".json") as f:
        version = json.load(f)["version"]
    require(version == 3, f"the churned index saved as version {version}")
    t0 = time.perf_counter()
    loaded = PDASCIndex.load(path, device="cuda")
    load_s = sync_s(t0)
    n_d = small.delta.size
    require(n_d > 0 and small.tombstones.bits.any(),
            "the saved index has no online tier to round-trip")
    require(loaded.device.type == "cuda", f"loaded on {loaded.device}")
    require(loaded.delta.size == n_d
            and np.array_equal(loaded.delta.ids[:n_d], small.delta.ids[:n_d])
            and np.array_equal(loaded.delta.active[:n_d],
                               small.delta.active[:n_d])
            and np.array_equal(loaded.tombstones.bits, small.tombstones.bits)
            and loaded._seen_id_ceiling() == small._seen_id_ceiling(),
            "the loaded index's online tiers differ from the saved ones")
    lres = loaded.plan(Query(k=10))(Qc)
    require(torch.equal(lres.ids, sres.ids)
            and torch.equal(lres.dists, sres.dists),
            "the loaded index's search differs from the saved index's")
    del loaded, lres, small, sres
    for ext in (".npz", ".json"):
        os.remove(path + ext)
    log(f"[online] save (v3, mutable meta) of a {SAVE_ROWS:,}-row index "
        f"after {n_d} delta rows: {save_s:.3f} s, load on the card "
        f"{load_s:.3f} s: tiers and id ceiling equal, search bit-equal")

    start_phase()
    live_vecs, live_ids = live_dataset(idx)
    gd_live, gt_rows = exact_knn(Qc, live_vecs, k=10, device="cuda")
    gt = live_ids[gt_rows.cpu().numpy()]
    gd_live = gd_live.cpu().numpy()
    counts["online-truth"] = launched("online-truth")
    rec_churn = recall(res.ids.cpu().numpy(), gt)
    fresh = PDASCIndex.build(live_vecs, gl=gl, distance="euclidean",
                             radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                             device="cuda")
    fr = fresh.plan(Query(k=10, radius=idx.default_radius))(Qc)
    fr_ids = fr.ids.cpu().numpy()
    rec_fresh = recall(np.where(fr_ids >= 0, live_ids[np.clip(fr_ids, 0, None)],
                                -1), gt)
    del fresh
    require(rec_fresh - rec_churn <= 0.02,
            f"recall under churn {rec_churn:.4f} vs a fresh build "
            f"{rec_fresh:.4f}: more than 0.02 lower")

    G = idx.data.levels[0].points.shape[0] // gl
    dead_slots = idx.tombstones.dead_slots()
    touched = set((idx.delta.leaf_slot[:idx.delta.size][
        idx.delta.active[:idx.delta.size]] // gl).tolist()) | set(
        (dead_slots // gl).tolist())
    start_phase()
    t0 = time.perf_counter()
    aff = idx.compact(scope="affected", group_chunk=GROUP_CHUNK)
    aff_s = sync_s(t0)
    t0 = time.perf_counter()
    full = idx.compact(scope="full", group_chunk=GROUP_CHUNK)
    full_s = sync_s(t0)
    counts["online-compact"] = launched("online-compact")
    old, new = idx.data.levels[0], aff.data.levels[0]
    same = ((old.points == new.points[:old.points.shape[0]]).all(-1)
            & (idx.data.leaf_ids == aff.data.leaf_ids[:old.points.shape[0]]))
    same_group = same.reshape(G, gl).all(-1).cpu().numpy()
    untouched = np.setdiff1d(np.arange(G), list(touched))
    require(same_group[untouched].all(),
            "affected compaction changed an untouched group's rows")
    share = 1.0 - same_group.mean()
    profile_breakdown(f"routing of {CHURN['batch']} upserts",
                      lambda: idx._route_to_leaf(ups[0][1]))
    exact = {}
    start_phase()
    for name, c_idx in (("affected", aff), ("full", full)):
        errs = check_index_invariants(c_idx.data)
        require(errs == [], f"{name} compaction: {errs[:5]}")
        require(c_idx.n_points == len(live_ids) and c_idx.epoch == 1,
                f"{name} compaction holds {c_idx.n_points} points")
        ex = c_idx.plan(Query(k=10, execution="dense", radius=1e9))(Qc)
        check_exact_sets(ex, gd_live, gt)
        exact[name] = recall(c_idx.plan(Query(k=10))(Qc).ids.cpu().numpy(), gt)
    counts["online-compacted"] = launched("online-compacted")
    out = dict(writes_per_s=w["n_ops"] / w["write_s"], write_s=w["write_s"],
               n_ops=w["n_ops"], delta_fill=fill,
               qps_frozen=len(Qc) / frozen_s, qps_churn=len(Qc) / churn_s,
               recall_churn=rec_churn, recall_fresh=rec_fresh,
               affected_s=aff_s, full_s=full_s, affected_share=share,
               recall_compacted=exact, vmap_s=vmap_s, save_s=save_s,
               load_s=load_s, counts=counts)
    log(f"[online] {w['n_ops']} writes (CHURN {json.dumps(CHURN)}) through "
        f"EpochHandle.apply_writes: {w['write_s']:.3f} s "
        f"({out['writes_per_s']:.1f} writes/s); delta fill "
        f"{idx.delta.size}/{idx.delta.capacity}, {idx.tombstones.count} "
        f"tombstoned; needs_compaction() true")
    log(f"[online] {len(Qc)} queries, beam 32 + delta leg + tombstone mask: "
        f"{churn_s:.4f} s ({out['qps_churn']:.1f} queries/s) against "
        f"{frozen_s:.4f} s frozen ({out['qps_frozen']:.1f} queries/s); no "
        f"deleted id surfaced; upserted vectors find themselves first; card "
        f"== CPU on {N_CPU_CHECK} queries (CPU took {cpu_s:.1f} s)")
    log(f"[online] recall@10 under churn {rec_churn:.4f}, a fresh build on "
        f"the {len(live_ids)} live points {rec_fresh:.4f} (bar: within 0.02)")
    log(f"[online] compact(affected) {aff_s:.3f} s ({100 * share:.2f}% of "
        f"{G} groups changed, untouched groups bit-identical), "
        f"compact(full) {full_s:.3f} s; both pass the invariants, their "
        f"dense exact search == exact_knn over the live set as sets; "
        f"recall@10 beam 32 after {json.dumps(exact)}")
    return out


def phase_store_churn(main: dict, data: np.ndarray) -> dict:
    """The CHURN stream at 1/8 its size on the store phase's index (int8
    store, memmapped exact payload, dense payload released): upserts
    route through the scan at k = 1, the default two-stage plan runs
    under the tombstone mask with the delta leg, and an affected
    compaction rebuilds the store into a fresh file."""
    from repro_torch.core.reference_impl import check_index_invariants
    from repro_torch.online import EpochHandle
    from repro_torch.query import Query

    idx, Qc = main["idx"], main["Qc"]
    require(idx._payload_released, "the store phase's index is not released")
    idx.enable_mutations()
    rng = np.random.default_rng(2)
    leaf_ids = idx.data.leaf_ids[idx.data.levels[0].valid].cpu().numpy()
    ups, rep, dead, c = churn_ops(rng, data, leaf_ids, scale=8)
    start_phase()
    w = apply_churn(EpochHandle(idx, delta_fill=1.0, tombstone_ratio=1.0),
                    ups, rep, dead, c, rng)
    counts = {"store-churn-writes": launched("store-churn-writes")}
    start_phase()
    plan = idx.plan(Query(k=10))
    legs = plan.describe()["online_legs"]
    require(plan.pipeline == "two_stage" and legs["tombstone_mask"]
            and legs["delta"], f"store churn plan: {plan.pipeline} {legs}")
    t0 = time.perf_counter()
    res = plan(Qc)
    q_s = sync_s(t0)
    require(not np.isin(res.ids.cpu().numpy(), w["deleted"]).any(),
            "a deleted id surfaced in two-stage under churn")
    check_self_found(plan, idx, w["upserted"], w["deleted"])
    counts["store-churn-search"] = launched("store-churn-search")

    old_path = idx.store.exact.path
    start_phase()
    t0 = time.perf_counter()
    new = idx.compact(scope="affected", group_chunk=GROUP_CHUNK)
    comp_s = sync_s(t0)
    counts["store-churn-compact"] = launched("store-churn-compact")
    errs = check_index_invariants(new.data)
    require(errs == [], f"store compaction: {errs[:5]}")
    require(new._payload_released and new.store.exact.path != old_path
            and new.store.exact.path.endswith(".epoch1"),
            f"the new epoch's payload file is {new.store.exact.path}")
    rb = new.store.last_rebuild
    block = idx.store.block
    n_old = idx.store.n
    old_rows = idx.store.exact.read_all()
    new_rows = new.store.exact.read_all()[:n_old]
    same = (old_rows == new_rows).all(-1) & (
        idx.data.leaf_ids.cpu().numpy() == new.data.leaf_ids.cpu().numpy()[:n_old])
    nb = n_old // block
    keep = same[:nb * block].reshape(nb, block).all(-1)
    rows = np.nonzero(np.repeat(keep, block))[0]
    require(np.array_equal(idx.store.codes[rows].cpu().numpy(),
                           new.store.codes[rows].cpu().numpy()),
            "unchanged blocks' codes differ after the rebuild")
    res2 = new.plan(Query(k=10))(Qc)
    require(not np.isin(res2.ids.cpu().numpy(), w["deleted"]).any(),
            "a deleted id surfaced after the store compaction")
    share = rb["requantized"] / rb["blocks"]
    log(f"[store-churn] {w['n_ops']} writes on the released int8 index: "
        f"{w['write_s']:.3f} s ({w['n_ops'] / w['write_s']:.1f} writes/s, "
        f"routed by the scan at k=1); two-stage {len(Qc)} queries with the "
        f"delta leg and the tombstone mask {q_s:.4f} s, no deleted id; "
        f"compact(affected) {comp_s:.3f} s, re-quantised {rb['requantized']} "
        f"of {rb['blocks']} blocks ({100 * share:.2f}%), {int(keep.sum())} "
        f"unchanged blocks' codes bit-equal, payload in a fresh file "
        f"({os.path.basename(new.store.exact.path)})")
    for st in (idx.store, new.store):
        if st.exact._pool is not None:
            st.exact._pool.close()
    return dict(write_s=w["write_s"], n_ops=w["n_ops"], query_s=q_s,
                compact_s=comp_s, requantized_share=share, counts=counts)


# ---------------------------------------------------------------------------
# serving phases: the batching engine, the replicated router, observability
# ---------------------------------------------------------------------------


def pcts(lat_s) -> dict:
    """p50 / p99 / p999 of latencies in seconds, as milliseconds."""
    ms = np.asarray(lat_s, np.float64) * 1e3
    return {f"p{p}": float(np.percentile(ms, q))
            for p, q in (("50", 50), ("99", 99), ("999", 99.9))}


def engine_closed_loop(engine, Q, *, threads: int = SERVE_THREADS,
                       rows=None, span_of=None):
    """Every row of ``Q`` (or ``rows``) once, from ``threads`` submitting
    threads, each waiting for its answer before its next request. Returns
    ``(answers by row, latencies s, q/s)``; ``span_of(i)`` may give a
    trace for row ``i``, finished when its answer arrives."""
    rows = np.arange(len(Q)) if rows is None else np.asarray(rows)
    out, lat, errors = {}, {}, []

    def worker(w):
        try:
            for i in rows[w::threads].tolist():
                tr = span_of(i) if span_of is not None else None
                t0 = time.perf_counter()
                req = engine.submit(Q[i], span=tr.root if tr else None)
                out[i] = req.wait(timeout=300)
                lat[i] = time.perf_counter() - t0
                if tr is not None:
                    tr.finish(outcome="ok")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    pool = [threading.Thread(target=worker, args=(w,))
            for w in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600)
    elapsed = time.perf_counter() - t0
    require(not errors and not any(t.is_alive() for t in pool),
            f"closed loop failed: {errors[:3]}")
    return out, np.array([lat[i] for i in rows.tolist()]), len(rows) / elapsed


def engine_open_loop(engine, Q, *, n: int, qps: float, seed: int):
    """``n`` Poisson arrivals at ``qps`` (``bench_serve._open_loop``'s
    schedule): the dispatcher never waits for an answer; each request's
    latency runs from its submit to its completion callback."""
    rng = np.random.default_rng(seed)
    order = rng.integers(0, len(Q), n)
    gaps = rng.exponential(1.0 / qps, n)
    t_sub, t_done = np.zeros(n), np.zeros(n)
    reqs = []
    next_at = time.perf_counter()
    for i in range(n):
        next_at += gaps[i]
        delay = next_at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t_sub[i] = time.perf_counter()
        reqs.append(engine.submit(
            Q[order[i]],
            on_done=lambda r, i=i: t_done.__setitem__(i, time.perf_counter())))
    answers = [r.wait(timeout=300) for r in reqs]
    return order, answers, t_done - t_sub


def same_rows(answers, rows, want_d, want_i, what: str) -> None:
    """Each engine answer bit-equal to its row of the plan's result."""
    for (d, i), row in zip(answers, rows):
        require(np.array_equal(i, want_i[row]) and np.array_equal(
            d, want_d[row]), f"{what}: the answer to query {row} differs "
            f"from its row of the plan's result")


def phase_serve_engine(main: dict) -> dict:
    """(a) The batching engine over the 1M index (``launch/serve.py``'s
    defaults): a closed loop of the 1,000 queries from 8 threads, answers
    bit-equal to the plan's rows, then 2,000 open-loop Poisson arrivals at
    0.6 x the closed-loop rate, and the device busy share of ~1 s of the
    open loop."""
    from repro_torch.query import Query
    from repro_torch.serving import BatchingEngine, QueryHandler

    idx, res = main["idx"], main["res"]
    Q = main["Qc"].cpu().numpy()
    want_d, want_i = res.dists.cpu().numpy(), res.ids.cpu().numpy()
    eng = BatchingEngine(QueryHandler(idx, Query(k=10, beam=32)),
                         batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS)
    try:
        eng.submit(Q[0]).wait(timeout=300)  # warm-up
        before = eng.stats
        start_phase()
        out, lat, qps = engine_closed_loop(eng, Q)
        after = eng.stats
        occ = ((after["occupancy_sum"] - before["occupancy_sum"])
               / max(1, after["batches"] - before["batches"]))
        same_rows([out[i] for i in range(len(Q))], range(len(Q)), want_d,
                  want_i, "serve-engine closed loop")
        order, answers, open_lat = engine_open_loop(
            eng, Q, n=SERVE_OPEN, qps=OPEN_LOAD * qps, seed=3)
        same_rows(answers, order, want_d, want_i, "serve-engine open loop")
        counts = launched("serve-engine")
        prof = profile_breakdown(
            f"serve-engine open loop, ~1 s at {OPEN_LOAD * qps:.0f} q/s",
            lambda: engine_open_loop(eng, Q, n=int(OPEN_LOAD * qps),
                                     qps=OPEN_LOAD * qps, seed=4))
    finally:
        eng.close()
    closed, opened = pcts(lat), pcts(open_lat)
    log(f"[serve-engine] BatchingEngine(batch {SERVE_BATCH}, max_wait "
        f"{SERVE_WAIT_MS} ms) over the 1M index, Query(k=10, beam=32): "
        f"closed loop {len(Q)} queries from {SERVE_THREADS} threads "
        f"{qps:.1f} q/s, p50 {closed['p50']:.3f} ms, p99 "
        f"{closed['p99']:.3f} ms, mean occupancy {occ:.3f}; every answer "
        f"bit-equal to its row of idx.plan(query)(test)")
    log(f"[serve-engine] open loop {SERVE_OPEN} Poisson arrivals at "
        f"{OPEN_LOAD * qps:.1f} q/s: p50 {opened['p50']:.3f} ms, p99 "
        f"{opened['p99']:.3f} ms, p999 {opened['p999']:.3f} ms; answers "
        f"bit-equal to the plan's rows")
    return dict(qps=qps, closed=closed, open=opened, occupancy=occ,
                counts=counts, profile=prof)


def phase_serve_churn(main: dict, data: np.ndarray, qps: float) -> dict:
    """(b) The engine with live writes over a ``from_arrays`` copy of the 1M
    index (``configs/pdasc.py``'s delta capacity 4,096 and compaction at
    half of it): 4,096 searches, 2,560 writes interleaved (upserts of
    resident rows + N(0, 0.01) noise, every fifth write a delete of an id
    upserted earlier), more upserts if those trip no swap, and a tail
    quarter of searches after the last write."""
    from repro_torch import obs
    from repro_torch.core.index import PDASCIndex
    from repro_torch.online import EpochHandle
    from repro_torch.query import Query
    from repro_torch.serving import BatchingEngine, QueryHandler

    q = Query(k=10, beam=32)
    Q = main["Qc"].cpu().numpy()
    idx = PDASCIndex.from_arrays(*main["idx"].to_arrays(), device="cuda")
    idx.enable_mutations(delta_capacity=SERVE_CHURN["delta_capacity"])
    handle = EpochHandle(idx, delta_fill=SERVE_CHURN["delta_fill"],
                         compact_kwargs=COMPACT_KW)
    rng = np.random.default_rng(5)
    n_search, n_writes = SERVE_CHURN["searches"], SERVE_CHURN["writes"]
    tail = n_search // 4
    head = n_search - tail
    write_at = np.sort(rng.choice(head, n_writes, replace=True))
    comp = obs.histogram(obs.names.ONLINE_COMPACTION_TIME)
    comp0 = comp.snapshot()
    eng = BatchingEngine(QueryHandler(handle, q), batch_size=SERVE_BATCH,
                         max_wait_ms=SERVE_WAIT_MS,
                         pad_payload=np.zeros(Q.shape[1], np.float32),
                         write_handler=handle.apply_writes)
    searches = []  # (engine request, query vector, submit seq, own id)
    deleted_at = {}  # id -> submit seq of its delete
    upserts = []  # (request, vector)
    seq = 0
    pending_checks = []
    t_sub, t_done = {}, {}

    def search(vec, own=None):
        nonlocal seq
        i = len(searches)
        t_sub[i] = time.perf_counter()
        req = eng.submit(vec, on_done=lambda r, i=i: t_done.__setitem__(
            i, time.perf_counter()))
        searches.append((req, vec, seq, own))
        seq += 1

    def upsert():
        nonlocal seq
        vec = data[rng.integers(len(data))] + rng.normal(
            0, SERVE_CHURN["noise"], data.shape[1]).astype(np.float32)
        upserts.append((eng.submit_upsert(vec), vec))
        seq += 1
        return len(upserts) - 1

    def delete():
        nonlocal seq
        while True:  # an id upserted earlier and not yet deleted
            j = int(rng.integers(len(upserts)))
            victim = int(np.asarray(upserts[j][0].wait(timeout=300))[0])
            if victim not in deleted_at:
                break
        deleted_at[victim] = seq
        eng.submit_delete(np.array([victim], np.int32)).wait(timeout=300)
        seq += 1

    try:
        eng.submit(Q[0]).wait(timeout=300)  # warm-up
        start_phase()
        gaps = rng.exponential(1.0 / (OPEN_LOAD * qps), n_search)
        w = 0
        t0 = time.perf_counter()
        next_at = t0
        for s in range(head):
            while w < n_writes and write_at[w] == s:
                if w % SERVE_CHURN["delete_every"] == 4 and upserts:
                    delete()
                else:
                    j = upsert()
                    if j % 16 == 15 and j < SERVE_CHURN["delta_capacity"] * \
                            SERVE_CHURN["delta_fill"] - 1:
                        # read-your-writes: the vector, searched right after
                        # its upsert (and before the swap), comes back first
                        pending_checks.append(len(searches))
                        search(upserts[j][1], own=j)
                w += 1
            next_at += gaps[s]
            delay = next_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            search(Q[rng.integers(len(Q))])
        extra = 0
        upserts[-1][0].wait(timeout=300)
        while handle.swaps == 0:  # the stream tripped no swap: keep writing
            upsert()
            extra += 1
            upserts[-1][0].wait(timeout=300)
            search(Q[rng.integers(len(Q))])
        tail_rows = rng.integers(0, len(Q), tail)
        first_tail = len(searches)
        for r in tail_rows:
            search(Q[r])
        answers = [req.wait(timeout=600) for req, _, _, _ in searches]
        wall = time.perf_counter() - t0
        counts = launched("serve-churn")
    finally:
        eng.close()
    ids = [np.asarray(u.wait(timeout=60)) for u, _ in upserts]
    for i in pending_checks:
        require(int(answers[i][1][0]) == int(ids[searches[i][3]][0]),
                f"read-your-writes: upsert {searches[i][3]} searched right "
                f"after it did not come back first")
    for (req, _, s, _), (_, got) in zip(searches, answers):
        late = [x for x in got.tolist() if deleted_at.get(x, seq) < s]
        require(not late, f"deleted ids {late} served after their delete")
    final = handle.current.plan(q)(_cuda(Q[tail_rows]))
    fd, fi = final.dists.cpu().numpy(), final.ids.cpu().numpy()
    same_rows(answers[first_tail:], range(tail), fd, fi,
              "serve-churn tail quarter")
    lat = [t_done[i] - t_sub[i] for i in range(len(searches))]
    c1 = comp.snapshot()
    swaps_s = c1["sum"] - comp0["sum"]
    n_swaps = c1["count"] - comp0["count"]
    require(n_swaps >= 1 and handle.swaps >= 1, "no epoch swap under traffic")
    p = pcts(lat)
    log(f"[serve-churn] {len(searches)} searches (open loop at "
        f"{OPEN_LOAD * qps:.1f} q/s) with {len(upserts)} upserts "
        f"({extra} past the planned {n_writes} writes to trip the swap) and "
        f"{len(deleted_at)} deletes through submit_upsert/submit_delete: "
        f"{wall:.3f} s, epoch swaps {handle.swaps} (epoch "
        f"{handle.current.epoch}), online_compaction_seconds {n_swaps} "
        f"swap(s) {swaps_s:.3f} s; search p50 {p['p50']:.3f} ms, p99 "
        f"{p['p99']:.3f} ms (the swap stall included), p999 "
        f"{p['p999']:.3f} ms; {len(pending_checks)} upserted vectors found "
        f"first right after their upsert, no deleted id served after its "
        f"delete, the tail {tail} answers bit-equal to the final epoch's plan")
    return dict(swaps=handle.swaps, swap_s=swaps_s, lat=p, extra=extra,
                counts=counts)


def make_tier(idx, query, fault_plan=None, **telemetry):
    """4 replicas of ``idx`` behind the router (``bench_serve._make_tier``'s
    tier and router knobs), each engine warmed; returns ``(replica set,
    router, device bytes the replicas added)``."""
    import torch
    from repro_torch.query import degraded
    from repro_torch.serving import ReplicaSet, Router, RouterConfig

    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    rs = ReplicaSet(idx, query, n_replicas=TIER["replicas"],
                    batch_size=TIER["batch"], max_wait_ms=TIER["wait_ms"],
                    degraded_query=degraded(query), fault_plan=fault_plan,
                    epoch_kwargs=dict(compact_kwargs=COMPACT_KW))
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - m0
    router = Router(rs, RouterConfig(
        deadline_s=5.0, max_retries=2, hedge=True, hedge_min_s=0.02,
        eject_failures=2, probe_cooldown_s=0.1, probe_timeout_s=0.25,
        probe_interval_s=0.02, seed=0, **telemetry))
    for req in [r.submit(r.probe_payload()) for r in rs.replicas]:
        req.wait(timeout=300)
    return rs, router, added


def host_contention(idx, Q) -> dict:
    """Plan calls (8 queries, beam 32, results to the host) a second from
    1, 2 and 4 threads at once: what several serving threads in one
    process cost each other (``tools/host_contention.py`` adds the
    diagnostic variants)."""
    from repro_torch.query import Query

    plan = idx.plan(Query(k=10, beam=32))
    x = _cuda(Q[:8])
    plan(x).ids.cpu()

    def rate(threads, calls):
        def work():
            for _ in range(calls):
                plan(x).ids.cpu()

        pool = [threading.Thread(target=work) for _ in range(threads)]
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=600)
        return threads * calls / (time.perf_counter() - t0)

    out = {f"{n} threads": rate(n, 30) for n in (1, 2, 4)}
    log(f"[serve-replicated] host contention, plan calls/s (8 queries, "
        f"beam 32, results to the host): "
        f"{json.dumps({k: round(v, 1) for k, v in out.items()})}")
    return out


def router_closed_loop(router, Q, *, workers: int = 8, per: int = 40):
    """Saturation q/s: every worker pinned in a search loop
    (``bench_serve._closed_loop_qps``)."""
    errors = []

    def worker(w):
        rng = np.random.default_rng(w)
        for _ in range(per):
            try:
                router.search(Q[rng.integers(len(Q))])
            except Exception as e:  # noqa: BLE001 — counted below
                errors.append(type(e).__name__)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(workers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return workers * per / (time.perf_counter() - t0), errors


def router_open_loop(router, Q, *, qps: float, n=None, seed: int,
                     stop=None):
    """Poisson arrivals at ``qps`` (``bench_serve._open_loop``): ``n`` of
    them, or until ``stop`` is set. Each request waits on its own thread.
    Returns ``(rows, results or None, error kinds)``."""
    rng = np.random.default_rng(seed)
    rows, results, errors, threads = [], [], [], []
    lock = threading.Lock()

    def fire(i, row):
        try:
            res = router.search(Q[row])
        except Exception as e:  # noqa: BLE001 — the caller-visible count
            with lock:
                errors.append(type(e).__name__)
            return
        results[i] = res

    next_at = time.perf_counter()
    i = 0
    while (n is None or i < n) and not (stop is not None and stop.is_set()):
        next_at += rng.exponential(1.0 / qps)
        delay = next_at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        row = int(rng.integers(len(Q)))
        rows.append(row)
        results.append(None)
        t = threading.Thread(target=fire, args=(i, row))
        t.start()
        threads.append(t)
        i += 1
    for t in threads:
        t.join(timeout=120)
    require(not any(t.is_alive() for t in threads), "a request hung")
    return rows, results, errors


def check_router_rows(rows, results, want_d, want_i, what: str) -> int:
    """Every answer served on the full plan equals the single plan's row;
    returns the count of degraded answers."""
    degraded = 0
    for row, res in zip(rows, results):
        if res is None:
            continue
        if res.degraded:
            degraded += 1
            continue
        require(np.array_equal(res.ids, want_i[row])
                and np.array_equal(res.dists, want_d[row]),
                f"{what}: replica r{res.replica}'s answer to query {row} "
                f"differs from the single plan's row")
    return degraded


def check_span_tree(trace) -> dict:
    """The exemplar's spans: every child inside its parent, and the
    self-times summing to the root's wall time within 10%. One exception,
    by the tracer's design (``repro``'s too): a hedged request's losing
    attempt ends when the winner returns, and the engine spans of its
    batch, already running, may end (or start) after it; they are counted,
    and the winning leg and the root hold every child inside."""
    names = set()
    total = 0.0
    overrun = 0

    def spans(span):
        yield span
        for c in span.children:
            yield from spans(c)

    # a losing leg's batch may still be running when the router returns:
    # wait (bounded) for every span to end before checking the tree
    deadline = time.monotonic() + 30.0
    while (any(sp.t1 is None for sp in spans(trace.root))
           and time.monotonic() < deadline):
        time.sleep(0.05)

    def visit(span, lost: bool) -> None:
        nonlocal total, overrun
        names.add(span.name)
        total += span.self_time
        for c in span.children:
            require(c.t1 is not None, f"span {c.name} never ended")
            inside = span.t0 <= c.t0 and c.t1 <= span.t1
            require(inside or lost, f"span {c.name} lies outside its "
                    f"parent {span.name}")
            overrun += not inside
            visit(c, lost or c.attrs.get("outcome") in ("cancelled",
                                                         "deadline"))

    visit(trace.root, False)
    for need in ("attempt", "queue_wait", "batch_wait", "execute", "plan"):
        require(need in names, f"the exemplar has no {need} span: "
                f"{sorted(names)}")
    wall = trace.root.duration
    require(abs(total - wall) <= 0.1 * wall,
            f"self-times sum to {total} s of a {wall} s request")
    return dict(names=sorted(names), wall_ms=wall * 1e3,
                self_sum_ms=total * 1e3, lost_leg_overruns=overrun)


def record_samples(estimator) -> list:
    """Wrap ``estimator.observe`` so that each sample it enqueues is also
    kept here as ``(payload, served ids)``: the check can then re-answer
    exactly the requests the estimate is made of."""
    kept = []
    observe = estimator.observe

    def spy(seq, payload, served_ids, **kw):
        took = observe(seq, payload, served_ids, **kw)
        if took:
            kept.append((np.array(payload, np.float32, copy=True),
                         np.asarray(served_ids).reshape(-1).copy()))
        return took

    estimator.observe = spy
    return kept


def check_shadow(sampled, reference, est, Q, gt, form) -> dict:
    """The shadow worker's own launch and its estimate. Each sampled query
    goes through the knn wrapper at b = 1 against the estimator's device
    reference (the live n: the shape the window launches, its many DB
    splits merged by ``knn_merge_kernel``), held to ``knn_ref`` under the
    tolerance rule. The estimate must then equal the served ids' recall
    against those answers exactly (same kernel, same inputs, bit-identical
    repeats), and against the ground truth's rows of the same queries:
    an answer set may differ from its truth row only where the plain 10th
    and 11th distances are a near-tie."""
    import torch
    from repro_torch.kernels import ref, topk

    vecs, ids = reference
    n, d = vecs.shape
    geo = topk.knn_geometry(1, n, d, 10, form)
    at = {Q[i].tobytes(): i for i in range(len(Q))}
    err, hits, hits_gt, tied = 0.0, 0, 0, 0
    for payload, served in sampled:
        row = at.get(payload.tobytes())
        require(row is not None, "a shadow sample is no test query")
        q = torch.from_numpy(payload[None]).cuda()
        err = max(err, parity_knn(q, vecs, 10, form))
        _, ki = topk.knn_cuda(q, vecs, 10, form)
        rd, _ = ref.knn_ref(q, vecs, 11, form)
        exact = set(ids[ki[0].cpu().numpy()].tolist())
        truth = set(gt[row].tolist())
        got = set(int(x) for x in served if x >= 0)
        hits += len(got & exact)
        hits_gt += len(got & truth)
        if exact != truth:
            r = rd[0].cpu().numpy().astype(np.float64)
            require(abs(r[10] - r[9]) <= atol_of(r[:10]) + 1e-5 * abs(r[9]),
                    f"query {row}: the shadow answer and the truth row "
                    f"differ without a near-tie at the 10th place")
            tied += 1
    m = len(sampled)
    require(m > 0 and est["queries"] == m and est["trials"] == 10 * m,
            f"the estimate holds {est['queries']} samples, {m} were enqueued")
    require(est["successes"] == hits,
            f"shadow estimate {est['successes']} hits vs {hits} re-answered")
    require(abs(hits_gt - hits) <= tied,
            f"shadow estimate {hits} hits vs {hits_gt} against the truth "
            f"rows of the same {m} queries ({tied} near-tied)")
    log(f"[serve-replicated] shadow knn at [1, {n}, {d}, 10] ({geo.route}, "
        f"{geo.splits} DB splits merged) against knn_ref on the {m} sampled "
        f"queries: max err {err:.3g}; estimate {hits}/{10 * m} = "
        f"{hits / (10 * m):.4f} equals the re-answered recall, and the "
        f"ground truth's rows of the same queries give {hits_gt}/{10 * m} "
        f"({tied} near-tied rows)")
    return dict(shape=[1, n, d, 10], splits=geo.splits, max_abs_err=err,
                samples=m, recall=hits / (10 * m),
                recall_truth=hits_gt / (10 * m))


def live_ids(rep) -> np.ndarray:
    from repro_torch.online import live_dataset

    return np.sort(live_dataset(rep.handle.current)[1])


def flush(rs) -> None:
    """Wait until every live replica applied the writes queued before
    now (a search queued after them is answered after them)."""
    for r in rs.replicas:
        if r.alive:
            r.submit(r.probe_payload()).wait(timeout=600)


def phase_serve_replicated(main: dict, data: np.ndarray) -> dict:
    """(c) ``bench_serve.py``'s tier at 1M: 4 replicas sharing the index,
    the fault-free run with tracing (1 in 4) and shadow recall (1 in 16),
    writes below the compaction threshold, kill + restart of a replica;
    then (d) upserts that carry every replica past ``delta_fill=0.5``
    under the same traffic; then the wedged run on a fresh tier."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.query import Query
    from repro_torch.serving import FaultPlan

    idx, res = main["idx"], main["res"]
    Q = main["Qc"].cpu().numpy()
    q = Query(k=10, beam=32)
    want_d, want_i = res.dists.cpu().numpy(), res.ids.cpu().numpy()
    resident = idx.memory_bytes()["total_resident"]
    out = dict(contention=host_contention(idx, Q))
    rs, router, added = make_tier(idx, q, trace_every=TRACE_EVERY,
                                  shadow_every=SHADOW_EVERY)
    try:
        require(added < 0.05 * resident, f"4 replicas added {added} bytes "
                f"on the device (index {resident} resident)")
        start_phase()
        sat, errs = router_closed_loop(router, Q)
        require(not errs, f"closed loop errors: {errs[:5]}")
        # the estimate and the check below cover the open loop's samples
        # only: the closed loop's are answered before the reset
        require(router.quality.drain(timeout=300), "shadow queue never drained")
        router.quality.reset_stats()
        sampled = record_samples(router.quality)
        rows, results, errs = router_open_loop(
            router, Q, qps=OPEN_LOAD * sat, n=TIER["open"], seed=11)
        require(not errs, f"fault-free open loop errors: {errs}")
        deg = check_router_rows(rows, results, want_d, want_i, "fault-free")
        lat = pcts([r.latency_s for r in results])
        require(router.quality.drain(timeout=300), "shadow queue never drained")
        est = router.quality.estimate()
        # the estimator's device reference of the live set it answered on
        reference = router.quality._ref
        require(reference is not None
                and reference[0].shape[0] == idx.n_points,
                "the shadow reference is not the live set")
        gt = main["gt"]
        offline = float(np.mean([
            len(set(r.ids.tolist()) & set(gt[row].tolist())) / 10
            for row, r in zip(rows, results)]))
        require(est["recall"] is not None
                and abs(est["recall"] - offline) <= 0.05,
                f"shadow recall {est['recall']} vs offline {offline}")
        ex = router.traces.exemplar(lat["p99"] / 1e3)
        require(ex is not None, "no trace was retained")
        tree = check_span_tree(ex)
        events = router.event_counts()
        log(f"[serve-replicated] {TIER['replicas']} replicas of the 1M index "
            f"(batch {TIER['batch']}, max_wait {TIER['wait_ms']} ms, "
            f"bench_serve's router): the replicas added {added} bytes on "
            f"the device ({100 * added / resident:.3f}% of the index's "
            f"{resident}); closed-loop saturation {sat:.1f} q/s; fault-free "
            f"open loop {TIER['open']} at {OPEN_LOAD * sat:.1f} q/s: errors "
            f"0, p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms, p999 "
            f"{lat['p999']:.3f} ms, degraded {deg}, events {events}; "
            f"answers on the full plan equal the single plan's rows")
        log(f"[serve-replicated] shadow recall {est['recall']:.4f} "
            f"[{est['wilson_lo']:.4f}, {est['wilson_hi']:.4f}] over "
            f"{est['queries']} samples vs offline {offline:.4f} over the "
            f"{len(rows)} served; p99 exemplar {tree['wall_ms']:.3f} ms, "
            f"spans {tree['names']}, self-times sum {tree['self_sum_ms']:.3f}"
            f" ms, {tree['lost_leg_overruns']} span(s) of a losing leg "
            f"outside their parent")
        log("[serve-replicated] p99 exemplar:\n" + ex.render())
        out["fault_free"] = dict(sat=sat, lat=lat, degraded=deg,
                                 shadow=est["recall"], offline=offline,
                                 added=added)
        # writes below the compaction threshold, then kill + restart
        rng = np.random.default_rng(12)
        new = []
        for _ in range(TIER["upserts"]):
            vec = data[rng.integers(len(data))] + rng.normal(
                0, 0.01, data.shape[1]).astype(np.float32)
            new += [int(x) for x in rs.upsert(vec)]
        for victim in rng.choice(new, TIER["deletes"], replace=False):
            require(int(rs.delete(np.array([victim]))) == 1, "delete missed")
        flush(rs)
        ref = live_ids(rs.replicas[0])
        for r in rs.replicas[1:]:
            require(np.array_equal(live_ids(r), ref),
                    f"replica r{r.id}'s live set differs from r0's")
        rs.kill(3)
        rs.restart(3)
        flush(rs)
        require(np.array_equal(live_ids(rs.replicas[3]), ref),
                "the restarted replica did not converge")
        counts = launched("serve-replicated")
        # launched after the window's read: a comparison launches no count
        out["shadow"] = check_shadow(sampled, reference, est, Q, gt,
                                     ops.resolve_form(idx.distance))
        del reference
        log(f"[serve-replicated] {TIER['upserts']} upserts + "
            f"{TIER['deletes']} deletes through the replica set: the 4 "
            f"live sets equal ({len(ref)} ids); kill(3) + restart(3) "
            f"replays the log to the same live set")
        out["swap"] = serve_replicated_swap(rs, router, Q, data, sat)
    finally:
        router.close(close_replicas=True)
    del rs, router
    torch.cuda.empty_cache()

    rs, router, _ = make_tier(idx, q, FaultPlan.parse(WEDGE))
    try:
        start_phase()
        rows, results, errs = router_open_loop(
            router, Q, qps=OPEN_LOAD * sat, n=TIER["open"], seed=13)
        require(not errs, f"wedged run: {len(errs)} caller-visible errors "
                f"{sorted(set(errs))}")
        t0 = time.time()
        while router.event_counts().get("readmit", 0) == 0 \
                and time.time() - t0 < 60:
            router.search(Q[0])  # light traffic until the probe readmits
            time.sleep(0.05)
        events = router.event_counts()
        require(events.get("eject", 0) > 0 and events.get("readmit", 0) > 0,
                f"the wedged run's events hold no eject + readmit: {events}")
        deg = check_router_rows(rows, results, want_d, want_i, "wedged")
        lat = pcts([r.latency_s for r in results])
        counts_w = launched("serve-replicated-wedge")
    finally:
        router.close(close_replicas=True)
    log(f"[serve-replicated] wedged ({WEDGE}) open loop {TIER['open']} at "
        f"{OPEN_LOAD * sat:.1f} q/s: errors 0, p50 {lat['p50']:.3f} ms, p99 "
        f"{lat['p99']:.3f} ms, p999 {lat['p999']:.3f} ms, degraded {deg}, "
        f"events {events}")
    out["wedged"] = dict(lat=lat, degraded=deg, events=events)
    out["counts"] = dict(counts, wedge=counts_w)
    return out


def serve_replicated_swap(rs, router, Q, data, sat) -> dict:
    """(d) The fault-free traffic goes on at the same rate while batches of
    upserts through the replica set carry all four replicas past
    ``delta_fill=0.5``: every replica compacts at the same write, on its
    engine's worker. What the callers see is printed, not required."""
    from repro_torch import obs
    from repro_torch.query import Query

    q = Query(k=10, beam=32)
    snap0 = obs.snapshot()
    ev0 = router.event_counts()
    stop = threading.Event()
    box = {}
    start_phase()
    t0 = time.perf_counter()
    traffic = threading.Thread(target=lambda: box.update(zip(
        ("rows", "results", "errors"),
        router_open_loop(router, Q, qps=OPEN_LOAD * sat, seed=14,
                         stop=stop))))
    traffic.start()
    rng = np.random.default_rng(15)
    # just enough upserts to carry each replica's delta cursor past the
    # trigger once: the replicas apply one log, so all trip at its last
    delta = rs.replicas[0].handle.current.delta
    need = int(np.ceil(delta.capacity * 0.5)) - delta.size
    n_up = 0
    try:
        while n_up < need:
            src = rng.integers(len(data), size=min(SWAP_UPSERT_BATCH,
                                                   need - n_up))
            rs.upsert(data[src] + rng.normal(
                0, 0.01, (len(src), data.shape[1])).astype(np.float32),
                timeout=600)
            n_up += len(src)
        deadline = time.time() + 600
        while not all(r.handle.swaps >= 1 for r in rs.replicas):
            require(time.time() < deadline, "the replicas never compacted")
            time.sleep(0.05)
        time.sleep(0.5)  # traffic on past the last swap
    finally:
        stop.set()
        traffic.join(timeout=300)
    swap_wall = time.perf_counter() - t0
    rows, results, errors = box["rows"], box["results"], box["errors"]
    ok = [r for r in results if r is not None]
    lat = pcts([r.latency_s for r in ok]) if ok else {}
    ev = router.event_counts()
    ev_delta = {k: v - ev0.get(k, 0) for k, v in ev.items()
                if v != ev0.get(k, 0)}
    snap = obs.snapshot()

    def total(s, name):
        e = s.get(name)
        return sum(r["value"] for r in e["series"]) if e else 0.0

    misses = total(snap, obs.names.ROUTER_DEADLINE_EXCEEDED) - total(
        snap0, obs.names.ROUTER_DEADLINE_EXCEEDED)
    comp = snap[obs.names.ONLINE_COMPACTION_TIME]["series"][0]["hist"]
    flush(rs)
    ref = live_ids(rs.replicas[0])
    for r in rs.replicas[1:]:
        require(np.array_equal(live_ids(r), ref),
                f"replica r{r.id}'s live set differs after the swap")
    counts = launched("serve-replicated-swap")
    # answers after every swap against each replica's new epoch
    wants = {}
    for r in rs.replicas:
        res = r.handle.current.plan(q)(_cuda(Q))
        wants[r.id] = (res.dists.cpu().numpy(), res.ids.cpu().numpy())
    prow, pres, perr = router_open_loop(router, Q, qps=OPEN_LOAD * sat,
                                        n=TIER["open"] // 3, seed=16)
    checked = 0
    for row, res in zip(prow, pres):
        if res is None or res.degraded:
            continue
        wd, wi = wants[res.replica]
        require(np.array_equal(res.ids, wi[row])
                and np.array_equal(res.dists, wd[row]),
                f"after the swap, r{res.replica}'s answer to query {row} "
                f"differs from its new epoch's plan")
        checked += 1
    kinds = {k: errors.count(k) for k in sorted(set(errors))}
    require(all(r.handle.swaps == 1 for r in rs.replicas),
            f"swaps {[r.handle.swaps for r in rs.replicas]}: not one each")
    log(f"[serve-replicated-swap] {n_up} upserts in batches of "
        f"{SWAP_UPSERT_BATCH} carried all 4 replicas past delta_fill 0.5 "
        f"under open-loop traffic at {OPEN_LOAD * sat:.1f} q/s: window "
        f"{swap_wall:.3f} s, {len(rows)} requests, caller-visible errors "
        f"{len(errors)} {kinds}, deadline misses {misses:.0f}, router events "
        f"{ev_delta}, p50 {lat.get('p50', float('nan')):.3f} ms, p99 "
        f"{lat.get('p99', float('nan')):.3f} ms, p999 "
        f"{lat.get('p999', float('nan')):.3f} ms; compactions so far "
        f"{comp['count']} ({comp['sum']:.3f} s in all); epochs "
        f"{[r.handle.current.epoch for r in rs.replicas]}, live sets equal "
        f"({len(ref)} ids); after the swap {checked} answers equal their "
        f"replica's new epoch ({len(perr)} errors)")
    return dict(errors=len(errors), kinds=kinds, misses=misses,
                events=ev_delta, lat=lat, window_s=swap_wall, upserts=n_up,
                requests=len(rows), counts=counts)


def parse_prometheus(text: str) -> int:
    """Count the samples of a Prometheus text exposition; fail on a line
    that is neither a comment nor ``name{labels} value``."""
    import re

    sample = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|'
        r'\\.)*",?)*\})? [-+]?([0-9.eE+-]+|Inf|NaN)$')
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        require(sample.match(line) is not None,
                f"to_prometheus line does not parse: {line!r}")
        n += 1
    return n


def phase_serve_two_stage(main: dict, workdir: str) -> dict:
    """(e) The engine over the released int8 index's two-stage plan with
    ``launch/serve.py``'s prefetch hook: 1,000 requests, 1 in 4 traced;
    the registry's snapshot, its Prometheus text and the offline report;
    the throughput with the registry on and off."""
    from repro_torch import obs
    from repro_torch.launch.serve import granule_prefetch
    from repro_torch.query import Query
    from repro_torch.serving import BatchingEngine, QueryHandler

    idx = main["idx"]
    Q = main["Qc"].cpu().numpy()
    q = Query(k=10, execution="two_stage")
    want = idx.plan(q)(main["Qc"])
    want_d, want_i = want.dists.cpu().numpy(), want.ids.cpu().numpy()
    eng = BatchingEngine(QueryHandler(idx, q), batch_size=SERVE_BATCH,
                         max_wait_ms=SERVE_WAIT_MS,
                         pad_payload=np.zeros(Q.shape[1], np.float32),
                         prefetch_fn=granule_prefetch(idx, batch=SERVE_BATCH,
                                                      beam=32))
    sampler = obs.TraceSampler(TRACE_EVERY, buffer=obs.TraceBuffer(
        maxlen=len(Q)))
    try:
        eng.submit(Q[0]).wait(timeout=300)
        start_phase()
        out, lat, qps = engine_closed_loop(
            eng, Q, span_of=lambda i: sampler.sample("request", i,
                                                     kind="search"))
        counts = launched("serve-two-stage")
        same_rows([out[i] for i in range(len(Q))], range(len(Q)), want_d,
                  want_i, "serve-two-stage")
        traces = sampler.buffer.traces()
        require(len(traces) == len(Q) // TRACE_EVERY,
                f"{len(traces)} traces retained")
        for tr in traces:
            names = {s.name for s in tr.root.walk()}
            for need in ("execute", "plan", "descend", "scan", "rerank",
                         "granule_fetch"):
                require(need in names, f"trace {tr.seq} has no {need} span")
        snap = obs.snapshot()
        n_series = sum(len(v["series"]) for v in snap.values())
        subs = sorted({obs.names.subsystem(k) for k in snap})

        def nonzero(sub):
            return sum(r.get("value", 0) or r.get("hist", {}).get("count", 0)
                       for k, v in snap.items()
                       if obs.names.subsystem(k) == sub
                       for r in v["series"])

        for sub in ("engine", "router", "plan", "store", "online"):
            require(nonzero(sub) > 0, f"the {sub} series are all zero")
        require(n_series >= 25 and len(subs) >= 5,
                f"{n_series} series over {subs}")
        n_samples = parse_prometheus(obs.to_prometheus(snap))
        m_path = os.path.join(workdir, "serve_metrics.json")
        t_path = os.path.join(workdir, "serve_traces.json")
        with open(m_path, "w") as f:
            f.write(obs.to_json(snap))
        with open(t_path, "w") as f:
            f.write(sampler.buffer.to_json())
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", "--metrics",
             m_path, "--trace", t_path], capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=SRC))
        require(rep.returncode == 0 and "series" in rep.stdout,
                f"obs.report failed: {rep.stderr[-2000:]}")
        # the registry on and off, untraced, in turns (off, on, on, off)
        rates = {True: [], False: []}
        for on in (False, True, True, False):
            obs.set_enabled(on)
            rates[on].append(engine_closed_loop(eng, Q)[2])
        obs.set_enabled(True)
    finally:
        obs.set_enabled(True)
        eng.close()
        if idx.store.exact._pool is not None:
            idx.store.exact._pool.close()
    ex = sampler.buffer.exemplar(float(np.percentile(lat, 99)))
    p = pcts(lat)
    on, off = float(np.mean(rates[True])), float(np.mean(rates[False]))
    log(f"[serve-two-stage] engine over Query(k=10, execution='two_stage') "
        f"on the released int8 index with the prefetch hook: {len(Q)} "
        f"requests from {SERVE_THREADS} threads, 1 in {TRACE_EVERY} traced: "
        f"{qps:.1f} q/s, p50 {p['p50']:.3f} ms, p99 {p['p99']:.3f} ms; "
        f"answers bit-equal to the plan's rows; {len(traces)} traces each "
        f"with descend, scan, rerank and granule_fetch")
    log(f"[serve-two-stage] registry: {n_series} series over {subs}, "
        f"{n_samples} Prometheus samples parsed; python -m "
        f"repro_torch.obs.report rendered the snapshot and "
        f"{len(traces)} traces ({len(rep.stdout.splitlines())} lines)")
    log(f"[serve-two-stage] untraced closed loop, registry on "
        f"{[round(r, 1) for r in rates[True]]} q/s vs off "
        f"{[round(r, 1) for r in rates[False]]} q/s: ratio {on / off:.3f} "
        f"(a wall-clock ratio, printed only)")
    log("[serve-two-stage] p99 exemplar:\n" + ex.render())
    return dict(qps=qps, lat=p, n_series=n_series, subsystems=subs,
                on_off=on / off, counts=counts)


SERVE_CLI = ["--n", "200000", "--gl", "256", "--queries", "256", "--batch",
             "32", "--trace-sample", "8", "--shadow-sample", "16"]
SERVE_CLI_PATHS = {  # (f): the beam index, with churn
    "single": ["--mode", "beam", "--churn", "64"],
    "replicated": ["--mode", "beam", "--replicas", "3", "--faults",
                   "wedge:r1@20+8:0.4", "--churn", "12"]}
REMOTE_CLI = ["--mode", "two_stage", "--store", "remote", "--store-block",
              str(STORE_BLOCK), "--remote-latency-ms",
              str(REMOTE["latency_ms"]), "--remote-cache-granules",
              str(REMOTE["cache_granules"])]
SERVE_CLI_REMOTE_PATHS = {  # (i): --store remote, half (f)'s queries
    "remote-single": REMOTE_CLI + ["--queries", "128"],
    "remote-replicated": REMOTE_CLI + ["--queries", "128", "--replicas", "3",
                                       "--faults", "wedge:r1@20+8:0.4"]}


def phase_serve_cli(paths: dict, tag: str = "serve-cli") -> dict:
    """``python -m repro_torch.launch.serve`` on each of ``paths``, as
    subprocesses on the card: (f) the beam index on both paths, (i) the
    remote payload tier on both."""
    out = {}
    base = SERVE_CLI
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        for name, extra in paths.items():
            cmd = [sys.executable, "-m", "repro_torch.launch.serve", *base,
                   *extra, "--metrics-dump", os.path.join(work, f"{name}.json")]
            t0 = time.perf_counter()
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600, cwd=HERE,
                                 env=dict(os.environ, PYTHONPATH=SRC))
            secs = time.perf_counter() - t0
            lines = [ln for ln in run.stdout.splitlines()
                     if "recall" in ln or "errors=" in ln
                     or "built on" in ln or "warm-up" in ln]
            require(run.returncode == 0, f"serve CLI ({name}) exited "
                    f"{run.returncode}: {run.stderr[-3000:]}")
            require(any("recall" in ln for ln in lines),
                    f"serve CLI ({name}) printed no recall line")
            if "remote" in name:
                require("remote exact tier" in run.stdout,
                        f"serve CLI ({name}) served no remote tier")
            if name.endswith("replicated"):
                require(any("errors=0" in ln for ln in lines),
                        f"serve CLI (replicated): {lines}")
            require(os.path.getsize(os.path.join(work, f"{name}.json")) > 0,
                    f"serve CLI ({name}) dumped no metrics")
            for ln in lines:
                log(f"[{tag}] {name}: {ln}")
            log(f"[{tag}] {name}: exit 0 in {secs:.1f} s")
            out[name] = dict(secs=secs, lines=lines)
    return out


def phase_recall_record() -> float:
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.data import make_dataset
    from repro_torch.query import Query

    data = make_dataset("dense_embed", n=7800 + 512, seed=0)
    train, test = data[:7800], data[7800:]
    idx = PDASCIndex.build(train, gl=256, distance="euclidean",
                           radius_quantile=0.35, device="cuda")
    res = idx.plan(Query(k=10, beam=32))(test)
    _, gt = exact_knn(test, train, k=10, device="cuda")
    torch.cuda.synchronize()
    rec = recall(res.ids.cpu().numpy(), gt.cpu().numpy())
    log(f"[record] dense_embed n=7800 gl=256 euclidean beam=32, 512 queries: "
        f"recall@10 {rec:.4f} (floor {RECALL_FLOOR}; repro on the CPU "
        f"records 0.904)")
    require(rec >= RECALL_FLOOR, f"recall@10 {rec:.4f} < {RECALL_FLOOR}")
    return rec


def phase_quickstart() -> dict:
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.data import make_dataset
    from repro_torch.query import Query

    out = {}

    def run(name, train, test, gl, distance, quantile, execution):
        idx = PDASCIndex.build(train, gl=gl, distance=distance,
                               radius_quantile=quantile, device="cuda")
        res = idx.plan(Query(k=10, execution=execution))(test)
        _, gt = exact_knn(test, train, distance=distance, k=10, device="cuda")
        out[name] = recall(res.ids.cpu().numpy(), gt.cpu().numpy())
        require(np.isfinite(res.dists.cpu().numpy()).all(),
                f"{name}: non-finite distances")
        log(f"[quickstart] {name:10s} ({execution}) recall@10 = "
            f"{out[name]:.3f}, mean candidates "
            f"{float(res.n_candidates.float().mean()):.0f} of {len(train)}")

    data = make_dataset("dense_embed", n=6000, seed=0)
    for distance in ("euclidean", "manhattan", "chebyshev", "cosine"):
        run(distance, data[:5900], data[5900:5950], 256, distance, 0.35, "auto")
    geo = make_dataset("geo_clusters", n=3000, seed=1)
    run("haversine", geo[:2900], geo[2900:2950], 60, "haversine", 0.5, "dense")
    docs = np.abs(make_dataset("sparse_highdim", n=3000, seed=2))
    run("jaccard", docs[:2900], docs[2900:2950], 128, "jaccard", 0.6, "dense")
    return out


# ---------------------------------------------------------------------------
# (g) the distributed deployment: 4 rank processes on the one card
# ---------------------------------------------------------------------------


def rank_distributed(rank: int, world: int, *, work: str, radius: float,
                     dead: np.ndarray, retrieval_seed: int) -> dict:
    """One rank of phase (g), run by ``launch.ranks.run_ranks`` in its own
    process (a ``gloo`` group; the rank's index and kernels on the card).
    Each window zeroes the rank's launch counts just before its work and
    reads them just after; the results come back as numpy."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import distances as dist_lib
    from repro_torch.core import distributed as dd
    from repro_torch.core import nsa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recsys as rec
    from repro_torch.query import Query, compile_sharded_plan
    from repro_torch.store import LeafStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    data = np.load(os.path.join(work, "dist_data.npy"), mmap_mode="r")
    Qc = torch.from_numpy(np.load(os.path.join(work, "dist_q.npy"))).cuda()
    mesh = make_mesh((world,), ("data",))
    shard = dd.shard_index(mesh, ("data",))
    per = data.shape[0] // world
    out = dict(shard=shard, launches={}, secs={}, merge_ms={}, res={})

    def window(name, fn):
        torch.cuda.synchronize()
        tdist.barrier()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out["secs"][name] = time.perf_counter() - t0
        out["launches"][name] = ops.launch_counts()
        return got

    def keep(name, pair):
        out["res"][name] = tuple(t.cpu().numpy() for t in pair)

    local = window("dist-build", lambda: dd.build_sharded(
        data, mesh, gl=256, distance="euclidean", method="pam",
        group_chunk=GROUP_CHUNK, device="cuda"))
    mc = dd.max_children_sharded(local, mesh)
    out["max_children"] = mc
    plans = {mode: compile_sharded_plan(
        mesh, Query(k=10, radius=radius, execution=mode, beam=32),
        dist="euclidean", max_children=mc if mode == "beam" else None)
        for mode in ("dense", "beam")}

    def search():
        for mode, plan in plans.items():
            plan(local, Qc)  # the first call
            torch.cuda.synchronize()
            tdist.barrier()
            t0 = time.perf_counter()
            res = plan(local, Qc)
            torch.cuda.synchronize()
            out["secs"][f"plan-{mode}-2nd"] = time.perf_counter() - t0
            keep(mode, (res.dists, res.ids))
            out["res"][f"{mode}_ncand"] = (res.n_candidates.cpu().numpy(),)

    window("dist-search", search)

    # the merges alone, on this rank's unmerged beam result
    loc = nsa.search_beam(local, Qc, dist=dist_lib.get("euclidean"), k=10,
                          r=radius,
                          beam=32, max_children=mc)
    gids = torch.where(loc.ids >= 0, loc.ids + shard * per, -1).to(
        torch.int32)
    grid = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    for method in ("butterfly", "allgather"):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            tdist.barrier()
            t0 = time.perf_counter()
            merged = dd.topk_merge(loc.dists, gids, mesh, ("data",), 10,
                                   method=method)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["merge_ms"][method] = float(np.median(times)) * 1e3
        keep(f"merge_{method}", merged)
        keep(f"merge2_{method}", dd.topk_merge(
            loc.dists, gids, grid, ("data", "model"), 10, method=method))

    truth = window("dist-truth", lambda: dd.exact_knn_sharded(
        data, Qc, mesh, distance="l2", k=10))
    keep("truth", truth)
    torch.cuda.synchronize()
    tdist.barrier()
    t0 = time.perf_counter()
    dd.exact_knn_sharded(data, Qc, mesh, distance="l2", k=10)
    torch.cuda.synchronize()
    out["secs"]["truth-2nd"] = time.perf_counter() - t0
    prof = profile_breakdown(f"rank {rank} sharded beam plan",
                             lambda: plans["beam"](local, Qc))
    out["busy"] = (prof["busy_ms"], prof["wall_ms"])

    routed = dict(dd.route_writes(dead, world, per))
    sv = torch.from_numpy(dd.local_slot_valid(
        local.leaf_ids.cpu().numpy(), routed.get(shard, []))).cuda()
    res = window("dist-deleted", lambda: plans["beam"](local, Qc,
                                                       slot_valid=sv))
    keep("deleted", (res.dists, res.ids))

    codes = np.load(os.path.join(work, "dist_codes.npy"), mmap_mode="c")
    store = LeafStore(backend="int8", block=STORE_BLOCK,
                      codes=torch.from_numpy(codes),
                      scales=torch.from_numpy(np.load(
                          os.path.join(work, "dist_scales.npy"))),
                      exact=None)
    codes_l, scales_l = (t.cuda() for t in dd.shard_payload(store, mesh))
    ci = torch.from_numpy(np.load(os.path.join(work, "dist_ci.npy"))).cuda()
    ok = torch.from_numpy(np.load(os.path.join(work, "dist_ok.npy"))).cuda()
    keep("scan", window("dist-scan", lambda: dd.scan_quantized_sharded(
        codes_l, scales_l, Qc, ci, ok, mesh, k=10, block=STORE_BLOCK)))

    # the recsys retrieval over the same ranks: each takes its row block of
    # the candidates, the lists merge over "data" (the butterfly)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params, user = retrieval_model(retrieval_seed)
    cand = retrieval_candidates(retrieval_seed)
    torch.cuda.synchronize()
    out["secs"]["retrieval-setup"] = time.perf_counter() - t0
    with torch.no_grad():
        keep("retrieval", window("dist-retrieval", lambda: rec.retrieval_step(
            params, user, cand, cfg, mesh, k=100, cand_axes=("data",))))
        torch.cuda.synchronize()
        tdist.barrier()
        t0 = time.perf_counter()
        rec.retrieval_step(params, user, cand, cfg, mesh, k=100,
                           cand_axes=("data",))
        torch.cuda.synchronize()
        out["secs"]["retrieval-2nd"] = time.perf_counter() - t0
    return out


def retrieval_model(seed: int):
    """(g)'s recsys user: ``RETRIEVAL_ARCH`` at full width, weights from a
    CUDA generator of ``seed`` (every rank and the parent draw the same),
    and one user's batch."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batch
    from repro_torch.data.pipeline import place
    from repro_torch.models import recsys as rec

    cfg = get_arch(RETRIEVAL_ARCH).config_fn()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = rec.init_params(cfg, gen, device="cuda")
    return cfg, params, place(recsys_batch(1, 1, cfg, seed=seed), "cuda")


def retrieval_candidates(seed: int):
    """``N_RETRIEVAL`` x 64 candidates drawn on the card from a CUDA
    generator of ``seed``: (g)'s ranks and parent and (l) each make
    theirs there, as a retrieval server holds them, with no host copy."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((N_RETRIEVAL, 64), generator=gen, device="cuda")


def phase_distributed(work: str) -> dict:
    """(g) The sharded deployment: ``DIST_RANKS`` rank processes on the one
    card build, search, merge and scan; held to single-process runs of the
    same functions on the same 1,024,000 rows."""
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.core import nsa
    from repro_torch.core.index import PDASCIndex
    from repro_torch.data import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.ranks import run_ranks

    t0 = time.perf_counter()
    full = make_dataset("dense_embed", n=N_DIST + N_QUERIES, seed=0)
    data, test = full[:N_DIST], full[N_DIST:]
    np.save(os.path.join(work, "dist_data.npy"), data)
    np.save(os.path.join(work, "dist_q.npy"), test)
    log(f"[dist] data made and written in {time.perf_counter() - t0:.1f} s "
        f"(set-up)")
    Qc = _cuda(test)
    # one index over all rows: the replicated descent of the payload scan,
    # and the radius the shards search with (the build's rule)
    idx = PDASCIndex.build(data, gl=256, distance="euclidean",
                           radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                           store="int8", store_block=STORE_BLOCK,
                           device="cuda")
    ci, ok = nsa.descend_beam(idx.data, Qc, dist=idx.distance,
                              r=idx.default_radius, beam=32,
                              max_children=idx.max_children)
    d1, s1 = ops.scan_quantized(Qc, idx.store.codes, idx.store.scales, ci, ok,
                                "euclidean", k=10, block=STORE_BLOCK)
    g1 = torch.where(d1 < BIG / 2, torch.gather(ci, 1, s1.long()), -1)
    for name, arr in (("codes", idx.store.codes), ("scales", idx.store.scales),
                      ("ci", ci), ("ok", ok)):
        np.save(os.path.join(work, f"dist_{name}.npy"), arr.cpu().numpy())
    radius = float(idx.default_radius)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gd, gt = exact_knn(Qc, data, k=10, device="cuda")
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    exact_knn(Qc, data, k=10, device="cuda")
    torch.cuda.synchronize()
    single_ms2 = (time.perf_counter() - t0) * 1e3
    gd, gt = gd.cpu().numpy(), gt.cpu().numpy()
    data_c = _cuda(data)  # the table resident: the knn launch and the copies
    exact_knn(Qc, data_c, k=10, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact_knn(Qc, data_c, k=10, device="cuda")
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) * 1e3
    del data_c
    dead = np.random.default_rng(7).choice(N_DIST, DIST_DELETES,
                                           replace=False)
    del idx

    t0 = time.perf_counter()
    outs = run_ranks(f"{os.path.abspath(__file__)}:rank_distributed",
                     DIST_RANKS, workdir=work,
                     kwargs=dict(work=work, radius=radius, dead=dead,
                                 retrieval_seed=0),
                     timeout=900)
    wall = time.perf_counter() - t0
    # every window launched its kernels in every rank
    for name, kernels in WINDOW_KERNELS.items():
        if not name.startswith("dist-"):
            continue
        total = {k: sum(o["launches"][name][k] for o in outs)
                 for k in KERNELS}
        PHASE_LAUNCHES[name] = total
        for o in outs:
            for k in kernels:
                require(o["launches"][name][k] > 0,
                        f"rank {o['shard']}: kernel {k} never launched in "
                        f"{name}")
        log(f"[{name}] kernel launches per rank: "
            f"{[o['launches'][name] for o in outs]}")
    # every rank's every result is bit-identical
    for o in outs[1:]:
        for key, arrs in outs[0]["res"].items():
            for a, b in zip(arrs, o["res"][key]):
                require(np.array_equal(a, b),
                        f"ranks 0 and {o['shard']} differ on {key}")
    res = outs[0]["res"]
    for method in ("butterfly", "allgather"):
        for key in (f"merge_{method}", f"merge2_{method}"):
            for a, b in zip(res[key], res["merge_butterfly"]):
                require(np.array_equal(a, b), f"{key} != the butterfly")
    for a, b in zip(res["merge_butterfly"], res["beam"]):
        require(np.array_equal(a, b), "merged beam != the sharded beam plan")
    # the sharded exact k-NN against one process's exact_knn, as sets
    td, ti = res["truth"]
    check_exact_sets(types.SimpleNamespace(ids=torch.from_numpy(ti),
                                           dists=torch.from_numpy(td)), gd, gt)
    values_agree(td, gd, squared=True)
    recalls = {m: recall(res[m][1], ti) for m in ("dense", "beam")}
    dead_hit = set(dead.tolist()) & set(res["deleted"][1].ravel().tolist())
    require(not dead_hit, f"deleted ids returned: {sorted(dead_hit)[:10]}")
    sd, si = res["scan"]
    err_scan = topk_agree(sd, si, d1.cpu().numpy(), g1.cpu().numpy(), sd)
    # the sharded retrieval against one process's retrieval_step
    from repro_torch.kernels import ref
    from repro_torch.models import recsys as rec

    t0 = time.perf_counter()
    cfg, params, user = retrieval_model(0)
    cand_c = retrieval_candidates(0)
    with torch.no_grad():
        u = rec.user_vector(params, user, cfg)
        want_s, want_i = rec.retrieval_step(params, user, cand_c, cfg, k=100)
    rs, ri = res["retrieval"]
    again = -(cand_c[torch.from_numpy(ri[0]).long().cuda()] @ u[0])[None]
    err_retr = topk_agree(-rs, ri, -want_s.cpu().numpy(),
                          want_i.cpu().numpy(), again.cpu().numpy())
    rd_ref, ri_ref = ref.knn_ref(u, cand_c, 100, "dot")
    topk_agree(-rs, ri, rd_ref.cpu().numpy(), ri_ref.cpu().numpy(),
               again.cpu().numpy())
    del params, cand_c
    check_s = sync_s(t0)
    build = [o["secs"]["dist-build"] for o in outs]
    secs = outs[0]["secs"]
    busy = [o["busy"] for o in outs]
    log(f"[dist] {DIST_RANKS} rank processes on one card (gloo, mesh "
        f"({DIST_RANKS},) 'data'), dense_embed n={N_DIST} ({N_DIST // DIST_RANKS}"
        f" rows a rank), {len(test)} queries; ranks started and ran in "
        f"{wall:.1f} s; every rank's results bit-identical")
    log(f"[dist] build_sharded gl=256 euclidean pam group_chunk="
        f"{GROUP_CHUNK}: max {max(build):.3f} s, per rank "
        f"{[round(b, 3) for b in build]}; max_children "
        f"{outs[0]['max_children']}")
    ncand = {m: float(res[f"{m}_ncand"][0].mean()) for m in ("dense", "beam")}
    log(f"[dist] sharded plans, second call: dense "
        f"{secs['plan-dense-2nd'] * 1e3:.3f} ms, beam 32 "
        f"{secs['plan-beam-2nd'] * 1e3:.3f} ms; recall@10 vs the sharded "
        f"exact k-NN: dense {recalls['dense']:.4f}, beam {recalls['beam']:.4f}"
        f"; mean candidates (summed over ranks): dense {ncand['dense']:.0f}, "
        f"beam {ncand['beam']:.0f}")
    log(f"[dist] merge of [{len(test)}, 10] over 4 ranks (median of 5): "
        f"butterfly {outs[0]['merge_ms']['butterfly']:.3f} ms, allgather "
        f"{outs[0]['merge_ms']['allgather']:.3f} ms; bit-equal, and equal "
        f"on a (2, 2) ('data', 'model') mesh over both axes")
    log(f"[dist] exact_knn_sharded {secs['dist-truth'] * 1e3:.3f} / "
        f"{secs['truth-2nd'] * 1e3:.3f} ms (rank 0, first / second call, "
        f"each rank reading and uploading its rows) vs one process's "
        f"exact_knn {single_ms:.3f} / {single_ms2:.3f} ms (uploading the "
        f"table) and {resident_ms:.3f} ms (the table resident); ids equal "
        f"as sets up to near-ties")
    log(f"[dist] device busy share of one sharded beam call per rank "
        f"(busy ms / wall ms): " + ", ".join(
            f"r{i} {b:.3f}/{w:.3f} ({100 * b / w:.1f}%)" if b is not None
            else f"r{i} not measured" for i, (b, w) in enumerate(busy)))
    log(f"[dist] {DIST_DELETES} deletes routed by id: no deleted id "
        f"returned; sharded int8 scan (block {STORE_BLOCK}) == one "
        f"process's scan_quantized (max err {err_scan:.3g})")
    log(f"[dist] recsys retrieval ({RETRIEVAL_ARCH} user, {N_RETRIEVAL:,} x 64 "
        f"candidates, k=100) over the 4 ranks' row blocks: "
        f"{secs['dist-retrieval'] * 1e3:.3f} / "
        f"{secs['retrieval-2nd'] * 1e3:.3f} ms (rank 0, first / second "
        f"call, the candidates on every rank's card, each ranking its "
        f"block); == one process's retrieval_step and knn_ref up to "
        f"near-ties (max err {err_retr:.3g}); set-up: model and candidates "
        f"{secs['retrieval-setup']:.2f} s on rank 0, the one-process "
        f"check {check_s:.2f} s")
    return dict(build=build, secs=secs, recalls=recalls, busy=busy,
                merge_ms=outs[0]["merge_ms"], single_ms=single_ms2)


# ---------------------------------------------------------------------------
# (h) the remote payload tier: streaming build, remote two-stage, v5
# ---------------------------------------------------------------------------


def phase_remote(main: dict, data: np.ndarray, work: str) -> dict:
    """(h) ``bench_store.py --scenario remote`` at full width: the 1M rows
    streamed in shards into a simulated object store, served two-stage
    from it, held to the same index served from memory, saved as v5 to a
    ``LocalFSStore`` and loaded back, and one error window of a fault
    plan."""
    import torch
    from repro_torch.core.index import PDASCIndex
    from repro_torch.query import Query
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.store import (ExactSource, LocalFSStore, RemoteSource,
                                   RemoteStoreError, SimulatedObjectStore,
                                   upload_payload)
    from repro_torch.store.two_stage import search_two_stage

    n, d = data.shape
    Qc, gt = main["Qc"], main["gt"]
    obj = SimulatedObjectStore(latency_ms=REMOTE["latency_ms"],
                               parallelism=8)

    def shards():
        for lo in range(0, n, REMOTE["shard_rows"]):
            yield data[lo:lo + REMOTE["shard_rows"]]

    start_phase()
    t0 = time.perf_counter()
    idx = PDASCIndex.build_streaming(
        shards(), gl=256, remote=obj, distance="euclidean", store="int8",
        block=STORE_BLOCK, method="kmeans", radius_quantile=0.35,
        cache_granules=REMOTE["cache_granules"], group_chunk=GROUP_CHUNK,
        device="cuda")
    build_s = sync_s(t0)
    launched("remote-build")
    src = idx.store.exact
    n_slots = src.n
    query = Query(k=10, execution="two_stage", beam=32,
                  rerank_width=RERANK_WIDTH)
    plan = idx.plan(query)
    require(plan.caps.remote and plan.pipeline == "two_stage",
            f"the streamed index planned {plan.pipeline}, caps {plan.caps}")
    start_phase()
    t0 = time.perf_counter()
    res = plan(Qc)
    first_s = sync_s(t0)
    launched("remote-search")
    t0 = time.perf_counter()
    res2 = plan(Qc)
    second_s = sync_s(t0)
    require(np.array_equal(res.ids.cpu().numpy(), res2.ids.cpu().numpy()),
            "the remote two-stage search is not repeatable")
    rec = recall(res.ids.cpu().numpy(), gt)
    mem = idx.memory_bytes()
    dense_payload = n * d * 4
    resident = mem["payload"] + mem["host_cache"]
    require(mem["remote_bytes"] == n_slots * d * 4,
            f"remote tier holds {mem['remote_bytes']} bytes, not the whole "
            f"exact payload ({n_slots} slots x {d} x 4)")
    require(resident <= 0.40 * dense_payload,
            f"resident payload {resident} above 0.40 x {dense_payload}")
    st, pf, ops_ = dict(src.stats), dict(src.pool.stats), dict(obj.op_counts)
    hit = st["hits"] / max(st["hits"] + st["fetches"], 1)

    # the same index served with its exact tier in memory
    idx.store.exact = ExactSource(src.read_all(), STORE_BLOCK)
    idx._plan_cache = None
    mplan = idx.plan(query)
    mplan(Qc)
    t0 = time.perf_counter()
    res_mem = mplan(Qc)
    mem_s = sync_s(t0)
    rec_mem = recall(res_mem.ids.cpu().numpy(), gt)
    require(abs(rec - rec_mem) <= 0.02,
            f"remote recall {rec:.4f} vs in-memory {rec_mem:.4f}")

    # v5: the payload in a LocalFSStore under build/, saved and loaded
    lfs = LocalFSStore(os.path.join(work, "objects"))
    upload_payload(lfs, idx.store.exact.read_all(), STORE_BLOCK)
    idx.store.exact = RemoteSource(lfs, n=n_slots, d=d, block=STORE_BLOCK,
                                   cache_granules=REMOTE["cache_granules"])
    idx._plan_cache = None
    want = idx.plan(query)(Qc)
    path = os.path.join(work, "remote_v5")
    idx.save(path)
    with open(path + ".json") as f:
        version = json.load(f)["version"]
    back = PDASCIndex.load(path, device="cuda",
                           cache_granules=REMOTE["cache_granules"])
    got = back.plan(query)(Qc)
    require(version == 5 and back._payload_released, "not a v5 round trip")
    for a, b in ((got.dists, want.dists), (got.ids, want.ids)):
        require(bool(torch.equal(a, b)), "the loaded v5 index answers "
                "differently")

    # one error window of a fault plan on the object store, met by the
    # rerank's own fetch (prefetch off: the window's dispatches are its)
    obj.faults = FaultPlan.parse("error:r0@0+2").injector(0)
    idx.store.exact = RemoteSource(obj, n=n_slots, d=d, block=STORE_BLOCK,
                                   cache_granules=REMOTE["cache_granules"])

    def faulty():
        return search_two_stage(
            idx.data, idx.store, Qc[:8], dist=idx.distance, k=10,
            r=idx.default_radius, beam=32, max_children=idx.max_children,
            rerank_width=RERANK_WIDTH, prefetch=False)

    for dispatch in range(2):  # each call meets one op of the window
        try:
            faulty()
            raise CheckFailed("the fault window raised nothing")
        except RemoteStoreError as e:
            msg = str(e)
        require(msg.startswith(
            f"remote get failed: InjectedFault: injected error (replica r0, "
            f"dispatch {dispatch}, window 0+2)"),
            f"the fault surfaced as {msg!r}")
    fres = faulty()  # the window has passed
    require(np.array_equal(fres.ids.cpu().numpy(),
                           res.ids[:8].cpu().numpy()),
            "after the fault window the answers differ")
    for h in (src, back.store.exact, idx.store.exact):
        h.close()

    log(f"[remote] streamed {n} dense_embed rows in shards of "
        f"{REMOTE['shard_rows']} (last {n % REMOTE['shard_rows']}) into a "
        f"SimulatedObjectStore (latency {REMOTE['latency_ms']} ms, "
        f"parallelism 8): build {build_s:.3f} s (kmeans, gl 256, int8 "
        f"block {STORE_BLOCK}), {n_slots} leaf slots, levels "
        f"{idx.stats.level_sizes}")
    log(f"[remote] two-stage beam 32 rerank {RERANK_WIDTH}, cache "
        f"{REMOTE['cache_granules']} granules, {len(Qc)} queries: first "
        f"{first_s:.3f} s ({len(Qc) / first_s:.1f} q/s), second "
        f"{second_s:.3f} s ({len(Qc) / second_s:.1f} q/s); in memory "
        f"{mem_s:.3f} s ({len(Qc) / mem_s:.1f} q/s); recall@10 remote "
        f"{rec:.4f} vs in memory {rec_mem:.4f}")
    log(f"[remote] memory: remote_bytes {mem['remote_bytes']} "
        f"(= {n_slots} x {d} x 4), codes + scales + host cache {resident} "
        f"= {resident / dense_payload:.4f} x the dense payload "
        f"({dense_payload}; bar 0.40); host cache {mem['host_cache']}")
    log(f"[remote] cache hit ratio {hit:.4f} ({st}); prefetch {pf}; remote "
        f"ops {ops_}")
    log(f"[remote] v5 save to a LocalFSStore + load: answers bit-equal; an "
        f"error window surfaced as RemoteStoreError ({msg[:60]}...), then "
        f"the same answers")
    return dict(build_s=build_s, qps=len(Qc) / second_s,
                qps_mem=len(Qc) / mem_s, recall=rec, recall_mem=rec_mem,
                hit=hit, ops=ops_, resident=resident)


# ---------------------------------------------------------------------------
# (j) the launch-geometry autotuner; (k) the NN-Descent baseline
# ---------------------------------------------------------------------------


def tune_plain(op, form, dtype, inputs, k):
    """The plain version's output on the tuner's inputs (``autotune``'s
    layouts), for holding each candidate geometry to it."""
    import torch
    from repro_torch.kernels import autotune, ref

    if op == "pairwise":
        X, Y = inputs
        return torch.cat([ref.pairwise_ref(X[i:i + 32], Y[i:i + 32], form)
                          for i in range(0, X.shape[0], 32)])
    if op == "knn":
        return ref.knn_ref(*inputs, k, form)
    if op == "rank":
        Q, P, sq, cand, ok = inputs
        return ref.rank_gathered_ref(Q, P, sq, cand, ok, k, form)
    if op == "scan":
        Q, codes, scales, cand, ok = inputs
        fmt = dtype if dtype in ("int4", "binary") else "dense"
        return ref.scan_gathered_ref(Q, codes, scales, autotune.SCAN_BLOCK,
                                     cand, ok, k, form, fmt)
    return ref.swap_deltas_ref(*inputs, k)


def tune_check(op, form, dtype, inputs, out, plain, k) -> float:
    """One candidate's output against the plain version (the tolerance
    rule; top-k ids up to near-ties, each picked id's plain distance equal
    to the kernel's). Returns the max error."""
    import torch
    from repro_torch.kernels import autotune, ref

    squared = form == "l2"
    if op in ("pairwise", "swap"):
        return values_agree(out.cpu().numpy(), plain.cpu().numpy(),
                            squared=squared and op == "pairwise")
    kd, ki = out
    rd, ri = plain
    Q = inputs[0]
    if op == "knn":
        again = ref.rowwise_ref(Q, inputs[1][ki.long()], form)
    elif op == "rank":
        _, P, sq, cand, _ = inputs
        picked = torch.gather(cand, 1, ki.long()).long()
        again = ref.rowwise_ref(Q, P[picked], form, sq[picked])
    else:
        _, codes, scales, cand, _ = inputs
        fmt = dtype if dtype in ("int4", "binary") else "dense"
        again = torch.gather(scan_rows(Q, codes, scales, autotune.SCAN_BLOCK,
                                       cand, form, fmt), 1, ki.long())
    return topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu(),
                      squared=squared)


def tune_one(op, form, dtype, shape) -> dict:
    """``autotune.tune`` at one key, each candidate held to the plain
    version (and compared bit for bit with the heuristic's output) before
    its time counts; then a second ``tune`` that must answer from the
    cache without timing anything."""
    import torch
    from repro_torch.kernels import autotune

    inputs = autotune.make_inputs(op, form, dtype, shape)
    k = autotune.shape_k(op, shape)
    plain = tune_plain(op, form, dtype, inputs, k)
    rows: list = []
    heur: list = []  # the heuristic's output (the sweep's first member)

    def measure(knobs):
        out = autotune.launch(op, form, dtype, inputs, knobs, k)
        err = tune_check(op, form, dtype, inputs, out, plain, k)
        outs = out if isinstance(out, tuple) else (out,)
        if not rows:
            heur.extend(outs)
        same = all(bool(torch.equal(a, b)) for a, b in zip(outs, heur))
        us = autotune.time_knobs(op, form, dtype, shape, knobs, reps=TUNE_REPS,
                                 inputs=inputs)
        rows.append(dict(knobs=knobs, us=us, err=err, bit_equal=same))
        return us

    r = autotune.tune(op, form=form, dtype=dtype, shape=shape, measure=measure)

    def exploding(knobs):
        raise CheckFailed(f"autotune {op}: a cache hit timed {knobs}")

    again = autotune.tune(op, form=form, dtype=dtype, shape=shape,
                          measure=exploding)
    require(again["cached"] and again["winner"] == r["winner"],
            f"autotune {op} {dtype}: the second tune missed the cache")
    require(autotune.lookup(op=op, form=form, dtype=dtype,
                            shape=shape) == r["winner"],
            f"autotune {op} {dtype}: the winner is not cached")
    require(r["default"] == rows[0]["knobs"],
            f"autotune {op}: the sweep did not start at the heuristic")
    waste = {json.dumps(s["knobs"]): s["waste"] for s in r["sweep"]}
    for row in rows:
        row["waste"] = waste[json.dumps(row["knobs"])]
    win = next(row for row in rows if row["knobs"] == r["winner"])
    log(f"[autotune] {op} {form} {dtype} {list(shape)}: {len(rows)} "
        f"candidates, each within the rule (max err "
        f"{max(row['err'] for row in rows):.3g}); heuristic "
        f"{r['default']} {rows[0]['us'] / 1e3:.4f} ms; winner {r['winner']} "
        f"{win['us'] / 1e3:.4f} ms (waste {win['waste']}); bit-equal to the "
        f"heuristic's output: {sum(row['bit_equal'] for row in rows)} of "
        f"{len(rows)}")
    for row in rows:
        log(f"[autotune]   {json.dumps(row['knobs'])}: {row['us'] / 1e3:.4f} "
            f"ms, waste {row['waste']}, err {row['err']:.3g}, bit-equal "
            f"{row['bit_equal']}")
    del inputs, plain
    return dict(op=op, form=form, dtype=dtype, shape=list(shape),
                heuristic=r["default"], heuristic_ms=rows[0]["us"] / 1e3,
                winner=r["winner"], winner_ms=win["us"] / 1e3,
                candidates=rows)


def phase_autotune(main: dict, data: np.ndarray, work: str) -> dict:
    """(j): ``autotune.tune`` for every op at the main path's shapes, with
    a fresh cache under the run's tmp dir, each candidate held to its plain
    version; a second tune answers from the cache. Then the 1M index
    rebuilt with the swap winner's ``kb`` and searched through
    ``Query(k=10, kernel=KernelConfig(auto=True))`` and ``ops.knn`` with
    the same config (the ``autotune`` launch window), held to the main
    path's run: the same ids up to near-ties where the winners launch the
    heuristic's swap geometry; else (S sums in another order, so k-medoids
    near-ties may flip) recall within 0.01 of the main path's. On the
    rebuilt index the auto plan is also held to the default plan."""
    import torch
    from repro_torch.core.index import PDASCIndex
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.query import Query

    autotune.set_cache_path(os.path.join(work, "kernel_tune.json"))
    log(f"[autotune] {nvidia_smi()}; cache {autotune.cache_path()} (fresh)")
    t0 = time.perf_counter()
    tuned = [tune_one(*case) for case in TUNE_CASES]
    tune_s = time.perf_counter() - t0
    log(f"[autotune] tuned {len(tuned)} keys in {tune_s:.1f} s: "
        + json.dumps([{k: t[k] for k in ("op", "dtype", "heuristic",
                                          "heuristic_ms", "winner",
                                          "winner_ms")} for t in tuned]))

    kb = autotune.lookup(op="swap", form="none", dtype="float32",
                         shape=TUNE_SWAP)["kb"]
    heur_kb = autotune.heuristic("swap", TUNE_SWAP)["kb"]
    auto = ops.KernelConfig(auto=True)
    Qc, DB = main["Qc"], _cuda(data)
    start_phase()
    t0 = time.perf_counter()
    idx = PDASCIndex.build(data, gl=256, distance="euclidean",
                           radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                           kb=kb, device="cuda")
    build_s = sync_s(t0)
    plan = idx.plan(Query(k=10, kernel=auto))
    t0 = time.perf_counter()
    res = plan(Qc)
    search_s = sync_s(t0)
    kd, ki = ops.knn(Qc, DB, "l2", k=10, config=auto)
    torch.cuda.synchronize()
    launched("autotune")
    require(plan.kernel.tuned_gen == autotune.generation(),
            "the auto plan is not stamped with the tuner's generation")
    # the tuned knn against the main path's exact_knn (default geometry)
    rd, ri = ops.knn(Qc, DB, "l2", k=10)
    again = ref.rowwise_ref(Qc, DB[ki.long()], "l2")
    knn_err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu(),
                         squared=True)
    require(np.array_equal(ri.cpu().numpy(), main["gt"]),
            "exact_knn is not repeatable")
    default_plan = idx.plan(Query(k=10))
    plain = default_plan(Qc)
    topk_agree(res.dists.cpu(), res.ids.cpu(), plain.dists.cpu(),
               plain.ids.cpu(), res.dists.cpu())
    # end to end: the two plans' calls in turns (default, auto, auto,
    # default, ...), each a host clock around a synchronised call
    calls = {"default": [], "auto": []}
    for turn in range(TUNE_TURNS):
        for name in (("default", "auto") if turn % 2 == 0
                     else ("auto", "default")):
            t0 = time.perf_counter()
            (plan if name == "auto" else default_plan)(Qc)
            calls[name].append(sync_s(t0) * 1e3)
    rec = recall(res.ids.cpu().numpy(), main["gt"])
    same_build = idx.stats.level_td == main["idx"].stats.level_td
    if kb == heur_kb:
        require(same_build, "the rebuild at the heuristic's kb differs from "
                "the main path's build")
        base = main["res"]
        topk_agree(res.dists.cpu(), res.ids.cpu(), base.dists.cpu(),
                   base.ids.cpu(), res.dists.cpu())
    else:
        require(abs(rec - main["recall"]) <= 0.01,
                f"tuned build recall {rec:.4f} vs {main['recall']:.4f}")
    log(f"[autotune] main path with KernelConfig(auto=True): swap kb {kb} "
        f"(heuristic {heur_kb}); build {build_s:.3f} s, level TDs "
        f"{'equal to' if same_build else 'differ from'} the main build's "
        f"({idx.stats.level_td[0]:.6g} vs {main['idx'].stats.level_td[0]:.6g} "
        f"at level 0); {len(Qc)} queries {search_s:.4f} s (first call); "
        f"recall@10 {rec:.4f} (main path {main['recall']:.4f}); auto plan == "
        f"default plan on this index up to near-ties; tuned knn vs default "
        f"max err {knn_err:.3g}; {TUNE_TURNS} calls each in turns, median "
        f"ms: default {np.median(calls['default']):.4f}, auto "
        f"{np.median(calls['auto']):.4f}")
    autotune.set_cache_path(None)
    del idx, plan, default_plan, res, plain, DB
    torch.cuda.empty_cache()
    return dict(tuned=tuned, build_s=build_s, search_s=search_s, recall=rec,
                kb=kb, calls=calls)


def phase_nndescent(data: np.ndarray, test: np.ndarray) -> dict:
    """(k): NN-Descent at bench_recall.py's setting (train[:4000],
    n_neighbors 15, iters 5; search n_seeds 24, max_steps 40) on the first
    NND_QUERIES held-out queries, recall@10 against ``exact_knn``; and the
    card's graph equal to the CPU's on integer-valued data."""
    from repro_torch.baselines import NNDescentIndex, exact_knn

    rng = np.random.default_rng(3)
    ints = rng.integers(0, 16, (400, 8)).astype(np.float32)
    kw = dict(n_neighbors=10, iters=3, seed=1)
    require(np.array_equal(
        NNDescentIndex.build(ints, device="cuda", **kw).graph,
        NNDescentIndex.build(ints, device="cpu", **kw).graph),
        "NN-Descent on integer data: the card's graph differs from the CPU's")
    train, Q = data[:NND_TRAIN], test[:NND_QUERIES]
    t0 = time.perf_counter()
    nnd = NNDescentIndex.build(train, n_neighbors=15, distance="euclidean",
                               iters=5, device="cuda")
    build_s = sync_s(t0)
    _, gt = exact_knn(Q, train, k=10, device="cuda")
    t0 = time.perf_counter()
    d, ids = nnd.search(Q, k=10, n_seeds=24, max_steps=40)
    search_s = sync_s(t0)
    rec = recall(ids, gt.cpu().numpy())
    require(np.isfinite(d).all() and rec > 0,
            f"NN-Descent found nothing (recall {rec})")
    log(f"[nndescent] dense_embed train[:{NND_TRAIN}] n_neighbors=15 iters=5 "
        f"on the card: build {build_s:.3f} s; {len(Q)} queries n_seeds=24 "
        f"max_steps=40: {search_s / len(Q) * 1e6:.1f} us a query; recall@10 "
        f"{rec:.4f}; card graph == CPU graph on integer data")
    return dict(build_s=build_s, us_per_query=search_s / len(Q) * 1e6,
                recall=rec)


# ---------------------------------------------------------------------------
# (l) the recsys family: serve, 1M-candidate retrieval on knn.cu, training
# ---------------------------------------------------------------------------


def window_sum(name: str, counts: dict) -> None:
    """Add ``counts`` to the window ``name`` (a window run in parts)."""
    total = PHASE_LAUNCHES.setdefault(name, dict.fromkeys(KERNELS, 0))
    for k, v in counts.items():
        total[k] += v


def run_trainer(args: list, timeout: float = 300) -> dict:
    """``python -m repro_torch.launch.train`` in a subprocess; its loss
    lines, step ms and the kernel launches it printed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=timeout, env=env)
    wall = time.perf_counter() - t0
    require(out.returncode == 0, f"launch.train {args} exited "
            f"{out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    done = [ln for ln in lines if ln.startswith("[train] done:")]
    last = [ln for ln in lines if " ms a step " in ln]
    require(done and last, f"launch.train printed no result:\n{out.stdout}")
    words = done[-1].split()
    loss, first = float(words[5]), float(words[7].strip("()"))
    head, _, counts = last[-1].partition("kernel launches ")
    step_ms = head.split(":")[-1].split("ms a step")[0].strip()
    peak = [ln for ln in lines if ln.startswith("[train] peak device memory")]
    return dict(loss=loss, first=first, wall_s=wall,
                step_ms=None if step_ms == "n/a" else float(step_ms),
                peak_gb=float(peak[-1].split()[4]) if peak else None,
                launches=json.loads(counts), stdout=out.stdout)


def phase_recsys(work: str) -> dict:
    """(l) The recsys family at full width (``config()``, weights from a
    seed on the card): every arch at ``serve_p99`` (card == the port's CPU
    on 64 rows), ``retrieval_cand`` through ``retrieval_step`` (knn.cu's
    dot form at [1, 1M, 64], k = 100, held to ``knn_ref`` and timed beside
    ``torch.topk(u @ C.T)``), ``launch.train`` at ``train_batch`` and a
    ``--ckpt`` restart of din under deterministic algorithms, bit-equal to
    an uninterrupted run. TF32 stays off here and in the trainers."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import recsys_batch
    from repro_torch.data.pipeline import place
    from repro_torch.kernels import ref, topk
    from repro_torch.models import recsys as rec

    t_phase = time.perf_counter()
    serve_b = RECSYS_SHAPES["serve_p99"].dims["batch"]
    n_cand = RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"]
    k = 100
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    models = {}
    for i, aid in enumerate(RECSYS_ARCHS):
        cfg = get_arch(aid).config_fn()
        gen = torch.Generator(device="cuda").manual_seed(i)
        models[aid] = (cfg, rec.init_params(cfg, gen, device="cuda"))
    C = retrieval_candidates(len(RECSYS_ARCHS))
    require(C.shape[0] == n_cand, "N_RETRIEVAL != retrieval_cand's count")
    batches = {aid: place(recsys_batch(0, serve_b, cfg, seed=0), "cuda")
               for aid, (cfg, _) in models.items()}
    users = {aid: place(recsys_batch(1, 1, cfg, seed=0), "cuda")
             for aid, (cfg, _) in models.items()}
    sizes = ", ".join(f"{a} {c.n_params() / 1e6:.1f}M"
                      for a, (c, _) in models.items())
    log(f"[recsys] params of {len(models)} archs at full width ({sizes}) "
        f"and {n_cand:,} candidates made on the card in "
        f"{sync_s(t0):.1f} s (set-up)")

    # serve_p99: one forward per arch; no kernel of the port runs here
    start_phase()
    with torch.no_grad():
        served = {aid: rec.forward(p, batches[aid], cfg)[0]
                  for aid, (cfg, p) in models.items()}
    torch.cuda.synchronize()
    launched("recsys-serve")
    out = dict(serve={}, retrieval={}, train={})
    for aid, (cfg, p) in models.items():
        logits = served[aid]
        require(tuple(logits.shape) == (serve_b,)
                and bool(torch.isfinite(logits).all()),
                f"{aid}: serve logits not finite or of shape {logits.shape}")
        cpu_p = {n: v.cpu() for n, v in p.items()}
        rows = {n: v[:RECSYS_CPU_ROWS].cpu() for n, v in batches[aid].items()}
        want, _ = rec.forward(cpu_p, rows, cfg)
        err = values_agree(logits[:RECSYS_CPU_ROWS].cpu().numpy(),
                           want.numpy())
        del cpu_p
        with torch.no_grad():
            ms = time_ms(lambda: rec.forward(p, batches[aid], cfg))
        out["serve"][aid] = dict(ms=ms, max_abs_err=err)
        log(f"[recsys] {aid} serve_p99 (batch {serve_b}): {ms:.4f} ms a "
            f"forward (CUDA events, 10 calls); logits finite, card == the "
            f"port's CPU on {RECSYS_CPU_ROWS} rows (max abs err {err:.3g})")
    with torch.no_grad():
        cfg, p = models["wide-deep"]
        profile_breakdown("wide-deep serve_p99 forward",
                          lambda: rec.forward(p, batches["wide-deep"], cfg))

    # retrieval_cand: retrieval_step's top-k is ops.knn(u, C, "dot")
    start_phase()
    with torch.no_grad():
        got = {aid: rec.retrieval_step(p, users[aid], C, cfg, k=k)
               for aid, (cfg, p) in models.items()}
    torch.cuda.synchronize()
    counts = launched("recsys-retrieval")
    require(counts["knn"] == len(models),
            f"retrieval launched knn {counts['knn']} times, not once an arch")
    nbytes = 4.0 * (n_cand * 64 + 64) + 8.0 * k
    b_ms, b_by = bound(2.0 * n_cand * 64, nbytes, PEAK_GRAM)
    for aid, (cfg, p) in models.items():
        with torch.no_grad():
            u = rec.user_vector(p, users[aid], cfg)
        scores, ids = got[aid]
        kd, ki = topk.knn_cuda(u, C, k, "dot")
        require(torch.equal(-kd, scores) and torch.equal(ki, ids),
                f"{aid}: retrieval_step != its knn launch")
        rd, ri = ref.knn_ref(u, C, k, "dot")
        again = -(C[ki[0].long()] @ u[0])[None]
        err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
        require(bool((scores[:, 1:] <= scores[:, :-1]).all()),
                f"{aid}: scores not descending")
        out["retrieval"][aid] = dict(
            ms=kernel_ms(lambda: topk.knn_cuda(u, C, k, "dot")),
            plain_ms=time_ms(lambda: ref.knn_ref(u, C, k, "dot")),
            library_ms=time_ms(lambda: torch.topk(u @ C.T, k)),
            step_ms=time_ms(lambda: rec.retrieval_step(p, users[aid], C,
                                                       cfg, k=k)),
            max_abs_err=err)
        r = out["retrieval"][aid]
        log(f"[recsys] {aid} retrieval_cand [1, {n_cand}, 64], k={k}: knn "
            f"dot kernel {r['ms']:.4f} ms (graph replay), plain "
            f"{r['plain_ms']:.4f} ms, library topk(u @ C.T) "
            f"{r['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"retrieval_step {r['step_ms']:.4f} ms (user tower + knn, CUDA "
            f"events); held to knn_ref (max abs err {err:.3g})")
    geo = topk.knn_geometry(1, n_cand, 64, k, "dot")
    first = out["retrieval"][RECSYS_ARCHS[0]]
    out["row"] = dict(
        shape=[1, n_cand, 64, k], form="dot", launches=counts["knn"],
        ms=first["ms"], plain_ms=first["plain_ms"],
        library_ms=first["library_ms"], bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(r["max_abs_err"] for r in out["retrieval"].values()),
        ms_per_arch={a: r["ms"] for a, r in out["retrieval"].items()},
        geometry=dict(route=geo.route, bq=geo.bq, splits=geo.splits,
                      chunk=geo.chunk))
    log(f"[recsys] knn geometry at [1, {n_cand}, 64, {k}]: "
        f"{out['row']['geometry']}")
    del models, batches, users, served, got, C
    torch.cuda.empty_cache()

    # training: launch.train at train_batch, then din's --ckpt restart
    batch = RECSYS_SHAPES["train_batch"].dims["batch"]
    arch, steps = RECSYS_TRAIN
    tr = run_trainer(["--arch", arch, "--batch", str(batch), "--steps",
                      str(steps), "--seed", "0"])
    require(np.isfinite(tr["loss"]) and np.isfinite(tr["first"]),
            f"{arch} training loss not finite: {tr['first']} -> {tr['loss']}")
    window_sum("recsys-train", tr["launches"])
    out["train"][arch] = tr
    log(f"[recsys] launch.train --arch {arch} --batch {batch} --steps "
        f"{steps}: loss {tr['first']:.4f} -> {tr['loss']:.4f}, "
        f"{tr['step_ms']:.3f} ms a step, process {tr['wall_s']:.1f} s")
    arch, steps = RECSYS_RESTART
    base = ["--arch", arch, "--batch", str(batch), "--seed", "0",
            "--deterministic", "--ckpt-every", "100"]
    whole, half = (os.path.join(work, f"ckpt_{n}") for n in ("whole", "half"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # the first two at once
        f_whole = pool.submit(run_trainer, base + ["--steps", str(steps),
                                                   "--ckpt", whole])
        f_half = pool.submit(run_trainer, base + ["--steps", str(steps // 2),
                                                  "--ckpt", half])
        runs = [f_whole.result(), f_half.result()]
    runs.append(run_trainer(base + ["--steps", str(steps), "--ckpt", half]))
    require("restored checkpoint @ step" in runs[2]["stdout"],
            "the resumed din run did not restore its checkpoint")
    for r in runs:
        window_sum("recsys-train", r["launches"])
    a, b = (np.load(os.path.join(d, f"step_{steps - 1:09d}", "arrays.npz"))
            for d in (whole, half))
    require(sorted(a.files) == sorted(b.files), "restart keys differ")
    for key in a.files:
        require(np.array_equal(a[key], b[key]),
                f"{arch} restart: {key} differs from the uninterrupted run")
    out["restart_s"] = time.perf_counter() - t0
    log(f"[recsys] {arch} --ckpt restart at batch {batch} (deterministic "
        f"algorithms): {steps} steps whole vs {steps // 2} + resumed "
        f"{steps - steps // 2}: all {len(a.files)} arrays of (params, "
        f"OptState) bit-equal; loss {runs[0]['first']:.4f} -> "
        f"{runs[0]['loss']:.4f}; {out['restart_s']:.1f} s (the first two "
        f"runs share the card, so no step time is kept)")
    log(f"[recsys] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def lm_launched(window: str) -> None:
    """``launched`` for an (m) window, which must count no launch."""
    counts = launched(window)
    require(not any(counts.values()),
            f"{window}: the transformer launched a kernel of the port: {counts}")


def lm_tokens_on(step: int, batch: int, seq: int, vocab: int):
    """``lm_tokens``' token rows as an int32 tensor on the card."""
    import torch
    from repro_torch.data import lm_tokens

    return torch.from_numpy(lm_tokens(step, batch, seq, vocab)["tokens"]).cuda()


def lm_cut(params: dict, n_layers: int, device: str) -> dict:
    """The first ``n_layers`` layers of ``params`` (and every other
    tensor), copied to ``device``."""
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: v[:n_layers].to(device)
                     for k, v in params["layers"].items()}
    return out


def lm_empty_cache(tfm, cfg, batch: int, seq: int, fill: dict = None) -> dict:
    """A zero KV cache of ``seq`` slots on the card, its first slots copied
    from a prefill's ``fill``."""
    import torch

    cache = {n: torch.zeros(s.shape, dtype=s.dtype, device="cuda")
             for n, s in tfm.cache_shapes(cfg, batch, seq).items()}
    for n, c in (fill or {}).items():
        cache[n][:, :, :c.shape[2]] = c
    return cache


def lm_greedy(tfm, params, cache, logits, cfg, start: int, steps: int):
    """``steps`` greedy decode steps from ``logits`` at position ``start``:
    the last logits and the tokens (argmax on the card, no host sync)."""
    import torch

    sh = tfm.ShardingConfig()
    toks = []
    for i in range(steps):
        nxt = logits[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        logits, cache = tfm.decode_step(params, cache, nxt, start + i, cfg, sh)
    return logits, torch.cat(toks, dim=1)


def lm_card_vs_cpu(tfm, params, cfg, tag: str) -> dict:
    """A ``LM_CPU``-layer fp32 cut of ``cfg`` on the card and on the port's
    CPU, the same weights and tokens: hidden and prefill logits, one
    decode step, the loss and its aux, each pair within the rule."""
    import torch

    B, S, L = LM_CPU
    cut = dataclasses.replace(cfg, n_layers=L, dtype=torch.float32)
    sh = tfm.ShardingConfig()
    toks = lm_tokens_on(7, B, S + 1, cfg.vocab)
    batch = dict(tokens=toks[:, :S], labels=toks[:, 1:])
    p_cpu = lm_cut(params, L, "cpu")
    p_gpu = lm_cut(params, L, "cuda")
    res = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            r = {"hidden": tfm.forward(p, b["tokens"], cut, sh)[0]}
            r["prefill"], pc = tfm.prefill_step(p, b["tokens"], cut, sh)
            cache = {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                     for n, s in tfm.cache_shapes(cut, B, S + 1).items()}
            for n in cache:
                cache[n][:, :, :S] = pc[n]
            r["decode"], _ = tfm.decode_step(p, cache, b["labels"][:, -1:], S,
                                             cut, sh)
            loss, parts = tfm.loss_fn(p, b, cut, sh)
            r["loss"], r["aux"] = loss[None], parts["aux"][None]
        res[dev] = {k: v.cpu().numpy() for k, v in r.items()}
    errs = {}
    for k, want in res["cpu"].items():
        got = res["cuda"][k]
        if k in ("prefill", "decode"):
            got, want = got[:, :cfg.vocab], want[:, :cfg.vocab]
        errs[k] = values_agree(got, want)
    log(f"[{tag}] card == the port's CPU on a {L}-layer fp32 cut of config() "
        f"(full width), {B} x {S} tokens: max abs err "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
    return errs


def phase_lm() -> dict:
    """(m) The transformer family on the card, weights from CUDA generator
    seeds, TF32 off. stablelm-1.6b at full width and depth: prefill at
    prefill_32k's 32,768 tokens (batch 1), then a 4 x 2,048 prompt's cache
    in a 32,768-slot cache (decode_32k's length, batch 4) and 32 greedy
    decode steps; at full width in fp32, prefill == 64 decode steps; bf16
    against fp32; card == CPU on a 2-layer cut. deepseek-moe-16b at full
    width, 4 layers: prefill 2 x 4,096 (dropped share of the dispatch), 16
    greedy decode steps, one loss_fn backward at 1 x 1,024, card == CPU on
    a 2-layer cut. Then ``launch.train --arch stablelm-1.6b --seq 4096``.
    Every window counts no launch of the port's kernels."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import value_and_grad

    t_phase = time.perf_counter()
    sh = tfm.ShardingConfig()
    out = {}
    torch.cuda.empty_cache()

    # ---- stablelm-1.6b, full width and depth ------------------------------
    cfg = get_arch(LM_ARCH).config_fn()
    V = cfg.vocab
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    log(f"[lm] {cfg.name} config(): {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv), d_ff {cfg.d_ff}, vocab "
        f"{V} (padded {cfg.vocab_padded}); {cfg.n_params() / 1e9:.3f} B "
        f"params, {4 * cfg.n_params() / 1e9:.2f} GB fp32 master, made on "
        f"the card in {sync_s(t0):.1f} s (set-up); compute in bf16")

    S = LM_SHAPES["prefill_32k"].dims["seq_len"]
    with torch.no_grad():
        tfm.prefill_step(params, lm_tokens_on(0, LM_PREFILL_BATCH, LM_WARMUP,
                                              V), cfg, sh)
        prompt = lm_tokens_on(1, LM_PREFILL_BATCH, S, V)
        torch.cuda.reset_peak_memory_stats()
        start_phase()
        t0 = time.perf_counter()
        logits, cache = tfm.prefill_step(params, prompt, cfg, sh)
        prefill_ms = 1e3 * sync_s(t0)
    lm_launched("lm-prefill")
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(tuple(logits.shape) == (LM_PREFILL_BATCH, cfg.vocab_padded)
            and bool(torch.isfinite(logits[:, :V]).all())
            and bool(torch.isneginf(logits[:, V:]).all()),
            "prefill_32k logits not finite, or padded columns not -inf")
    require(tuple(cache["k"].shape) == (cfg.n_layers, LM_PREFILL_BATCH, S,
                                        cfg.n_kv_heads, cfg.hd),
            f"prefill cache of shape {tuple(cache['k'].shape)}")
    out["prefill"] = dict(ms=prefill_ms, peak_gb=peak, tokens=S,
                          batch=LM_PREFILL_BATCH)
    log(f"[lm] prefill_32k ({LM_PREFILL_BATCH} x {S} tokens, after a "
        f"{LM_WARMUP}-token warm-up): {prefill_ms:.1f} ms (host clock, "
        f"synchronised), {LM_PREFILL_BATCH * S / prefill_ms * 1e3:.0f} "
        f"tokens/s; peak memory {peak:.2f} GB (max_memory_allocated); "
        f"logits finite, padded columns -inf")
    del logits, cache, prompt
    torch.cuda.empty_cache()

    Bd, P, steps = LM_DECODE
    Sd = LM_SHAPES["decode_32k"].dims["seq_len"]
    with torch.no_grad():
        logits, pc = tfm.prefill_step(params, lm_tokens_on(2, Bd, P, V), cfg,
                                      sh)
        cache = lm_empty_cache(tfm, cfg, Bd, Sd, pc)
        del pc
        cache_gb = sum(c.numel() * c.element_size() for c in cache.values()) / 1e9
        torch.cuda.reset_peak_memory_stats()
        start_phase()
        t0 = time.perf_counter()
        logits, gen = lm_greedy(tfm, params, cache, logits, cfg, P, steps)
        decode_s = sync_s(t0)
    lm_launched("lm-decode")
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(bool(torch.isfinite(logits[:, :V]).all())
            and bool(((gen >= 0) & (gen < V)).all()),
            "decode logits not finite or a token out of the vocab")
    out["decode"] = dict(ms_per_step=1e3 * decode_s / steps,
                         tokens_per_s=Bd * steps / decode_s, peak_gb=peak,
                         cache_gb=cache_gb, batch=Bd, cache_seq=Sd)
    log(f"[lm] decode_32k: a {Bd} x {P} prompt's cache in cache_shapes("
        f"{Bd}, {Sd}) ({cache_gb:.2f} GB bf16), {steps} greedy steps: "
        f"{out['decode']['ms_per_step']:.3f} ms a step, "
        f"{out['decode']['tokens_per_s']:.1f} tokens/s (host clock, "
        f"synchronised once); peak memory {peak:.2f} GB; logits finite")
    with torch.no_grad():  # one more step, at the next slot
        out["decode"]["profile"] = profile_breakdown(
            f"{cfg.name} decode step (batch {Bd}, {Sd}-slot cache)",
            lambda: tfm.decode_step(params, cache, gen[:, -1:], P + steps,
                                    cfg, sh))
    del cache, logits
    torch.cuda.empty_cache()

    # prefill == decode at full width in fp32; then bf16 against fp32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    Bc, Pc = LM_CONSIST
    prompt = lm_tokens_on(3, Bc, Pc, V)
    with torch.no_grad():
        lp, cp = tfm.prefill_step(params, prompt, cfg32, sh)
        cache = lm_empty_cache(tfm, cfg32, Bc, Pc)
        for t in range(Pc):
            ld, cache = tfm.decode_step(params, cache, prompt[:, t:t + 1], t,
                                        cfg32, sh)
        lb, _ = tfm.prefill_step(params, prompt, cfg, sh)
    lp, ld, lb = (x[:, :V].double().cpu().numpy() for x in (lp, ld, lb))
    rel = float(np.linalg.norm(lb - lp) / np.linalg.norm(lp))
    log(f"[lm] fp32 at full width, {Bc} x {Pc} tokens: prefill's last "
        f"logits vs {Pc} decode steps' max abs err "
        f"{float(np.abs(ld - lp).max()):.3g} (max |logit| "
        f"{float(np.abs(lp).max()):.3g}); bf16 vs fp32 relative L2 of the "
        f"last logits {rel:.4f} (limit 0.1)")
    err = values_agree(ld, lp)
    cerr = max(values_agree(cache[n].cpu().numpy(), cp[n].cpu().numpy())
               for n in ("k", "v"))
    require(rel <= 0.1, f"bf16 vs fp32 relative L2 {rel:.4f} > 0.1")
    out["consistency"] = dict(max_abs_err=err, cache_err=cerr, bf16_rel=rel)
    del cache, cp
    out["cpu"] = lm_card_vs_cpu(tfm, params, cfg, "lm")
    del params
    torch.cuda.empty_cache()

    # ---- deepseek-moe-16b, full width, 4 layers ---------------------------
    mcfg = dataclasses.replace(get_arch(MOE_ARCH).config_fn(),
                               n_layers=MOE_LAYERS)
    moe = mcfg.moe
    V = mcfg.vocab
    t0 = time.perf_counter()
    params = tfm.init_params(mcfg, torch.Generator(device="cuda").manual_seed(1),
                             device="cuda")
    log(f"[moe] {mcfg.name} config() cut to {MOE_LAYERS} of 28 layers: d "
        f"{mcfg.d_model}, {moe.n_experts} routed experts top-{moe.top_k} + "
        f"{moe.n_shared} shared, d_ff_expert {moe.d_ff_expert}, vocab {V}; "
        f"{mcfg.n_params() / 1e9:.3f} B params ({4 * mcfg.n_params() / 1e9:.2f}"
        f" GB fp32), {mcfg.n_active_params() / 1e9:.3f} B active a token, "
        f"made on the card in {sync_s(t0):.1f} s (set-up)")
    Bm, Pm, msteps = MOE_PREFILL
    prompt = lm_tokens_on(4, Bm, Pm, V)
    C = tfm.capacity(moe, Bm * Pm)
    with torch.no_grad():
        tfm.prefill_step(params, prompt[:, :LM_WARMUP], mcfg, sh)
        torch.cuda.reset_peak_memory_stats()
        start_phase()
        t0 = time.perf_counter()
        logits, pc = tfm.prefill_step(params, prompt, mcfg, sh)
        prefill_ms = 1e3 * sync_s(t0)
        lm_launched("moe-prefill")
        peak = torch.cuda.max_memory_allocated() / 1e9
        require(bool(torch.isfinite(logits[:, :V]).all()),
                "moe prefill logits not finite")
        cache = lm_empty_cache(tfm, mcfg, Bm, Pm + msteps, pc)
        del pc
        start_phase()
        t0 = time.perf_counter()
        last, gen = lm_greedy(tfm, params, cache, logits, mcfg, Pm, msteps)
        decode_s = sync_s(t0)
        lm_launched("moe-decode")
        require(bool(torch.isfinite(last[:, :V]).all()),
                "moe decode logits not finite")
        drops = []  # (dropped slots, slots) a layer, from the same routing
        real = tfm._moe_local

        def spy(x_flat, router_w, *a, **kw):
            _, _, top_e = tfm.route(x_flat, router_w, moe.top_k)
            n = torch.bincount(top_e.reshape(-1), minlength=moe.n_experts)
            drops.append((int(torch.clamp(n - C, min=0).sum()), top_e.numel()))
            return real(x_flat, router_w, *a, **kw)

        tfm._moe_local = spy
        try:
            tfm.prefill_step(params, prompt, mcfg, sh)
        finally:
            tfm._moe_local = real
    dropped = sum(d for d, _ in drops) / sum(n for _, n in drops)
    out["moe"] = dict(prefill_ms=prefill_ms, peak_gb=peak,
                      ms_per_step=1e3 * decode_s / msteps,
                      tokens_per_s=Bm * msteps / decode_s, dropped=dropped,
                      capacity=C)
    log(f"[moe] prefill {Bm} x {Pm} (T = {Bm * Pm}, C = {C}): "
        f"{prefill_ms:.1f} ms, peak memory {peak:.2f} GB; dropped "
        f"{100 * dropped:.2f}% of the dispatched slots (per layer "
        f"{[round(100 * d / n, 2) for d, n in drops]}%); {msteps} greedy "
        f"decode steps (no capacity): {out['moe']['ms_per_step']:.3f} ms a "
        f"step, {out['moe']['tokens_per_s']:.1f} tokens/s; logits finite")
    with torch.no_grad():
        out["moe"]["profile"] = profile_breakdown(
            f"{mcfg.name} prefill {Bm} x {Pm}",
            lambda: tfm.prefill_step(params, prompt, mcfg, sh))
    del cache, logits, last

    Bt, St = MOE_TRAIN
    toks = lm_tokens_on(5, Bt, St + 1, V)
    batch = dict(tokens=toks[:, :St], labels=toks[:, 1:])
    torch.cuda.reset_peak_memory_stats()
    start_phase()
    train_ms = []
    for _ in range(2):  # the first call pays for lazy set-up
        t0 = time.perf_counter()
        (loss, parts), grads = value_and_grad(
            lambda p, b: tfm.loss_fn(p, b, mcfg, sh), params, batch)
        train_ms.append(1e3 * sync_s(t0))
        require(np.isfinite(float(loss))
                and all(bool(torch.isfinite(g).all())
                        for g in tree_leaves(grads)),
                "moe loss or a gradient not finite")
        del grads
    lm_launched("moe-train")
    peak = torch.cuda.max_memory_allocated() / 1e9
    out["moe"].update(train_ms=train_ms, train_peak_gb=peak, loss=float(loss))
    log(f"[moe] loss_fn backward at {Bt} x {St}: loss {float(loss):.4f} (nll "
        f"{float(parts['nll']):.4f}, aux {float(parts['aux']):.4f}), "
        f"{train_ms[0]:.1f} ms the first call, {train_ms[1]:.1f} ms the "
        f"second (host clock), peak memory {peak:.2f} GB; every gradient "
        f"finite")
    out["moe_cpu"] = lm_card_vs_cpu(tfm, params, mcfg, "moe")
    del params
    torch.cuda.empty_cache()

    # ---- launch.train at train_4k's sequence -----------------------------
    tr = run_trainer(LM_TRAIN)
    require(np.isfinite(tr["loss"]) and np.isfinite(tr["first"])
            and tr["peak_gb"] is not None,
            f"{LM_ARCH} training loss not finite ({tr['first']} -> "
            f"{tr['loss']}) or no peak memory printed")
    PHASE_LAUNCHES["lm-train"] = tr["launches"]
    require(not any(tr["launches"].values()),
            f"lm-train launched a kernel of the port: {tr['launches']}")
    out["train"] = tr
    log(f"[lm] launch.train {' '.join(LM_TRAIN)}: loss {tr['first']:.4f} -> "
        f"{tr['loss']:.4f}, {tr['step_ms']:.1f} ms a step, peak memory "
        f"{tr['peak_gb']:.2f} GB, process {tr['wall_s']:.1f} s")
    log(f"[lm] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def no_launch(window: str) -> None:
    """``launched`` for a window of library calls (the EGNN, the recsys
    models): no launch of the port's kernels allowed."""
    counts = launched(window)
    require(not any(counts.values()),
            f"{window}: a library-call path launched a kernel of the port: "
            f"{counts}")


def gnn_molecule(base, rng) -> dict:
    """(n), molecule: 128 molecules of 30 atoms on their own kNN graphs."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.egnn import specialise
    from repro_torch.models import gnn
    from repro_torch.models import graph_sampler as gs
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   value_and_grad)

    dims = GNN_SHAPES["molecule"].dims
    B, n, k = dims["batch"], dims["n_nodes"], GNN_MOLECULE_K
    cfg = specialise(base, "molecule")
    coords = rng.normal(size=(B, n, 3)).astype(np.float32)
    coords *= rng.uniform(0.5, 1.5, (B, 1, 1)).astype(np.float32)
    start_phase()
    t0 = time.perf_counter()
    edges = np.stack([gs.knn_graph(c, k) for c in coords])
    graph_s = time.perf_counter() - t0
    counts = launched("gnn-molecule-graph")
    require(counts["knn"] == B, f"molecule graphs launched knn "
            f"{counts['knn']} times, not once a molecule")
    require(edges.shape == (B, 2, n * k) and n * k <= dims["n_edges"],
            f"molecule edges of shape {edges.shape}")
    centred = coords - coords.mean(1, keepdims=True)
    batch = {name: torch.from_numpy(v).cuda() for name, v in dict(
        feats=rng.normal(size=(B, n, cfg.d_feat)).astype(np.float32),
        coords=coords, edges=edges,
        targets=(centred ** 2).sum(-1).mean(-1).astype(np.float32)).items()}
    gen = torch.Generator(device="cuda").manual_seed(10)
    params = gnn.init_params(cfg, gen, device="cuda")
    with torch.no_grad():
        card = gnn.graph_reg_loss(params, batch, cfg)[0]
        cpu = gnn.graph_reg_loss(tree_map(lambda t: t.cpu(), params),
                                 tree_map(lambda t: t.cpu(), batch), cfg)[0]
    err = values_agree(np.array([float(card)]), np.array([float(cpu)]))
    opt = adamw_init(params)
    losses, step_ms = [], []
    start_phase()
    for _ in range(GNN_MOLECULE_STEPS):
        t0 = time.perf_counter()
        (loss, _), g = value_and_grad(
            lambda p, b: gnn.graph_reg_loss(p, b, cfg), params, batch)
        params, opt, _ = adamw_update(g, opt, params, AdamWConfig(**GNN_OPT))
        losses.append(float(loss))
        step_ms.append(1e3 * sync_s(t0))
    no_launch("gnn-molecule-train")
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"molecule loss did not fall: {losses}")
    log(f"[gnn] molecule ({B} x {n} atoms, d_feat {cfg.d_feat}): "
        f"{B} knn_graph(k={k}) in {graph_s:.3f} s ({k * n} edges each); "
        f"graph_reg_loss card {float(card):.6f} == CPU {float(cpu):.6f} "
        f"(err {err:.3g}); {GNN_MOLECULE_STEPS} AdamW steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; ms a step (host clock, "
        f"synchronised) {step_ms[0]:.3f} the first, median of the rest "
        f"{float(np.median(step_ms[1:])):.3f}")
    return dict(graph_s=graph_s, loss=losses, step_ms=step_ms,
                max_abs_err=err)


def gnn_exact_graph(pts, X, rng) -> dict:
    """(n), minibatch_lg's graph: ``knn_graph(k=492)`` over every point,
    through one knn launch (caught by a spy on ``ops.knn`` so that its
    output can be checked), then ``CSRGraph.from_edge_list``."""
    import torch
    from repro_torch.kernels import ops, ref, topk
    from repro_torch.models import graph_sampler as gs

    N, d = X.shape
    k1 = GNN_LG_K + 1
    seen = {}
    real = ops.knn

    def spy(Q, DB, distance="l2", **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(Q, DB, distance, **kw)
        end.record()
        torch.cuda.synchronize()
        seen.update(ms=start.elapsed_time(end), out=out,
                    done=time.perf_counter())
        return out

    start_phase()
    ops.knn = spy
    try:
        t0 = time.perf_counter()
        edges = gs.knn_graph(pts, GNN_LG_K)
        t_end = time.perf_counter()
    finally:
        ops.knn = real
    counts = launched("gnn-graph")
    require(counts["knn"] == 1,
            f"gnn-graph launched knn {counts['knn']} times")
    wall, mask_s = t_end - t0, t_end - seen["done"]
    kd, ki = seen.pop("out")
    require(edges.shape == (2, N * GNN_LG_K), f"edges of shape {edges.shape}")

    rows = torch.from_numpy(
        rng.choice(N, GNN_CHECK_ROWS, replace=False)).cuda()
    Q = X[rows]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rd, ri = ref.knn_ref(Q, X, k1, "l2")
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    again = ref.rowwise_ref(Q, X[ki[rows].long()], "l2")
    err = topk_agree(kd[rows].cpu(), ki[rows].cpu(), rd.cpu(), ri.cpu(),
                     again.cpu(), squared=True)
    del rd, ri, again

    def library():
        for i in range(0, N, GNN_LIB_BLOCK):
            torch.topk(torch.cdist(X[i:i + GNN_LIB_BLOCK], X), k1,
                       largest=False)

    library_ms = time_ms(library, iters=1, warmup=1)
    b_ms, b_by = bound(2.0 * N * N * d, 4.0 * 2 * N * d + 8.0 * N * k1,
                       PEAK_GRAM)
    geo = topk.knn_geometry(N, N, d, k1, "l2")
    t0 = time.perf_counter()
    g = gs.CSRGraph.from_edge_list(edges[0], edges[1], N)
    csr_s = time.perf_counter() - t0
    require(g.n_edges == N * GNN_LG_K and g.n_nodes == N,
            f"CSR of {g.n_nodes} nodes, {g.n_edges} edges")
    log(f"[gnn] minibatch_lg graph: knn_graph(k={GNN_LG_K}) over {N:,} 3-D "
        f"points: {wall:.3f} s, of it the knn kernel at [{N}, {N}, {d}], "
        f"k={k1}: {seen['ms']:.3f} ms (CUDA events around its one launch), "
        f"the copy to the host and the self-edge mask {mask_s:.3f} s; "
        f"{edges.shape[1]:,} edges; CSRGraph.from_edge_list {csr_s:.3f} s")
    log(f"[time] knn at knn_graph's shape [{N}, {N}, {d}, {k1}]: kernel "
        f"{seen['ms']:.4f} ms, plain {plain_ms:.4f} ms for "
        f"{GNN_CHECK_ROWS} rows, library topk(cdist) over blocks of "
        f"{GNN_LIB_BLOCK} {library_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); {GNN_CHECK_ROWS} random rows held to the plain knn "
        f"(max abs err {err:.3g}, squared)")
    row = dict(shape=[N, N, d, k1], form="l2", launches=counts["knn"],
               ms=seen["ms"], plain_ms=plain_ms, plain_rows=GNN_CHECK_ROWS,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=err, geometry=dict(
                   route=geo.route, bq=geo.bq, splits=geo.splits,
                   chunk=geo.chunk, shared_states=geo.shared_states))
    return dict(edges=edges, graph=g, wall_s=wall, mask_s=mask_s,
                csr_s=csr_s, row=row)


def gnn_pdasc(pts, edges) -> dict:
    """(n): the PDASC route of ``knn_graph`` at k = 15 over every point
    (the build in slabs of ``GROUP_CHUNK`` groups: the default 8 took 23
    of its 26 s at 160,000 points), its edges' overlap with the exact
    graph's first 15 a row."""
    from repro_torch.models import graph_sampler as gs

    N, k = len(pts), GNN_PDASC_K
    start_phase()
    t0 = time.perf_counter()
    got = gs.knn_graph(pts, k, method="pdasc",
                       pdasc_kwargs=dict(group_chunk=GROUP_CHUNK))
    secs = sync_s(t0)
    launched("gnn-pdasc")
    want = edges.reshape(2, N, GNN_LG_K)[:, :, :k].reshape(2, -1)
    key = lambda e: e[0].astype(np.int64) * N + e[1]  # noqa: E731
    overlap = float(np.isin(key(want), key(got)).mean())
    require(overlap > 0.7, f"PDASC knn_graph overlap {overlap:.4f} <= 0.7")
    log(f"[gnn] PDASC knn_graph(k={k}) over {N:,} points (gl "
        f"{max(8, min(64, N // 4))}, group_chunk {GROUP_CHUNK}, dense plan "
        f"at 4 x the default radius): {secs:.3f} s; {got.shape[1]:,} edges, "
        f"overlap with the exact graph's first {k} a row {overlap:.4f} "
        f"(bar 0.7)")
    return dict(seconds=secs, overlap=overlap)


def gnn_stack(subs, args: dict) -> dict:
    """``sample_subgraph``'s arrays (its own feature, coordinate and label
    gathers) stacked into the egnn cell's ``[G, n_max, ...]`` batch on the
    card, each leaf in its argument's shape and dtype (``args``)."""
    import torch

    out = {}
    for key, sd in args.items():
        t = torch.from_numpy(np.stack([s[key] for s in subs])).cuda().to(
            sd.dtype)
        require(tuple(t.shape) == (len(subs),) + tuple(sd.shape[1:]),
                f"{key} of shape {tuple(t.shape)}, the cell's {sd.shape}")
        out[key] = t
    return out


def gnn_train(base, graph, pts, rng) -> dict:
    """(n), minibatch_lg training through the egnn cell
    (``launch.steps``, its subgraph count cut to ``GNN_SUBGRAPHS``, on a
    (1, 1) ``MeshShape``): sampled subgraphs, AdamW steps of the mean of
    their ``node_class_loss`` with remat; card == CPU on one subgraph; two
    backward passes bit-compared with deterministic algorithms off and
    on."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.egnn import specialise
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import gnn
    from repro_torch.models import graph_sampler as gs
    from repro_torch.optim import adamw_init, value_and_grad

    spec = GNN_SHAPES["minibatch_lg"]
    dims = dict(spec.dims, n_subgraphs=GNN_SUBGRAPHS)
    cell = steps.build_cell("egnn", dataclasses.replace(spec, dims=dims),
                            MeshShape(("data", "model"), (1, 1)))
    N, fanouts, seeds_n = dims["n_nodes"], dims["fanouts"], dims["batch_nodes"]
    cfg = specialise(base, "minibatch_lg")
    n_max, e_max = gs.subgraph_budget(seeds_n, fanouts)
    batch_args = cell.args[2]
    require(batch_args["feats"].shape == (GNN_SUBGRAPHS, n_max, cfg.d_feat),
            f"the cell's batch {batch_args['feats'].shape}")
    t0 = time.perf_counter()
    feats = rng.standard_normal((N, cfg.d_feat), dtype=np.float32)
    labels = feats[:, :cfg.n_classes].argmax(1)  # a planted function
    log(f"[gnn] minibatch_lg features [{N}, {cfg.d_feat}] and "
        f"{cfg.n_classes} labels made on the host in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    def sample(count):
        t = time.perf_counter()
        subs = [gs.sample_subgraph(
            graph, rng.choice(N, seeds_n, replace=False), fanouts, rng,
            feats=feats, labels=labels, coords=pts) for _ in range(count)]
        return subs, time.perf_counter() - t

    gen = torch.Generator(device="cuda").manual_seed(11)
    params = gnn.init_params(cfg, gen, device="cuda")
    opt = adamw_init(params)

    def loss_of(p, b):
        return gnn.node_class_loss(p, b, cfg)

    sample_s, copy_s, step_ms, losses, sizes = [], [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    start_phase()
    for _ in range(GNN_STEPS):
        subs, secs = sample(GNN_SUBGRAPHS)
        sample_s.append(secs)
        sizes.append([(s["n_nodes"], s["n_edges"]) for s in subs])
        t0 = time.perf_counter()
        batch = gnn_stack(subs, batch_args)
        copy_s.append(sync_s(t0))
        t0 = time.perf_counter()
        params, opt, m = cell.step(params, opt, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * sync_s(t0))
        del batch, m
    no_launch("gnn-train")
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(np.isfinite(losses).all(), f"minibatch_lg losses {losses}")
    log(f"[gnn] minibatch_lg training through the egnn cell "
        f"({cfg.n_layers} layers, d_hidden {cfg.d_hidden}, d_feat "
        f"{cfg.d_feat}, {cfg.n_classes} classes, remat; the mean of the "
        f"subgraphs' losses): {GNN_STEPS} AdamW steps of {GNN_SUBGRAPHS} "
        f"subgraphs "
        f"(n_max {n_max:,}, e_max {e_max:,}; real (nodes, edges) "
        f"{sizes[0]}): losses {[round(x, 4) for x in losses]}, "
        f"{[round(x, 1) for x in step_ms]} ms a step (host clock, "
        f"synchronised), the batch's copy to the card "
        f"{[round(x, 2) for x in copy_s]} s a step, sampling "
        f"{[round(x, 2) for x in sample_s]} s a step (host, the sampler's "
        f"feature, coordinate and label gathers included), peak memory "
        f"{peak:.2f} GB")

    subs, _ = sample(1)
    one = steps.subgraph_batch(gnn_stack(subs, {
        k: dataclasses.replace(a, shape=(1,) + a.shape[1:])
        for k, a in batch_args.items()}))
    with torch.no_grad():
        card = float(loss_of(params, one)[0])
        cpu = float(loss_of(tree_map(lambda t: t.cpu(), params),
                            {k: v.cpu() for k, v in one.items()})[0])
    err = values_agree(np.array([card]), np.array([cpu]))
    log(f"[gnn] node_class_loss on one subgraph: card {card:.7f} == CPU "
        f"{cpu:.7f} (err {err:.3g})")

    det = {}
    was = torch.are_deterministic_algorithms_enabled()
    try:
        for flag in (False, True):
            torch.use_deterministic_algorithms(flag, warn_only=True)
            runs, ms = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                (loss, _), g = value_and_grad(loss_of, params, one)
                ms.append(1e3 * sync_s(t0))
                runs.append([loss] + tree_leaves(g))
            det[flag] = dict(equal=all(torch.equal(a, b) for a, b in
                                       zip(*runs)), ms=ms)
    finally:
        torch.use_deterministic_algorithms(was)
    log(f"[gnn] one subgraph's loss and gradients twice: bit-equal "
        f"{det[False]['equal']} with deterministic algorithms off "
        f"({[round(x, 1) for x in det[False]['ms']]} ms), "
        f"{det[True]['equal']} with them on "
        f"({[round(x, 1) for x in det[True]['ms']]} ms)")
    require(det[True]["equal"], "deterministic algorithms did not make two "
            "backward passes bit-equal")
    return dict(losses=losses, step_ms=step_ms, sample_s=sample_s,
                copy_s=copy_s,
                peak_gb=peak, max_abs_err=err,
                deterministic={str(k): v for k, v in det.items()})


def phase_gnn() -> dict:
    """(n) The GNN family on the card (see the module docstring)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base = get_arch("egnn").config_fn()
    rng = np.random.default_rng(25)
    out = dict(molecule=gnn_molecule(base, rng))
    N = GNN_SHAPES["minibatch_lg"].dims["n_nodes"]
    pts = rng.uniform(size=(N, 3)).astype(np.float32)
    X = torch.from_numpy(pts).cuda()
    exact = gnn_exact_graph(pts, X, rng)
    out["row"] = exact.pop("row")
    want = GNN_SHAPES["minibatch_lg"].dims["n_edges"]
    log(f"[gnn] {exact['edges'].shape[1]:,} edges against minibatch_lg's "
        f"{want:,}: {100 * abs(exact['edges'].shape[1] / want - 1):.4f}% off")
    out["pdasc"] = gnn_pdasc(pts, exact.pop("edges"))
    out["train"] = gnn_train(base, exact.pop("graph"), pts, rng)
    out["graph"] = exact
    del X
    torch.cuda.empty_cache()
    log(f"[gnn] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def cells_dryrun() -> dict:
    """(o) 1: every cell on both production meshes through
    ``launch.dryrun.run_cell`` on the meta device, in this process."""
    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    n_ok = 0
    for arch, shape in all_cells():
        for mk in ("single", "multi"):
            res = dryrun.run_cell(arch, shape, mk)
            require(res["ok"], f"dry-run of {arch} x {shape} x {mk} failed")
            r, m = res["roofline"], res["memory_analysis"]
            log(f"[cells] {arch} x {shape} x {mk}: {res['n_chips']} ranks, "
                f"flops/rank {res['cost_analysis']['flops']:.4g}, bytes/rank "
                f"(unfused) {res['cost_analysis']['bytes accessed']:.4g}, "
                f"args/rank {m['argument_size_in_bytes'] / 2**30:.4f} GiB, "
                f"fits_hbm {m['fits_hbm']}, bound "
                f"{r['step_time_lower_bound_s'] * 1e3:.4f} ms "
                f"({r['bottleneck']})")
            n_ok += 1
    secs = time.perf_counter() - t0
    log(f"[cells] dry-run {n_ok} ok, 0 failed in {secs:.1f} s")
    return dict(n_ok=n_ok, seconds=secs)


def one_mesh_bound(arch: str, shape: str, variant: str = "base") -> float:
    """The dry-run's ``step_time_lower_bound_s`` of a cell on a (1, 1)
    ``MeshShape``: the whole step on one card."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    res = dryrun.run_cell(arch, shape, "1x1", variant,
                          mesh=MeshShape(("data", "model"), (1, 1)))
    return res["roofline"]["step_time_lower_bound_s"]


def cell_shapes(tree) -> dict:
    """``{path: (shape, dtype)}`` of a tree of tensors or ShapeDtypes."""
    from repro_torch._tree import tree_flatten_with_path

    return {p: (tuple(t.shape), t.dtype)
            for p, t in tree_flatten_with_path(tree)}


def cells_pdasc(mesh) -> dict:
    """(o) 2: the pdasc cells at full width on a world of one: build_1m,
    then search_1m in each of ``CELLS_VARIANTS``."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.baselines import exact_knn
    from repro_torch.configs import get_arch
    from repro_torch.core import distances as dist_lib
    from repro_torch.core import nsa
    from repro_torch.core.reference_impl import check_index_invariants
    from repro_torch.data import make_dataset
    from repro_torch.launch import steps

    cfg = get_arch("pdasc").config_fn()
    t0 = time.perf_counter()
    full = make_dataset("dense_embed", n=cfg.n + cfg.n_queries, seed=26)
    data, Q = _cuda(full[:cfg.n]), _cuda(full[cfg.n:])
    del full
    log(f"[cells] pdasc data: dense_embed {cfg.n:,} x {cfg.d} and "
        f"{cfg.n_queries:,} held-out queries on the card in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    build = steps.build_cell("pdasc", "build_1m", mesh)
    require(cell_shapes((data,)) == cell_shapes(build.args),
            "the build's data differs from the cell's argument")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start_phase()
    t0 = time.perf_counter()
    index = build.step(data)
    build_s = sync_s(t0)
    build_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launched("cells-build")
    local = tree_map(lambda a: a[0], index)
    errs = check_index_invariants(local)
    require(not errs, f"the cell's index breaks invariants: {errs[:3]}")
    lb = one_mesh_bound("pdasc", "build_1m")
    log(f"[cells] pdasc build_1m through the cell (gl {cfg.gl}, "
        f"{cfg.method}, kb {cfg.kb}, {len(local.levels)} levels): "
        f"{build_s:.3f} s (dry-run bound {lb:.4g} s), peak "
        f"{build_gb:.2f} GB; invariants hold; pairwise "
        f"{counts['pairwise']}, swap_deltas {counts['swap_deltas']} "
        f"launches")
    out = dict(build=dict(seconds=build_s, peak_gb=build_gb, bound_s=lb,
                          launches=counts))
    start_phase()
    _, gt = exact_knn(Q, data, k=cfg.k, device=data.device)
    launched("cells-truth")
    gt = gt.cpu().numpy()
    dist = dist_lib.get(cfg.distance)
    for variant in CELLS_VARIANTS:
        cell = steps.build_cell("pdasc", "search_1m", mesh, variant=variant)
        require(cell_shapes(index) == cell_shapes(cell.args[0]),
                f"the built index's leaves differ from the dry-run's "
                f"analytic search arguments ({variant})")
        torch.cuda.reset_peak_memory_stats()
        start_phase()
        res = cell.step(index, Q)
        torch.cuda.synchronize()
        counts = launched(f"cells-search-{variant}")
        t0 = time.perf_counter()
        again = cell.step(index, Q)
        ms = 1e3 * sync_s(t0)
        gb = torch.cuda.max_memory_allocated() / 1e9
        require(torch.equal(again.ids, res.ids)
                and torch.equal(again.dists, res.dists),
                f"two calls of the {variant} search differ")
        if variant == "opt-beam":
            mc = (0,) + (8,) * (len(local.levels) - 1)
            want = nsa.search_beam(local, Q, dist=dist, k=cfg.k,
                                   r=cfg.radius, beam=32, max_children=mc)
            what = "one-process beam search (beam 32, max_children 8)"
        else:
            want = nsa.search_dense(local, Q, dist=dist, k=cfg.k,
                                    r=cfg.radius)
            what = "one-process dense search"
        gd = res.dists.cpu().numpy()
        err = topk_agree(gd, res.ids.cpu().numpy(), want.dists.cpu().numpy(),
                         want.ids.cpu().numpy(), gd, squared=True)
        rec = recall(res.ids.cpu().numpy(), gt)
        lb = one_mesh_bound("pdasc", "search_1m", variant)
        out[variant] = dict(ms=ms, peak_gb=gb, bound_s=lb, recall=rec,
                            max_abs_err=err, launches=counts)
        log(f"[cells] pdasc search_1m {variant} through the cell "
            f"({cfg.n_queries} queries, k {cfg.k}, radius {cfg.radius}): "
            f"second call {ms:.3f} ms (dry-run bound {lb * 1e3:.4f} ms), "
            f"peak {gb:.2f} GB; == the {what} on the same index up to "
            f"near-ties (max abs err {err:.3g}); recall@{cfg.k} {rec:.4f} "
            f"against exact_knn")
        del res, again, want
    del index, local, data, Q
    torch.cuda.empty_cache()
    return out


def cells_recsys(mesh) -> dict:
    """(o) 3: wide-deep's retrieval_cand, serve_p99 and train_batch cells
    at full width, each through ``cell.step`` on tensors made from its
    arguments."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batch
    from repro_torch.data.pipeline import place
    from repro_torch.kernels import ref
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rec
    from repro_torch.optim import adamw_init

    arch = "wide-deep"
    cfg = get_arch(arch).config_fn()
    gen = torch.Generator(device="cuda").manual_seed(26)
    params = rec.init_params(cfg, gen, device="cuda")
    out = {}

    cell = steps.build_cell(arch, "retrieval_cand", mesh)
    require(cell_shapes(params) == cell_shapes(cell.args[0]),
            "the params differ from the cell's arguments")
    user = place(recsys_batch(1, 1, cfg, seed=26), "cuda")
    user.pop("labels")
    require(cell_shapes(user) == cell_shapes(cell.args[1]),
            "the user batch differs from the cell's argument")
    C = torch.randn(cell.args[2].shape, generator=gen, device="cuda")
    k = 100
    start_phase()
    with torch.no_grad():
        scores, ids = cell.step(params, user, C)
    torch.cuda.synchronize()
    counts = launched("cells-retrieval")
    require(counts["knn"] == 1, f"the retrieval cell launched knn "
            f"{counts['knn']} times")
    with torch.no_grad():
        u = rec.user_vector(params, user, cfg)
        rd, ri = ref.knn_ref(u, C, k, "dot")
        again = -(C[ids[0].long()] @ u[0])[None]
        ms = time_ms(lambda: cell.step(params, user, C))
    err = topk_agree(-scores.cpu(), ids.cpu(), rd.cpu(), ri.cpu(),
                     again.cpu())
    lb = one_mesh_bound(arch, "retrieval_cand")
    out["retrieval"] = dict(ms=ms, bound_s=lb, max_abs_err=err)
    log(f"[cells] {arch} retrieval_cand through the cell ([1, "
        f"{C.shape[0]:,}, {C.shape[1]}], k {k}): {ms:.4f} ms a step (CUDA "
        f"events; dry-run bound {lb * 1e3:.4f} ms); top-{k} == knn_ref up "
        f"to near-ties (max abs err {err:.3g})")
    del C, rd, ri, again

    cell = steps.build_cell(arch, "serve_p99", mesh)
    batch = place(recsys_batch(0, cell.args[1]["sparse"].shape[0], cfg,
                               seed=26), "cuda")
    batch.pop("labels")
    require(cell_shapes(batch) == cell_shapes(cell.args[1]),
            "the serve batch differs from the cell's argument")
    start_phase()
    with torch.no_grad():
        probs = cell.step(params, batch)
    torch.cuda.synchronize()
    no_launch("cells-serve")
    require(tuple(probs.shape) == (batch["sparse"].shape[0],)
            and bool(((probs >= 0) & (probs <= 1)).all()),
            f"serve probabilities of shape {tuple(probs.shape)}")
    with torch.no_grad():
        ms = time_ms(lambda: cell.step(params, batch))
    lb = one_mesh_bound(arch, "serve_p99")
    out["serve"] = dict(ms=ms, bound_s=lb)
    log(f"[cells] {arch} serve_p99 through the cell (batch "
        f"{probs.shape[0]}): {ms:.4f} ms a step (CUDA events; dry-run bound "
        f"{lb * 1e3:.4f} ms); probabilities in [0, 1]")

    cell = steps.build_cell(arch, "train_batch", mesh)
    batch = place(recsys_batch(0, cell.args[2]["sparse"].shape[0], cfg,
                               seed=27), "cuda")
    require(cell_shapes(batch) == cell_shapes(cell.args[2]),
            "the train batch differs from the cell's argument")
    opt = adamw_init(params)
    require(cell_shapes(opt) == cell_shapes(cell.args[1]),
            "the optimizer state differs from the cell's argument")
    torch.cuda.reset_peak_memory_stats()
    start_phase()
    step_ms, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        params, opt, m = cell.step(params, opt, batch)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * sync_s(t0))
    no_launch("cells-train")
    require(np.isfinite(losses).all(), f"train losses {losses}")
    lb = one_mesh_bound(arch, "train_batch")
    gb = torch.cuda.max_memory_allocated() / 1e9
    out["train"] = dict(step_ms=step_ms, loss=losses, bound_s=lb, peak_gb=gb)
    log(f"[cells] {arch} train_batch through the cell (batch "
        f"{batch['sparse'].shape[0]:,}): losses {losses}, {step_ms[0]:.1f} "
        f"ms the first step, {step_ms[1]:.1f} ms the second (host clock, "
        f"synchronised; dry-run bound {lb * 1e3:.4f} ms), peak {gb:.2f} GB")
    del params, opt, batch
    torch.cuda.empty_cache()
    return out


def phase_cells() -> dict:
    """(o) The cells and the dry-run (see the module docstring)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    out = dict(dryrun=cells_dryrun())
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        out["pdasc"] = cells_pdasc(mesh)
        out["recsys"] = cells_recsys(mesh)
    finally:
        dist.destroy_process_group()
    log(f"[cells] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py drives the port on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    load_constants()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = nvidia_smi()
    log(f"[env] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"TF32 off (matmul allow_tf32=False, precision 'highest', cudnn "
        f"allow_tf32=False)")

    from repro_torch.data import make_dataset

    phase_build()
    phase_parity()
    t0 = time.perf_counter()
    full = make_dataset("dense_embed", n=N_MAIN + N_QUERIES, seed=0)
    data, test = full[:N_MAIN], full[N_MAIN:]
    log(f"[main] data made in {time.perf_counter() - t0:.1f} s (set-up)")
    phase_build_parity(data)
    main_run = phase_main_path(data, test)
    phase_cpu_check(main_run)
    phase_profile(data, main_run)
    rows = phase_timing(data, main_run)
    phase_kmeans(data, test, main_run)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        phase_online(main_run, data, work)
        engine = phase_serve_engine(main_run)
        phase_serve_churn(main_run, data, engine["qps"])
        phase_serve_replicated(main_run, data)
        store = phase_store(main_run, work)  # releases the dense payload
        rows.append(phase_scan_timing(main_run, store))
        phase_serve_two_stage(main_run, work)
        phase_store_churn(main_run, data)
    phase_recall_record()
    phase_quickstart()
    phase_serve_cli(SERVE_CLI_PATHS)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        phase_distributed(work)
        phase_remote(main_run, data, work)
    phase_serve_cli(SERVE_CLI_REMOTE_PATHS, "serve-cli-remote")
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        phase_autotune(main_run, data, work)
    phase_nndescent(data, test)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        recsys = phase_recsys(work)
    phase_lm()
    gnn = phase_gnn()
    phase_cells()
    knn_row = next(r for r in rows if r["name"] == "knn")
    knn_row["retrieval"] = recsys["row"]
    knn_row["knn_graph"] = gnn["row"]
    log(f"[script] {time.perf_counter() - t_start:.1f} s from its start")
    for r in rows:  # each phase's launches of the kernel, beside the main path's
        r["phase_launches"] = {ph: c[r["name"]] for ph, c in PHASE_LAUNCHES.items()}
    torch.cuda.synchronize()
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
