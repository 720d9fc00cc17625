"""Model zoo of the port (counterpart of ``repro.models``).

  transformer.py — decoder-only LMs (dense + MoE): GQA, sort-dispatch MoE
                   with shared experts, chunked online-softmax attention,
                   chunked-vocab cross-entropy, per-layer remat, prefill
                   and KV-cache decode
  gnn.py         — EGNN (E(n)-equivariant message passing, ``index_add``
                   aggregation), node classification and batched
                   molecule regression
  graph_sampler.py — CSR graphs, GraphSAGE fan-out sampling (numpy, the
                   same draws as ``repro``'s), k-NN graphs on ``ops.knn``
                   or the PDASC index
  recsys.py      — EmbeddingBag + Wide&Deep / xDeepFM / DIN / AutoInt, and
                   the 1M-candidate retrieval on ``ops.knn``
"""
