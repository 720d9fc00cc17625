"""Model zoo of the port (counterpart of ``repro.models``).

  transformer.py — decoder-only LMs (dense + MoE): GQA, sort-dispatch MoE
                   with shared experts, chunked online-softmax attention,
                   chunked-vocab cross-entropy, per-layer remat, prefill
                   and KV-cache decode
  recsys.py      — EmbeddingBag + Wide&Deep / xDeepFM / DIN / AutoInt, and
                   the 1M-candidate retrieval on ``ops.knn``

``repro``'s EGNN and graph sampler come in a later slice.
"""
