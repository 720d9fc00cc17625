"""Model zoo of the port (counterpart of ``repro.models``).

  recsys.py — EmbeddingBag + Wide&Deep / xDeepFM / DIN / AutoInt, and the
              1M-candidate retrieval on ``ops.knn``

``repro``'s transformer, EGNN and graph sampler come in later slices.
"""
