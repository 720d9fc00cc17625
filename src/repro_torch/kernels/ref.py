"""Plain PyTorch versions of the kernel contracts.

Every CUDA kernel of this package has its contract defined *here*, as in
``repro.kernels.ref``: ``ops.py`` runs these functions for tensors on the
CPU, the tests hold them against ``repro``'s oracles, and ``chip_smoke.py``
holds each CUDA kernel against them on the card. Nothing on the main path
calls them for a CUDA tensor.

Forms (registry names map onto forms via ``FORM_OF``):

  sqeuclidean  ||x-y||^2            (Gram form)
  l2           ||x-y||              (Gram form)
  cosine       1 - x.y/(|x||y|)     (Gram form)
  dot          -x.y                 (Gram form)
  l1           sum|x-y|             (abs-difference form)
  chebyshev    max|x-y|             (abs-difference form)

Top-k order: ``jax.lax.top_k`` puts the lower index first among equal
values, and ``torch.topk`` makes no such promise, so :func:`topk_smallest`
takes a stable sort of the key and keeps its first ``k`` columns.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

GRAM_FORMS = ("sqeuclidean", "l2", "cosine", "dot")
VPU_FORMS = ("l1", "chebyshev")
FORMS = GRAM_FORMS + VPU_FORMS
NORM_FORMS = ("sqeuclidean", "l2", "cosine")  # forms consuming ||c||^2

# registry distance name -> kernel form
FORM_OF = {
    "euclidean": "l2",
    "manhattan": "l1",
    "chebyshev": "chebyshev",
    "cosine": "cosine",
    "dot": "dot",
}

_EPS = 1e-12
BIG = 1e30


def topk_smallest(D: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The ``k`` smallest entries along the last axis, ascending, with the
    lower index first among equal values (``lax.top_k(-D, k)``'s order).
    Returns ``(values, int32 indices)``."""
    vals, idx = torch.sort(D, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def topk_largest(D: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The ``k`` largest entries along the last axis, descending, lower
    index first among equal values (``lax.top_k(D, k)``'s order)."""
    vals, idx = torch.sort(D, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def stream_blocks(pairwise_fn, X: Tensor, Y: Tensor, chunk: int) -> Tensor:
    """``pairwise_fn`` applied to ``[chunk]``-row slabs of ``X`` and ``Y``
    and written into one ``[..., m, n]`` result, so that a broadcast-form
    distance never holds more than a ``[chunk, chunk, d]`` cube."""
    m, n = X.shape[-2], Y.shape[-2]
    out = None
    for i in range(0, m, chunk):
        for j in range(0, n, chunk):
            blk = pairwise_fn(X[..., i:i + chunk, :], Y[..., j:j + chunk, :])
            if out is None:
                out = blk.new_empty(blk.shape[:-2] + (m, n))
            out[..., i:i + chunk, j:j + chunk] = blk
    return out


def pairwise_ref_chunked(X: Tensor, Y: Tensor, form: str, chunk: int) -> Tensor:
    """Broadcast-form pairwise with both axes streamed: peak memory is one
    ``[chunk, chunk, d]`` slab regardless of ``m`` and ``n``."""
    if X.shape[-2] <= chunk and Y.shape[-2] <= chunk:
        return pairwise_ref(X, Y, form)
    return stream_blocks(lambda a, b: pairwise_ref(a, b, form), X, Y, chunk)


def pairwise_ref(X: Tensor, Y: Tensor, form: str) -> Tensor:
    """``[..., m, d] x [..., n, d] -> [..., m, n]`` distances (float32).

    Leading axes are a batch of groups (the build's ``[G, g, d]`` slabs)."""
    X = X.float()
    Y = Y.float()
    if form in ("sqeuclidean", "l2"):
        xx = torch.sum(X * X, dim=-1)
        yy = torch.sum(Y * Y, dim=-1)
        g = X @ Y.transpose(-1, -2)
        d2 = torch.clamp(xx[..., :, None] + yy[..., None, :] - 2.0 * g, min=0.0)
        return d2 if form == "sqeuclidean" else torch.sqrt(d2)
    if form == "cosine":
        xn = torch.sqrt(torch.clamp(torch.sum(X * X, dim=-1), min=_EPS))
        yn = torch.sqrt(torch.clamp(torch.sum(Y * Y, dim=-1), min=_EPS))
        cos = (X @ Y.transpose(-1, -2)) / (xn[..., :, None] * yn[..., None, :])
        return 1.0 - torch.clamp(cos, -1.0, 1.0)
    if form == "dot":
        return -(X @ Y.transpose(-1, -2))
    if form == "l1":
        return torch.abs(X[..., :, None, :] - Y[..., None, :, :]).sum(-1)
    if form == "chebyshev":
        return torch.abs(X[..., :, None, :] - Y[..., None, :, :]).amax(-1)
    raise ValueError(f"unknown form {form!r}")


def knn_ref(Q: Tensor, DB: Tensor, k: int, form: str) -> tuple[Tensor, Tensor]:
    """Brute-force k-NN of ``[q, d]`` queries over an ``[n, d]`` database.

    Returns ``(dists[q, k] ascending, ids[q, k] int32)``."""
    return topk_smallest(pairwise_ref(Q, DB, form), k)


def swap_deltas_ref(
    D: Tensor, d1: Tensor, d2: Tensor, n1: Tensor, valid: Tensor, k: int
) -> Tensor:
    """FasterPAM swap-sweep terms ``dTD[i, j] = S[j] + T[i, j]``.

    ``D``: ``[..., g, g]`` dissimilarities; ``d1/d2``: ``[..., g]`` nearest
    and second-nearest medoid distance; ``n1``: ``[..., g]`` nearest medoid
    slot; ``valid``: ``[..., g]``. Returns the raw ``[..., k, g]`` deltas
    (callers mask medoid and invalid columns)::

      S[j]    = sum_o min(D[o, j] - d1[o], 0)
      T[i, j] = sum_{o: n1[o]=i, D[o, j] >= d1[o]} min(d2[o], D[o, j]) - d1[o]
    """
    vf = valid.float()[..., :, None]
    D = D.float()
    c1 = d1.float()[..., :, None]
    gain = torch.clamp(D - c1, max=0.0) * vf
    S = gain.sum(-2)  # [..., g]
    t = torch.where(D >= c1, torch.minimum(d2.float()[..., :, None], D) - c1,
                    torch.zeros_like(D)) * vf
    seg = torch.where(valid, n1.long(), torch.full_like(n1.long(), k))
    T = D.new_zeros(D.shape[:-2] + (k + 1, D.shape[-1]))
    T.scatter_add_(-2, seg[..., :, None].expand_as(t), t)  # invalid -> bucket k
    return S[..., None, :] + T[..., :k, :]


def fold_slot_valid(cand_idx: Tensor, cand_ok: Tensor, slot_valid) -> Tensor:
    """AND a per-row table validity mask (``bool[n]``, True = live) into a
    candidate mask; ``None`` passes ``cand_ok`` through."""
    if slot_valid is None:
        return cand_ok
    n = slot_valid.shape[0]
    rows = torch.clamp(cand_idx.long(), 0, n - 1)
    return cand_ok & slot_valid[rows]


def rowwise_ref(
    Q: Tensor, C: Tensor, form: str, cc: Optional[Tensor] = None
) -> Tensor:
    """Per-query candidate distances: ``[b, d] x [b, w, d] -> [b, w]``.

    ``cc`` optionally supplies the squared candidate norms ``[b, w]``
    (gathered from the index's norm cache); without it they are reduced
    from ``C``."""
    Q = Q.float()
    C = C.float()
    if cc is None and form in NORM_FORMS:
        cc = torch.sum(C * C, dim=-1)
    if form in GRAM_FORMS:
        g = torch.einsum("bd,bwd->bw", Q, C)
        if form == "dot":
            return -g
        qq = torch.sum(Q * Q, dim=-1)[:, None]
        cc = cc.float()
        if form in ("sqeuclidean", "l2"):
            d2 = torch.clamp(qq + cc - 2.0 * g, min=0.0)
            return d2 if form == "sqeuclidean" else torch.sqrt(d2)
        qn = torch.sqrt(torch.clamp(qq, min=_EPS))
        cn = torch.sqrt(torch.clamp(cc, min=_EPS))
        return 1.0 - torch.clamp(g / (qn * cn), -1.0, 1.0)
    if form == "l1":
        return torch.abs(Q[:, None, :] - C).sum(-1)
    if form == "chebyshev":
        return torch.abs(Q[:, None, :] - C).amax(-1)
    raise ValueError(f"unknown form {form!r}")


def rank_ref(
    Q: Tensor, C: Tensor, ok: Tensor, k: int, form: str,
    cc: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Masked per-query top-k over gathered candidates ``C [b, w, d]``.

    Returns ``(dists[b, k] ascending, slots[b, k])`` into the ``w`` axis;
    masked slots rank as ``BIG``."""
    D = torch.where(ok, rowwise_ref(Q, C, form, cc),
                    torch.full((), BIG, device=Q.device))
    return topk_smallest(D, k)


def rank_gathered_ref(
    Q: Tensor, points: Tensor, sq_norm: Optional[Tensor], cand_idx: Tensor,
    ok: Tensor, k: int, form: str,
) -> tuple[Tensor, Tensor]:
    """The rank kernel's function: candidates given as rows ``cand_idx
    [b, w]`` of a shared ``points [n, d]`` table. Gathers the ``[b, w, d]``
    cube (the kernel gathers inside itself) and ranks it."""
    rows = torch.clamp(cand_idx.long(), 0, points.shape[0] - 1)
    cc = sq_norm[rows] if (form in NORM_FORMS and sq_norm is not None) else None
    return rank_ref(Q, points[rows], ok, k, form, cc=cc)


# -- packed code formats (int4 / binary payload tiers) ----------------------

CODE_FORMATS = ("dense", "int4", "binary")


def packed_width(d: int, fmt: str) -> int:
    """Packed last-axis width of a ``[.., d]`` code row in format ``fmt``."""
    if fmt == "int4":
        return -(-d // 2)
    if fmt == "binary":
        return -(-d // 8)
    return d


def _pad_last(t: Tensor, width: int) -> Tensor:
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def pack_int4(vals: Tensor) -> Tensor:
    """Pack int4 codes two per byte along the last axis.

    ``vals``: ``[..., d]`` integer codes in ``[-8, 7]``. Returns
    ``[..., ceil(d/2)]`` int8: element ``2j`` in the low nibble of byte
    ``j``, ``2j+1`` in the high nibble (zero-padded when ``d`` is odd)."""
    v = vals.to(torch.int32)
    dc = packed_width(v.shape[-1], "int4")
    pairs = _pad_last(v, 2 * dc).reshape(*v.shape[:-1], dc, 2)
    packed = ((pairs[..., 1] & 0xF) << 4) | (pairs[..., 0] & 0xF)  # 0..255
    return ((packed ^ 0x80) - 0x80).to(torch.int8)  # the byte as int8


def pack_binary(x: Tensor) -> Tensor:
    """Pack sign bits eight per byte along the last axis.

    ``x``: ``[..., d]`` values (or bools); bit ``j`` of byte ``i`` is
    ``x[..., 8i+j] >= 0``. Returns ``[..., ceil(d/8)]`` uint8."""
    bits = (x if x.dtype == torch.bool else x >= 0).to(torch.int32)
    dc = packed_width(bits.shape[-1], "binary")
    groups = _pad_last(bits, 8 * dc).reshape(*bits.shape[:-1], dc, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=x.device)
    return (groups * weights).sum(-1).to(torch.uint8)


def unpack_codes(codes: Tensor, fmt: str, d: int) -> Tensor:
    """Unpack packed codes to per-dimension integer codes.

    ``codes``: ``[..., packed_width(d, fmt)]``; returns ``[..., d]`` int32:
    signed nibbles for ``int4``, ±1 for ``binary``. ``dense`` passes
    through (int8 / fp16 codes keep their dtype). The byte is taken as
    ``& 0xFF`` first, whatever the container's signedness, then sign
    extended without branches: the arithmetic ``csrc/scan.cu`` inlines."""
    if fmt == "dense":
        return codes
    c = codes.to(torch.int32) & 0xFF
    if fmt == "int4":
        lo = ((c & 0xF) ^ 0x8) - 0x8
        hi = ((c >> 4) ^ 0x8) - 0x8
        full = torch.stack([lo, hi], dim=-1).reshape(*c.shape[:-1], -1)
        return full[..., :d]
    if fmt == "binary":
        shifts = torch.arange(8, dtype=torch.int32, device=c.device)
        bits = (c[..., None] >> shifts) & 1
        return (2 * bits.reshape(*c.shape[:-1], -1) - 1)[..., :d]
    raise ValueError(f"unknown code format {fmt!r}; use {CODE_FORMATS}")


def scan_quantized_ref(
    Q: Tensor, C: Tensor, c_scales: Tensor, ok: Tensor, k: int, form: str,
    fmt: str = "dense",
) -> tuple[Tensor, Tensor]:
    """Stage-1 scan of the two-stage search over gathered quantised codes.

    ``C``: ``[b, w, dc]`` per-query candidate codes (int8 or fp16 for
    ``"dense"``, packed int4 / binary otherwise); ``c_scales``: ``[b, w]``
    per-row scales. Candidates are unpacked, dequantised (``code *
    scale``) and ranked like :func:`rank_ref`, with the squared norms taken
    from the dequantised rows; masked slots rank as ``BIG``. Returns
    ``(dists[b, k] ascending, slots[b, k])``."""
    Cf = unpack_codes(C, fmt, Q.shape[-1]).float() \
        * c_scales.float()[..., None]
    return rank_ref(Q, Cf, ok, k, form)


def dequantize_rows(codes: Tensor, scales: Tensor, block: int, rows: Tensor,
                    fmt: str, d: int) -> Tensor:
    """Rows ``rows [...]`` of a code table ``codes [n, dc]``, unpacked and
    dequantised with ``scales[row // block]``: ``[..., d]`` float32."""
    rows = torch.clamp(rows.long(), 0, codes.shape[0] - 1)
    srows = scales[torch.clamp(rows // block, 0, scales.shape[0] - 1)]
    return unpack_codes(codes[rows], fmt, d).float() * srows.float()[..., None]


def scan_gathered_ref(
    Q: Tensor, codes: Tensor, scales: Tensor, block: int, cand_idx: Tensor,
    ok: Tensor, k: int, form: str, fmt: str = "dense",
) -> tuple[Tensor, Tensor]:
    """The scan kernel's function: candidates given as rows ``cand_idx
    [b, w]`` of a shared code table ``codes [n, dc]`` whose rows take
    ``scales[row // block]``. Gathers and dequantises the ``[b, w, d]``
    candidates (the kernel reads the codes in place) and ranks them."""
    C = dequantize_rows(codes, scales, block, cand_idx, fmt, Q.shape[-1])
    return rank_ref(Q, C, ok, k, form)
