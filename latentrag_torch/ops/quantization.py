"""Int8 (SQ8) and packed int4 (SQ4) scalar quantization of the latent corpus.

The port of the JAX package's ``ops/quantization.py``:

* ``sq8_quantize``: symmetric per-tensor int8 codes and their scale; the
  int8 store keeps the codes on the device, the binary and int4 stores
  keep them on the host for their exact stage-2 rescore;
* ``sq4_quantize`` / ``sq4_quantize_with_scale`` / ``sq4_unpack``: two
  4-bit codes in [-7, 7] a byte, the int4 store's device operand;
* ``sq8_topk`` / ``sq4_topk``: the plain searches over those stores, the
  JAX functions at ``recall_target=1.0`` (XLA's ``approx_max_k`` is an
  exact top-k on the CPU): the queries quantized with one SQ8 scale over
  the whole batch, ``int8 x int8`` dots, scores ``float32(dot) *
  float32(q_scale * corpus_scale)``, the exact top k with ties to the
  lower row, the corpus in blocks. They are the stores' search on the CPU
  and the plain versions of the int8 and int4 kernels in
  ``ops.fused_topk``.

Codes, scales and scores are the JAX package's bit for bit: ``torch.round``
rounds half to even as ``jnp.round`` does; a scale is max|x| times the fp32
reciprocal of 127 (or 7), since XLA compiles the JAX package's division by
that constant into that product (its HLO: ``multiply(max, 0.00787401572)``),
which differs from an fp32 division by one ulp for a few percent of maxima;
the codes divide by the scale in fp32, as the HLO does; and the dots are
exact integers. The plain searches take the
dots as fp32 products of the codes: each product is at most 127^2 = 16129
and every partial sum of d <= 1040 of them stays below 2^24, so an fp32
sum in any order (TF32 too: the codes have 7 significant bits) is the
integer dot.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import NEG_INF, as_bool_mask, decode_keys, order_keys

SQ4_LEVELS = 7  # symmetric [-7, 7]; code -8 is unused so negation is exact
# fp32 reciprocals of the code ranges, as XLA folds the JAX package's
# division by the constant
_INV_127 = float(np.float32(1) / np.float32(127))
_INV_SQ4 = float(np.float32(1) / np.float32(SQ4_LEVELS))


def sq8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (codes [N, D] int8, scale f32).

    ``x ~ codes * scale``; scale = max|x| / 127, as the JAX package's
    compiled function computes it (see the module's docstring), so scale
    and codes match it bit for bit."""
    x = x.float()
    scale = torch.clamp(x.abs().max() * _INV_127, min=1e-12)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def sq8_queries(queries) -> tuple:
    """The prepared queries' SQ8 (codes, scale) by ``sq8_quantize``, one
    scale over the batch; a pair that the caller quantized already passes
    as it is (a sharded search quantizes its queries once, not once a
    shard)."""
    if isinstance(queries, tuple):
        return queries
    return sq8_quantize(queries)


def sq4_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int4: (packed uint8 [N, ceil(D/2)], scale).

    ``x ~ codes * scale``; scale = max|x| / 7. Codes live in [-7, 7] and
    pack two a byte (low nibble the even dim, high nibble the odd dim,
    two's complement in 4 bits); an odd D pads a code 0."""
    x = x.float()
    scale = torch.clamp(x.abs().max() * _INV_SQ4, min=1e-12)
    return sq4_quantize_with_scale(x, scale), scale


def sq4_quantize_with_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """Pack int4 codes at an existing scale (rows added to a store must
    compare with its rows)."""
    codes = torch.clamp(torch.round(x.float() / scale), -SQ4_LEVELS,
                        SQ4_LEVELS).to(torch.int8)
    if codes.shape[1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    lo = codes[:, 0::2].view(torch.uint8) & 0xF  # the same 8 bits
    hi = codes[:, 1::2].view(torch.uint8) & 0xF
    return (lo | (hi << 4)).contiguous()


def sq4_unpack(packed: torch.Tensor, d: int) -> torch.Tensor:
    """uint8 [N, ceil(d/2)] -> int8 codes [N, d] (sign-extended)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)[:, :d]


def score_factor(q_scale, corpus_scale) -> torch.Tensor:
    """``float32(q_scale * corpus_scale)`` as a one-element fp32 tensor on
    the queries' scale's device: what the int32 dots are multiplied by."""
    q_scale = torch.as_tensor(q_scale, dtype=torch.float32)
    return (q_scale * torch.as_tensor(corpus_scale, dtype=torch.float32,
                                      device=q_scale.device)).reshape(1)


def quantized_scores(q_codes: torch.Tensor, rows: torch.Tensor,
                     factor: torch.Tensor) -> torch.Tensor:
    """[Q, B] fp32 scores ``float32(q_codes . rows) * factor`` of int8 code
    rows; the dots are exact (see the module's docstring)."""
    return (q_codes.float() @ rows.float().T) * factor


def quantized_topk(q_codes: torch.Tensor, n: int, rows_of, factor, k: int,
                   block_size: int = 2097152, mask=None):
    """Exact top-k of ``quantized_scores`` over N code rows, the corpus in
    blocks (``rows_of(lo, hi)`` gives rows [lo, hi) as int8 codes):
    (scores [Q, k] f32, ids [Q, k] i64), best first, ties to the lower row.
    Rows outside ``mask`` (bool [N], or its packed int32 words) score
    NEG_INF and their ids are arbitrary, as the JAX functions leave them;
    callers sentinel those slots."""
    mask = as_bool_mask(mask, n)
    k = min(k, n)
    dev = q_codes.device
    run = None
    for base in range(0, n, block_size):
        end = min(base + block_size, n)
        s = quantized_scores(q_codes, rows_of(base, end), factor)
        if mask is not None:
            s = torch.where(mask[None, base:end], s, NEG_INF)
        rows = torch.arange(base, end, device=dev)
        keys = torch.topk(order_keys(s, rows[None, :]), min(k, end - base),
                          dim=1)[0]
        if run is not None:
            keys = torch.topk(torch.cat([run, keys], dim=1), k, dim=1)[0]
        run = keys
    return decode_keys(run)


def same_ids_at_ties(scores_a, ids_a, scores_b, ids_b) -> np.ndarray:
    """Per row, whether two top-k results agree up to the order of ties:
    equal scores, distinct ids on each side (ids < 0 are empty slots), and
    the same ids by set within each group of equal scores. The last group
    of a row may be cut by k, so there the two sides may hold different
    members of the tie. A row of ids shorter than its scores (a row of doc
    ids with its empty slots dropped) is padded with empty slots."""
    def arr(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def padded(ids, n):
        ids = arr(ids).astype(np.int64)
        return np.concatenate([ids, np.full(n - len(ids), -1, np.int64)])

    out = []
    for sa, ia, sb, ib in zip(scores_a, ids_a, scores_b, ids_b):
        sa, sb = arr(sa), arr(sb)
        if sa.shape != sb.shape or not np.array_equal(sa, sb):
            out.append(False)
            continue
        ia, ib = padded(ia, len(sa)), padded(ib, len(sa))
        ok = all(len(np.unique(i[i >= 0])) == int((i >= 0).sum())
                 for i in (ia, ib))
        out.append(ok and all(
            set(ia[sa == v].tolist()) == set(ib[sa == v].tolist())
            for v in np.unique(sa) if v != sa[-1]))
    return np.asarray(out, dtype=bool)


def sq8_topk(
    queries: torch.Tensor,
    corpus_codes: torch.Tensor,
    corpus_scale,
    k: int,
    block_size: int = 2097152,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine/dot top-k over an int8 corpus: (scores [Q, k] f32, ids [Q, k]
    i64). Queries (prepared for the metric) are quantized with one scale
    over the batch (``sq8_queries``); scores return in the float scale. The JAX function at
    ``recall_target=1.0``. ``mask`` restricts eligibility; excluded slots
    score NEG_INF."""
    q_codes, q_scale = sq8_queries(queries)
    return quantized_topk(
        q_codes, corpus_codes.shape[0],
        lambda lo, hi: corpus_codes[lo:hi],
        score_factor(q_scale, corpus_scale), k, block_size, mask)


def sq4_topk(
    queries: torch.Tensor,
    packed: torch.Tensor,
    corpus_scale,
    d: int,
    k: int,
    block_size: int = 2097152,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine/dot top-k over a packed int4 corpus: each block unpacks to
    int8 codes and scores against the SQ8-quantized queries, as
    ``sq8_topk`` does (the JAX function at ``recall_target=1.0``)."""
    q_codes, q_scale = sq8_queries(queries)
    return quantized_topk(
        q_codes, packed.shape[0],
        lambda lo, hi: sq4_unpack(packed[lo:hi], d),
        score_factor(q_scale, corpus_scale), k, block_size, mask)
