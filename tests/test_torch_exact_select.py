"""The exact search past the exact kernel's 2048 (``csrc/exact_select.cuh``)
on the CPU: the plain version against the JAX package, and a numpy mirror
of the kernel's routes against the plain version bit for bit: the radix
select, collect and sort on data with heavy ties, and the buffer routes
(a threshold from a strided sample, one buffer pass with its capacity and
count, the check, the radix select for the queries that fall back, the
sort) on rows in random order, on corpora built so that the sample
misplaces the threshold, and on ties at it.

The JAX package's exact search at these k is ``pallas_topk_raw(mode=
"exact")``, but its kernel unrolls one extraction per kept entry, and in
interpret mode XLA takes over ten minutes to compile it on the CPU at
k=2049 (N=2600, d=16). So the plain version is held to the JAX
``exact_topk`` (the package's exact oracle, the same top k ties to the
lower row), and ``pallas_topk_raw`` is run in interpret mode at a k the
CPU compiles quickly, to hold the two JAX functions to each other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops.pallas_topk import pallas_topk_raw
from latentrag_tpu.ops.topk import exact_topk as jax_exact_topk
from latentrag_torch.ops import fused_topk as ft


def _case(rng, metric, nq=5, n=2600, d=16):
    q = rng.standard_normal((nq, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
    return q, c


@pytest.mark.parametrize("k", [2049, 2600])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_plain_past_2048_matches_jax(rng, metric, k):
    """The plain version of the exact entry at k past the lists (k=N
    included) gives the JAX exact search's ids and scores."""
    q, c = _case(rng, metric)
    s_t, i_t = ft.fused_topk_raw(torch.from_numpy(q), torch.from_numpy(c),
                                 k=k, metric=metric, mode="exact")
    s_j, i_j = jax_exact_topk(jnp.asarray(q), jnp.asarray(c), k=k,
                              metric=metric)
    assert i_t.shape == (5, k) and i_t.dtype == torch.int32
    assert np.mean(i_t.numpy() == np.asarray(i_j)) >= 0.999
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                               atol=1e-4 if metric == "euclidean" else 1e-5)
    if k == c.shape[0]:  # every row, each once
        assert (np.sort(i_t.numpy(), 1) == np.arange(k)).all()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_jax_exact_search_agrees_with_its_kernel(rng, metric):
    """The JAX oracle used above and the JAX Pallas exact kernel (interpret
    mode, at a k it compiles quickly) give the same top k."""
    q, c = _case(rng, metric, n=700)
    s_p, i_p = pallas_topk_raw(jnp.asarray(q), jnp.asarray(c), k=8,
                               metric=metric, mode="exact", interpret=True)
    s_j, i_j = jax_exact_topk(jnp.asarray(q), jnp.asarray(c), k=8,
                              metric=metric)
    np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_j))
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_j), atol=1e-4)


# ------------------------------------------------ the kernel's algorithm

_TOP = np.uint64(1 << 63)


def _keys(scores):
    """The kernel's unsigned keys: (monotone_i32(s) ^ 0x80000000) << 32 |
    (INT_MAX - row), whose unsigned order is (score desc, row asc)."""
    b = scores.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(b < 2**31, b ^ np.uint64(0x80000000),
                 np.uint64(0xFFFFFFFF) - b)
    rows = np.arange(scores.shape[1], dtype=np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0x7FFFFFFF) - rows)


def _select_mirror(scores, k):
    """exact_select_kernel's passes, exact_select_scan, the collect pass
    and exact_select_sort, query by query: (scores [Q, k], ids [Q, k])
    best first, and the number of passes each query took part in."""
    nq, n = scores.shape
    keys = _keys(scores)
    pre = np.zeros(nq, np.uint64)
    need = np.full(nq, k, np.int64)
    row_bits = 8
    while row_bits < 32 and (n - 1) >> row_bits:
        row_bits += 8
    fill = np.uint64(0x7FFFFFFF & ~((1 << row_bits) - 1))
    passes = np.zeros(nq, np.int64)
    for shift in range(56, -1, -8):
        if row_bits <= shift < 32:
            continue  # bits every row's INT_MAX - row shares
        himask = np.uint64(0 if shift == 56 else
                           ((1 << 64) - 1) & ~((1 << (shift + 8)) - 1))
        for qi in np.nonzero(need)[0]:
            passes[qi] += 1
            match = ((keys[qi] ^ pre[qi]) & himask) == 0
            digit = (keys[qi][match] >> np.uint64(shift)) & np.uint64(255)
            hist = np.bincount(digit.astype(np.int64), minlength=256)
            left, b = int(need[qi]), 255
            while b > 0 and hist[b] < left:
                left -= hist[b]
                b -= 1
            pre[qi] |= np.uint64(b) << np.uint64(shift)
            if hist[b] == left:
                left = 0
            else:
                pre[qi] |= fill
            need[qi] = left
    assert (need == 0).all()  # the last pass always ends on one key
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for qi in range(nq):
        sel = keys[qi][keys[qi] >= pre[qi]]
        assert sel.size == k  # the collect lands exactly k keys
        out_s[qi], out_i[qi] = _best(sel, k)
    return out_s, out_i, passes


def _best(sel, k):
    """exact_select_sort on one query's buffer of unsigned keys: the best
    k (scores, ids), best first."""
    top = np.sort((sel ^ _TOP).view(np.int64))[::-1][:k]  # signed, desc
    m = (top >> 32).astype(np.int32)
    return (np.where(m >= 0, m, m ^ 0x7FFFFFFF).astype(np.int32)
            .view(np.float32), 0x7FFFFFFF - (top & 0xFFFFFFFF))


def _route_mirror(scores, k):
    """The route ``ft._select_plan`` picks at these shapes, query by
    query: on the buffer routes the threshold (the key, without row bits,
    of the m-th best score of every s-th row, or the least key), the
    buffer pass's count, exact_select_check, the radix select for the
    queries that fell back and the sort of each buffer. Returns (scores,
    ids, the plan, fallback flags [Q], counts [Q]); flags and counts are
    None on the radix route."""
    nq, n = scores.shape
    plan = ft._select_plan(nq, n, k)
    route, stride, rank, cap = plan
    if route == "radix":
        return (*_select_mirror(scores, k)[:2], plan, None, None)
    keys = _keys(scores)
    thr = np.zeros(nq, np.uint64)
    if route == "sampled":
        sample = np.sort(keys[:, ::stride], axis=1)[:, ::-1]
        thr = (sample[:, rank - 1] >> np.uint64(32)) << np.uint64(32)
    cnt = (keys >= thr[:, None]).sum(1)
    fell = (cnt < k) | (cnt > cap)
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    if fell.any():
        out_s[fell], out_i[fell] = _select_mirror(scores[fell], k)[:2]
    for qi in np.nonzero(~fell)[0]:
        out_s[qi], out_i[qi] = _best(keys[qi][keys[qi] >= thr[qi]], k)
    return out_s, out_i, plan, fell, cnt


def _plain_scores(q, c, metric):
    """The plain version's fp32 scores, tile by tile as it computes them
    (the same matmul shapes, so the same bits)."""
    nq, n = q.shape[0], c.shape[0]
    q = q.float()
    out = torch.empty((nq, n))
    q_sq = ft.row_sq(q)[:, None]
    csq = torch.sum(torch.square(c.float()), dim=1)
    for base in range(0, n, 4096):
        tile = torch.zeros((4096, c.shape[1]))
        tile[: min(n, base + 4096) - base] = c[base : base + 4096].float()
        s = q @ tile.T
        if metric == "euclidean":
            cs = torch.zeros(4096)
            cs[: min(n, base + 4096) - base] = csq[base : base + 4096]
            s = 2.0 * s - q_sq - cs[None, :]
        out[:, base : base + 4096] = s[:, : min(n, base + 4096) - base]
    return out.numpy()


def _tied_store(rng, kind, n, d, distinct=30, noise=1e-4):
    if kind == "duplicated":  # a few distinct rows, each many times
        base = rng.standard_normal((distinct, d)).astype(np.float32)
        return torch.from_numpy(base[rng.integers(0, distinct, n)])
    # bf16-collinear: one direction plus noise below bf16's resolution,
    # so most rows round to a few bf16 vectors
    x = rng.standard_normal(d).astype(np.float32)
    dx = noise * rng.standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x[None, :] + dx).bfloat16()


@pytest.mark.parametrize("k", [2049, 2600])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("kind", ["duplicated", "bf16_collinear"])
def test_select_mirror_matches_plain_on_ties(rng, kind, metric, k):
    """The mirror of the radix select gives the plain version's ids and
    scores bit for bit where most rows tie: the row passes hand the k-th
    score's ties to the lowest rows."""
    n, d = 2600, 16
    c = _tied_store(rng, kind, n, d)
    q = torch.from_numpy(rng.standard_normal((4, d)).astype(np.float32))
    q = q.to(c.dtype)
    s_p, i_p = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="exact")
    s_m, i_m, passes = _select_mirror(_plain_scores(q, c, metric), k)
    np.testing.assert_array_equal(i_m, i_p.numpy())
    np.testing.assert_array_equal(s_m.view(np.int32),
                                  s_p.numpy().view(np.int32))
    # the case holds ties at the k-th score, which the row passes resolve
    if k < n:
        kth = s_p.numpy()[:, k - 1]
        assert ((_plain_scores(q, c, metric) == kth[:, None]).sum(1) > 1).any()
        assert passes.max() > 4


def test_select_mirror_without_ties_ends_in_score_passes(rng):
    """With distinct scores a query is done within the four score passes,
    so the row passes launch and skip it."""
    q, c = _case(rng, "cosine")
    scores = _plain_scores(torch.from_numpy(q), torch.from_numpy(c),
                           "cosine")
    s_m, i_m, passes = _select_mirror(scores, 2049)
    s_p, i_p = ft.fused_topk_raw(torch.from_numpy(q), torch.from_numpy(c),
                                 k=2049, mode="exact")
    np.testing.assert_array_equal(i_m, i_p.numpy())
    assert passes.max() <= 4


# ------------------------------------------------- the buffer routes

def _assert_route_matches_plain(q, c, metric, k):
    """The route mirror against the plain version, bit for bit; returns
    the plan, fallback flags and counts."""
    s_p, i_p = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="exact")
    s_m, i_m, plan, fell, cnt = _route_mirror(_plain_scores(q, c, metric), k)
    np.testing.assert_array_equal(i_m, i_p.numpy())
    np.testing.assert_array_equal(s_m.view(np.int32),
                                  s_p.numpy().view(np.int32))
    return plan, fell, cnt


@pytest.mark.parametrize("k", [2049, 3000, 4096])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_route_random_rows_never_fall_back(rng, metric, k):
    """Rows in random order: the sample places every query's threshold so
    that k <= count <= C, and one buffer pass serves them all."""
    q, c = (torch.from_numpy(a) for a in _case(rng, metric, nq=6, n=20000))
    plan, fell, cnt = _assert_route_matches_plain(q, c, metric, k)
    assert plan[0] == "sampled" and plan[3] == 8192
    assert fell.sum() == 0 and (cnt >= k).all() and (cnt <= plan[3]).all()


def _overshoot_case(rng, metric, n, aligned):
    """Queries and a corpus whose sampled rows (every s-th) are the best
    rows of the queries flagged in ``aligned``, so that their threshold
    overshoots: about m keys pass it, fewer than k."""
    nq, d = aligned.size, 16
    stride = ft._select_plan(nq, n, 3000)[1]
    q = (0.25 * rng.standard_normal((nq, d))).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "euclidean":  # the sampled rows lie next to the queries
        c *= 3.0
        c[::stride] = q.mean(0) + 0.01 * rng.standard_normal(
            (c[::stride].shape[0], d)).astype(np.float32)
    else:  # a large first dim, scored only by the aligned queries
        c[:, 0] = 0.0
        c[::stride, 0] = 5.0
        q[:, 0] = np.where(aligned, 1.0, 0.0)
    return torch.from_numpy(q), torch.from_numpy(c)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_route_overshoot_every_query_falls_back(rng, metric):
    """The sampled rows are every query's best: each threshold passes too
    few keys (count < k), every query falls back to the radix select, and
    the answer is still the plain version's."""
    q, c = _overshoot_case(rng, metric, 20000, np.ones(5, bool))
    plan, fell, cnt = _assert_route_matches_plain(q, c, metric, 3000)
    assert plan[0] == "sampled"
    assert fell.all() and (cnt < 3000).all()


def test_route_mixed_some_queries_fall_back(rng):
    """In one call the queries aligned with the sampled rows fall back and
    the others are served by the buffer pass."""
    aligned = np.array([True, False, True, False, False, True])
    q, c = _overshoot_case(rng, "cosine", 20000, aligned)
    plan, fell, cnt = _assert_route_matches_plain(q, c, "cosine", 3000)
    assert plan[0] == "sampled"
    np.testing.assert_array_equal(fell, aligned)
    assert 0 < fell.sum() < fell.size


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("kind", ["duplicated", "bf16_collinear"])
def test_route_ties_at_threshold_fall_back(rng, kind, metric):
    """Rows equal in their stored values tie at the threshold by the
    thousand: the count passes C, the query falls back, and the radix
    passes hand the k-th score's ties to the lowest rows."""
    c = _tied_store(rng, kind, 20000, 16, distinct=2, noise=1e-6)
    q = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    q = q.to(c.dtype)
    plan, fell, cnt = _assert_route_matches_plain(q, c, metric, 3000)
    assert plan[0] == "sampled"
    assert fell.all() and (cnt > plan[3]).all()


@pytest.mark.parametrize("k", [2049, 2600])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_route_small_corpus_keeps_every_row(rng, metric, k):
    """N <= C (k=2049, and k=N): the buffer takes every row, no query can
    fall back, and the sort of the whole corpus gives the top k."""
    q, c = (torch.from_numpy(a) for a in _case(rng, metric))
    plan, fell, cnt = _assert_route_matches_plain(q, c, metric, k)
    assert plan == ("all", 0, 0, 8192)
    assert fell.sum() == 0 and (cnt == 2600).all()


def test_route_past_8192_takes_the_radix_select(rng):
    """k > 8192 needs a buffer of more keys than a sort block holds: the
    radix select serves every query."""
    q, c = (torch.from_numpy(a) for a in _case(rng, "cosine", nq=3,
                                               n=12000))
    plan, fell, _ = _assert_route_matches_plain(q, c, "cosine", 9000)
    assert plan == ("radix", 0, 0, 0) and fell is None


@pytest.mark.parametrize("nq,n,k", [
    (1024, 1_000_000, 2049), (1024, 1_000_000, 3000),
    (1024, 1_000_000, 4096), (1024, 1_000_000, 4097),
    (1024, 1_000_000, 8192), (1024, 1_000_000, 8193),
    (37, 5003, 5003), (5, 8192, 4096), (5, 8193, 4096),
    (16384, 100_000, 3000), (16385, 100_000, 3000),
    (3, 100_000_000, 6000),
])
def test_select_plan_rule(nq, n, k):
    """The plan depends on the shapes alone and keeps its sizing: C = 2
    es_width(k); radix past 16384 keys or 1 GiB of buffers; every row when
    N <= C; else m <= 256 of a sample of more than m rows, aimed at a
    count T strictly between k and C."""
    route, stride, rank, cap = ft._select_plan(nq, n, k)
    assert ft._select_plan(nq, n, k) == (route, stride, rank, cap)
    want_cap = 2 * (1 << (k - 1).bit_length())
    if want_cap > 16384 or nq * want_cap * 8 > 1 << 30:
        assert (route, stride, rank, cap) == ("radix", 0, 0, 0)
        return
    assert cap == want_cap
    if n <= cap:
        assert (route, stride, rank) == ("all", 0, 0)
        return
    assert route == "sampled" and stride >= 2
    assert 1 <= rank <= 256 and rank < -(-n // stride)
    target = (9 * k + 7 * cap) // 16
    assert stride * (rank - 1) < target <= stride * rank
    assert k < target < cap
