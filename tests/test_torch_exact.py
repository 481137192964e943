"""The approximate routes of the port past the exact kernels' 2048, its
self-check, the kernels' order of the |q|^2 sum, and a numpy mirror of
the exact tensor-core kernel's lists (``csrc/exact_mma.cuh``), on the CPU
against the JAX package.

Past ``EXACT_MAX_K`` the float and binary approximate routes take a
blocked search on any device, so these tests run the code the card runs
there. Sign-dot and float scores tie where rows coincide: ids are compared
on >= 99 % of slots and scores as sorted multisets, within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops import binary as jb
from latentrag_tpu.ops.topk import approx_topk as jax_approx_topk
from latentrag_tpu.ops.topk import exact_topk as jax_exact_topk
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_torch.ops import binary as tb
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.retrieval import DenseRetriever


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _close_as_multisets(got, want, atol=1e-5):
    np.testing.assert_allclose(np.sort(np.asarray(got), 1),
                               np.sort(np.asarray(want), 1), atol=atol)


# ------------------------------------------------ past EXACT_MAX_K


@pytest.mark.parametrize("jax_fn", ["exact_topk", "approx_topk"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_approx_fused_topk_answers_above_2048(rng, metric, jax_fn):
    """k=3000 on a float store of N=5003, d=64: the route answers as the
    JAX package's exact and xla routes do."""
    q = rng.standard_normal((12, 64)).astype(np.float32)
    c = rng.standard_normal((5003, 64)).astype(np.float32)
    if metric == "cosine":
        q, c = _unit(rng, 12, 64), _unit(rng, 5003, 64)
    s_t, i_t = ft.approx_fused_topk(torch.from_numpy(q), torch.from_numpy(c),
                                    k=3000, metric=metric)
    fn = jax_exact_topk if jax_fn == "exact_topk" else jax_approx_topk
    s_j, i_j = fn(jnp.asarray(q), jnp.asarray(c), k=3000, metric=metric)
    assert i_t.shape == (12, 3000) and i_t.dtype == torch.int32
    assert np.mean(i_t.numpy() == np.asarray(i_j)) >= 0.99
    _close_as_multisets(s_t.numpy(), s_j, atol=1e-4 if metric == "euclidean"
                        else 1e-5)
    assert bool((s_t[:, :-1] >= s_t[:, 1:]).all())


@pytest.mark.parametrize("d", [64, 48])
def test_approx_binary_fused_topk_answers_above_2048(rng, d):
    """k=2400 (the binary store's 8 x 300): the route is the blocked
    sign-dot search, which gives the JAX package's exact sign-dot top-k."""
    x, q = _unit(rng, 5003, d), rng.standard_normal((12, d)).astype(np.float32)
    packed = tb.binary_quantize(torch.from_numpy(x))
    s_t, i_t = ft.approx_binary_fused_topk(torch.from_numpy(q), packed, d=d,
                                           k=2400)
    s_j, i_j = jb.binary_topk(q, jb.binary_quantize(x), d=d, k=2400,
                              recall_target=1.0)
    assert i_t.shape == (12, 2400) and i_t.dtype == torch.int32
    assert np.mean(i_t.numpy() == np.asarray(i_j)) >= 0.99
    _close_as_multisets(s_t.numpy(), s_j)


def test_binary_store_top_k_300_matches_jax(rng):
    """A binary store over 3000 rows at top_k=300 asks stage 1 for 2400
    candidates, past the exact kernel's 2048, and answers as the JAX store
    does (as ``test_binary_store_matches_jax`` holds top_k=10)."""
    emb = rng.standard_normal((3000, 64)).astype(np.float32)
    texts = [f"t{i}" for i in range(3000)]
    j = JaxDense(store_dtype="binary", backend="xla")
    j.build(emb.copy(), texts)
    t = DenseRetriever(store_dtype="binary", device="cpu")
    t.build(emb.copy(), texts)
    q = rng.standard_normal((9, 64)).astype(np.float32)
    s_j, i_j = j.search(q.copy(), 300)
    s_t, i_t = t.search(q.copy(), 300)
    assert i_t.shape == (9, 300)
    same = i_t == i_j
    assert same.mean() >= 0.99
    np.testing.assert_allclose(s_t[same], s_j[same], atol=1e-5)


# ----------------------------------------------------------- self-check


@pytest.mark.parametrize("backend,modes", [
    ("pallas", ["fold"]), ("pallas_exact", ["exact"]), ("xla_exact", []),
])
def test_self_check_searches_the_configured_backend(rng, monkeypatch,
                                                    backend, modes):
    """The check searches as a query would (the JAX package's
    dense.py:657-665): a ``pallas`` store checks through the fold route."""
    seen = []
    real = ft.fused_topk_raw

    def counting(*args, **kwargs):
        seen.append(kwargs["mode"])
        return real(*args, **kwargs)

    emb = rng.standard_normal((300, 16)).astype(np.float32)
    r = DenseRetriever(backend=backend, device="cpu")
    r.build(emb, [str(i) for i in range(300)], sanity_check=False)
    monkeypatch.setattr(ft, "fused_topk_raw", counting)
    assert r._self_check()
    assert seen == modes


def test_self_check_propagates_kernel_errors(rng, monkeypatch):
    """Only a wrong top-1 fails the check; a kernel error raises."""
    def broken(*args, **kwargs):
        raise RuntimeError("fold kernel launch failed")

    emb = rng.standard_normal((50, 8)).astype(np.float32)
    r = DenseRetriever(backend="pallas", device="cpu")
    r.build(emb, [str(i) for i in range(50)], sanity_check=False)
    monkeypatch.setattr(ft, "fused_topk_raw", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        r._self_check()


# ----------------------------------------------------- the |q|^2 order


@pytest.mark.parametrize("d", [8, 64, 384])
def test_row_sq_is_the_kernels_order(rng, d):
    """``row_sq`` sums dim by dim from 0 with each product and sum rounded
    to fp32 (the kernels' __fmul_rn / __fadd_rn), bit for bit as numpy's
    float32 loop; the plain version's euclidean scores use it."""
    x = (rng.standard_normal((40, d)) * rng.uniform(0.1, 30, d)).astype(
        np.float32)
    want = np.zeros(40, np.float32)
    for j in range(d):
        want = want + x[:, j] * x[:, j]
    np.testing.assert_array_equal(ft.row_sq(torch.from_numpy(x)).numpy(),
                                  want)
    c = rng.standard_normal((300, d)).astype(np.float32)
    s, i = ft.fused_topk_raw_reference(torch.from_numpy(x),
                                       torch.from_numpy(c), k=5,
                                       metric="euclidean", mode="exact")
    ci = c[i.numpy()]
    dots = np.einsum("qd,qkd->qk", x, ci)
    c_sq = np.sum(np.square(ci), axis=2)
    np.testing.assert_allclose(s.numpy(), 2.0 * dots - want[:, None] - c_sq,
                               rtol=1e-5, atol=1e-3)


# ------------------------------------- the exact kernel's lists, mirrored

_INT_MAX = 2**31 - 1
_EMPTY = np.iinfo(np.int64).min
_SUB = 128  # rows of a sub-tile (TN)


def _keys(scores: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The kernel's order key: monotone_i32(score) << 32 | (INT_MAX - row)."""
    b = scores.astype(np.float32).view(np.int32).astype(np.int64)
    mono = np.where(b >= 0, b, b ^ 0x7FFFFFFF)
    return (mono << 32) | (_INT_MAX - rows.astype(np.int64))


def _pair(t, j):
    """em_pair: t with a 0 bit inserted at j."""
    return ((t & ~(j - 1)) << 1) | (t & (j - 1))


def _bitonic_sort_asc(x):
    kp = len(x)
    t = np.arange(kp // 2)
    s = 2
    while s <= kp:
        j = s // 2
        while j:
            i = _pair(t, j)
            a, b = x[i].copy(), x[i + j].copy()
            swap = (a > b) == ((i & s) == 0)
            x[i[swap]], x[(i + j)[swap]] = b[swap], a[swap]
            j //= 2
        s *= 2


def _bitonic_merge_desc(x):
    t = np.arange(len(x) // 2)
    j = len(x) // 2
    while j:
        i = _pair(t, j)
        a, b = x[i].copy(), x[i + j].copy()
        swap = a < b
        x[i[swap]], x[(i + j)[swap]] = b[swap], a[swap]
        j //= 2


def _slab_list(scores, row0, k, kp):
    """One query's list over one slab, as exact_mma_kernel keeps it: rows
    in 128-row sub-tiles, the fp32 filter and the exact key compare
    against the k-th key, appends to the buffer of BUF = max(KP, 256), and
    a flush (sort the buffer, keep the larger of list entry i and the
    buffer's i-th of its best KP, merge) when it holds more than BUF - 128
    or at the slab's end."""
    buf_n = max(kp, 256)
    lst = np.full(kp, _EMPTY, np.int64)
    buf, thr, thr_f = [], _EMPTY, -np.inf
    n_sub = -(-len(scores) // _SUB)
    for sub in range(n_sub):
        lo = sub * _SUB
        s = scores[lo : lo + _SUB]
        key = _keys(s, row0 + lo + np.arange(len(s)))
        buf += key[(s >= thr_f) & (key > thr)].tolist()
        last = sub == n_sub - 1
        if buf and (last or len(buf) > buf_n - _SUB):
            assert len(buf) <= buf_n  # the kernel's buffer never overflows
            b = np.array(buf + [_EMPTY] * (buf_n - len(buf)), np.int64)
            _bitonic_sort_asc(b)
            b = np.maximum(b[buf_n - kp:], lst)
            _bitonic_merge_desc(b)
            lst, buf = b, []
            thr = lst[k - 1]
            thr_f = (-np.inf if thr == _EMPTY else
                     _score_of(np.array([thr]))[0])
    return lst[:k]


def _score_of(keys):
    m = (keys >> 32).astype(np.int32)
    return np.where(m >= 0, m, m ^ 0x7FFFFFFF).astype(np.int32).view(
        np.float32)


def _merge_slabs(lists, k, kp):
    """exact_merge_kernel: slab 0's list, then each other slab's read
    reversed, the larger entry kept, one bitonic merge."""
    a = np.full(kp, _EMPTY, np.int64)
    a[:k] = lists[0]
    for p in lists[1:]:
        if p[0] <= a[k - 1]:
            continue
        rev = np.full(kp, _EMPTY, np.int64)
        rev[kp - k:] = p[::-1]
        a = np.maximum(a, rev)
        _bitonic_merge_desc(a)
    return a[:k]


@pytest.mark.parametrize("slabs", [1, 3])
@pytest.mark.parametrize("k", [10, 129, 160, 300])
def test_exact_list_mirror_matches_binary_topk(rng, k, slabs):
    """Rows drawn from 40 distinct sign patterns tie everywhere; the
    mirror of the kernel's lists, slabs and merge gives ``binary_topk``'s
    ids (ties to the lower row) and scores exactly."""
    d, n = 64, 1500
    base = rng.standard_normal((40, d)).astype(np.float32)
    x = base[rng.integers(0, 40, n)]
    q = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
    packed = tb.binary_quantize(torch.from_numpy(x))
    s_p, i_p = tb.binary_topk(q, packed, d, k)
    scores = (q.bfloat16().float()
              @ tb.binary_unpack(packed, d).float().T).numpy()
    kp = 128
    while kp < k:
        kp *= 2
    slab_rows = -(-(-(-n // _SUB)) // slabs) * _SUB
    for qi in range(5):
        lists = [_slab_list(scores[qi, lo : lo + slab_rows], lo, k, kp)
                 for lo in range(0, n, slab_rows)]
        top = _merge_slabs(lists, k, kp)
        np.testing.assert_array_equal(_INT_MAX - (top & 0xFFFFFFFF),
                                      i_p[qi].numpy())
        np.testing.assert_array_equal(_score_of(top), s_p[qi].numpy())
    # the case holds ties at equal scores
    assert bool((s_p[:, :-1] == s_p[:, 1:]).any())
