"""The int8 and int4 stores' exact search past k = 256 on Hopper
(``csrc/exact_i8_select.cuh``: a sampled threshold, one TMA + wgmma buffer
pass over 64 queries, a check, a radix fallback and a sort) on the CPU:
the plan (route, sample stride, sample rank, capacity) as a pure function,
a numpy model of the buffer pass's raw-dot threshold, and the plan's plain
model (``fused_topk.quantized_select_reference``) held bit for bit to the
plain exact search and to the JAX package's ``sq8_topk`` / ``sq4_topk``
(``latentrag_tpu/ops/quantization.py:35``, ``:147``) on seeded numpy
inputs, crafted corpora whose queries fall back included. The kernel
itself runs only on the card (``tests/test_torch_cuda.py -k select``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops import quantization as jq
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.ops import quantization as tq
from latentrag_torch.ops.topk import NEG_INF, pack_row_mask

_INT_MIN, _INT_MAX = -(2**31), 2**31 - 1
_CAP = 8192


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("nq,n,k,want", [
    (1024, 8_800_000, 257, ("sampled", 15, 249, _CAP)),
    (1024, 8_800_000, 320, ("sampled", 15, 251, _CAP)),  # int4 top_k 40
    (1024, 8_800_000, 512, ("sampled", 16, 242, _CAP)),
    (1024, 8_800_000, 1000, ("sampled", 17, 244, _CAP)),
    (1024, 8_800_000, 1024, ("sampled", 17, 245, _CAP)),
    (1024, 8_800_000, 2048, ("sampled", 19, 250, _CAP)),
    (1024, 880_000, 512, ("sampled", 16, 242, _CAP)),  # a tenth of 8.8M
    (2000, 1997, 320, ("all", 0, 0, _CAP)),  # the reranked int4 main
    (1, 8192, 2048, ("all", 0, 0, _CAP)),
    (1, 8193, 2048, ("sampled", 19, 250, _CAP)),
    (64, 100, 320, ("all", 0, 0, _CAP)),  # fewer rows than k
    (64, 0, 320, ("all", 0, 0, _CAP)),  # no rows
    (16384, 8_800_000, 512, ("sampled", 16, 242, _CAP)),  # 1 GiB buffers
    (16385, 8_800_000, 512, ("radix", 0, 0, 0)),
])
def test_select_plan_cases(nq, n, k, want):
    """The plan is a function of the shapes alone (a filter's allowed rows
    are counted on the card, and never read by the host)."""
    assert ft.quantized_select_plan(nq, n, k) == want


@pytest.mark.parametrize("k", [257, 300, 320, 511, 512, 1000, 1024, 1500,
                               2047, 2048])
@pytest.mark.parametrize("n", [8193, 20_000, 100_000, 1_000_000,
                               8_800_000])
def test_select_plan_sizes_the_sample(n, k):
    """On the sampled route the count aimed at lies between k and C, the
    sample's rank is at most 256 (the list ``exact_i8_wgmma_kernel`` keeps)
    and the sample holds more rows than it; m s reaches T, (m - 1) s does
    not; the stride is 15-19, so the sample is 1/15-1/19 of the rows."""
    route, s, m, cap = ft.quantized_select_plan(1024, n, k)
    assert (route, cap) == ("sampled", _CAP)
    t = (9 * k + 7 * cap) // 16
    assert k < t < cap
    assert 1 <= m <= 256 and m * s >= t > (m - 1) * s
    assert -(-n // s) > m
    assert 15 <= s <= 19


# ------------------------------------------------- the raw-dot threshold


def _score(dots, factor):
    """float32(dot) * factor, each step rounded to nearest in fp32."""
    return (np.asarray(dots).astype(np.float32)
            * np.float32(factor)).astype(np.float32)


def _u32(v):
    """es_u32: the high word of a score's unsigned key."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return np.where(b < 0x80000000, b ^ 0x80000000, ~b).astype(np.uint32)


def _threshold(u, factor):
    """ei_threshold's arithmetic on a key's high word u: the score back
    from u, floor(score / factor) in float64, less 3, clamped to int32;
    INT_MIN where the score is NaN."""
    u = np.asarray(u, np.uint32)
    v = np.where(u >= 0x80000000, u ^ 0x80000000, ~u).astype(
        np.uint32).view(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        t = np.floor(v.astype(np.float64) / np.float64(np.float32(factor)))
    t = np.where(np.isnan(v), _INT_MIN, t - 3.0)
    return np.clip(t, _INT_MIN, _INT_MAX).astype(np.int64)


@pytest.mark.parametrize("factor", np.geomspace(1e-8, 1e2, 41).tolist())
def test_select_threshold_is_exact(factor):
    """For thresholds v of both signs (each the score of a dot with |dot|
    < 2^24, as the sample's m-th is) and for the radix passes' prefixes of
    them (the key's low bits cut): no dot below the threshold t has a key
    at or above it (the score rises with the dot, so t - 1 is the one to
    check), and the least dot that reaches a full threshold lies 0 to 4
    steps above t."""
    rng = np.random.default_rng(int(factor * 1e9) % 2**32)
    dots = np.concatenate([
        rng.integers(-(2**24) + 1, 2**24, 4000),
        rng.integers(-300, 300, 1000),
        (2**24 - 1) - rng.integers(0, 64, 500),
        -(2**24 - 1) + rng.integers(0, 64, 500),
        np.array([0, 1, -1, 2**22, -(2**22)]),
    ]).astype(np.int64)
    u = _u32(_score(dots, factor))
    t = _threshold(u, factor)
    assert (_u32(_score(t - 1, factor)) < u).all()
    reach = _u32(_score(t[:, None] + np.arange(6), factor)) >= u[:, None]
    assert reach.any(axis=1).all() and reach.argmax(axis=1).max() <= 4
    for cut in (8, 16, 24):  # a prefix: the digits found so far
        up = (u >> cut) << cut
        tp = _threshold(up, factor)
        assert (_u32(_score(tp - 1, factor)) < up).all()
        assert (tp <= t).all()


def test_select_threshold_bounds():
    """The least key (a first radix pass, the "all" route) and a prefix
    whose score is NaN or -inf bound nothing (INT_MIN); a huge score over a
    tiny factor clamps to INT_MAX."""
    assert _threshold(np.uint32(0), 1e-4) == _INT_MIN
    assert _threshold(_u32(np.float32(-np.inf)), 1e-4) == _INT_MIN
    assert _threshold(np.uint32(0x00400000), 1e-4) == _INT_MIN  # a NaN
    assert _threshold(_u32(np.float32(3e38)), 1e-8) == _INT_MAX


# ------------------------------------------------------------ the model


def _jax_topk(store, q, corpus, scale, d, k, mask):
    """The JAX package's search at recall_target 1.0 (exact on the CPU)."""
    m_j = None if mask is None else jnp.asarray(mask)
    if store == "int8":
        s, i = jq.sq8_topk(q, jnp.asarray(corpus), jnp.float32(scale), k=k,
                           recall_target=1.0, mask=m_j)
    else:
        s, i = jq.sq4_topk(q, jnp.asarray(corpus), jnp.float32(scale), d=d,
                           k=k, recall_target=1.0, mask=m_j)
    return np.asarray(s), np.asarray(i)


def _check_model(store, q, corpus, scale, d, k, mask=None, route="auto"):
    """The model against the plain exact search (bit for bit, ids in
    place) and the JAX function (scores bit for bit, ids by set at ties;
    empty slots (NEG_INF, -1)); returns the model's fallbacks and plan."""
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    qc, qs = tq.sq8_quantize(torch.from_numpy(q))
    fac = tq.score_factor(qs, scale)
    c = torch.from_numpy(corpus)
    pm = None if mask is None else pack_row_mask(torch.from_numpy(mask))
    s, i, fell, plan = ft.quantized_select_reference(
        qc, c, fac, d=d, k=k, op=op, mask=pm, route=route)
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=d, k=k, op=op, mode="exact", mask=pm)
    assert torch.equal(s, s_p) and torch.equal(i, i_p)
    s_w, i_w = _jax_topk(store, q, corpus, scale, d, k, mask)
    live = s_w > NEG_INF * 0.5
    np.testing.assert_array_equal(s.numpy(), s_w)
    np.testing.assert_array_equal(i.numpy()[~live], -1)
    assert tq.same_ids_at_ties(s_w, np.where(live, i.numpy(), -1),
                               s_w, np.where(live, i_w, -1)).all()
    if mask is not None:
        assert mask[i.numpy()[live]].all()
    return fell, plan


def _seeded(store, nq, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c, scale = (tq.sq8_quantize if store == "int8" else tq.sq4_quantize)(
        torch.from_numpy(x))
    return q, c.numpy(), float(scale), rng


# (n, allowed, route): N above C (sampled), below it (all), a 10 % mask
# over 100k rows and over 20k (sampled, the sample's allowed rows 1/s of
# the allowed; over 20k fewer than m of them, so that every allowed row is
# buffered), the radix route forced
_MODEL_CASES = [(20_000, None, "sampled"), (5003, None, "all"),
                (100_000, 0.1, "sampled"), (20_000, 0.1, "sampled"),
                (20_000, None, "radix")]


@pytest.mark.parametrize("n,allowed,route", _MODEL_CASES)
@pytest.mark.parametrize("k", [257, 320, 512, 1000, 2048])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_select_model_matches_plain_and_jax(store, k, n, allowed, route):
    """The plan's model on seeded unit rows (d = 64 int8, d = 33 int4: a
    pad nibble), 16 queries: its route as planned from the shapes, no
    query falling back on rows in random order, and its answer
    the plain exact search's bit for bit and the JAX function's."""
    d = 64 if store == "int8" else 33
    q, corpus, scale, rng = _seeded(store, 16, n, d, seed=k + n)
    mask = None if allowed is None else rng.random(n) < allowed
    fell, plan = _check_model(store, q, corpus, scale, d, k, mask,
                              "radix" if route == "radix" else "auto")
    assert plan[0] == route
    if route == "radix":
        assert fell is None
    else:
        assert not bool(fell.any())


@pytest.mark.parametrize("n_allowed", [0, 1, 100, 319])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_select_model_fewer_allowed_rows_than_k(store, n_allowed):
    """A filter that allows fewer rows than k (or none) over 20k rows: the
    sampled route, whose sample holds fewer than m allowed rows, so that
    the threshold is NEG_INF and every allowed row is buffered; no fallback
    (the count must reach only the allowed rows), every allowed row in the
    answer and the rest (NEG_INF, -1)."""
    d = 64 if store == "int8" else 33
    q, corpus, scale, rng = _seeded(store, 8, 20_000, d, seed=n_allowed)
    mask = np.zeros(20_000, bool)
    mask[rng.choice(20_000, n_allowed, replace=False)] = True
    fell, plan = _check_model(store, q, corpus, scale, d, 320, mask)
    assert plan[0] == "sampled" and not bool(fell.any())


def _pack4(codes):
    """int4 codes [N, d] (d even) -> packed nibbles, low nibble the even
    dim, as ``sq4_quantize`` packs them."""
    lo = codes[:, 0::2].astype(np.int64) & 0xF
    hi = codes[:, 1::2].astype(np.int64) & 0xF
    return (lo | (hi << 4)).astype(np.uint8)


def crafted_corpus(kind, store, nq, n, k, seed=0):
    """Codes whose sampled threshold fails: "overshoot", every s-th row
    (the sample) lifted to the top code on dims 0-7, which the even
    queries weigh by 127 (5.8 standard deviations of the other dims' sum
    for int4, 7.8 for int8), so that their sample's m-th score is a lifted
    row's and only the sample reaches it (m < k keys: the even queries fall
    back); "ties", every row one of two vectors, so that a tie group of
    about n / 2 > C rows holds the threshold (every query falls back).
    Returns (float queries whose SQ8 codes are themselves, corpus codes or
    nibbles, the corpus scale, d, the queries built to fall back)."""
    rng = np.random.default_rng(seed)
    d = 32
    top = 127 if store == "int8" else 7
    q = rng.integers(-100, 101, (nq, d)).astype(np.float32)
    # dims 0-7 of the even queries at 127, of the odd ones 0; the batch's
    # SQ8 scale is then 1, so the codes are the floats themselves
    q[:, :8] = np.where(np.arange(nq) % 2 == 0, 127, 0)[:, None]
    if kind == "overshoot":
        stride = ft.quantized_select_plan(nq, n, k)[1]
        c = rng.integers(-top + 1, top, (n, d))
        c[::stride, :8] = top
        want = np.arange(nq) % 2 == 0
    else:
        pair = rng.integers(-top + 1, top, (2, d))
        c = pair[rng.integers(0, 2, n)]
        want = np.ones(nq, bool)
    c = c.astype(np.int8)
    return q, (c if store == "int8" else _pack4(c)), 0.01, d, want


@pytest.mark.parametrize("k", [257, 512, 2048])
@pytest.mark.parametrize("kind", ["overshoot", "ties"])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_select_model_crafted_fallbacks(store, kind, k):
    """On the crafted corpora (20k rows) the model's check flags exactly
    the queries built to fall back, and its answer stays the plain exact
    search's bit for bit and the JAX function's."""
    q, corpus, scale, d, want = crafted_corpus(kind, store, 16, 20_000, k)
    fell, plan = _check_model(store, q, corpus, scale, d, k)
    assert plan[0] == "sampled"
    np.testing.assert_array_equal(fell.numpy(), want)
