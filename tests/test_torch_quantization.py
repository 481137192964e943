"""The port's int8 (SQ8) and int4 (SQ4) quantization and searches against
the JAX package's ``ops/quantization.py``, on the CPU.

Codes, scales and packed nibbles must be bit-identical, and so must the
scores of ``sq8_topk`` / ``sq4_topk`` (exact int32 dots times one fp32
factor). int8 scores tie whenever two rows give the same integer dot, so
ids are held equal by set within each tie group
(``quantization.same_ids_at_ties``);
the JAX search on the CPU ranks ties to the lower row, and so does the
port, so they come out equal in place too. The int8 / int4 kernels' plain
versions (``ops.fused_topk``) and the routes the stores take on the card
(``approx_sq8_fused_topk`` / ``approx_sq4_fused_topk``, run here through
the plain versions) are held to the same searches; the CUDA kernels
themselves are held to their plain versions by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops import quantization as jq
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.ops import quantization as tq
from latentrag_torch.ops.topk import NEG_INF, pack_row_mask


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ------------------------------------------------------------- quantizers


@pytest.mark.parametrize("d", [32, 33])  # odd dims pad a zero nibble
@pytest.mark.parametrize("fn", ["sq8_quantize", "sq4_quantize",
                                "sq4_quantize_with_scale", "sq4_unpack"])
def test_quantizers_bit_identical(rng, fn, d):
    x = rng.standard_normal((257, d)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    xt = torch.from_numpy(x)
    if fn == "sq8_quantize":
        (got, s_t), (want, s_j) = tq.sq8_quantize(xt), jq.sq8_quantize(x)
        assert got.dtype == torch.int8 and float(s_t) == float(s_j)
    elif fn == "sq4_quantize":
        (got, s_t), (want, s_j) = tq.sq4_quantize(xt), jq.sq4_quantize(x)
        assert got.dtype == torch.uint8 and float(s_t) == float(s_j)
        assert got.shape == (257, (d + 1) // 2)
    elif fn == "sq4_quantize_with_scale":
        scale = np.float32(0.0731)
        got = tq.sq4_quantize_with_scale(xt, float(scale))
        want = jq.sq4_quantize_with_scale(x, jnp.float32(scale))
    else:
        packed = jq.sq4_quantize(x)[0]
        got = tq.sq4_unpack(torch.from_numpy(np.asarray(packed)), d)
        want = jq.sq4_unpack(packed, d)
        assert got.dtype == torch.int8 and got.shape == (257, d)
        assert int(got.min()) >= -7 and int(got.max()) <= 7
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["sq8_quantize", "sq4_quantize"])
def test_scale_is_the_compiled_jax_scale(fn):
    """XLA compiles the JAX package's ``max|x| / 127`` (``/ 7``) into a
    product with the fp32 reciprocal, which differs from an fp32 division
    by one ulp for a few percent of maxima; the port's scale is that
    product. Over 400 maxima the scales, and so the codes, are equal."""
    rng = np.random.default_rng(12)
    maxima = rng.uniform(0.01, 50.0, 400).astype(np.float32)
    f_t, f_j = getattr(tq, fn), getattr(jq, fn)
    x = np.stack([maxima, -maxima / 3, maxima / 2.5], axis=1)
    for row in x:
        (c_t, s_t), (c_j, s_j) = f_t(torch.from_numpy(row[None])), f_j(
            jnp.asarray(row[None]))
        assert float(s_t) == float(s_j), row
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("d", [32, 33])
def test_sq4_requantization_round_trip(rng, d):
    """``tests/test_int4.py``'s round trip, in the port and against the
    JAX package: the codes are clip(round(x / scale)), and re-quantizing
    the dequantized rows (what corpus.npy holds) gives the scale and the
    nibbles back, as it does there."""
    x = rng.standard_normal((257, d)).astype(np.float32)
    packed, scale = tq.sq4_quantize(torch.from_numpy(x))
    codes = tq.sq4_unpack(packed, d).numpy()
    ref = np.clip(np.round(x / float(scale)), -7, 7)
    np.testing.assert_array_equal(codes, ref)
    deq = (ref * float(scale)).astype(np.float32)
    packed2, scale2 = tq.sq4_quantize(torch.from_numpy(deq))
    packed_j, scale_j = jq.sq4_quantize(jnp.asarray(deq))
    assert float(scale2) == float(scale_j)
    assert abs(float(scale2) - float(scale)) < 1e-9
    np.testing.assert_array_equal(packed2.numpy(), packed.numpy())
    np.testing.assert_array_equal(packed2.numpy(), np.asarray(packed_j))


# -------------------------------------------------------------- searches


def _case(rng, d, n=3000, nq=16, allowed=None):
    x, q = _unit(rng, n, d), rng.standard_normal((nq, d)).astype(np.float32)
    mask = None if allowed is None else rng.random(n) < allowed
    return x, q, mask


@pytest.mark.parametrize("allowed", [None, 0.1])
@pytest.mark.parametrize("d", [32, 33])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_topk_matches_jax(rng, store, d, allowed):
    """``sq8_topk`` / ``sq4_topk`` against the JAX functions at
    ``recall_target=1.0`` (exact on the CPU), with and without a row mask,
    in blocks of 1000 rows: scores bit for bit, ids by set at ties."""
    x, q, mask = _case(rng, d, allowed=allowed)
    m_t = None if mask is None else torch.from_numpy(mask)
    m_j = None if mask is None else jnp.asarray(mask)
    if store == "int8":
        c_j, s_j = jq.sq8_quantize(x)
        want = jq.sq8_topk(q, c_j, s_j, k=20, block_size=1000,
                           recall_target=1.0, mask=m_j)
        got = tq.sq8_topk(torch.from_numpy(q),
                          torch.from_numpy(np.asarray(c_j)), float(s_j), 20,
                          block_size=1000, mask=m_t)
    else:
        p_j, s_j = jq.sq4_quantize(x)
        want = jq.sq4_topk(q, p_j, s_j, d=d, k=20, block_size=1000,
                           recall_target=1.0, mask=m_j)
        got = tq.sq4_topk(torch.from_numpy(q),
                          torch.from_numpy(np.asarray(p_j)), float(s_j), d,
                          20, block_size=1000, mask=m_t)
    s_w, i_w = (np.asarray(a) for a in want)
    s_g, i_g = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(s_g, s_w)
    live = s_w > NEG_INF * 0.5  # masked slots carry arbitrary ids
    assert tq.same_ids_at_ties(s_w, np.where(live, i_g, -1),
                               s_w, np.where(live, i_w, -1)).all()
    if mask is not None:
        assert mask[i_g[live]].all()


def _codes(x, store):
    if store == "int8":
        return tq.sq8_quantize(torch.from_numpy(x))
    return tq.sq4_quantize(torch.from_numpy(x))


@pytest.mark.parametrize("k", [10, 200, 2100])
@pytest.mark.parametrize("allowed", [None, 0.1])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_approx_route_matches_jax(rng, store, allowed, k):
    """The route each store takes on the card, run here through its plain
    versions: the fold at ``fold_plan``'s width and candidates, rescored
    exactly (k=10), the exact kernel's plain version (k=200) and the
    blocked search (k=2100). Scores equal the JAX function's bit for bit
    and ids by set at ties; empty slots (the mask) are (NEG_INF, -1)."""
    d = 33 if store == "int4" else 32
    x, q, mask = _case(rng, d, allowed=allowed)
    corpus, scale = _codes(x, store)
    pm = None if mask is None else pack_row_mask(torch.from_numpy(mask))
    m_j = None if mask is None else jnp.asarray(mask)
    qt = torch.from_numpy(q)
    if store == "int8":
        s_g, i_g = ft.approx_sq8_fused_topk(qt, corpus, float(scale), k=k,
                                            mask=pm)
        s_w, i_w = jq.sq8_topk(q, jnp.asarray(corpus.numpy()),
                               jnp.float32(scale), k=k, recall_target=1.0,
                               mask=m_j)
    else:
        s_g, i_g = ft.approx_sq4_fused_topk(qt, corpus, float(scale), d=d,
                                            k=k, mask=pm)
        s_w, i_w = jq.sq4_topk(q, jnp.asarray(corpus.numpy()),
                               jnp.float32(scale), d=d, k=k,
                               recall_target=1.0, mask=m_j)
    s_w, i_w = np.asarray(s_w), np.asarray(i_w)
    live = s_w > NEG_INF * 0.5
    assert i_g.dtype == torch.int32
    np.testing.assert_array_equal(s_g.numpy(), s_w)
    np.testing.assert_array_equal(i_g.numpy()[~live], -1)
    assert tq.same_ids_at_ties(s_w, np.where(live, i_g.numpy(), -1),
                               s_w, np.where(live, i_w, -1)).all()


@pytest.mark.parametrize("mode", ["fold", "exact"])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_raw_plain_versions(rng, store, mode):
    """The kernels' plain versions over the quantized codes. Exact mode is
    ``quantized_topk`` (the JAX function's answer); the fold at 512-row
    tiles over N=2100 (not a multiple) returns 19-bit keys within one key
    step of the exact scores of its ids and finds >= 0.95 of the exact
    top-10, the fold's contract at k=10. The wrapper on a CPU tensor is
    the plain version."""
    d = 33 if store == "int4" else 64
    x, q, _ = _case(rng, d, n=2100)
    corpus, scale = _codes(x, store)
    qc, qs = tq.sq8_quantize(torch.from_numpy(q))
    fac = tq.score_factor(qs, scale)
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    s, i = ft.quantized_fused_topk_raw_reference(
        qc, corpus, fac, d=d, k=10, op=op, mode=mode, block_n=512)
    raw = (ft.sq8_fused_topk_raw(qc, corpus, fac, k=10, mode=mode,
                                 block_n=512) if store == "int8" else
           ft.sq4_fused_topk_raw(qc, corpus, fac, d=d, k=10, mode=mode,
                                 block_n=512))
    assert torch.equal(raw[0], s) and torch.equal(raw[1], i)
    rows = corpus if store == "int8" else tq.sq4_unpack(corpus, d)
    exact = tq.quantized_scores(qc, rows, fac)
    s_e, i_e = tq.quantized_topk(qc, 2100, lambda lo, hi: rows[lo:hi], fac,
                                 10)
    own = torch.gather(exact, 1, i.long())
    if mode == "exact":
        assert torch.equal(s, s_e) and torch.equal(i.long(), i_e)
        assert torch.equal(own, s)
    else:
        step = 2.0 ** -10 * own.abs() + 1e-6  # 13 mantissa bits cut
        assert bool(((s - own).abs() <= step).all())
        hits = np.mean([len(set(a) & set(b)) / 10 for a, b in
                        zip(i.tolist(), i_e.tolist())])
        assert hits >= 0.95


def test_rescore_ranks_ties_to_the_lower_row():
    """The fold's candidates come in lane order; the rescore ranks them
    by exact score, ties to the lower row, empty slots last."""
    qc = torch.tensor([[1, 2]], dtype=torch.int8)
    rows = torch.tensor([[[1, 1], [0, 0], [3, 0], [1, 1], [2, -1]]],
                        dtype=torch.int8)
    idx = torch.tensor([[40, -1, 7, 3, 9]], dtype=torch.int32)
    s, i = ft.rescore_quantized_candidates(qc, rows, idx,
                                           torch.tensor([0.5]))
    assert i.tolist() == [[3, 7, 40, 9, -1]]
    assert s.tolist()[0][:4] == [1.5, 1.5, 1.5, 0.0]
    assert s[0, 4] == NEG_INF


def _unpack4_mirror(packed: np.ndarray) -> np.ndarray:
    """numpy mirror of the int4 stage's unpack (csrc/fold_mma.cuh:
    fm_s4x8): four packed bytes to eight int8 codes by the byte
    permutations 0x5140 / 0x7362 of (low nibbles, high nibbles), then each
    byte's bit 3 copied into its high nibble by a multiply by 0x1E."""
    n, w = packed.shape
    words = np.pad(packed, ((0, 0), (0, (-w) % 4))).view("<u4")
    lo = words & np.uint32(0x0F0F0F0F)
    hi = (words >> np.uint32(4)) & np.uint32(0x0F0F0F0F)

    def perm(x, y, sel):
        src = np.stack([(x >> np.uint32(8 * b)) & np.uint32(0xFF)
                        for b in range(4)]
                       + [(y >> np.uint32(8 * b)) & np.uint32(0xFF)
                          for b in range(4)])
        out = np.zeros_like(x)
        for b in range(4):
            out |= src[(sel >> (4 * b)) & 0xF] << np.uint32(8 * b)
        return out

    a, b = perm(lo, hi, 0x5140), perm(lo, hi, 0x7362)
    a |= (a & np.uint32(0x08080808)) * np.uint32(0x1E)
    b |= (b & np.uint32(0x08080808)) * np.uint32(0x1E)
    out = np.stack([a, b], axis=-1).reshape(n, -1)  # two words a word in
    return out.view(np.int8)


@pytest.mark.parametrize("d", [64, 33, 384])
def test_stage_unpack_mirror_matches_sq4_unpack(rng, d):
    """The kernel's unpack gives ``sq4_unpack``'s codes on dims < d, and
    the pad nibble (odd d) and the bytes past a row's last are code 0."""
    x = rng.standard_normal((130, d)).astype(np.float32)
    packed, _ = tq.sq4_quantize(torch.from_numpy(x))
    codes = _unpack4_mirror(packed.numpy())
    np.testing.assert_array_equal(codes[:, :d],
                                  tq.sq4_unpack(packed, d).numpy())
    np.testing.assert_array_equal(codes[:, d:], 0)


def test_quantized_wrappers_validate():
    qc = torch.zeros((2, 64), dtype=torch.int8)
    codes = torch.zeros((300, 64), dtype=torch.int8)
    fac = torch.tensor([0.1])
    with pytest.raises(ValueError, match="k <= 128"):
        ft.sq8_fused_topk_raw(qc, codes, fac, k=129)
    with pytest.raises(ValueError, match="int8 codes"):
        ft.sq8_fused_topk_raw(qc, codes.float(), fac, k=3)
    with pytest.raises(ValueError, match="query codes"):
        ft.sq8_fused_topk_raw(qc.float(), codes, fac, k=3)
    with pytest.raises(ValueError, match="packed nibbles"):
        ft.sq4_fused_topk_raw(qc, codes, fac, d=64, k=3)
    with pytest.raises(ValueError, match="one float32"):
        ft.sq8_fused_topk_raw(qc, codes, torch.tensor([0.1, 0.2]), k=3)
    with pytest.raises(ValueError, match="multiple of"):
        ft.sq8_fused_topk_raw(qc, codes, fac, k=3, block_n=200)
    with pytest.raises(ValueError, match="mode"):
        ft.sq8_fused_topk_raw(qc, codes, fac, k=3, mode="approx")
