"""The port's device IVF (``latentrag_torch.ops.ivf``) against the JAX
package's ``ops/ivf.py``, on the CPU, where ``ivf_scan`` runs its plain
version: the same numpy inputs, the same assignments, through both.

Layouts (``_grouped_blocks``, ``ivf_build_from_assign``,
``ivf_assignments``, ``ivf_append``) are held bit for bit. Searches over
the same index: int8 and int4 blocks bit for bit (scores and ids); float
and binary blocks to fp32 sum-order tolerances, ids by
``same_ids_at_ties``. Both coarse paths are covered: the narrow one (the
top blocks of the block-replicated list scores) and the wide one (more
than 8192 blocks: the top lists, each expanded through a stable argsort of
``block2list``), with an appended list on the wide index."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops import ivf as jivf
from latentrag_tpu.ops.binary import binary_quantize as jax_binary_quantize
from latentrag_tpu.ops.quantization import sq4_quantize as jax_sq4_quantize
from latentrag_tpu.ops.quantization import sq8_quantize as jax_sq8_quantize
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.ops import ivf as tivf
from latentrag_torch.ops.binary import binary_quantize
from latentrag_torch.ops.quantization import (
    same_ids_at_ties,
    sq4_quantize,
    sq8_quantize,
    sq8_topk,
)
from latentrag_torch.ops.topk import NEG_INF, exact_topk, pack_row_mask

D = 16
NLIST = 32
CAP = 64
KINDS = ("float32", "bfloat16", "int8", "int4", "binary")


def _mixture(n, d, n_centers, seed, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, n_centers, size=n)
    x = centers[which] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _store(x, kind):
    """(JAX rows, port rows, scale, dim) of ``x`` as ``kind`` stores it."""
    if kind == "int8":
        cj, sj = jax_sq8_quantize(jnp.asarray(x))
        ct, st = sq8_quantize(torch.tensor(x))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        return cj, ct, float(st), 0
    if kind == "int4":
        cj, sj = jax_sq4_quantize(jnp.asarray(x))
        ct, st = sq4_quantize(torch.tensor(x))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        return cj, ct, float(st), x.shape[1]
    if kind == "binary":
        return (jax_binary_quantize(jnp.asarray(x)),
                binary_quantize(torch.tensor(x)), None, x.shape[1])
    if kind == "bfloat16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.tensor(x).to(torch.bfloat16), None, 0)
    return jnp.asarray(x), torch.tensor(x), None, 0


def _same_layout(index_t, index_j, packed_binary=False):
    blocks_j = np.asarray(index_j.blocks)
    if index_t.blocks.dtype == torch.bfloat16:  # exact in fp32
        blocks_j = blocks_j.astype(np.float32)
        blocks_t = index_t.blocks.float().numpy()
    else:
        blocks_t = index_t.blocks.numpy()
    if packed_binary:
        blocks_t = blocks_t.view(np.uint32)
    np.testing.assert_array_equal(blocks_t, blocks_j)
    np.testing.assert_array_equal(index_t.block_ids.numpy(),
                                  np.asarray(index_j.block_ids))
    np.testing.assert_array_equal(index_t.block2list.numpy(),
                                  np.asarray(index_j.block2list))


@pytest.fixture(scope="module")
def data():
    """A clustered corpus, its JAX centroids and assignments (the JAX
    build's), and both packages' layouts of every store kind from those
    assignments."""
    x = _mixture(6000, D, 24, seed=0)
    ref = jivf.ivf_build(jnp.asarray(x), NLIST, CAP, seed=0)
    cent = np.asarray(ref.centroids)
    assign = np.asarray(jivf.ivf_assignments(ref, len(x)))
    out = {"x": x, "cent": cent, "assign": assign, "stores": {}}
    for kind in KINDS:
        rj, rt, scale, dim = _store(x, kind)
        ij = jivf.ivf_build_from_assign(rj, jnp.asarray(cent),
                                        jnp.asarray(assign), CAP)
        it = tivf.ivf_build_from_assign(rt, cent, assign, CAP)
        out["stores"][kind] = (ij, it, scale, dim, rj, rt)
    out["queries"] = _mixture(24, D, 24, seed=5)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_layout_from_the_same_assignments_is_bit_identical(data, kind):
    ij, it, *_ = data["stores"][kind]
    _same_layout(it, ij, packed_binary=kind == "binary")
    assert it.nblocks == ij.nblocks and it.cap == CAP
    assert it.row_width == ij.row_width
    # every row once; pad slots hold zero rows and id -1
    ids = it.block_ids.numpy().ravel()
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(6000))
    pad = it.block_ids.numpy() < 0
    assert not it.blocks.float().numpy()[pad].any()
    got = tivf.ivf_assignments(it, 6000).numpy()
    np.testing.assert_array_equal(got, data["assign"])
    np.testing.assert_array_equal(
        got, np.asarray(jivf.ivf_assignments(ij, 6000)))


@pytest.mark.parametrize("kind", ["float32", "int8", "int4", "binary"])
def test_append_is_bit_identical(data, kind):
    ij, it, _, dim, *_ = data["stores"][kind]
    extra = _mixture(300, D, 24, seed=9)
    if kind == "int8":  # the store's own codes at its scale
        codes = np.clip(np.round(extra / data["stores"][kind][2]), -127,
                        127).astype(np.int8)
        new_j, new_t = jnp.asarray(codes), torch.tensor(codes)
    else:
        new_j, new_t, _, _ = _store(extra, kind)
    aj = jivf.ivf_append(ij, new_j, 6000, dim=dim)
    at = tivf.ivf_append(it, new_t, 6000, dim=dim)
    _same_layout(at, aj, packed_binary=kind == "binary")
    assert at.nblocks > it.nblocks  # appended at the tail
    np.testing.assert_array_equal(at.blocks[: it.nblocks].numpy(),
                                  it.blocks.numpy())
    np.testing.assert_array_equal(tivf.ivf_assignments(at, 6300).numpy(),
                                  np.asarray(jivf.ivf_assignments(aj, 6300)))
    if kind in ("int4", "binary"):
        with pytest.raises(ValueError, match="dim"):
            tivf.ivf_append(it, new_t, 6000)


def _search_pair(data, kind, *, k=10, nprobe=12, metric="cosine", mask=None,
                 exact_select=False):
    ij, it, scale, dim, *_ = data["stores"][kind]
    q = data["queries"]
    jm = tm = None
    if mask is not None:
        jm = jnp.asarray(mask)
        tm = pack_row_mask(torch.tensor(mask))
    sj, ij_ = jivf.ivf_search(jnp.asarray(q), ij, k=k, nprobe=nprobe,
                              metric=metric, scale=scale, mask=jm, dim=dim,
                              exact_select=exact_select)
    st, it_ = tivf.ivf_search(torch.tensor(q), it, k=k, nprobe=nprobe,
                              metric=metric, scale=scale, mask=tm, dim=dim,
                              exact_select=exact_select)
    return (np.asarray(sj), np.asarray(ij_)), (st.numpy(), it_.numpy())


def _hold(kind, want, got):
    (sj, ij), (st, it) = want, got
    assert it.dtype == np.int32 and st.dtype == np.float32
    if kind in ("int8", "int4"):  # int32 dots times one factor
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))
        return
    tol = (1e-5, 1e-6) if kind == "binary" else (1e-4, 1e-5)
    np.testing.assert_allclose(st, sj, atol=tol[0], rtol=tol[1])
    assert np.mean(it == ij) >= 0.99
    live = sj > NEG_INF * 0.5
    np.testing.assert_array_equal(it[~live], -1)
    np.testing.assert_array_equal(ij[~live], -1)


SEARCH_CASES = [
    ("float32", "cosine"), ("float32", "dot"), ("float32", "euclidean"),
    ("float32", "mahalanobis"), ("bfloat16", "cosine"),
    ("bfloat16", "euclidean"), ("int8", "cosine"), ("int8", "dot"),
    ("int4", "cosine"), ("binary", "cosine"),
]


@pytest.mark.parametrize("kind,metric", SEARCH_CASES)
def test_search_matches_jax(data, kind, metric):
    _hold(kind, *_search_pair(data, kind, metric=metric))


@pytest.mark.parametrize("kind", ["float32", "int8", "int4", "binary"])
@pytest.mark.parametrize("allowed", [0.02, 0.3, 0.0])
def test_masked_search_matches_jax(data, kind, allowed):
    rng = np.random.default_rng(int(allowed * 100))
    mask = rng.random(6000) < allowed
    want, got = _search_pair(data, kind, mask=mask, k=20)
    _hold(kind, want, got)
    ids = got[1]
    assert all(mask[i] for i in ids[ids >= 0])
    if allowed == 0.0:
        assert (ids == -1).all() and (got[0] == NEG_INF).all()


@pytest.mark.parametrize("kind", ["float32", "int8"])
@pytest.mark.parametrize("nprobe,k", [(1, 10), (3, 200), (7, 5), (500, 10)])
def test_pinned_budgets_and_k_past_the_probed_rows(data, kind, nprobe, k):
    """nprobe=1 probes one block: k past its 64 slots pads (NEG_INF,
    -1); nprobe past the blocks clamps."""
    want, got = _search_pair(data, kind, nprobe=nprobe, k=k)
    _hold(kind, want, got)
    assert got[1].shape == (24, k)
    if nprobe * CAP < k:
        assert (got[1][:, nprobe * CAP:] == -1).all()


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_full_probe_exact_select_is_the_exhaustive_search(data, kind):
    ij, it, scale, *_ = data["stores"][kind]
    want, got = _search_pair(data, kind, nprobe=it.nblocks, k=15,
                             exact_select=True)
    _hold(kind, want, got)
    q = torch.tensor(data["queries"])
    if kind == "int8":  # equal scores; a tie ranks by slot, not by row
        s_x, i_x = sq8_topk(q, data["stores"][kind][5], scale, 15)
        np.testing.assert_array_equal(got[0], s_x.numpy())
        assert same_ids_at_ties(got[0], got[1], s_x.numpy(),
                                i_x.numpy()).all()
    else:
        s_x, i_x = exact_topk(q, torch.tensor(data["x"]), k=15)
        assert same_ids_at_ties(got[0], got[1], s_x.numpy(),
                                i_x.numpy()).all() or np.allclose(
            got[0], s_x.numpy(), atol=1e-6)


def test_scan_reference_sentinels_pads_and_mask(data):
    _, it, scale, *_ = data["stores"]["int8"]
    q = torch.tensor(data["queries"][:2])
    qc, qs = sq8_quantize(q)
    fac = torch.tensor([float(qs) * scale], dtype=torch.float32)
    # a real block, the sentinel, a block with pad slots
    pad_block = int(np.nonzero((it.block_ids.numpy() < 0).any(1))[0][0])
    sel = torch.tensor([[0, it.nblocks, pad_block]] * 2, dtype=torch.int32)
    mask = torch.zeros(6000, dtype=torch.bool)
    mask[it.block_ids[0, :10].long()] = True
    for m in (None, pack_row_mask(mask)):
        s, i = tivf.ivf_scan(qc, it.blocks, it.block_ids, sel, factor=fac,
                             mask=m)
        assert s.shape == (2, 3 * CAP)
        assert (i[:, CAP:2 * CAP] == -1).all()
        assert (s[:, CAP:2 * CAP] == NEG_INF).all()
        pads = it.block_ids[pad_block] < 0
        assert (i[:, 2 * CAP:][:, pads] == -1).all()
        live = i >= 0
        assert (s[~live] == NEG_INF).all()
        if m is not None:
            assert live.sum() == 2 * 10
        else:
            assert torch.equal(i[0, :CAP], it.block_ids[0])
    with pytest.raises(ValueError, match="factor"):
        tivf.ivf_scan(qc, it.blocks, it.block_ids, sel)
    with pytest.raises(ValueError, match="queries"):
        tivf.ivf_scan(q, it.blocks, it.block_ids, sel, factor=fac)
    with pytest.raises(ValueError, match="cosine/dot"):
        tivf.ivf_scan(qc, it.blocks, it.block_ids, sel, factor=fac,
                      euclid=True)
    before = dict(ft.launches)
    tivf.ivf_scan(qc, it.blocks, it.block_ids, sel, factor=fac)
    assert ft.launches == before  # the plain version counts no launch


def test_auto_nprobe_matches_jax():
    for nb in (1, 10, 31, 32, 100, 1600, 1601, 17_000, 123_457):
        for frac in (0.02, 0.005, 0.1):
            assert tivf.auto_nprobe(nb, frac) == jivf.auto_nprobe(nb, frac)


@pytest.mark.parametrize("kind", ["float32", "int4", "binary"])
def test_port_builds_partition_the_rows_by_nearest_list(data, kind):
    _, _, _, dim, _, rt = data["stores"][kind]
    build = {"float32": lambda: tivf.ivf_build(rt, NLIST, CAP, seed=1),
             "int4": lambda: tivf.ivf_build_sq4(rt, dim, NLIST, CAP, seed=1),
             "binary": lambda: tivf.ivf_build_binary(rt, dim, NLIST, CAP,
                                                     seed=1)}[kind]
    timings = {}
    if kind == "float32":
        idx = tivf.ivf_build(rt, NLIST, CAP, seed=1, timings=timings)
        assert set(timings) == {"kmeans_s", "assign_s", "layout_s"}
    else:
        idx = build()
    ids = idx.block_ids.numpy().ravel()
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(6000))
    assign = tivf.ivf_assignments(idx, 6000)
    if kind == "float32":
        from latentrag_torch.ops.kmeans import assign_clusters

        want = assign_clusters(rt, idx.centroids)
    else:
        want = tivf._assign_packed(rt, idx.centroids, dim,
                                   "sq4" if kind == "int4" else "binary")
    assert torch.equal(assign, want)
    again = build()  # seeded: the same layout
    assert torch.equal(again.block_ids, idx.block_ids)


@pytest.fixture(scope="module")
def wide():
    """More than 8192 blocks (cap 8 over 70k rows, d=8, 256 lists), the
    assignments JAX's nearest-centre sweep gives, and a grown list
    appended at the tail."""
    x = _mixture(70_000, 8, 256, seed=2, spread=0.1)
    cent = _mixture(256, 8, 256, seed=2, spread=0.0)
    from latentrag_tpu.ops.kmeans import assign_clusters as jassign

    assign = np.asarray(jassign(jnp.asarray(x), jnp.asarray(cent)))
    ij = jivf.ivf_build_from_assign(jnp.asarray(x), jnp.asarray(cent),
                                    jnp.asarray(assign), 8)
    it = tivf.ivf_build_from_assign(torch.tensor(x), cent, assign, 8)
    extra = _mixture(400, 8, 256, seed=3, spread=0.1)
    ij = jivf.ivf_append(ij, jnp.asarray(extra), 70_000)
    it = tivf.ivf_append(it, torch.tensor(extra), 70_000)
    _same_layout(it, ij)
    assert it.nblocks > 8192
    return ij, it, np.concatenate([x, extra])


@pytest.mark.parametrize("nprobe,mlb", [(64, None), (300, "build")])
def test_wide_index_lists_expand_as_jax(wide, nprobe, mlb):
    ij, it, x = wide
    q = _mixture(8, 8, 256, seed=11, spread=0.1)
    if mlb == "build":
        b2l = it.block2list.numpy()
        mlb = int(np.bincount(b2l[b2l >= 0]).max())
    sj, i_j = jivf.ivf_search(jnp.asarray(q), ij, k=20, nprobe=nprobe,
                              max_list_blocks=mlb)
    st, i_t = tivf.ivf_search(torch.tensor(q), it, k=20, nprobe=nprobe,
                              max_list_blocks=mlb)
    _hold("float32", (np.asarray(sj), np.asarray(i_j)),
          (st.numpy(), i_t.numpy()))
    # the probe set itself: the same selected blocks, slot for slot
    cscore = torch.tensor(q) @ it.centroids.T
    sel = tivf._coarse(cscore, it, nprobe, False, mlb)
    assert sel.shape[1] % (mlb or 1) == 0
    # appended rows (ids >= 70000) are reachable through their list
    hit = tivf.ivf_search(torch.tensor(x[70_000:70_008]), it, k=1,
                          nprobe=nprobe, max_list_blocks=mlb)[1]
    assert (hit[:, 0].numpy() == np.arange(70_000, 70_008)).all()


@pytest.mark.parametrize("path", ["narrow", "wide"])
def test_probe_sets_equal_jax(data, wide, path):
    """k = every probed slot: the ids each package returns are its probe
    set's live rows, so equal results show equal probe sets."""
    if path == "narrow":
        ij, it, *_ = data["stores"]["float32"]
        q, nprobe, mlb = data["queries"], 12, None
    else:
        ij, it, _ = wide
        q, nprobe = _mixture(8, 8, 256, seed=12, spread=0.1), 64
        b2l = it.block2list.numpy()
        mlb = int(np.bincount(b2l[b2l >= 0]).max())
    sel = tivf._coarse(torch.tensor(q) @ it.centroids.T, it, nprobe, False,
                       mlb)
    k = sel.shape[1] * it.cap
    sj, i_j = jivf.ivf_search(jnp.asarray(q), ij, k=k, nprobe=nprobe,
                              max_list_blocks=mlb)
    st, i_t = tivf.ivf_search(torch.tensor(q), it, k=k, nprobe=nprobe,
                              max_list_blocks=mlb)
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    for a, b in zip(i_t, i_j):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
    _hold("float32", (np.asarray(sj), i_j), (st.numpy(), i_t))


def test_narrow_ties_select_whole_lists_front_to_back(data):
    """Every block of a list carries its list's score: the lower block
    wins the tie, so a partly probed list is scanned from its front."""
    _, it, *_ = data["stores"]["float32"]
    q = torch.tensor(data["queries"][:4])
    cscore = q @ it.centroids.T
    sel = tivf._coarse(cscore, it, 5, False, None).long()
    b2l = it.block2list
    for r in range(4):
        lists = b2l[sel[r]].tolist()
        best = torch.argsort(cscore[r], descending=True, stable=True)
        order = [b for lst in best.tolist()
                 for b in torch.nonzero(b2l == lst)[:, 0].tolist()]
        assert sel[r].tolist() == order[:5], (lists, order[:8])
