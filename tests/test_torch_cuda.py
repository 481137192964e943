"""Tests of the port that need the card: the CUDA kernels have no CPU
mode. Each skips here with its reason; on a machine with an NVIDIA GPU and
nvcc run them with

    python -m pytest tests/test_torch_cuda.py -m cuda

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed."""

import numpy as np
import pytest
import torch

from latentrag_torch.ops import binary as tb
from latentrag_torch.ops import fused_topk as ft

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _data(cuda, dtype, nq=37, n=9000, d=64, seed=0):
    """Seeded queries and corpus on the card. d=64 takes the kernels'
    16-byte staged loads; other widths the element-wise loads."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((nq, d), generator=g, device=cuda).to(dtype)
    c = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    return q, c


@pytest.mark.parametrize("d", [64, 50])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("mode", ["exact", "fold"])
def test_kernel_matches_plain(cuda, mode, metric, store, d):
    q, c = _data(cuda, getattr(torch, store), d=d)
    s_k, i_k = ft.fused_topk_raw(q, c, k=16, metric=metric, mode=mode)
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=16, metric=metric,
                                           mode=mode)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.99
    if mode == "exact":  # fp32 sums in another order
        tol = 1e-4 + 1e-5 * s_p.abs()
        assert bool(((s_k - s_p).abs() <= tol)[same].all())


@pytest.mark.parametrize("k", [1, 10, 40, 128])
@pytest.mark.parametrize("block_n", [128, 4096])
@pytest.mark.parametrize("d", [48, 64, 384])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_bf16_fold_kernel_matches_plain(cuda, metric, d, block_n, k):
    """The tensor-core fold (csrc/fold_mma.cuh). N=5003 is not a multiple
    of 128; 100 queries leave a ragged query tile with an idle warp pair;
    d=48 zero-fills stage dims, d=384 takes six 64-dim chunks."""
    q, c = _data(cuda, torch.bfloat16, nq=100, n=5003, d=d)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q.float(), dim=1).bfloat16()
        c = torch.nn.functional.normalize(c.float(), dim=1).bfloat16()
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="fold",
                                 block_n=block_n)
    assert ft.last_kernel.split("+")[0] == "fold_mma_kernel"
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric=metric,
                                           mode="fold", block_n=block_n)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.99
    # equal ids carry the same 19-bit key, up to one key step (10 bits of
    # mantissa kept) where the fp32 sums ran in another order
    step = 2.0 ** -10 * s_p.abs() + 1e-6
    assert bool(((s_k - s_p).abs() <= step)[same].all())


@pytest.mark.parametrize("case", ["one_slab", "element_loads"])
def test_bf16_fold_kernel_paths(cuda, case):
    """One slab: the partial kernel writes scores and ids itself. A corpus
    whose base is not 16-byte aligned loads its stages element by element."""
    q, c = _data(cuda, torch.bfloat16, nq=70, n=3000)
    if case == "element_loads":
        buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)
        c = buf[1:].view(c.shape).copy_(c)
        assert c.data_ptr() % 16 != 0 and c.is_contiguous()
    s_k, i_k = ft.fused_topk_raw(q, c, k=40, metric="euclidean",
                                 mode="fold", block_n=4096)
    if case == "one_slab":
        assert ft.last_kernel == "fold_mma_kernel"
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=40, metric="euclidean",
                                           mode="fold", block_n=4096)
    assert (i_k == i_p).float().mean().item() >= 0.99


def test_fold_routes_by_store_dtype(cuda):
    """bf16 stores take the bf16 instances of the tensor-core kernels, fp32
    stores their 3xTF32 instances; each counts as a launch of its mode."""
    q, c = _data(cuda, torch.float32, n=3000)
    ft.reset_launches()
    ft.fused_topk_raw(q, c, k=10, mode="fold")
    assert ft.last_kernel.split("+")[0] == "fold_mma_kernel<f32>"
    ft.fused_topk_raw(q.bfloat16(), c.bfloat16(), k=10, mode="fold")
    assert ft.last_kernel.split("+")[0] == "fold_mma_kernel"
    ft.fused_topk_raw(q.bfloat16(), c.bfloat16(), k=10, mode="exact")
    assert ft.last_kernel.split("+")[0] == "exact_mma_kernel"
    ft.fused_topk_raw(q, c, k=10, mode="exact")
    assert ft.last_kernel.split("+")[0] == "exact_mma_kernel<f32>"
    assert ft.launches == {"fold": 2, "exact": 2, "binary_fold": 0,
                           "binary_exact": 0, "blocked": 0,
                           "binary_blocked": 0}


@pytest.mark.parametrize("mode", ["exact", "fold"])
@pytest.mark.parametrize("d", [64, 40, 37])
@pytest.mark.parametrize("side", ["queries", "corpus"])
def test_f32_fragment_layout_exact_on_integers(cuda, side, d, mode):
    """The fp32 kernels' 3xTF32 fragments against a scalar loop. Small
    integers on one side and values of 15 significant bits (a + b / 4096)
    on the other make every product and every sum exact in fp32, and the
    fine side needs its tf32 lo part: the kernel's scores must equal a
    float64 loop over the dims bit for bit, so a fragment read from the
    wrong row or dim, or a dropped lo part, shows. d=40 leaves zero dims in
    the second 32-dim stage; d=37 loads the stages element by element."""
    rng = np.random.default_rng(d)
    nq, n = 37, 300
    ints = lambda r, w: rng.integers(-3, 4, (r, w)).astype(np.float64)  # noqa: E731
    fine = lambda r, w: (rng.integers(-4, 5, (r, w))  # noqa: E731
                         + rng.integers(-4095, 4096, (r, w)) / 4096.0)
    q, c = ((fine(nq, d), ints(n, d)) if side == "queries"
            else (ints(nq, d), fine(n, d)))
    ref = np.zeros((nq, n))
    for j in range(d):  # the scalar loop, dim by dim in float64
        ref += q[:, j, None] * c[None, :, j]
    qt = torch.from_numpy(q).float().to(cuda)
    ct = torch.from_numpy(c).float().to(cuda)
    assert np.array_equal(qt.double().cpu().numpy(), q)
    k = n if mode == "exact" else 128
    s_k, i_k = ft.fused_topk_raw(qt, ct, k=k, metric="dot", mode=mode,
                                 block_n=128)
    assert ft.last_kernel.split("+")[0] == f"{mode}_mma_kernel<f32>"
    s_p, i_p = ft.fused_topk_raw_reference(qt, ct, k=k, metric="dot",
                                           mode=mode, block_n=128)
    assert torch.equal(i_k, i_p)
    if mode == "exact":  # every row's score, in place
        got = np.full((nq, n), np.nan)
        np.put_along_axis(got, i_k.long().cpu().numpy(),
                          s_k.double().cpu().numpy(), 1)
        assert np.array_equal(got, ref)
    else:  # the same exact scores give the same 19-bit keys
        assert torch.equal(s_k, s_p)


@pytest.mark.parametrize("k", [10, 40, 128])
@pytest.mark.parametrize("block_n", [128, 4096])
@pytest.mark.parametrize("d", [48, 64, 384])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_f32_fold_kernel_matches_plain(cuda, metric, d, block_n, k):
    """The fp32 fold in 3xTF32 (fold_mma_kernel<E, OP_F32>). N=5003 is not
    a multiple of 128; 100 queries leave a ragged query tile; d=48 half
    fills its second 32-dim stage, d=384 takes twelve, and at k=128 the
    2-stage ring."""
    q, c = _data(cuda, torch.float32, nq=100, n=5003, d=d, seed=d + k)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q, dim=1)
        c = torch.nn.functional.normalize(c, dim=1)
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="fold",
                                 block_n=block_n)
    assert ft.last_kernel.startswith("fold_mma_kernel<f32>")
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric=metric,
                                           mode="fold", block_n=block_n)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.99
    step = 2.0 ** -10 * s_p.abs() + 1e-6  # one 19-bit key step
    assert bool(((s_k - s_p).abs() <= step)[same].all())


@pytest.mark.parametrize("k", [1, 10, 128, 160, 300, 2048])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_f32_exact_kernel_matches_plain(cuda, metric, k):
    """The fp32 exact kernel in 3xTF32 (exact_mma_kernel<KP, OP_F32>)
    against its plain version: 37 queries over N=5003 run several slabs
    and the merge (k=2048: four queries a block, lists of 2048)."""
    q, c = _data(cuda, torch.float32, nq=37, n=5003, seed=k)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q, dim=1)
        c = torch.nn.functional.normalize(c, dim=1)
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="exact")
    assert ft.last_kernel.startswith("exact_mma_kernel<f32>")
    if k == 2048:
        assert ft.last_kernel.endswith("+exact_merge_kernel")
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric=metric,
                                           mode="exact")
    same = i_k == i_p
    assert same.float().mean().item() >= 0.999
    tol = 1e-4 + 1e-5 * s_p.abs()
    assert bool(((s_k - s_p).abs() <= tol)[same].all())


@pytest.mark.parametrize("mode,k", [("fold", 128), ("exact", 300)])
def test_f32_kernels_d384_unaligned(cuda, mode, k):
    """fp32 at the encoder width from a corpus base that is not 16-byte
    aligned: the stages load element by element."""
    q, c = _data(cuda, torch.float32, nq=37, n=5003, d=384)
    buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)
    c = buf[1:].view(c.shape).copy_(c)
    assert c.data_ptr() % 16 != 0 and c.is_contiguous()
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric="euclidean", mode=mode)
    assert ft.last_kernel.startswith(f"{mode}_mma_kernel<f32>")
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric="euclidean",
                                           mode=mode)
    same = i_k == i_p
    assert same.float().mean().item() >= (0.999 if mode == "exact" else 0.99)
    if mode == "exact":
        tol = 1e-4 + 1e-5 * s_p.abs()
        assert bool(((s_k - s_p).abs() <= tol)[same].all())


def test_f32_store_launches(cuda):
    """An fp32 store through the retriever: at k=10 the fold serves the
    self-check and the search; at k=150 the fp32 exact kernel the search."""
    from latentrag_torch.retrieval import DenseRetriever

    emb = torch.randn((3000, 64), generator=torch.Generator().manual_seed(3))
    r = DenseRetriever(store_dtype="float32", device="cuda")
    ft.reset_launches()
    r.build(emb.numpy(), [str(i) for i in range(3000)])
    s, i = r.search(emb[:20].numpy(), 10)
    assert ft.launches["fold"] == 2 and ft.launches["exact"] == 0
    assert ft.last_kernel.startswith("fold_mma_kernel<f32>")
    assert (i[:, 0] == np.arange(20)).all() and np.isfinite(s).all()
    s, i = r.search(emb[:20].numpy(), 150)
    assert ft.launches["exact"] == 1
    assert ft.last_kernel.startswith("exact_mma_kernel<f32>")
    assert (i[:, 0] == np.arange(20)).all() and np.isfinite(s).all()


def test_launch_counts_and_validation(cuda):
    q, c = _data(cuda, torch.float32, n=500)
    ft.reset_launches()
    ft.fused_topk(q, c, k=5, mode="fold")
    ft.fused_topk(q, c, k=5, mode="exact")
    ft.approx_fused_topk(q, c, k=5)
    assert ft.launches == {"fold": 2, "exact": 1, "binary_fold": 0,
                           "binary_exact": 0, "blocked": 0,
                           "binary_blocked": 0}
    # past the exact kernels' 2048 the blocked route, counted apart
    big = _data(cuda, torch.float32, n=2100)[1]
    s, i = ft.approx_fused_topk(q, big, k=2050)
    assert ft.launches["blocked"] == 1 and ft.launches["exact"] == 1
    s_p, i_p = ft.fused_topk_raw_reference(q, big, k=2050, mode="exact")
    assert (i == i_p).float().mean().item() >= 0.99
    # the exact entry answers past the lists through the radix select
    s, i = ft.fused_topk_raw(q, big, k=2050, mode="exact")
    assert ft.launches["exact"] == 2
    assert ft.last_kernel == "exact_select_kernel<f32>"
    assert (i == i_p).float().mean().item() >= 0.999
    with pytest.raises(ValueError, match="contiguous"):
        ft.fused_topk_raw(q, c.T.contiguous().T, k=5)


def _select(q, c, k, metric="cosine", route="auto"):
    """The exact entry past 2048 on the exact select's private ``route``."""
    return ft._fused_topk_raw_cuda(q, c, None, k, metric == "euclidean",
                                   "exact", 4096, route=route)


def _assert_slots_match_plain(s_k, i_k, s_p, i_p):
    """The limits of a large corpus, where two fp32 sum orders swap
    neighbours that differ in the last bits: the plain ids found in the
    kernel's row on >= 99.9 %, and every slot's score (the j-th best of
    each) within 1e-4 + 1e-5 |s|."""
    n = int(max(i_k.max().item(), i_p.max().item())) + 1
    off = torch.arange(i_k.shape[0], device=i_k.device)[:, None] * n
    found = torch.isin(i_p.long() + off, i_k.long() + off)
    assert found.float().mean().item() >= 0.999
    assert bool(((s_k - s_p).abs() <= 1e-4 + 1e-5 * s_p.abs()).all())


def _assert_same_as_radix(q, c, k, metric, s_k, i_k):
    """The auto route's answer equals the radix route's bit for bit."""
    s_r, i_r = _select(q, c, k, metric, route="radix")
    assert torch.equal(i_k, i_r)
    assert torch.equal(s_k.view(torch.int32), s_r.view(torch.int32))


@pytest.mark.parametrize("k", [2049, 3000, 5003])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_exact_select_matches_plain(cuda, metric, store, k):
    """Past the exact kernel's 2048 the radix select
    (csrc/exact_select.cuh): N=5003 is not a multiple of 128, 37 queries
    leave a ragged query tile, d=50 takes the element-wise loads; k=N
    selects every row."""
    q, c = _data(cuda, getattr(torch, store), n=5003, d=50)
    ft.reset_launches()
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="exact")
    assert ft.launches["exact"] == 1
    assert ft.last_kernel == "exact_select_kernel" + (
        "<f32>" if store == "float32" else "")
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric=metric,
                                           mode="exact")
    assert i_k.shape == (37, k) and s_k.shape == (37, k)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.999
    tol = 1e-4 + 1e-5 * s_p.abs()
    assert bool(((s_k - s_p).abs() <= tol)[same].all())
    assert bool((s_k[:, :-1] >= s_k[:, 1:]).all())
    # N <= C: the buffer keeps every row
    assert ft.last_select["route"] == "all" and ft.select_fallbacks() == 0
    _assert_same_as_radix(q, c, k, metric, s_k, i_k)


def test_exact_select_sorts_in_device_memory(cuda):
    """k=17000 needs a sort of 32768 entries a query, past the 16384 a
    block holds in shared memory: the sort runs in place in device
    memory."""
    q, c = _data(cuda, torch.bfloat16, nq=5, n=20000)
    s_k, i_k = ft.fused_topk_raw(q, c, k=17000, mode="exact")
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=17000, mode="exact")
    same = i_k == i_p
    assert same.float().mean().item() >= 0.999
    assert bool(((s_k - s_p).abs() <= 1e-4 + 1e-5 * s_p.abs())[same].all())
    assert bool((s_k[:, :-1] >= s_k[:, 1:]).all())
    # past k = 8192 the plan takes the radix route itself
    assert ft.last_select["route"] == "radix" and ft.select_fallbacks() is None
    _assert_same_as_radix(q, c, 17000, "cosine", s_k, i_k)


def test_exact_select_ties(cuda):
    """Rows from 40 distinct vectors tie at every score: the row passes
    must hand the k-th score's ties to the lowest rows."""
    g = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn((40, 64), generator=g, device=cuda)
    pick = torch.randint(0, 40, (6000,), generator=g, device=cuda)
    c = base[pick].bfloat16().contiguous()
    q = torch.randn((20, 64), generator=g, device=cuda).bfloat16()
    s_k, i_k = ft.fused_topk_raw(q, c, k=3000, mode="exact")
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=3000, mode="exact")
    assert torch.equal(i_k, i_p)
    assert ft.last_kernel == "exact_select_kernel"
    _assert_same_as_radix(q, c, 3000, "cosine", s_k, i_k)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_pallas_exact_store_past_2048(cuda, store):
    """The pallas_exact backend answers at k past 2048 as the JAX
    package's does, through the radix select."""
    from latentrag_torch.retrieval import DenseRetriever

    emb = torch.randn((3000, 64), generator=torch.Generator().manual_seed(2))
    r = DenseRetriever(backend="pallas_exact", store_dtype=store,
                       device="cuda")
    r.build(emb.numpy(), [str(i) for i in range(3000)])
    ft.reset_launches()
    s, i = r.search(emb[:20].numpy(), 2500)
    assert ft.launches["exact"] == 1
    assert ft.last_kernel.startswith("exact_select_kernel")
    assert i.shape == (20, 2500) and (i[:, 0] == np.arange(20)).all()
    assert np.isfinite(s).all() and (np.diff(s, axis=1) <= 0).all()
    assert ft.last_select["route"] == "all" and ft.select_fallbacks() == 0
    # the store's prepared rows through both routes
    q = r._corpus[:20].contiguous()
    s_k, i_k = _select(q, r._corpus, 2500)
    _assert_same_as_radix(q, r._corpus, 2500, "cosine", s_k, i_k)


@pytest.mark.parametrize("k", [2049, 3000, 4096])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_exact_select_sampled_route(cuda, metric, store, k):
    """N > C: the sampled threshold and one buffer pass serve rows in
    random order with no fallback, and answer as the radix route does,
    bit for bit; 40 queries leave a ragged query tile."""
    q, c = _data(cuda, getattr(torch, store), nq=40, n=60000)
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="exact")
    assert ft.last_select["route"] == "sampled"
    assert ft.last_kernel.startswith("exact_select_kernel")
    assert ft.last_kernel.endswith("+exact_mma_kernel" + (
        "<f32>" if store == "float32" else ""))
    assert ft.select_fallbacks() == 0
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric=metric,
                                           mode="exact")
    _assert_slots_match_plain(s_k, i_k, s_p, i_p)
    _assert_same_as_radix(q, c, k, metric, s_k, i_k)


def _fallback_case(cuda, case, dtype, nq=32, n=60000, d=64, k=3000):
    """Queries and a corpus on which the sampled threshold fails: in
    "mixed" the sampled rows (every s-th) are the best rows of the even
    queries (their threshold overshoots: count < k) and score like any
    row for the odd ones; in "ties" every row is one of 2 vectors (more
    than C keys on the threshold's score). Returns (q, c, queries that
    must fall back)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((nq, d), generator=g, device=cuda)
    if case == "ties":
        base = torch.randn((2, d), generator=g, device=cuda)
        pick = torch.randint(0, 2, (n,), generator=g, device=cuda)
        return q.to(dtype), base[pick].to(dtype).contiguous(), nq
    stride = ft._select_plan(nq, n, k)[1]
    c = torch.randn((n, d), generator=g, device=cuda)
    c[:, 0] = 0.0
    c[::stride, 0] = 20.0
    q[:, 0] = 0.0
    q[::2, 0] = 1.0
    return q.to(dtype), c.to(dtype), nq // 2


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mixed", "ties"])
def test_exact_select_fallback(cuda, case, store):
    """Queries whose threshold fails fall back to the radix passes in the
    same call (the device counts them); the answer is the plain version's
    and, bit for bit, the radix route's."""
    q, c, fall = _fallback_case(cuda, case, getattr(torch, store))
    s_k, i_k = ft.fused_topk_raw(q, c, k=3000, mode="exact")
    assert ft.last_select["route"] == "sampled"
    assert ft.select_fallbacks() == fall
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=3000, mode="exact")
    if case == "ties":
        assert torch.equal(i_k, i_p)
    _assert_slots_match_plain(s_k, i_k, s_p, i_p)
    _assert_same_as_radix(q, c, 3000, "cosine", s_k, i_k)


@pytest.mark.parametrize("k", [10, 150])
def test_aggregate_docs_on_card_matches_cpu(cuda, k):
    """MaxSim on the card gives the CPU placement's doc ids and scores,
    with tied chunk scores, repeated docs and empty slots."""
    from latentrag_torch.pipeline import aggregate_docs

    rng = np.random.default_rng(0)
    nq, c = 300, max(k, 30)
    scores = -np.sort(-np.round(rng.standard_normal((nq, c)), 1), axis=1)
    idx = rng.integers(0, 2000, (nq, c)).astype(np.int64)
    idx[:5, -3:] = -1
    doc_ids = list(rng.integers(0, 400, 2000))
    ds_g, ids_g = aggregate_docs(scores, idx, doc_ids, k, cuda)
    ds_c, ids_c = aggregate_docs(scores, idx, doc_ids, k, "cpu")
    assert ids_g == ids_c
    np.testing.assert_array_equal(ds_g, ds_c)


def test_approx_route_recall(cuda):
    q, c = _data(cuda, torch.bfloat16, nq=200, n=50_000)
    q = torch.nn.functional.normalize(q.float(), dim=1).bfloat16()
    c = torch.nn.functional.normalize(c.float(), dim=1).bfloat16()
    _, i0 = ft.fused_topk_raw(q, c, k=10, mode="exact")
    _, i1 = ft.approx_fused_topk(q, c, k=10, recall_target=0.99)
    hits = (i1[:, :, None] == i0[:, None, :]).any(-1).float().mean().item()
    assert hits >= 0.99


def test_main_path_on_card(cuda, tmp_path):
    from latentrag_torch import main as torch_main
    from latentrag_torch.models import VariationalAutoencoder

    base = str(tmp_path)
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    ft.reset_launches()
    results = []
    rc = torch_main.main([
        "--ae_type", "vae", "--set", "data.dataset=synthetic",
        "data.max_samples=60", "encoder.vocab_size=800",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={base}/vae.pth",
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", "logging.log_to_file=false",
    ], results=results)
    assert rc == 0
    # the self-check searches through the configured route, as the search
    assert ft.launches["fold"] >= 2 and ft.launches["exact"] == 0
    assert np.isfinite(results[0]["doc_scores"]).all()


def _binary_data(cuda, d, nq=37, n=9000, seed=0):
    """Seeded bf16 queries and the packed sign words of a unit corpus."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((nq, d), generator=g, device=cuda).bfloat16()
    c = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device=cuda), dim=1)
    return q, tb.binary_quantize(c)


@pytest.mark.parametrize("block_n", [4096, 512])
@pytest.mark.parametrize("d", [64, 48])
def test_binary_kernel_matches_plain(cuda, d, block_n):
    """d=48 pads each row's last word; N=9000 is not a multiple of the
    tile; 37 queries leave a ragged query tile."""
    q, packed = _binary_data(cuda, d)
    s_k, i_k = ft.binary_fused_topk_raw(q, packed, d=d, k=16,
                                        block_n=block_n)
    assert ft.last_kernel.startswith("fold_mma_kernel<bin>")
    s_p, i_p = ft.binary_fused_topk_raw_reference(q, packed, d=d, k=16,
                                                  block_n=block_n)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.99
    e_k, j_k = ft.rescore_binary_candidates(q, packed, i_k, d)
    e_p, j_p = ft.rescore_binary_candidates(q, packed, i_p, d)
    eq = j_k == j_p
    tol = 1e-5 + 1e-6 * e_p.abs()
    assert bool(((e_k - e_p).abs() <= tol)[eq].all())


def test_binary_launch_counts_and_store(cuda):
    q, packed = _binary_data(cuda, 64, n=3000)
    ft.reset_launches()
    ft.binary_fused_topk(q, packed, d=64, k=5)
    ft.approx_binary_fused_topk(q, packed, d=64, k=40)
    assert ft.launches == {"fold": 0, "exact": 0, "binary_fold": 2,
                           "binary_exact": 0, "blocked": 0,
                           "binary_blocked": 0}
    # above 128 candidates the route takes the exact binary kernel
    ft.approx_binary_fused_topk(q, packed, d=64, k=129)
    assert ft.launches["binary_exact"] == 1
    assert ft.last_kernel.startswith("exact_mma_kernel<bin>")
    # past 2048 its blocked route, counted apart
    s, i = ft.approx_binary_fused_topk(q, packed, d=64, k=2049)
    assert ft.launches["binary_blocked"] == 1 and i.shape == (37, 2049)
    assert ft.launches["binary_exact"] == 1
    with pytest.raises(ValueError, match="k <= 2048"):
        ft.binary_exact_topk_raw(q, packed, d=64, k=2049)

    from latentrag_torch.retrieval import DenseRetriever

    emb = torch.randn((3000, 64), generator=torch.Generator().manual_seed(1))
    r = DenseRetriever(store_dtype="binary", device="cuda")
    ft.reset_launches()
    r.build(emb.numpy(), [str(i) for i in range(3000)])
    s, i = r.search(emb[:20].numpy(), 10)
    assert ft.launches["binary_fold"] == 2  # self-check and search
    assert (i[:, 0] == np.arange(20)).all() and np.isfinite(s).all()
    assert r._corpus.is_cuda and r._corpus.dtype == torch.int32


@pytest.mark.parametrize("k", [10, 80, 128])
@pytest.mark.parametrize("block_n", [128, 4096])
@pytest.mark.parametrize("d", [64, 48, 384])
def test_binary_fold_kernel_matches_plain(cuda, d, block_n, k):
    """The binary fold on the tensor cores (fold_mma_kernel<E, true>).
    N=5003 is not a multiple of 128; 100 queries leave a ragged query tile
    with an idle warp pair; d=48 has pad bits in word 1, d=384 is 12 words
    a row in six 64-dim stages."""
    q, packed = _binary_data(cuda, d, nq=100, n=5003, seed=d + k)
    s_k, i_k = ft.binary_fused_topk_raw(q, packed, d=d, k=k, block_n=block_n)
    assert ft.last_kernel.startswith("fold_mma_kernel<bin>")
    s_p, i_p = ft.binary_fused_topk_raw_reference(q, packed, d=d, k=k,
                                                  block_n=block_n)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.99
    # equal ids carry the same 19-bit key, up to one key step
    step = 2.0 ** -10 * s_p.abs() + 1e-6
    assert bool(((s_k - s_p).abs() <= step)[same].all())


def test_binary_fold_kernel_one_slab(cuda):
    """One 4096-row tile: the partial kernel writes scores and ids itself."""
    q, packed = _binary_data(cuda, 64, nq=70, n=3000)
    _, i_k = ft.binary_fused_topk_raw(q, packed, d=64, k=40, block_n=4096)
    assert ft.last_kernel == "fold_mma_kernel<bin>"
    _, i_p = ft.binary_fused_topk_raw_reference(q, packed, d=64, k=40,
                                                block_n=4096)
    assert (i_k == i_p).float().mean().item() >= 0.99


@pytest.mark.parametrize("k", [129, 160, 300, 1024, 2048])
@pytest.mark.parametrize("d", [64, 48, 384])
def test_binary_exact_kernel_matches_plain(cuda, d, k):
    """The exact binary kernel on the tensor cores (exact_mma_kernel<KP,
    true>) against ``binary_topk``: ties to the lower row in both, fp32
    sums in another order. 37 queries over N=5003 run many slabs and the
    merge."""
    q, packed = _binary_data(cuda, d, nq=37, n=5003, seed=k)
    s_k, i_k = ft.binary_exact_topk_raw(q, packed, d=d, k=k)
    assert ft.last_kernel.startswith("exact_mma_kernel<bin>")
    s_p, i_p = tb.binary_topk(q, packed, d, k)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.999
    tol = 1e-4 + 1e-5 * s_p.abs()
    assert bool(((s_k - s_p).abs() <= tol)[same].all())


def test_binary_store_top_k_20_launches(cuda):
    """top_k=20 asks stage 1 for 8 x 20 = 160 candidates: the search takes
    the exact binary kernel, the self-check (k=4, 32 candidates) the fold."""
    from latentrag_torch.retrieval import DenseRetriever

    emb = torch.randn((3000, 64), generator=torch.Generator().manual_seed(2))
    r = DenseRetriever(store_dtype="binary", device="cuda")
    r.build(emb.numpy(), [str(i) for i in range(3000)], sanity_check=False)
    ft.reset_launches()
    assert r._self_check()
    s, i = r.search(emb[:20].numpy(), 20)
    assert ft.launches == {"fold": 0, "exact": 0, "binary_fold": 1,
                           "binary_exact": 1, "blocked": 0,
                           "binary_blocked": 0}
    assert i.shape == (20, 20) and (i[:, 0] == np.arange(20)).all()
    assert np.isfinite(s).all()


@pytest.mark.parametrize("k", [1, 10, 64, 128, 160, 300, 2048])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_bf16_exact_kernel_matches_plain(cuda, metric, k):
    """The bf16 exact kernel on the tensor cores (exact_mma_kernel<KP,
    false>) against its plain version: 37 queries over N=5003 run many
    slabs and the merge; ties to the lower row in both."""
    q, c = _data(cuda, torch.bfloat16, nq=37, n=5003, seed=k)
    if metric == "cosine":
        q = torch.nn.functional.normalize(q.float(), dim=1).bfloat16()
        c = torch.nn.functional.normalize(c.float(), dim=1).bfloat16()
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric=metric, mode="exact")
    assert ft.last_kernel.split("+")[0] == "exact_mma_kernel"
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric=metric,
                                           mode="exact")
    same = i_k == i_p
    assert same.float().mean().item() >= 0.999
    tol = 1e-4 + 1e-5 * s_p.abs()
    assert bool(((s_k - s_p).abs() <= tol)[same].all())


@pytest.mark.parametrize("case", ["one_slab", "element_loads", "binary"])
def test_exact_kernel_one_slab_and_loads(cuda, case):
    """2000 queries over 315 rows fill the card with one slab: the kernel
    writes scores and ids itself. A corpus base that is not 16-byte
    aligned loads its stages element by element."""
    if case == "binary":
        q, packed = _binary_data(cuda, 64, nq=2000, n=315)
        s_k, i_k = ft.binary_exact_topk_raw(q, packed, d=64, k=160)
        assert ft.last_kernel == "exact_mma_kernel<bin>"
        s_p, i_p = tb.binary_topk(q, packed, 64, 160)
    else:
        q, c = _data(cuda, torch.bfloat16, nq=2000, n=315)
        if case == "element_loads":
            buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)
            c = buf[1:].view(c.shape).copy_(c)
            assert c.data_ptr() % 16 != 0 and c.is_contiguous()
        s_k, i_k = ft.fused_topk_raw(q, c, k=10, metric="euclidean",
                                     mode="exact")
        if case == "one_slab":
            assert ft.last_kernel == "exact_mma_kernel"
        s_p, i_p = ft.fused_topk_raw_reference(q, c, k=10,
                                               metric="euclidean",
                                               mode="exact")
    assert (i_k == i_p).float().mean().item() >= 0.999
