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


def _counts(**launched):
    """Every launch counter at 0 but those given: a route launches what
    it should and nothing else."""
    return {**dict.fromkeys(ft.launches, 0), **launched}


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
    assert ft.launches == _counts(fold=2, exact=2)


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
    assert ft.launches == _counts(fold=2, exact=1)
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
    assert ft.launches == _counts(binary_fold=2)
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
    assert ft.launches == _counts(binary_fold=1, binary_exact=1)
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


# ------------------------------------------------------ the row mask

MASKS = [0.01, 0.1, 0.5, 1.0, "fewer_than_k", "none"]
# (Q, N, d): the reference config, and a ragged shape at MiniLM's d=384
MASK_SHAPES = {"reference": (2000, 315, 64), "d384": (37, 5003, 384)}


def _row_mask(cuda, n, allowed, k, seed=3):
    """A seeded bool row mask on the card and its packed words: a share of
    rows allowed, k // 2 rows (fewer than k), or none."""
    from latentrag_torch.ops.topk import pack_row_mask

    g = torch.Generator(device=cuda).manual_seed(seed)
    if allowed == "none":
        m = torch.zeros(n, dtype=torch.bool, device=cuda)
    elif allowed == "fewer_than_k":
        m = torch.zeros(n, dtype=torch.bool, device=cuda)
        m[torch.randperm(n, generator=g, device=cuda)[: max(1, k // 2)]] = True
    else:
        m = torch.rand(n, generator=g, device=cuda) < allowed
    return m, pack_row_mask(m)


def _assert_masked_match(m, s_k, i_k, s_p, i_p, id_match):
    """Kernel and plain version agree on the slots' ids, leave the same
    slots empty as (NEG_INF, -1), and return allowed rows only."""
    from latentrag_torch.ops.topk import NEG_INF

    assert torch.equal(i_k < 0, i_p < 0)
    assert bool((s_k[i_k < 0] == NEG_INF).all())
    live = i_k >= 0
    assert bool(m[i_k[live].long()].all())
    if live.any():
        assert (i_k == i_p)[live].float().mean().item() >= id_match


@pytest.mark.parametrize("allowed", MASKS)
@pytest.mark.parametrize("shape", sorted(MASK_SHAPES))
@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode,k", [("fold", 40), ("exact", 10),
                                    ("exact", 160)])
def test_masked_kernel_matches_plain(cuda, mode, k, store, shape, allowed):
    """fold_mma_kernel<E, OP, true> and exact_mma_kernel<KP, OP, true>
    against their masked plain versions; the fold at the approximate
    route's plan (128-row tiles at 2000 x 315)."""
    nq, n, d = MASK_SHAPES[shape]
    q, c = _data(cuda, getattr(torch, store), nq=nq, n=n, d=d)
    m, words = _row_mask(cuda, n, allowed, k)
    block_n = ft.fold_plan(n, 10, 0.99)[0] if mode == "fold" else 4096
    ft.reset_launches()
    s_k, i_k = ft.fused_topk_raw(q, c, k=k, metric="euclidean", mode=mode,
                                 block_n=block_n, mask=words)
    assert ft.launches["masked"] == 1 and ft.launches[mode] == 1
    assert ft.last_kernel.split("+")[0].endswith("<mask>")
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, metric="euclidean",
                                           mode=mode, block_n=block_n,
                                           mask=words)
    _assert_masked_match(m, s_k, i_k, s_p, i_p,
                         0.99 if mode == "fold" else 0.999)


@pytest.mark.parametrize("allowed", MASKS)
@pytest.mark.parametrize("shape", sorted(MASK_SHAPES))
@pytest.mark.parametrize("kernel,k", [("fold", 128), ("exact", 160)])
def test_masked_binary_kernel_matches_plain(cuda, kernel, k, shape,
                                            allowed):
    """The masked binary fold (at the plan's tiles) and the masked exact
    binary kernel against their plain versions."""
    nq, n, d = MASK_SHAPES[shape]
    q, packed = _binary_data(cuda, d, nq=nq, n=n)
    m, words = _row_mask(cuda, n, allowed, k)
    ft.reset_launches()
    if kernel == "fold":
        block_n = ft.fold_plan(n, 32, 0.99)[0]
        s_k, i_k = ft.binary_fused_topk_raw(q, packed, d=d, k=k,
                                            block_n=block_n, mask=words)
        assert ft.last_kernel.split("+")[0] == "fold_mma_kernel<bin><mask>"
        s_p, i_p = ft.binary_fused_topk_raw_reference(
            q, packed, d=d, k=k, block_n=block_n, mask=words)
    else:
        s_k, i_k = ft.binary_exact_topk_raw(q, packed, d=d, k=k, mask=words)
        assert ft.last_kernel.split("+")[0] == "exact_mma_kernel<bin><mask>"
        s_p, i_p = ft.binary_exact_topk_raw(q.cpu(), packed.cpu(), d=d, k=k,
                                            mask=words.cpu())
        s_p, i_p = s_p.to(cuda), i_p.to(cuda)
    assert ft.launches["masked"] == 1
    _assert_masked_match(m, s_k, i_k, s_p, i_p, 0.99)


def test_filtered_retriever_runs_the_masked_kernels(cuda):
    """A filtered search through ``xla`` on the card launches the masked
    kernels and returns the xla_exact oracle's filtered docs;
    ``pallas_exact`` refuses a filter; the exact select past 2048 refuses
    a mask; CPU tensors never launch."""
    from latentrag_torch.retrieval import DenseRetriever

    gen = torch.Generator().manual_seed(4)
    emb = torch.randn((5000, 64), generator=gen).numpy()
    ids = list(range(5000))
    md = [{"part": i % 10} for i in ids]
    spec = {"where": {"part": [1, 2]}}
    q = emb[:50] + 0.01
    out = {}
    for backend in ("xla", "xla_exact"):
        r = DenseRetriever(backend=backend, store_dtype="float32",
                           device="cuda")
        r.build(emb, [str(i) for i in ids], metadata=md)
        ft.reset_launches()
        for k in (10, 150):
            out[(backend, k)] = r.search(q, k, filter=spec)
        if backend == "xla":
            assert ft.launches["masked"] == 2
            assert ft.launches["fold"] == 1 and ft.launches["exact"] == 1
    for k in (10, 150):
        s_a, i_a = out[("xla", k)]
        s_o, i_o = out[("xla_exact", k)]
        assert (i_a == i_o).mean() >= 0.99
        assert all(i % 10 in (1, 2) for i in i_a.ravel())
    p = DenseRetriever(backend="pallas_exact", store_dtype="float32",
                       device="cuda")
    p.build(emb, [str(i) for i in ids], metadata=md)
    with pytest.raises(ValueError, match="filtered search"):
        p.search(q, 5, filter=spec)
    m, words = _row_mask(cuda, 5000, 0.5, 10)
    qc = torch.from_numpy(q).cuda()
    with pytest.raises(ValueError, match="no row mask"):
        ft.fused_topk_raw(qc, torch.from_numpy(emb).cuda(), k=3000,
                          mode="exact", mask=words)
    ft.reset_launches()
    ft.fused_topk(torch.from_numpy(q), torch.from_numpy(emb), k=10,
                  mode="fold", mask=words.cpu())
    ft.binary_exact_topk_raw(torch.from_numpy(q),
                             tb.binary_quantize(torch.from_numpy(emb)), d=64,
                             k=150, mask=words.cpu())
    assert ft.launches == dict.fromkeys(ft.launches, 0)


def test_http_serve_on_card(cuda, tmp_path):
    """The port's server on ``--device cuda`` over HTTP with a micro-batch
    window: one fold launch per coalesced search, no exact launch, and
    served ids equal to one direct call's on the same retriever."""
    import json
    import logging
    import threading
    import urllib.request
    from types import SimpleNamespace

    from latentrag_torch import serve
    from latentrag_torch.models import VariationalAutoencoder
    from latentrag_torch.utils import apply_overrides, load_config

    base = str(tmp_path)
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg = apply_overrides(load_config(None), [
        "data.dataset=synthetic", "data.max_samples=60",
        "encoder.vocab_size=800", "encoder.hidden_dim=32",
        "encoder.num_layers=1", "encoder.num_heads=4", "encoder.mlp_dim=64",
        # fp32 encodes: a batch's length bucket must not move a query
        "encoder.dtype=float32",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={base}/vae.pth",
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"retrieval.index_path={base}/index", "logging.log_to_file=false",
    ])
    loggers = SimpleNamespace(main=logging.getLogger("latentrag_torch.main"))
    args = SimpleNamespace(ae_type="vae", generate=False, cold_boot=False,
                           device="cuda", batch_window_ms=30.0,
                           max_batch=64, http=0)
    runner, compressor, retriever, mode = serve.boot(cfg, args, loggers)
    sizes = []
    orig = retriever.search

    def spy(q_emb, k, **kw):
        sizes.append(int(q_emb.shape[0]))
        return orig(q_emb, k, **kw)

    retriever.search = spy
    handle = serve.make_handle(cfg, args, runner, compressor, retriever,
                               mode)
    queries = [f"experiment {i} findings" for i in range(12)]
    out = [None] * len(queries)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/search",
            data=json.dumps({"query": queries[i], "k": 5}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out[i] = json.loads(r.read())

    with serve.running_http(handle, retriever, mode, "127.0.0.1", 0,
                            loggers) as server:
        port = server.server_address[1]
        post(0)
        sizes.clear()
        ft.reset_launches()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert ft.launches["fold"] == len(sizes) and ft.launches["exact"] == 0
        assert len(sizes) < len(queries)
        assert all(s in (8, 16, 32, 64) for s in sizes), sizes
        _, idx = orig(compressor.encode_text(queries), 5)
        for i, o in enumerate(out):
            assert o["results"][0]["query"] == queries[i]
            got = [h["doc_id"] for h in o["results"][0]["hits"]]
            assert got == [retriever.doc_ids[j] for j in idx[i]]


# ------------------------------------------------------------ int8 and int4


def _quantized(cuda, store, nq, n, d, seed=3, dup_every=0):
    """Seeded unit rows quantized as the int8 / int4 stores hold them, the
    SQ8 query codes and the score factor. ``dup_every`` copies row 0 into
    every such row, so that scores tie across lanes and tiles."""
    from latentrag_torch.ops import quantization as tq

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device=cuda), dim=1)
    if dup_every:
        x[::dup_every] = x[0]
    q = torch.nn.functional.normalize(
        torch.randn((nq, d), generator=g, device=cuda), dim=1)
    qc, qs = tq.sq8_quantize(q)
    c, cs = (tq.sq8_quantize(x) if store == "int8" else tq.sq4_quantize(x))
    return qc, c, tq.score_factor(qs, cs), g


def _quantized_raw(store, qc, c, fac, d, **kw):
    if store == "int8":
        return ft.sq8_fused_topk_raw(qc, c, fac, **kw)
    return ft.sq4_fused_topk_raw(qc, c, fac, d=d, **kw)


def _quantized_kernel(store, mode, k):
    """The C kernel a quantized store's fold or exact search at k runs
    (the int4 fold: ``fold_i8_wgmma_kernel`` through ``lr_fold_i4``)."""
    if mode == "fold":
        return "fold_i8_wgmma_kernel" + ("" if store == "int8" else "<i4>")
    return ft.quantized_exact_kernel(
        ft._OP_I8 if store == "int8" else ft._OP_I4, k)


@pytest.mark.parametrize("nq", [100, 1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [64, 33, 48, 384])
@pytest.mark.parametrize("k", [10, 40, 128, 160, 2048])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_quantized_kernels_match_plain(cuda, store, k, d, masked, nq):
    """The int8 and int4 fold (k <= 128, at ``fold_plan``'s tile) and exact
    (k = 160, 2048: ``exact_i8_wgmma_kernel`` at 160,
    ``exact_i8_select_kernel`` at 2048) kernels, and their row-mask instances
    (10 % allowed), against their plain versions on the same codes: scores
    are exact
    integer dots times one factor, so the exact kernel equals its plain
    version bit for bit (ids and scores, ties to the lower row), and so
    do the int8 and int4 folds (``fold_i8_wgmma_kernel``, int4 through
    ``lr_fold_i4``: its order is total). d = 33 takes the element-wise
    loads (and int4's pad nibble; the int8 fold's producer-warp copies,
    the int4 producer's byte loads), d = 48 the int8 fold's TMA with a k
    step past d (int4: 24-byte rows, byte loads), d = 384 three stages a
    sub-tile (and its __int2float_rn path; int4: the producer's query
    chunks);
    N = 5003 leaves a ragged tile, 100 queries a ragged query tile and one
    query (a served search, the self-check) 63 of the 64 tile rows
    padding."""
    from latentrag_torch.ops.topk import pack_row_mask

    qc, c, fac, g = _quantized(cuda, store, nq, 5003, d)
    mask = (pack_row_mask(torch.rand(5003, generator=g, device=cuda) < 0.1)
            if masked else None)
    mode = "fold" if k <= 128 else "exact"
    block_n = ft.fold_plan(5003, k, 0.99)[0] if mode == "fold" else 4096
    ft.reset_launches()
    s_k, i_k = _quantized_raw(store, qc, c, fac, d, k=k, mode=mode,
                              block_n=block_n, mask=mask)
    assert ft.last_kernel.split("+")[0] == (
        _quantized_kernel(store, mode, k) + ("<mask>" if masked else ""))
    assert ft.launches[f"{store}_{mode}"] == 1
    assert ft.launches["masked"] == int(masked)
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=d, k=k, op=op, mode=mode, block_n=block_n, mask=mask)
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    if masked:  # only allowed rows; empty slots (NEG_INF, -1)
        from latentrag_torch.ops.topk import unpack_row_mask

        allowed = unpack_row_mask(mask, 5003)
        live = i_k >= 0
        assert bool(allowed[i_k[live].long()].all())


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_quantized_kernels_ties_and_unaligned(cuda, store):
    """Every 7th row a copy of row 0 (ties across lanes and tiles) and a
    corpus whose base is not 16-byte aligned (the element-wise loads; the
    int8 fold's producer-warp copies in place of TMA; the int4 producer's
    byte loads): the exact kernel still equals its plain version bit for
    bit, ties to the lower row, and so do the int8 and int4 folds at k =
    10, 40 and 128 (ties to the higher column of a lane, then the earlier
    tile)."""
    qc, c, fac, _ = _quantized(cuda, store, 64, 3001, 64, dup_every=7)
    buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)
    c = buf[1:].view(c.shape).copy_(c)
    assert c.data_ptr() % 16 != 0
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    s_k, i_k = _quantized_raw(store, qc, c, fac, 64, k=300, mode="exact")
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=64, k=300, op=op, mode="exact")
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    for k, block_n in ((10, 128), (40, 1024), (128, 4096)):
        ft.reset_launches()
        s_k, i_k = _quantized_raw(store, qc, c, fac, 64, k=k, mode="fold",
                                  block_n=block_n)
        assert ft.last_kernel.split("+")[0] == _quantized_kernel(
            store, "fold", k)
        assert ft.launches[f"{store}_fold"] == 1
        s_p, i_p = ft.quantized_fused_topk_raw_reference(
            qc, c, fac, d=64, k=k, op=op, mode="fold", block_n=block_n)
        assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)


def _allowed_mask(cuda, n, allowed, seed):
    """The packed row mask of ``allowed``: a share of the N rows chosen
    at random, or "few": 5 rows, fewer than any k the tests ask for."""
    from latentrag_torch.ops.topk import pack_row_mask

    g = torch.Generator(device=cuda).manual_seed(seed)
    if allowed == "few":
        keep = torch.zeros(n, dtype=torch.bool, device=cuda)
        keep[torch.randperm(n, generator=g, device=cuda)[:5]] = True
    else:
        keep = torch.rand(n, generator=g, device=cuda) < allowed
    return pack_row_mask(keep)


def _assert_int8_fold_bit_for_bit(qc, c, fac, k, block_n, mask=None):
    d = c.shape[1]
    ft.reset_launches()
    s_k, i_k = ft.sq8_fused_topk_raw(qc, c, fac, k=k, mode="fold",
                                     block_n=block_n, mask=mask)
    torch.cuda.synchronize()
    assert ft.last_kernel.split("+")[0] == (
        "fold_i8_wgmma_kernel" + ("<mask>" if mask is not None else ""))
    assert ft.launches["int8_fold"] == 1
    assert ft.launches["masked"] == int(mask is not None)
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=d, k=k, op=ft._OP_I8, mode="fold", block_n=block_n,
        mask=mask)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k, s_p)
    return s_k, i_k


@pytest.mark.parametrize("k", [10, 40, 128])
@pytest.mark.parametrize("d", [48, 64, 128, 256, 384])
@pytest.mark.parametrize("n", [315, 1997, 5003, 12289])
@pytest.mark.parametrize("nq", [1, 8, 37, 64, 2000])
def test_int8_fold_matches_plain_bit_for_bit(cuda, nq, n, d, k):
    """``fold_i8_wgmma_kernel`` at ``fold_plan``'s tile against the plain
    fold on the same codes: ids equal, scores equal, at every batch the
    store brings (1: a served query or the self-check; 8-64: coalesced
    batches; 2000: the main path), the main path's corpora (315, 1997),
    N = 5003 and 12289 (ragged last sub-tile and tile; 12289 leaves one
    row in the last tile), d = 48 (a k step past d), 64, 128 and 256 (the
    WIDE instance with the exact conversion and the skip test; 256 is the
    widest d they take) and 384 (three stages a sub-tile,
    ``__int2float_rn``), every list width."""
    qc, c, fac, _ = _quantized(cuda, "int8", nq, n, d, seed=nq + n + d + k)
    block_n = ft.fold_plan(n, k, 0.95)[0]
    _assert_int8_fold_bit_for_bit(qc, c, fac, k, block_n)


@pytest.mark.parametrize("allowed", [0.01, 0.1, 1.0, "few"])
@pytest.mark.parametrize("k", [10, 40, 128])
@pytest.mark.parametrize("d", [48, 64, 128, 256, 384])
@pytest.mark.parametrize("nq", [37, 2000])
def test_int8_fold_masked_matches_plain(cuda, nq, d, k, allowed):
    """The row-mask instance against the masked plain fold, bit for bit:
    1 %, 10 % and all rows allowed, and 5 rows (fewer than k), whose empty
    slots must be (NEG_INF, -1); every returned row is allowed."""
    from latentrag_torch.ops.topk import NEG_INF, unpack_row_mask

    n = 5003
    qc, c, fac, _ = _quantized(cuda, "int8", nq, n, d, seed=7 + d + k)
    mask = _allowed_mask(cuda, n, allowed, seed=d + k)
    block_n = ft.fold_plan(n, k, 0.95)[0]
    s_k, i_k = _assert_int8_fold_bit_for_bit(qc, c, fac, k, block_n, mask)
    live = i_k >= 0
    assert bool(unpack_row_mask(mask, n)[i_k[live].long()].all())
    assert bool((s_k[~live] == NEG_INF).all())
    if allowed == "few":
        assert int(live.sum(1).max()) == 5 and bool((~live).any())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [40, 128])
@pytest.mark.parametrize("d", [512, 768, 1000, 1536])
@pytest.mark.parametrize("nq", [37, 2000])
def test_int8_fold_wide_dims(cuda, nq, d, k, masked):
    """Encoder widths past the query tile's old room, where the ring
    streams the queries' dim chunks with the corpus's: 512 and 768 (a
    768-d encoder's store with ``ae_type none``), 1000 (rows that are not
    whole 16-byte chunks: the producer's loads) and 1536, at k = 40 and
    128, unmasked and with 10 % of the rows allowed, bit for bit."""
    n = 5003
    qc, c, fac, _ = _quantized(cuda, "int8", nq, n, d, seed=d + k + nq)
    mask = _allowed_mask(cuda, n, 0.1, seed=d + k) if masked else None
    block_n = ft.fold_plan(n, k, 0.95)[0]
    _assert_int8_fold_bit_for_bit(qc, c, fac, k, block_n, mask)


@pytest.mark.parametrize("d", [256, 257])
def test_int8_fold_extreme_codes(cuda, d):
    """Codes of -128 and 127, where the dot meets its bound: at d = 256 a
    row of -128 against a query of -128 has the dot 2^22, the largest the
    exact conversion takes; at d = 257 the kernel converts by
    ``__int2float_rn``. Bit for bit at k = 10 and 128."""
    g = torch.Generator(device=cuda).manual_seed(d)
    n = 3001
    qc = torch.randint(-128, 128, (16, d), generator=g, device=cuda,
                       dtype=torch.int8)
    c = torch.randint(-128, 128, (n, d), generator=g, device=cuda,
                      dtype=torch.int8)
    qc[0] = -128
    c[::97] = -128
    c[5::89] = 127
    c[7::101] = qc[1]
    fac = torch.tensor([3e-7], dtype=torch.float32, device=cuda)
    assert int((qc[0].int() * c[0].int()).sum()) == d * 128 * 128
    for k in (10, 128):
        block_n = ft.fold_plan(n, k, 0.95)[0]
        _, i_k = _assert_int8_fold_bit_for_bit(qc, c, fac, k, block_n)
        assert int(i_k[0, 0]) % 97 == 0  # a row of -128 leads query 0


@pytest.mark.parametrize("d", [128, 768])
def test_int8_fold_wide_unaligned_queries(cuda, d):
    """The WIDE instance with query codes on a base that is not 16-byte
    aligned and an aligned corpus: both come by the producer's loads."""
    qc, c, fac, _ = _quantized(cuda, "int8", 100, 3001, d, seed=d)
    buf = torch.empty(qc.numel() + 1, dtype=qc.dtype, device=cuda)
    qc = buf[1:].view(qc.shape).copy_(qc)
    assert qc.data_ptr() % 16 != 0 and c.data_ptr() % 16 == 0
    _assert_int8_fold_bit_for_bit(qc, c, fac, 40, 1024)


@pytest.mark.parametrize("d", [64, 48])
def test_int8_fold_crafted_lane_ties(cuda, d):
    """Equal 19-bit keys in one lane: rows 128 apart in one 4096-row tile
    (one lane) hold codes whose scores share a key, the higher-scoring
    row at the lower column. The fold keeps the lane's higher column (the
    key's tie rule: column desc), as the plain fold does, and between
    tiles the earlier tile."""
    g = torch.Generator(device=cuda).manual_seed(21)
    n, nq, k = 3 * 4096, 4, 10
    c = torch.randint(-20, 21, (n, d), generator=g, device=cuda,
                      dtype=torch.int8)
    qc = torch.randint(-127, 128, (nq, d), generator=g, device=cuda,
                       dtype=torch.int8)
    fac = torch.tensor([1e-4], dtype=torch.float32, device=cuda)
    v = qc[0].clone()

    def keys_of(rows):  # the rows' scores against query 0 and their keys
        dots = (qc[0].int() * rows.int()).sum(1).float() * fac
        return dots, ft._monotone_i32(dots) & ~ft._IDX_MASK

    # w: v with one code moved one step toward 0, a dot |v_j| lower; the
    # first such j (smallest |v_j| first) whose score keeps v's key
    for j in torch.argsort(v.abs().int()).tolist():
        if int(v[j]) == 0:
            continue
        w = v.clone()
        w[j] = v[j] - (1 if v[j] > 0 else -1)
        dots, keys = keys_of(torch.stack([v, w]))
        if int(keys[0]) == int(keys[1]) and dots[0] > dots[1]:
            break
    else:
        pytest.fail("no code step keeps the key")
    lane = 77
    c[lane + 128 * 3] = v          # tile 0: the best score, lower column
    c[lane + 128 * 9] = w          # tile 0: one key, higher column
    c[4096 + lane + 128 * 2] = w   # tile 1: the same key again
    s_k, i_k = _assert_int8_fold_bit_for_bit(qc, c, fac, k, 4096)
    # the lane's winner is the higher column; the next tile's copy comes
    # after it in the list
    assert int(i_k[0, 0]) == lane + 128 * 9
    assert int(i_k[0, 1]) == 4096 + lane + 128 * 2


def _assert_int4_fold_bit_for_bit(qc, packed, fac, d, k, block_n, mask=None):
    """The int4 fold on the card (``fold_i8_wgmma_kernel`` through
    ``lr_fold_i4``) against its plain version: the C kernel's name, one
    ``int4_fold`` launch, ids and scores equal."""
    ft.reset_launches()
    s_k, i_k = ft.sq4_fused_topk_raw(qc, packed, fac, d=d, k=k, mode="fold",
                                     block_n=block_n, mask=mask)
    torch.cuda.synchronize()
    assert ft.last_kernel.split("+")[0] == (
        "fold_i8_wgmma_kernel<i4>" + ("<mask>" if mask is not None else ""))
    assert ft.launches["int4_fold"] == 1 and ft.launches["int8_fold"] == 0
    assert ft.launches["masked"] == int(mask is not None)
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, packed, fac, d=d, k=k, op=ft._OP_I4, mode="fold",
        block_n=block_n, mask=mask)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k, s_p)
    return s_k, i_k


@pytest.mark.parametrize("k", [10, 40, 128])
@pytest.mark.parametrize("d", [33, 48, 64, 128, 384])
@pytest.mark.parametrize("n", [315, 1997, 12289])
@pytest.mark.parametrize("nq", [1, 8, 64, 2000])
def test_int4_fold_matches_plain_bit_for_bit(cuda, nq, n, d, k):
    """The int4 fold at ``fold_plan``'s tile against the plain fold on the
    same nibbles, ids and scores: the batches the store brings (1, 8, 64,
    2000), the main path's corpora and 12289 rows (one row in the last
    tile), d = 33 (a pad nibble; 17-byte rows: the producer's byte loads),
    48 (24-byte rows), 64 (16-byte loads, TMA query tile), 128 and 384
    (the WIDE instance: the producer unpacks 128-dim chunks and loads the
    queries' chunks), every list width."""
    qc, c, fac, _ = _quantized(cuda, "int4", nq, n, d, seed=nq + n + d + k)
    block_n = ft.fold_plan(n, k, 0.95)[0]
    _assert_int4_fold_bit_for_bit(qc, c, fac, d, k, block_n)


@pytest.mark.parametrize("allowed", [0.01, 0.1, "few"])
@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("d", [33, 64, 384])
@pytest.mark.parametrize("nq", [37, 2000])
def test_int4_fold_masked_matches_plain(cuda, nq, d, k, allowed):
    """The int4 fold's row-mask instance against the masked plain fold,
    bit for bit; empty slots (NEG_INF, -1), every returned row allowed."""
    from latentrag_torch.ops.topk import NEG_INF, unpack_row_mask

    n = 5003
    qc, c, fac, _ = _quantized(cuda, "int4", nq, n, d, seed=11 + d + k)
    mask = _allowed_mask(cuda, n, allowed, seed=d + k)
    block_n = ft.fold_plan(n, k, 0.95)[0]
    s_k, i_k = _assert_int4_fold_bit_for_bit(qc, c, fac, d, k, block_n,
                                             mask)
    live = i_k >= 0
    assert bool(unpack_row_mask(mask, n)[i_k[live].long()].all())
    assert bool((s_k[~live] == NEG_INF).all())
    if allowed == "few":
        assert int(live.sum(1).max()) == 5 and bool((~live).any())


@pytest.mark.parametrize("d", [63, 256, 257, 768])
def test_int4_fold_extreme_codes(cuda, d):
    """Nibbles of -8 and 7 (bytes 0x88, 0x77) against query codes of -128
    and 127, the dot at its bound d x 128 x 8; random bytes elsewhere, so
    that every nibble value meets the sign extension. At d = 63 the last
    byte's high nibble is a pad the query's zero codes past d must cancel
    (it is set to -8 here, not to the store's 0); 257 and 768 take the
    WIDE instance (768 with ``__int2float_rn``). Bit for bit at k = 10 and
    128, on an aligned base and on one that is not."""
    g = torch.Generator(device=cuda).manual_seed(d)
    n, w = 3001, (d + 1) // 2
    qc = torch.randint(-128, 128, (16, d), generator=g, device=cuda,
                       dtype=torch.int8)
    c = torch.randint(0, 256, (n, w), generator=g, device=cuda,
                      dtype=torch.int32).to(torch.uint8)
    qc[0] = -128
    c[::97] = 0x88
    c[5::89] = 0x77
    fac = torch.tensor([3e-7], dtype=torch.float32, device=cuda)
    from latentrag_torch.ops.quantization import sq4_unpack

    assert int((qc[0].int() * sq4_unpack(c[:1], d).int()).sum()) \
        == d * 128 * 8
    buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)
    shifted = buf[1:].view(c.shape).copy_(c)
    for packed in (c, shifted):
        for k in (10, 128):
            block_n = ft.fold_plan(n, k, 0.95)[0]
            _, i_k = _assert_int4_fold_bit_for_bit(qc, packed, fac, d, k,
                                                   block_n)
            assert int(i_k[0, 0]) % 97 == 0  # a row of -8 leads query 0


def test_int4_fold_instances_have_no_stack(cuda):
    """Every instance the int4 fold launches (``fold_i8_wgmma_kernel<E,
    MASK, WIDE>``, E 1, 2, 4, both libraries) keeps 0 stack bytes by
    ``cuobjdump -res-usage``: no spill in the producer's unpack at its 40
    registers, nor in the consumers."""
    import os
    import re
    import subprocess

    from latentrag_torch.ops import cuda_build

    ft._libraries()  # built
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for masked, spec in enumerate(ft.LIBRARIES):
        out = subprocess.run(
            [tool, "-res-usage", cuda_build.library_path(*spec)],
            capture_output=True, text=True, timeout=120).stdout
        for e in (1, 2, 4):
            for wide in (0, 1):
                name = f"fold_i8_wgmma_kernelILi{e}ELb{masked}ELb{wide}E"
                m = re.search(re.escape(name) + r"\S*:\s*\n\s*REG:(\d+) "
                              r"STACK:(\d+)", out)
                assert m, name
                assert int(m.group(2)) == 0, (name, m.group(0))


def _assert_int8_exact_bit_for_bit(qc, c, fac, k, mask=None, store="int8",
                                   d=None):
    """The int8 (or, ``store="int4"``, the int4: ``c`` the packed nibbles
    of ``d`` dims) exact search at k on the card against its plain
    version: the C kernel its k routes to (up to 256
    ``exact_i8_wgmma_kernel``, the int4 store's through ``lr_exact_i4``,
    named ``exact_i8_wgmma_kernel<i4>``; past it
    ``exact_i8_select_kernel`` / ``<i4>``), one ``int8_exact`` /
    ``int4_exact`` launch, the launches that read a mask (a filtered
    select's sample search reads it too), ids and scores equal."""
    d = c.shape[1] if store == "int8" else d
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    ft.reset_launches()
    s_k, i_k = _quantized_raw(store, qc, c, fac, d, k=k, mode="exact",
                              mask=mask)
    torch.cuda.synchronize()
    want = _quantized_kernel(store, "exact", min(k, c.shape[0]))
    assert ft.last_kernel.split("+")[0] == (
        want + ("<mask>" if mask is not None else ""))
    assert ft.launches[f"{store}_exact"] == 1
    assert ft.launches["int8_exact" if store == "int4" else "int4_exact"] \
        == 0
    sampled = "+exact_i8_wgmma_kernel" in ft.last_kernel
    assert ft.launches["masked"] == (0 if mask is None else 1 + sampled)
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=d, k=k, op=op, mode="exact", mask=mask)
    assert torch.equal(i_k, i_p)
    assert torch.equal(s_k, s_p)
    return s_k, i_k


# (store, nq, d, k): the int8 store's grid, then the int4 store's, whose
# odd widths make packed rows that are not whole 16-byte pieces (d = 33,
# 63, 65: the producer's byte loads; 63 a pad nibble) and whose k are
# past the fold's 128 candidates, where its store takes the exact search
_EXACT_CASES = (
    [("int8", nq, d, k) for nq in (1, 63, 65, 2000)
     for d in (33, 48, 64, 128, 384) for k in (1, 10, 128, 129, 160, 256)]
    + [("int4", nq, d, k) for nq in (1, 8, 64, 2000)
       for d in (33, 63, 64, 65, 384) for k in (10, 129, 160, 256)])


@pytest.mark.parametrize("store,nq,d,k", _EXACT_CASES)
def test_int8_exact_matches_plain_bit_for_bit(cuda, store, nq, d, k):
    """``exact_i8_wgmma_kernel`` against the plain exact search on the
    same codes, ids and scores, over the int8 store's codes and (through
    ``lr_exact_i4``) the int4 store's nibbles: one query (a served search;
    63 of the 64 tile rows padding), 8, 63, 64 and 65 (a ragged query
    tile), 2000 (the main path); d = 33 (rows that are not whole 16-byte
    chunks: the producer's loads), 48 (a k step past d), 63 and 65 (int4:
    a pad nibble, byte loads, and 65 the WIDE instance's ragged chunk), 64,
    128 and 384 (the WIDE instance, one and three stages a sub-tile); k
    from 1 to 256, both list widths (128 and 256 slots) and either side of
    128; N = 5003 leaves a ragged sub-tile."""
    qc, c, fac, _ = _quantized(cuda, store, nq, 5003, d,
                               seed=nq + d + k + (store == "int4"))
    _assert_int8_exact_bit_for_bit(qc, c, fac, k, store=store, d=d)


@pytest.mark.parametrize("k", [10, 160, 256])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_int8_exact_long_slabs(cuda, store, k):
    """The 8.8M-row store's slabs, cut to 1M rows: 1024 queries (16 query
    tiles) leave slabs of tens of thousands of rows, where the lists fill,
    the skip test drops almost every half and the slabs' lists merge;
    both stores."""
    qc, c, fac, _ = _quantized(cuda, store, 1024, 1_000_003, 64, seed=k)
    _assert_int8_exact_bit_for_bit(qc, c, fac, k, store=store, d=64)
    assert "+exact_merge_kernel" in ft.last_kernel


# (store, nq, d, k, allowed): the int8 store's grid, then the int4
# store's at k past the fold's candidates, 1 % allowed too
_EXACT_MASKED_CASES = (
    [("int8", nq, d, k, a) for nq in (1, 65, 2000) for d in (64, 128)
     for k in (10, 160, 256) for a in (0.0, 0.1, 1.0, "few")]
    + [("int4", nq, d, k, a) for nq in (1, 65, 2000) for d in (63, 64, 384)
       for k in (129, 160, 256) for a in (0.0, 0.01, 0.1, 1.0, "few")])


@pytest.mark.parametrize("store,nq,d,k,allowed", _EXACT_MASKED_CASES)
def test_int8_exact_masked_matches_plain(cuda, store, nq, d, k, allowed):
    """The row-mask instance against the masked plain search, bit for bit,
    both stores: no row, 1 % (int4), 10 % and every row allowed, and 5
    rows (fewer than k), whose empty slots must be (NEG_INF, -1); every
    returned row is allowed."""
    from latentrag_torch.ops.topk import NEG_INF, unpack_row_mask

    n = 5003
    qc, c, fac, _ = _quantized(cuda, store, nq, n, d, seed=11 + d + k)
    mask = _allowed_mask(cuda, n, allowed, seed=d + k)
    s_k, i_k = _assert_int8_exact_bit_for_bit(qc, c, fac, k, mask,
                                              store=store, d=d)
    live = i_k >= 0
    assert bool(unpack_row_mask(mask, n)[i_k[live].long()].all())
    assert bool((s_k[~live] == NEG_INF).all())
    if allowed == "few":
        assert int(live.sum(1).max()) == 5 and bool((~live).any())
    if allowed == 0.0:
        assert not bool(live.any())


@pytest.mark.parametrize("k", [10, 160, 256])
@pytest.mark.parametrize("store,d", [("int8", 256), ("int4", 63),
                                     ("int4", 256), ("int4", 257),
                                     ("int4", 768)])
def test_int8_exact_extreme_codes(cuda, store, d, k):
    """Codes at their bounds and a small factor: int8, -128 and 127 at d =
    256, where a row of -128 against a query of -128 has the dot 2^22;
    int4, nibbles of -8 and 7 (bytes 0x88, 0x77) against query codes of
    -128 and 127, the dot at d x 128 x 8, random bytes elsewhere so that
    every nibble value meets the sign extension (d = 63: the last byte's
    high nibble a pad of -8 that the query's zero codes past d must
    cancel; 257 and 768 the WIDE instance), on an aligned base and on one
    that is not. Bit for bit, a row of -128 (-8) first for query 0."""
    g = torch.Generator(device=cuda).manual_seed(k + d)
    n = 3001
    qc = torch.randint(-128, 128, (16, d), generator=g, device=cuda,
                       dtype=torch.int8)
    qc[0] = -128
    fac = torch.tensor([3e-7], dtype=torch.float32, device=cuda)
    if store == "int8":
        c = torch.randint(-128, 128, (n, d), generator=g, device=cuda,
                          dtype=torch.int8)
        c[::97] = -128
        c[5::89] = 127
        assert int((qc[0].int() * c[0].int()).sum()) == 1 << 22
        _, i_k = _assert_int8_exact_bit_for_bit(qc, c, fac, k)
        assert int(i_k[0, 0]) == 0  # the first row of -128 leads query 0
        return
    from latentrag_torch.ops.quantization import sq4_unpack

    c = torch.randint(0, 256, (n, (d + 1) // 2), generator=g, device=cuda,
                      dtype=torch.int32).to(torch.uint8)
    c[::97] = 0x88
    c[5::89] = 0x77
    assert int((qc[0].int() * sq4_unpack(c[:1], d).int()).sum()) \
        == d * 128 * 8
    buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)
    shifted = buf[1:].view(c.shape).copy_(c)
    for packed in (c, shifted):
        _, i_k = _assert_int8_exact_bit_for_bit(qc, packed, fac, k,
                                                store=store, d=d)
        assert int(i_k[0, 0]) == 0  # the first row of -8 leads query 0


@pytest.mark.parametrize("k", [10, 160, 256])
@pytest.mark.parametrize("dup_every", [7, 1])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_int8_exact_ties_to_the_lower_row(cuda, store, dup_every, k):
    """Every 7th row a copy of row 0, or every row the same: equal scores
    across halves, sub-tiles and slabs go to the lower row, bit for bit,
    and with one vector everywhere the answer is rows 0 .. k - 1; both
    stores."""
    qc, c, fac, _ = _quantized(cuda, store, 65, 20000, 64,
                               dup_every=dup_every)
    _, i_k = _assert_int8_exact_bit_for_bit(qc, c, fac, k, store=store,
                                            d=64)
    if dup_every == 1:
        want = torch.arange(k, dtype=torch.int32, device=cuda)
        assert torch.equal(i_k, want.expand_as(i_k))


@pytest.mark.parametrize("store,d", [("int8", 64), ("int4", 64),
                                     ("int4", 128)])
def test_int8_exact_unaligned(cuda, store, d):
    """Codes on a base that is not 16-byte aligned (the producer's loads in
    place of TMA or of 16-byte loads), corpus and queries: bit for bit at
    k = 160; int4 also at d = 128 (the WIDE instance's query chunks)."""
    qc, c, fac, _ = _quantized(cuda, store, 100, 3001, d, seed=5)
    for t in ("corpus", "queries"):
        src = c if t == "corpus" else qc
        buf = torch.empty(src.numel() + 1, dtype=src.dtype, device=cuda)
        moved = buf[1:].view(src.shape).copy_(src)
        assert moved.data_ptr() % 16 != 0
        if t == "corpus":
            _assert_int8_exact_bit_for_bit(qc, moved, fac, 160, store=store,
                                           d=d)
        else:
            _assert_int8_exact_bit_for_bit(moved, c, fac, 160, store=store,
                                           d=d)


# (store, nq, n, d, k): past k = 256 both stores' exact search is
# exact_i8_select_kernel: N = 5003 <= C its "all" route, N = 20011 (ragged)
# the sampled route; one query, a ragged query tile, 2000 (the main
# path's); d = 33 / 48 / 63 (int4: byte loads, a pad nibble), 64, 384
# (WIDE, three stages a sub-tile)
_SELECT_CASES = (
    [(store, nq, n, 64, k) for store in ("int8", "int4")
     for nq in (1, 65, 2000) for n in (5003, 20011)
     for k in (257, 320, 512, 1000, 2048)]
    + [("int8", 65, 20011, d, k) for d in (33, 48, 384) for k in (320, 2048)]
    + [("int4", 65, 20011, d, k) for d in (33, 48, 63, 384)
       for k in (320, 2048)])


@pytest.mark.parametrize("store,nq,n,d,k", _SELECT_CASES)
def test_int8_exact_select_matches_plain_bit_for_bit(cuda, store, nq, n, d,
                                                      k):
    """``exact_i8_select_kernel`` (k = 257-2048) against the plain exact
    search, ids and scores, over the int8 codes and (its producer
    warpgroup's unpack) the int4 nibbles: the route its plan picks
    (``ft.last_select``; the sample's search ``exact_i8_wgmma_kernel`` on
    the sampled route), no query falling back on rows in random order, and
    the same bits from the radix route forced for every query."""
    qc, c, fac, _ = _quantized(cuda, store, nq, n, d, seed=nq + n + d + k)
    s_k, i_k = _assert_int8_exact_bit_for_bit(qc, c, fac, k, store=store,
                                              d=d)
    route = "all" if n <= 8192 else "sampled"
    assert ft.last_select["route"] == route
    assert ft.last_kernel.endswith("+exact_i8_wgmma_kernel"
                                   + ("<i4>" if store == "int4" else "")) \
        == (route == "sampled")
    assert ft.select_fallbacks() == 0
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    s_r, i_r = ft._exact_i8_select(qc, c, fac.reshape(1), d=d, k_eff=k,
                                   op=op, route="radix")
    assert ft.select_fallbacks() is None
    assert torch.equal(s_r, s_k) and torch.equal(i_r, i_k)


# (store, d, n, k, allowed): 10 % of 100k rows, of 20k (2000 allowed:
# fewer than m in the sample, so every allowed row is buffered), every row,
# 5 rows (fewer than k) and none; every case on the sampled route
_SELECT_MASKED_CASES = (
    [(store, d, n, k, a) for store, d in (("int8", 64), ("int4", 63))
     for n, a in ((100_000, 0.1), (20_011, 0.1), (20_011, 1.0),
                  (20_011, "few"), (20_011, 0.0))
     for k in (320, 2048)]
    + [("int8", 384, 100_000, 512, 0.1), ("int4", 384, 100_000, 512, 0.1)])


@pytest.mark.parametrize("store,d,n,k,allowed", _SELECT_MASKED_CASES)
def test_int8_exact_select_masked_matches_plain(cuda, store, d, n, k,
                                                allowed):
    """The select's row-mask instances against the masked plain search,
    bit for bit: the plan is the shapes', the sample's search reads the
    mask (its own row-mask instance), and a filter that allows fewer rows
    than k leaves the rest of the slots (NEG_INF, -1) without a fallback
    (the allowed rows counted on the card)."""
    from latentrag_torch.ops.topk import NEG_INF, unpack_row_mask

    qc, c, fac, _ = _quantized(cuda, store, 65, n, d, seed=n + k + d)
    mask = _allowed_mask(cuda, n, allowed, seed=k + d)
    s_k, i_k = _assert_int8_exact_bit_for_bit(qc, c, fac, k, mask,
                                              store=store, d=d)
    live = i_k >= 0
    n_allowed = int(unpack_row_mask(mask, n).sum())
    assert bool(unpack_row_mask(mask, n)[i_k[live].long()].all())
    assert bool((s_k[~live] == NEG_INF).all())
    assert int(live.sum(1).max()) == min(k, n_allowed)
    assert ft.last_select["route"] == "sampled"
    assert ft.last_kernel.endswith(
        "+exact_i8_wgmma_kernel" + ("<i4>" if store == "int4" else "")
        + "<mask>")
    assert ft.select_fallbacks() == 0


@pytest.mark.parametrize("store,d", [("int8", 64), ("int4", 64),
                                     ("int4", 128)])
def test_int8_exact_select_unaligned(cuda, store, d):
    """Codes on a base that is not 16-byte aligned, corpus and queries
    (the producer's loads in place of TMA or of 16-byte loads; int4 at d =
    128 the WIDE instance's query chunks): bit for bit at k = 320 on the
    sampled route."""
    qc, c, fac, _ = _quantized(cuda, store, 100, 20011, d, seed=7)
    for t in ("corpus", "queries"):
        src = c if t == "corpus" else qc
        buf = torch.empty(src.numel() + 1, dtype=src.dtype, device=cuda)
        moved = buf[1:].view(src.shape).copy_(src)
        assert moved.data_ptr() % 16 != 0
        if t == "corpus":
            _assert_int8_exact_bit_for_bit(qc, moved, fac, 320, store=store,
                                           d=d)
        else:
            _assert_int8_exact_bit_for_bit(moved, c, fac, 320, store=store,
                                           d=d)
        assert ft.last_select["route"] == "sampled"


def _crafted_select_case(cuda, kind, store, nq, n, k):
    """Codes whose sampled threshold fails (as
    ``tests/test_torch_exact_i8_select.py`` builds them on the CPU):
    "overshoot", every s-th row (the sample) lifted to the top code on dims
    0-7, which the even queries weigh by 127, so that only the sample
    reaches their threshold (m < k keys: they fall back); "ties", every row
    one of two vectors (a tie group past C holds every query's threshold).
    Returns (query codes, corpus codes or nibbles, factor, d, the queries
    built to fall back)."""
    g = torch.Generator(device=cuda).manual_seed(n + k)
    d = 32
    top = 127 if store == "int8" else 7
    qc = torch.randint(-100, 101, (nq, d), generator=g, device=cuda,
                       dtype=torch.int8)
    qc[:, :8] = torch.where(torch.arange(nq, device=cuda) % 2 == 0, 127,
                            0).to(torch.int8)[:, None]
    if kind == "overshoot":
        stride = ft.quantized_select_plan(nq, n, k)[1]
        codes = torch.randint(-top + 1, top, (n, d), generator=g,
                              device=cuda, dtype=torch.int8)
        codes[::stride, :8] = top
        want = torch.arange(nq, device=cuda) % 2 == 0
    else:
        pair = torch.randint(-top + 1, top, (2, d), generator=g, device=cuda,
                             dtype=torch.int8)
        codes = pair[torch.randint(0, 2, (n,), generator=g, device=cuda)]
        want = torch.ones(nq, dtype=torch.bool, device=cuda)
    if store == "int4":
        lo, hi = codes[:, 0::2].to(torch.int32), codes[:, 1::2].to(torch.int32)
        codes = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)
    fac = torch.tensor([1e-3], dtype=torch.float32, device=cuda)
    return qc, codes.contiguous(), fac, d, want


@pytest.mark.parametrize("k", [257, 512, 2048])
@pytest.mark.parametrize("kind", ["overshoot", "ties"])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_int8_exact_select_crafted_fallbacks(cuda, store, kind, k):
    """Corpora on which the sampled threshold fails (200k rows, 128
    queries: two query tiles, slabs of the radix passes): the device's
    fallback count equals the queries built to fall back and the plan's
    plain model's count, and the fallen queries' radix passes keep the
    answer the plain search's bit for bit."""
    n = 200_003
    qc, c, fac, d, want = _crafted_select_case(cuda, kind, store, 128, n, k)
    _assert_int8_exact_bit_for_bit(qc, c, fac, k, store=store, d=d)
    assert ft.last_select["route"] == "sampled"
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    fell = ft.quantized_select_reference(qc, c, fac, d=d, k=k, op=op)[2]
    assert torch.equal(fell, want)
    assert ft.select_fallbacks() == int(want.sum())


@pytest.mark.parametrize("op", [ft._OP_I8, ft._OP_I4])
def test_int8_exact_occupancy(cuda, op):
    """Blocks an SM as the kernels' headers state them at d = 64, for
    either store (the same blocks): ``exact_i8_wgmma_kernel`` two up to k =
    120, one from k = 121, at k = 128 and at k = 256; a WIDE block at k =
    256 still fits; ``exact_i8_select_kernel``'s buffer pass two at every
    k (d = 64 and 384), its histogram passes two at d = 64 and one WIDE;
    the old template's entry refuses both stores at every k."""
    lib = ft._library()
    assert lib.lr_exact_i8_occupancy(64, 10, op) == 2
    assert lib.lr_exact_i8_occupancy(64, 120, op) == 2
    assert lib.lr_exact_i8_occupancy(64, 121, op) == 1
    assert lib.lr_exact_i8_occupancy(64, 128, op) == 1
    assert lib.lr_exact_i8_occupancy(64, 256, op) == 1
    assert lib.lr_exact_i8_occupancy(384, 256, op) == 1
    assert lib.lr_exact_i8_occupancy(64, 257, op) < 0
    assert lib.lr_exact_i8_smem(64, 160, op) == lib.lr_exact_i8_smem(
        64, 160, ft._OP_I8)
    for k in (1, 128, 256, 257, 512, 1024, 2048):
        assert lib.lr_exact_mma_occupancy(64, k, op) == -1
    for masked in (False, True):
        sel = ft._library(masked)
        assert sel.lr_exact_i8_select_occupancy(64, op, 0) == 2
        assert sel.lr_exact_i8_select_occupancy(384, op, 0) == 2
        assert sel.lr_exact_i8_select_occupancy(64, op, 1) == 2
        assert sel.lr_exact_i8_select_occupancy(384, op, 1) == 1


def test_exact_i8_wgmma_instances_have_no_stack(cuda):
    """Every instance either store's exact search launches
    (``exact_i8_wgmma_kernel<KP, MASK, WIDE>``, KP 128 and 256, and
    ``exact_i8_select_kernel<HIST, MASK, WIDE>``, both libraries) keeps 0
    stack bytes by ``cuobjdump -res-usage``: no spill in the int4
    producer's unpack at its 40 registers, nor in the consumers; and no
    library holds ``exact_mma_kernel<KP, OP_I8 | OP_I4>`` at any KP any
    more."""
    import os
    import re
    import subprocess

    from latentrag_torch.ops import cuda_build

    ft._libraries()  # built
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for masked, spec in enumerate(ft.LIBRARIES):
        out = subprocess.run(
            [tool, "-res-usage", cuda_build.library_path(*spec)],
            capture_output=True, text=True, timeout=120).stdout
        for kp in (128, 256):
            for wide in (0, 1):
                name = (f"exact_i8_wgmma_kernelILi{kp}ELb{masked}"
                        f"ELb{wide}E")
                m = re.search(re.escape(name) + r"\S*:\s*\n\s*REG:(\d+) "
                              r"STACK:(\d+)", out)
                assert m, name
                assert int(m.group(2)) == 0, (name, m.group(0))
        for hist in (0, 1):
            for wide in (0, 1):
                name = (f"exact_i8_select_kernelILb{hist}ELb{masked}"
                        f"ELb{wide}E")
                m = re.search(re.escape(name) + r"\S*:\s*\n\s*REG:(\d+) "
                              r"STACK:(\d+)", out)
                assert m, name
                assert int(m.group(2)) == 0, (name, m.group(0))
        for kp in (128, 256, 512, 1024, 2048):
            for op in (3, 4):
                assert f"exact_mma_kernelILi{kp}ELi{op}E" not in out


@pytest.mark.parametrize("k", [10, 200, 2100])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_quantized_routes_on_card(cuda, store, k):
    """``approx_sq8_fused_topk`` / ``approx_sq4_fused_topk`` on the card:
    the fold (k=10), the exact kernel (k=200) and the blocked route
    (k=2100), each counted; every returned score is the exact score of
    its row; the exact routes return the plain exact search's scores, the
    fold finds >= 99 % of its rows (recall_target 0.99)."""
    from latentrag_torch.ops import quantization as tq

    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.nn.functional.normalize(
        torch.randn((20000, 64), generator=g, device=cuda), dim=1)
    q = torch.randn((50, 64), generator=g, device=cuda)
    ft.reset_launches()
    if store == "int8":
        c, cs = tq.sq8_quantize(x)
        s, i = ft.approx_sq8_fused_topk(q, c, float(cs), k=k)
        s0, i0 = tq.sq8_topk(q, c, float(cs), k)
        rows = c
    else:
        c, cs = tq.sq4_quantize(x)
        s, i = ft.approx_sq4_fused_topk(q, c, float(cs), d=64, k=k)
        s0, i0 = tq.sq4_topk(q, c, float(cs), 64, k)
        rows = tq.sq4_unpack(c, 64)
    route = "fold" if k <= 128 else "exact" if k <= 2048 else "blocked"
    assert ft.launches[f"{store}_{route}"] == 1
    qc, qs = tq.sq8_quantize(q)
    exact = tq.quantized_scores(qc, rows, tq.score_factor(qs, cs))
    assert torch.equal(torch.gather(exact, 1, i.long()), s)
    if route == "fold":
        found = [len(set(a) & set(b)) for a, b in zip(i.tolist(),
                                                      i0.tolist())]
        assert sum(found) >= 0.99 * i0.numel()
    else:
        assert torch.equal(s, s0)


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_quantized_store_on_card(cuda, store):
    """A ``DenseRetriever`` of each quantized store on the card: built,
    self-checked and searched through the int8 / int4 kernels, filtered
    through their masked instances, and answering as the same store on
    the CPU does (the JAX package's exact answer, by
    ``test_torch_int8_store``): >= 99 % of its ids in each row (the fold's
    recall_target 0.99), scores bit for bit at equal ids."""
    from latentrag_torch.retrieval import DenseRetriever

    rng = np.random.default_rng(4)
    emb = rng.standard_normal((6000, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    texts = [str(i) for i in range(6000)]
    meta = [{"s": i % 4} for i in range(6000)]
    q = rng.standard_normal((33, 64)).astype(np.float32)
    on = DenseRetriever(store_dtype=store, metric="dot", device="cuda")
    ft.reset_launches()
    on.build(emb.copy(), texts, metadata=meta)
    assert ft.launches[f"{store}_fold"] == 1  # the self-check
    cpu = DenseRetriever(store_dtype=store, metric="dot", device="cpu")
    cpu.build(emb.copy(), texts, metadata=meta)
    for k, spec in ((10, None), (20, None), (10, {"where": {"s": 1}})):
        ft.reset_launches()
        s_c, i_c = on.search(q, k, filter=spec)
        s_p, i_p = cpu.search(q, k, filter=spec)
        route = "exact" if store == "int4" and k == 20 else "fold"
        assert ft.launches[f"{store}_{route}"] == 1
        assert ft.launches["masked"] == int(spec is not None)
        found = sum(len(set(a) & set(b)) for a, b in zip(i_c.tolist(),
                                                          i_p.tolist()))
        assert found >= 0.99 * i_p.size
        same = i_c == i_p
        np.testing.assert_array_equal(s_c[same], s_p[same])


# ------------------------------------------------------ the device IVF


def _ivf_setup(cuda, kind, d, cap, n=6000, seed=11):
    """A clustered store of ``kind`` laid out in an IVF (nearest of 48
    centres), 300 rows appended at the tail; the scan's queries, factor
    and a probe set of 12 blocks plus a sentinel."""
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.ops import quantization as tq
    from latentrag_torch.ops.kmeans import assign_clusters

    g = torch.Generator(device=cuda).manual_seed(seed)
    cent = torch.nn.functional.normalize(
        torch.randn((48, d), generator=g, device=cuda), dim=1)

    def rows(m):
        which = torch.randint(0, 48, (m,), generator=g, device=cuda)
        return torch.nn.functional.normalize(
            cent[which] + 0.1 * torch.randn((m, d), generator=g,
                                            device=cuda), dim=1)

    x, extra = rows(n), rows(300)
    scale, dim = None, 0
    if kind == "int8":
        store, scale = tq.sq8_quantize(x)
        scale = float(scale)
        new = torch.clamp(torch.round(extra / scale), -127, 127).to(
            torch.int8)
    elif kind == "int4":
        store, scale = tq.sq4_quantize(x)
        scale, dim = float(scale), d
        new = tq.sq4_quantize_with_scale(extra, scale)
    elif kind == "binary":
        store, new, dim = tb.binary_quantize(x), tb.binary_quantize(extra), d
    else:
        store = x.to(getattr(torch, kind)).contiguous()
        new = extra.to(store.dtype)
    idx = tivf.ivf_build_from_assign(store, cent, assign_clusters(x, cent),
                                     cap)
    idx = tivf.ivf_append(idx, new, n, dim=dim)
    return idx, cent, scale, dim, rows


def _ivf_queries(kind, q, scale):
    from latentrag_torch.ops import quantization as tq

    if kind in ("int8", "int4"):
        qc, qs = tq.sq8_quantize(q)
        return qc, tq.score_factor(qs, scale)
    if kind == "float32":
        return q.contiguous(), None
    return q.to(torch.bfloat16).contiguous(), None


IVF_KINDS = ["int8", "bfloat16", "float32", "int4", "binary"]


@pytest.mark.parametrize("nq", [1, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [64, 33, 384])
@pytest.mark.parametrize("kind", IVF_KINDS)
def test_ivf_scan_matches_plain(cuda, kind, d, masked, nq):
    """``ivf_scan_kernel`` against ``ivf_scan_reference``: the same slots
    and ids, int8 / int4 scores bit for bit, float and binary within the
    exact kernels' limits; d=64 and 384 take 16-byte row loads where the
    row's bytes allow, d=33 the element loads."""
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.ops.topk import NEG_INF, pack_row_mask

    idx, cent, scale, dim, rows = _ivf_setup(cuda, kind, d, 64)
    q = rows(nq)
    qv, fac = _ivf_queries(kind, q, scale)
    sel = tivf._coarse(q @ cent.T, idx, 12, True, None)
    sel = torch.cat([sel, torch.full((nq, 1), idx.nblocks, dtype=torch.int32,
                                     device=cuda)], 1)
    mask = None
    if masked:
        keep = torch.rand(6300, generator=torch.Generator(
            device=cuda).manual_seed(2), device=cuda) < 0.3
        mask = pack_row_mask(keep)
    euclids = (False, True) if kind in ("bfloat16", "float32") else (False,)
    for euclid in euclids:
        kw = dict(dim=dim, factor=fac, mask=mask, euclid=euclid)
        before = ft.launches["ivf_scan"]
        s_k, i_k = tivf.ivf_scan(qv, idx.blocks, idx.block_ids, sel, **kw)
        torch.cuda.synchronize()
        assert ft.launches["ivf_scan"] == before + 1
        assert ft.last_kernel.startswith("ivf_scan_kernel")
        assert ft.last_kernel.endswith("<mask>") == masked
        s_p, i_p = tivf.ivf_scan_reference(qv, idx.blocks, idx.block_ids,
                                           sel, **kw)
        assert torch.equal(i_k, i_p)
        assert bool((i_k[:, -64:] == -1).all())  # the sentinel slot
        assert bool(((s_k == NEG_INF) == (i_k < 0)).all())
        if masked:
            live = i_k[i_k >= 0].long()
            assert bool(keep[live].all())
        if kind in ("int8", "int4"):
            assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
        else:
            tol = (1e-5 + 1e-6 * s_p.abs() if kind == "binary"
                   else 1e-4 + 1e-5 * s_p.abs())
            assert bool(((s_k - s_p).abs() <= tol).all())


@pytest.mark.parametrize("store", ["int8", "int4", "bfloat16"])
def test_ivf_store_on_card(cuda, store, tmp_path):
    """An IVF store's search on the card: a small batch goes through one
    ``ivf_scan`` launch and no fold, equal to the same search on the plain
    scan; a large batch stays exhaustive; the store warm-boots from its
    sidecars and answers the same."""
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.retrieval import DenseRetriever

    g = torch.Generator(device=cuda).manual_seed(4)
    cent = torch.nn.functional.normalize(
        torch.randn((256, 64), generator=g, device=cuda), dim=1)
    which = torch.randint(0, 256, (40_000,), generator=g, device=cuda)
    x = torch.nn.functional.normalize(
        cent[which] + 0.08 * torch.randn((40_000, 64), generator=g,
                                         device=cuda), dim=1)
    kw = dict(store_dtype=store, backend="xla", ivf_nlist=64, ivf_cap=64,
              index_path=str(tmp_path / "s"), device="cuda")
    r = DenseRetriever(**kw)
    r.build(x, [""] * 40_000)
    assert r._ivf_index is not None
    q = x[:8] + 0.01
    ft.reset_launches()
    s, i = r.search(q, 10, nprobe=16)
    assert ft.launches["ivf_scan"] == 1
    assert sum(v for k, v in ft.launches.items() if k != "ivf_scan") == 0
    real = tivf.ivf_scan
    tivf.ivf_scan = tivf.ivf_scan_reference
    try:
        s_p, i_p = r.search(q, 10, nprobe=16)
    finally:
        tivf.ivf_scan = real
    if store == "bfloat16":
        assert np.mean(i == i_p) >= 0.99
    else:
        np.testing.assert_array_equal(i, i_p)
        np.testing.assert_array_equal(s.view(np.int32), s_p.view(np.int32))
    ft.reset_launches()
    r.search(x[:512], 10)
    assert ft.launches["ivf_scan"] == 0
    r2 = DenseRetriever(**kw)
    s2, i2 = r2.search(q, 10, nprobe=16)
    assert r2._ivf_build_info["restored"] is True
    np.testing.assert_array_equal(i2, i)


# ------------------------------------------------------------ the ANN tiers

def _lowrank_rows(n, d, seed):
    """Unit rows near a d/4-rank subspace (noise 0.05), numpy."""
    rng = np.random.default_rng(seed)
    rank = max(d // 4, 8)
    g = rng.standard_normal((n, rank)).astype(np.float32)
    proj = rng.standard_normal((rank, d)).astype(np.float32)
    x = g @ proj + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n", [9000, 1997])
def test_knn_graph_runs_the_fp32_fold(cuda, n):
    """The k-NN stage of the HNSW build on the card: one fp32 fold launch
    a 4096-row query block at k + 1 = 65 (128 candidates), lists against
    the plain exact ones by neighbour recall."""
    from latentrag_torch.ops import knn

    c = _lowrank_rows(n, 64, 3)
    ft.reset_launches()
    ids = knn.knn_graph(c, 64, metric="cosine")
    assert ft.launches == _counts(fold=-(-n // 4096))
    assert ft.last_kernel.split("+")[0] == "fold_mma_kernel<f32>"
    want = knn.knn_graph(c, 64, metric="cosine", exact=True)
    hits = (ids[:, :, None] == want[:, None, :]).any(-1)
    assert hits.mean() >= 0.95
    assert (ids != np.arange(n)[:, None]).all() and (ids >= 0).all()


def test_knn_fold_on_main_path_latents(cuda):
    """The fold at the HNSW main path's own k-NN plan (Q = N = 1997, tile
    128, 128 candidates) over its near-collinear latents
    (``tests/data/main_path_latents.npz``): candidate sets as the plain
    fold's (a row's 128 candidates span ~4 19-bit keys, so slot order
    follows the fp32 sum order), lists >= 0.95 of the exact ones, and a
    one-thread graph from them as good as one from exact lists."""
    import os

    from latentrag_torch.ops import knn
    from latentrag_torch.retrieval.ann import HNSWIndex

    z = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "main_path_latents.npz"))
    c, q = (x / np.linalg.norm(x, axis=1, keepdims=True)
            for x in (z["corpus"], z["queries"]))
    cd = torch.tensor(c, device=cuda)
    block_n, cand = ft.fold_plan(1997, 65, 0.95)
    assert (block_n, cand) == (128, 128)
    _, i_k = ft.fused_topk_raw(cd, cd, k=cand, metric="cosine", mode="fold",
                               block_n=block_n)
    _, i_p = ft.fused_topk_raw_reference(cd, cd, k=cand, metric="cosine",
                                         mode="fold", block_n=block_n)
    i_k, i_p = i_k.cpu().numpy(), i_p.cpu().numpy()
    assert np.mean([len(set(a) & set(b)) / cand
                    for a, b in zip(i_k, i_p)]) >= 0.999
    ft.reset_launches()
    ids = knn.knn_graph(cd, 64, metric="cosine")
    assert ft.launches == _counts(fold=1)
    want = knn.knn_graph(cd, 64, metric="cosine", exact=True)
    assert (ids[:, :, None] == want[:, None, :]).any(-1).mean() >= 0.95
    true = np.argsort(-(q.astype(np.float64) @ c.astype(np.float64).T),
                      axis=1)[:, :10]
    recall = {}
    for name, lists in (("fold", ids), ("exact", want)):
        ix = HNSWIndex.from_knn(c, lists, M=32, ef_construction=200,
                                nthreads=1)
        got = ix.search(q, 10, nthreads=1)[1]
        recall[name] = np.mean([len(set(g) & set(t)) / 10
                                for g, t in zip(got, true)])
    assert recall["fold"] >= recall["exact"] - 0.005, recall


def test_hnsw_auto_build_on_card(cuda):
    """``hnsw_build=auto`` on CUDA is the knn build; recall of the graph
    against the exact search."""
    from latentrag_torch.retrieval.ann_retriever import ANNRetriever
    from latentrag_torch.utils.config import RetrievalConfig

    c = _lowrank_rows(10_000, 64, 4)
    q = _lowrank_rows(64, 64, 5)
    r = ANNRetriever(RetrievalConfig(backend="hnsw", index_path="",
                                     hnsw_m=16, hnsw_ef_search=128),
                     "hnsw", device="cuda")
    ft.reset_launches()
    r.build(c, [""] * 10_000)
    assert r.build_split["mode"] == "knn"
    assert ft.launches == _counts(fold=3)
    _, got = r.search(q, 10)
    true = np.argsort(-(q @ c.T), axis=1)[:, :10]
    recall = np.mean([len(set(got[i]) & set(true[i])) / 10
                      for i in range(64)])
    assert recall >= 0.95


def test_ivfpq_device_build_on_card(cuda):
    """``ivfpq_build=auto`` on CUDA trains and encodes on the card; given
    the card's parameters, the CPU encoder gives the same lists and codes
    but at fp32 near-ties."""
    from latentrag_torch.ops import kmeans as tkm
    from latentrag_torch.retrieval.ann_retriever import ANNRetriever
    from latentrag_torch.utils.config import RetrievalConfig

    x = _lowrank_rows(20_000, 64, 6)
    coarse, books = tkm.ivfpq_train_device(x, 128, 16, iters=8)
    a_card, c_card = tkm.ivfpq_encode_device(x, coarse, books)
    a_cpu, c_cpu = tkm.ivfpq_encode_device(torch.from_numpy(x), coarse,
                                           books)
    assert np.mean(a_card == a_cpu) >= 0.999
    assert np.mean(c_card == c_cpu) >= 0.999
    r = ANNRetriever(RetrievalConfig(backend="ivfpq", index_path="",
                                     ivfpq_nlist=128, ivfpq_nprobe=32,
                                     ivfpq_refine=8),
                     "ivfpq", device="cuda")
    r.build(x, [""] * 20_000)
    assert r.build_split["mode"] == "device"
    q = _lowrank_rows(64, 64, 7)
    _, got = r.search(q, 10)
    true = np.argsort(-(q @ x.T), axis=1)[:, :10]
    assert np.mean([len(set(got[i]) & set(true[i])) / 10
                    for i in range(64)]) >= 0.9


def test_ann_device_builds_never_fall_back(cuda, monkeypatch):
    """A kernel that cannot launch fails the build; nothing drops to the
    beam build or the plain fold."""
    from latentrag_torch.retrieval.ann_retriever import ANNRetriever
    from latentrag_torch.utils.config import RetrievalConfig

    def broken(*a, **k):
        raise RuntimeError("fold kernel unavailable")

    monkeypatch.setattr(ft, "_fold_mma", broken)
    r = ANNRetriever(RetrievalConfig(backend="hnsw", index_path=""),
                     "hnsw", device="cuda")
    with pytest.raises(RuntimeError, match="fold kernel unavailable"):
        r.build(_lowrank_rows(500, 64, 8), [""] * 500)
    assert not r.is_built


# ---------------------------------------------- the second stage, chunking

RERANK_TEXTS = [
    "the telescope observes distant galaxies and stars",
    "mitochondria produce energy inside living cells",
    "markets react to interest rate announcements",
    "volcanic eruptions reshape the island coastline",
    "quantum processors need error correction to scale",
]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 0.03)])
def test_cross_encoder_on_card_matches_cpu(cuda, dtype, atol):
    """The same weights score the same pairs on the card as on the CPU:
    fp32 to sum-order noise, bf16 within the band the CPU parity test
    holds the port to the JAX package."""
    from latentrag_torch.data.tokenizer import WordPieceTokenizer
    from latentrag_torch.models.encoder.cross import CrossEncoderScorer
    from latentrag_torch.utils.config import EncoderConfig

    tok = WordPieceTokenizer.train_from_corpus(RERANK_TEXTS, vocab_size=300)
    cfg = EncoderConfig(vocab_size=300, hidden_dim=64, num_layers=2,
                        num_heads=4, mlp_dim=128, max_length=64,
                        batch_size=16, dtype=dtype)
    cpu = CrossEncoderScorer(tok, cfg, seed=3, device="cpu")
    card = CrossEncoderScorer(tok, cfg, state_dict=cpu.module.state_dict(),
                              device=cuda)
    assert all(p.is_cuda for p in card.module.parameters())
    rng = np.random.default_rng(0)
    queries = [" ".join(rng.choice(RERANK_TEXTS[i % 5].split(), 4))
               for i in range(40)]
    docs = [" ".join([RERANK_TEXTS[(i * 3) % 5]] * (1 + i % 4))
            for i in range(40)]
    np.testing.assert_allclose(card.score_pairs(queries, docs),
                               cpu.score_pairs(queries, docs), atol=atol,
                               rtol=1e-4)


def test_reranked_chunked_main_on_card(cuda, tmp_path):
    """``main`` with a reranker the port wrote and sliding chunks: the
    fold serves stage 1 (search and self-check), the cross-encoder runs
    on the card, candidate_k widens to 40."""
    from latentrag_torch import main as torch_main
    from latentrag_torch.data.tokenizer import resolve_tokenizer
    from latentrag_torch.models import VariationalAutoencoder
    from latentrag_torch.models.encoder.cross import CrossEncoderScorer
    from latentrag_torch.retrieval.reranker import save_reranker
    from latentrag_torch.utils import Config, apply_overrides

    base = str(tmp_path)
    overrides = [
        "data.dataset=synthetic", "data.max_samples=60",
        "encoder.vocab_size=800", "encoder.hidden_dim=32",
        "encoder.num_layers=1", "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={base}/vae.pth",
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", "logging.log_to_file=false",
        f"retrieval.index_path={base}/index", "retrieval.rerank=cross",
        "chunking.enabled=true", "chunking.mode=sliding",
        "chunking.max_tokens=16", "chunking.stride=8",
    ]
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    from latentrag_torch.data import load_evaluation_data, synthetic_examples

    _, corpus, _ = load_evaluation_data(synthetic_examples(60))
    cfg = apply_overrides(Config(), overrides)
    tok = resolve_tokenizer(cfg.paths.data_dir, 800, corpus)
    save_reranker(cfg, CrossEncoderScorer(tok, cfg.encoder, seed=4,
                                          device="cpu"),
                  max_length=48, query_max=16)
    ft.reset_launches()
    results = []
    assert torch_main.main(["--ae_type", "vae", "--set", *overrides],
                           results=results) == 0
    res = results[0]
    assert res["candidate_k"] == 40 and res["n_chunks"] > 2 * len(corpus)
    assert "rerank_s" in res["timings"] and "chunking_s" in res["timings"]
    assert ft.launches["fold"] >= 2 and ft.launches["exact"] == 0
    assert np.isfinite(res["doc_scores"]).all()
    for row in res["retrieved_doc_ids"]:
        assert len(row) == len(set(row)) == 10


# one train step on the card against the same step on the CPU from the
# same model, optimizer state and batch (fp32, TF32 off): the smoke's 3u
# limits
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-6


def _step_twins(cuda, trainer, twin, module, batch, eps=None, skip=()):
    """Step ``trainer`` (card) and ``twin`` (CPU, the same model and a
    copy of the optimizer's state) on ``batch``; returns the two losses
    and the largest error of ``module(trainer)``'s params outside ``skip``
    (name suffixes) and inside it."""
    import copy

    twin.optimizer.load_state_dict(copy.deepcopy(
        trainer.optimizer.state_dict()))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = {} if eps is None else {"eps": eps.to(cuda)}
        got = trainer.train_step({k: v.to(cuda) for k, v in batch.items()},
                                 **kw).item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    kw = {} if eps is None else {"eps": eps}
    want = twin.train_step(batch, **kw).item()
    sd, ref = module(trainer).state_dict(), module(twin).state_dict()
    errs = {k: (sd[k].cpu() - ref[k]).abs().max().item() for k in ref}
    held = max(e for k, e in errs.items() if not k.endswith(skip))
    rest = max([e for k, e in errs.items() if k.endswith(skip)] or [0.0])
    return got, want, held, rest


@pytest.mark.parametrize("ae_type", ["vae", "dae", "cae"])
def test_ae_train_step_card_matches_cpu(cuda, ae_type):
    import copy

    from latentrag_torch.models import build_autoencoder
    from latentrag_torch.training.trainer import Trainer
    from latentrag_torch.utils.config import AutoencoderConfig, TrainingConfig

    cfg = TrainingConfig(batch_size=64, learning_rate=1e-3,
                         weight_decay=1e-4 if ae_type == "cae" else 0.0,
                         grad_clip_norm=1.0 if ae_type == "cae" else 0.0)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 384)).astype(np.float32))
    batch = ({"q": x, "p": x.roll(1, 0) + 0.1 * x} if ae_type == "cae"
             else {"x": x + 0.05, "y": x})
    model = build_autoencoder(ae_type, AutoencoderConfig())
    trainer = Trainer(model, ae_type, cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(3):  # a state past Adam's first steps
        trainer.train_step({k: v.to(cuda) for k, v in batch.items()}, g)
    twin = Trainer(copy.deepcopy(trainer.model).cpu(), ae_type, cfg,
                   device="cpu")
    eps = (torch.randn((64, 64), generator=torch.Generator().manual_seed(2))
           if ae_type == "vae" else None)
    got, want, err, _ = _step_twins(cuda, trainer, twin, lambda t: t.model,
                                    batch, eps)
    assert abs(got - want) <= STEP_LOSS_RTOL * abs(want)
    assert err <= STEP_PARAM_ATOL
    assert all(p.device.type == cuda.type for p in trainer.model.parameters())


def test_encoder_train_step_card_matches_cpu(cuda):
    """fp32 mode at 2 layers and width 128. The attention key biases are
    held to 2 x lr instead: their true gradient is 0 (the softmax drops a
    constant logit shift) and each device's is rounding noise, which
    Adam's normalisation scales up to the order of lr
    (tests/test_torch_encoder_training.py)."""
    from latentrag_torch.data import WordPieceTokenizer, synthetic_examples
    from latentrag_torch.models.encoder import SentenceEncoder
    from latentrag_torch.training.train_encoder import EncoderTrainer
    from latentrag_torch.utils.config import EncoderConfig, TrainingConfig

    ex = synthetic_examples(64)
    queries = [e["question"] for e in ex]
    passages = [e["context"] for e in ex]
    tok = WordPieceTokenizer.train_from_corpus(passages + queries,
                                               vocab_size=500)
    ecfg = EncoderConfig(vocab_size=500, hidden_dim=128, num_layers=2,
                         num_heads=4, mlp_dim=256, dtype="float32")
    cfg = TrainingConfig(batch_size=16, learning_rate=3e-4)
    enc = SentenceEncoder(tok, ecfg, seed=3, device=cuda)
    trainer = EncoderTrainer(enc, cfg, max_length=48)
    data = trainer._tokenize_pairs(queries, passages)
    for s in range(0, 48, 16):  # a state past Adam's first steps
        trainer.train_step(trainer.to_device(
            {k: v[s:s + 16] for k, v in data.items()}))
    cpu_enc = SentenceEncoder(tok, ecfg, device="cpu", state_dict={
        k: v.cpu() for k, v in enc.module.state_dict().items()})
    twin = EncoderTrainer(cpu_enc, cfg, max_length=48)
    batch = {k: torch.from_numpy(v[48:64]) for k, v in data.items()}
    got, want, err, kbias = _step_twins(cuda, trainer, twin,
                                        lambda t: t.module, batch,
                                        skip=(".k.bias",))
    assert abs(got - want) <= STEP_LOSS_RTOL * abs(want)
    assert err <= STEP_PARAM_ATOL
    assert kbias <= 2 * cfg.learning_rate
    assert int(trainer.optimizer.state_dict()["state"][0]["step"]) == 4


# ------------------------------------------ HF checkpoints and the doctor

_HF_LAYER = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value",
             "attn_out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm",
             "mlp_in": "intermediate.dense", "mlp_out": "output.dense",
             "mlp_ln": "output.LayerNorm"}


def _write_hf_bert(path, sd, vocab):
    """A ``BertModel`` checkpoint directory (config.json,
    pytorch_model.bin, vocab.txt) of the port's encoder state dict."""
    import json
    import os

    os.makedirs(path)
    h = sd["embed_ln.weight"].shape[0]
    tensors = {
        "embeddings.word_embeddings.weight": sd["word_embeddings.weight"],
        "embeddings.position_embeddings.weight":
            sd["position_embeddings.weight"],
        "embeddings.token_type_embeddings.weight": torch.stack(
            [sd["token_type_embedding"], torch.zeros(h)]),
        "embeddings.LayerNorm.weight": sd["embed_ln.weight"],
        "embeddings.LayerNorm.bias": sd["embed_ln.bias"],
    }
    for key, t in sd.items():
        if key.startswith("layers."):
            _, i, name, leaf = key.split(".")
            tensors[f"encoder.layer.{i}.{_HF_LAYER[name]}.{leaf}"] = t
    torch.save(tensors, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "hidden_size": h}, f)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")


def test_hf_checkpoint_converted_and_served_on_card(cuda, tmp_path):
    """``default_encoder`` on the card converts a local HF directory into
    ``encoder.msgpack`` (the written tensors bit for bit) and encodes on
    the card as the CPU encoder of the same file does (fp32, 1e-5)."""
    from latentrag_torch.models.convert import minilm_state_dict_from_jax
    from latentrag_torch.models.encoder.minilm import (
        MiniLMEncoder,
        seeded_init,
    )
    from latentrag_torch.models.encoder.msgpack_io import load_msgpack
    from latentrag_torch.pipeline import default_encoder
    from latentrag_torch.utils import Config, apply_overrides

    words = [f"w{i}" for i in range(115)]
    module = MiniLMEncoder(vocab_size=120, hidden_dim=32, num_layers=2,
                           num_heads=4, mlp_dim=64,
                           max_position_embeddings=64)
    seeded_init(module, torch.Generator().manual_seed(4))
    sd = module.state_dict()
    _write_hf_bert(str(tmp_path / "hf"), sd,
                   ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
    cfg = apply_overrides(Config(), [
        f"encoder.name={tmp_path}/hf", "encoder.dtype=float32",
        "encoder.vocab_size=120", "encoder.hidden_dim=32",
        "encoder.num_layers=2", "encoder.num_heads=4", "encoder.mlp_dim=64",
        "encoder.max_position_embeddings=64",
        f"paths.data_dir={tmp_path}/data",
        f"paths.checkpoints_dir={tmp_path}/ckpt"])
    enc = default_encoder(cfg, words, device=cuda)
    got = minilm_state_dict_from_jax(
        load_msgpack(f"{tmp_path}/ckpt/encoder.msgpack"))
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert all(p.is_cuda for p in enc.module.parameters())
    texts = [" ".join(words[i:i + 9]) for i in range(0, 100, 7)]
    on_card = enc.encode_batch(texts)
    on_cpu = default_encoder(cfg, words, device="cpu").encode_batch(texts)
    assert on_card.is_cuda
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(),
                               atol=1e-5)


def test_doctor_on_card(cuda, tmp_path, capsys):
    """``python -m latentrag_torch.doctor`` on the card: the kernels build,
    launch and match their plain versions; stdout is one JSON line."""
    import json

    from latentrag_torch import doctor

    rc = doctor.main(["--index", str(tmp_path / "none"),
                      "--checkpoints", str(tmp_path / "none")])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 1
    checks = json.loads(out[0])["doctor"]["checks"]
    for name in ("imports", "platform", "kernels", "native", "tokenizer"):
        assert checks[name]["status"] == "pass", (name, checks[name])


# ------------------------------------------------ the sharded corpus (mesh)


def _mesh4():
    from latentrag_torch.parallel import make_mesh

    return make_mesh(devices=["cuda:0"] * 4)


@pytest.mark.parametrize("backend,k,kernel", [
    ("approx", 10, "fold"), ("exact", 160, "exact"),
    ("exact", 3000, "exact")])
@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_sharded_topk_launches_each_shard(cuda, store, backend, k, kernel):
    """A 4-shard mesh on one card: each shard launches its kernel once
    (the fold, the exact kernel, the exact select past 2048), and the
    exact routes give the unsharded exact route's ids (by set where
    scores tie) with scores within the exact kernels' limits."""
    from latentrag_torch.parallel import make_sharded_topk, shard_rows

    n = 20003  # not a multiple of 4: pad rows on the last shard
    q, c = _data(cuda, getattr(torch, store), nq=64, n=n)
    q = torch.nn.functional.normalize(q.float(), dim=1).to(c.dtype)
    c = torch.nn.functional.normalize(c.float(), dim=1).to(c.dtype)
    mesh = _mesh4()
    sh = shard_rows(c, mesh)
    ft.reset_launches()
    s, i = make_sharded_topk(mesh, k=k, backend=backend)(q, sh, n)
    assert ft.launches[kernel] == 4
    assert int(i.max()) < n and int(i.min()) >= 0
    s0, i0 = ft.fused_topk(q, c, k=k, mode="exact")
    if backend == "exact":
        assert torch.allclose(s, s0, atol=1e-4, rtol=1e-5)
    else:
        hit = sum(len(set(a.tolist()) & set(b.tolist()))
                  for a, b in zip(i.cpu(), i0.cpu()))
        assert hit / i0.numel() >= 0.95


@pytest.mark.parametrize("store", ["int8", "binary", "bfloat16"])
def test_sharded_dense_store_on_card(cuda, store, tmp_path):
    """DenseRetriever(mesh=) on 4 shards of cuda:0: each search launches
    the store's kernel once a shard, a filter the masked instances, and
    the store saves, warm-boots and mutates."""
    from latentrag_torch.retrieval import DenseRetriever

    g = torch.Generator().manual_seed(3)
    x = torch.nn.functional.normalize(torch.randn(9001, 64, generator=g),
                                      dim=1).numpy()
    texts = [f"t{j}" for j in range(9001)]
    path = str(tmp_path / "idx")
    r = DenseRetriever(store_dtype=store, mesh=_mesh4(), index_path=path)
    r.build(x, texts, metadata=[{"g": j % 10} for j in range(9001)])
    key = {"int8": "int8_fold", "binary": "binary_fold",
           "bfloat16": "fold"}[store]
    ft.reset_launches()
    _, ids = r.search(x[:32], 10)
    assert ft.launches[key] == 4
    assert (ids[:, 0] == np.arange(32)).mean() >= 0.95
    ft.reset_launches()
    _, ids = r.search(x[:8], 10, filter={"where": {"g": 3}})
    assert ft.launches["masked"] == 4
    live = ids[ids >= 0]
    assert live.size and (live % 10 == 3).all()
    r2 = DenseRetriever(store_dtype=store, mesh=_mesh4(), index_path=path)
    assert r2.is_built
    np.testing.assert_array_equal(r2.search(x[:32], 10)[1],
                                  r.search(x[:32], 10)[1])
    r2.add(x[:1] * 0.5 + 0.2, ["new"], doc_ids=[99999])
    r2.remove([5])
    _, ids = r2.search(np.concatenate([x[5:6], x[:1] * 0.5 + 0.2]), 5)
    assert 5 not in {r2.doc_ids[j] for j in ids[0]}
    assert r2.doc_ids[ids[1, 0]] == 99999


@pytest.mark.parametrize("store", ["int8", "bfloat16", "binary"])
def test_sharded_ivf_on_card(cuda, store):
    """The sharded IVF on 4 shards of cuda:0: one ivf_scan launch a shard
    a search; the full probe equals its plain route (each shard's scan on
    ``ivf_scan_reference``), the pad rows never come back."""
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.ops.binary import binary_quantize
    from latentrag_torch.ops.quantization import sq8_quantize
    from latentrag_torch.parallel import ivf as pivf
    from latentrag_torch.parallel import shard_rows

    n = 40_003
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.nn.functional.normalize(
        torch.randn((n, 64), generator=g, device=cuda), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((8, 64), generator=g, device=cuda), dim=1)
    scale, dim = None, 0
    if store == "int8":
        rows, scale = sq8_quantize(x)
        scale = float(scale)
    elif store == "binary":
        rows, dim = binary_quantize(x), 64
    else:
        rows = x.to(torch.bfloat16)
    mesh = _mesh4()
    sivf = pivf.build_sharded_ivf(shard_rows(rows, mesh), mesh, nlist=256,
                                  cap=64, dim=dim)
    search = pivf.make_sharded_ivf_topk(mesh, k=10, nprobe=10**6, dim=dim)
    ft.reset_launches()
    s, i = search(q, sivf, n, scale=scale)
    assert ft.launches["ivf_scan"] == 4
    assert int(i.max()) < n and int(i.min()) >= 0
    real = tivf.ivf_scan
    tivf.ivf_scan = tivf.ivf_scan_reference
    try:
        s_p, i_p = search(q, sivf, n, scale=scale)
    finally:
        tivf.ivf_scan = real
    if store == "int8":
        assert torch.equal(i, i_p) and torch.equal(s, s_p)
    else:
        assert (i == i_p).float().mean().item() >= 0.99
        assert torch.allclose(s, s_p, atol=1e-4, rtol=1e-5)


def test_sharded_ivf_retriever_and_mesh_training_on_card(cuda, tmp_path):
    """DenseRetriever(mesh=, ivf_nlist>0) on 4 shards: a small batch goes
    through the sharded IVF (4 scans), saves and warm-boots from its
    ivf_mesh_p sidecar; then a DAE step with Trainer(mesh=) on those shards
    equals the one-device step within 1e-6."""
    from latentrag_torch.models import build_autoencoder
    from latentrag_torch.retrieval import DenseRetriever
    from latentrag_torch.training import trainer as tt
    from latentrag_torch.utils.config import AutoencoderConfig, TrainingConfig

    g = torch.Generator().manual_seed(5)
    x = torch.nn.functional.normalize(torch.randn(20_003, 64, generator=g),
                                      dim=1).numpy()
    texts = [""] * len(x)
    path = str(tmp_path / "idx")
    kw = dict(store_dtype="int8", mesh=_mesh4(), index_path=path,
              ivf_nlist=256, ivf_cap=64, ivf_nprobe=64)
    r = DenseRetriever(**kw)
    r.build(x, texts)
    ft.reset_launches()
    _, ids = r.search(x[:4], 10)
    assert ft.launches["ivf_scan"] == 4 and ft.launches["int8_fold"] == 0
    r2 = DenseRetriever(**kw)
    np.testing.assert_array_equal(r2.search(x[:4], 10)[1], ids)
    assert r2._ivf_build_info["restored"] is True

    acfg = AutoencoderConfig(input_dim=64, latent_dim=8, hidden_dim=32)
    cfg = TrainingConfig(batch_size=32, learning_rate=1e-2)
    batch = {"x": x[:32], "y": x[:32]}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products
    try:
        one = tt.Trainer(build_autoencoder("dae", acfg), "dae", cfg)
        mesh = tt.Trainer(build_autoencoder("dae", acfg), "dae", cfg,
                          mesh=_mesh4())
        mesh.model.load_state_dict(one.model.state_dict())
        l1 = one.train_step(one._device_batch(batch)).item()
        lm = mesh.train_step(mesh._device_batch(batch)).item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(l1 - lm) <= 1e-6
    for a, b in zip(one.params, mesh.params):
        assert torch.allclose(a, b, atol=1e-6)


def test_streaming_build_on_card(cuda):
    """ivf_build_binary_streaming on the card, chunks made on the card:
    the layout of ivf_build_from_assign over the same assignments."""
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.ops.binary import binary_quantize

    n, chunk = 300_007, 65_536
    g = torch.Generator(device=cuda).manual_seed(6)
    words = binary_quantize(torch.randn((n, 64), generator=g, device=cuda))
    idx = tivf.ivf_build_binary_streaming(
        lambda i: words[i * chunk:(i + 1) * chunk], n, 64, nlist=512,
        cap=256, chunk_rows=chunk, kmeans_iters=3)
    assign = tivf._assign_packed(words, idx.centroids, 64, "binary", 32768)
    ref = tivf.ivf_build_from_assign(words, idx.centroids, assign, 256)
    for a, b in zip(idx[1:], ref[1:]):
        assert torch.equal(a, b)
