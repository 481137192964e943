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


@pytest.mark.parametrize("nq", [100, 1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [64, 33, 384])
@pytest.mark.parametrize("k", [10, 40, 128, 160, 2048])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_quantized_kernels_match_plain(cuda, store, k, d, masked, nq):
    """The int8 and int4 fold (k <= 128, at ``fold_plan``'s tile) and exact
    (k = 160, 2048) kernels, and their row-mask instances (10 % allowed),
    against their plain versions on the same codes: scores are exact
    integer dots times one factor, so the exact kernel equals its plain
    version bit for bit (ids and scores, ties to the lower row), and the
    fold's keys equal the plain fold's wherever the ids do (>= 99 %; the
    lanes keep the higher column of a tie in both). d = 33 takes the
    element-wise loads (and int4's pad nibble), d = 384 three stages a
    sub-tile; N = 5003 leaves a ragged tile, 100 queries a ragged query
    tile and one query (a served search, the self-check) 63 of the 64
    tile rows padding."""
    from latentrag_torch.ops.topk import pack_row_mask

    qc, c, fac, g = _quantized(cuda, store, nq, 5003, d)
    mask = (pack_row_mask(torch.rand(5003, generator=g, device=cuda) < 0.1)
            if masked else None)
    mode = "fold" if k <= 128 else "exact"
    block_n = ft.fold_plan(5003, k, 0.99)[0] if mode == "fold" else 4096
    ft.reset_launches()
    s_k, i_k = _quantized_raw(store, qc, c, fac, d, k=k, mode=mode,
                              block_n=block_n, mask=mask)
    tag = "<i8>" if store == "int8" else "<i4>"
    assert ft.last_kernel.split("+")[0] == (
        f"{mode}_mma_kernel{tag}" + ("<mask>" if masked else ""))
    assert ft.launches[f"{store}_{mode}"] == 1
    assert ft.launches["masked"] == int(masked)
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=d, k=k, op=op, mode=mode, block_n=block_n, mask=mask)
    if mode == "exact":
        assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)
    else:
        same = i_k == i_p
        assert same.float().mean().item() >= 0.99
        assert torch.equal(s_k[same], s_p[same])
    if masked:  # only allowed rows; empty slots (NEG_INF, -1)
        from latentrag_torch.ops.topk import unpack_row_mask

        allowed = unpack_row_mask(mask, 5003)
        live = i_k >= 0
        assert bool(allowed[i_k[live].long()].all())


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_quantized_kernels_ties_and_unaligned(cuda, store):
    """Every 7th row a copy of row 0 (ties across lanes and tiles) and a
    corpus whose base is not 16-byte aligned (the element-wise loads): the
    exact kernel still equals its plain version bit for bit, ties to the
    lower row, and the approximate route returns exact scores."""
    qc, c, fac, _ = _quantized(cuda, store, 64, 3001, 64, dup_every=7)
    buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)
    c = buf[1:].view(c.shape).copy_(c)
    assert c.data_ptr() % 16 != 0
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    s_k, i_k = _quantized_raw(store, qc, c, fac, 64, k=300, mode="exact")
    s_p, i_p = ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=64, k=300, op=op, mode="exact")
    assert torch.equal(i_k, i_p) and torch.equal(s_k, s_p)


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
