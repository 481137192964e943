"""The fused distance + top-k (``latentrag_torch.ops.fused_topk``).

On the CPU the wrapper runs the kernels' plain version, which is held to
the JAX package's Pallas kernels run in interpret mode (as
``tests/test_ops_pallas.py`` runs them): exact and fold modes, cosine,
euclidean and whitened mahalanobis, fp32 and bf16 stores, N not a multiple
of block_n, k clipped to N. The CUDA kernels themselves are held to the
plain version by ``tests/test_torch_cuda.py`` (marked ``cuda``, skipped
without a card) and by ``chip_smoke.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from latentrag_tpu.ops.distances import (
    estimate_covariance,
    prepare_for_metric,
    whitening_factor,
)
from latentrag_tpu.ops.pallas_topk import pallas_topk, pallas_topk_raw
from latentrag_torch.ops import fused_topk as ft


def _inputs(rng, metric, store, nq=8, n=600, d=16):
    q = rng.standard_normal((nq, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    w = None
    if metric == "mahalanobis":
        c[:, 0] *= 5.0
        w = whitening_factor(estimate_covariance(jnp.asarray(c)))
    qj = prepare_for_metric(jnp.asarray(q), metric, w)
    cj = prepare_for_metric(jnp.asarray(c), metric, w)
    if store == "bfloat16":
        qj, cj = qj.astype(jnp.bfloat16), cj.astype(jnp.bfloat16)
        to_t = lambda a: torch.from_numpy(  # noqa: E731
            np.array(a.astype(jnp.float32))).bfloat16()
    else:
        to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return qj, cj, to_t(qj), to_t(cj)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "mahalanobis"])
@pytest.mark.parametrize("mode", ["exact", "fold"])
def test_plain_matches_pallas_interpret(rng, mode, metric, store):
    qj, cj, qt, ct = _inputs(rng, metric, store)
    s_j, i_j = pallas_topk_raw(qj, cj, k=7, metric=metric, mode=mode,
                               block_q=8, block_n=256, interpret=True)
    s_t, i_t = ft.fused_topk_raw(qt, ct, k=7, metric=metric, mode=mode,
                                 block_n=256)
    same = i_t.numpy() == np.asarray(i_j)
    assert same.mean() >= 0.99
    # fp32 sums in another order; fold keys are 19-bit, so equal ids
    # carry equal quantized scores up to one key step
    tol = 1e-4 if mode == "exact" else 2e-3
    np.testing.assert_allclose(s_t.numpy()[same], np.asarray(s_j)[same],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["exact", "fold"])
def test_k_clipped_to_n(rng, mode):
    qj, cj, qt, ct = _inputs(rng, "cosine", "float32", nq=4, n=5)
    s_j, i_j = pallas_topk_raw(qj, cj, k=9, mode=mode, block_q=8,
                               block_n=128, interpret=True)
    s_t, i_t = ft.fused_topk_raw(qt, ct, k=9, mode=mode, block_n=128)
    assert i_t.shape == (4, 5)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_rescored_fold_matches_pallas_topk(rng, metric):
    qj, cj, qt, ct = _inputs(rng, metric, "bfloat16")
    s_j, i_j = pallas_topk(qj, cj, k=6, metric=metric, mode="fold",
                           block_q=8, block_n=256, interpret=True)
    s_t, i_t = ft.fused_topk(qt, ct, k=6, metric=metric, mode="fold",
                             block_n=256)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-4)


def test_fold_candidate_recall(rng):
    """The fold's contract case (``tests/test_ops_pallas.py``): candidate
    recall >= 0.95 against exact at k=10 on 20k x 32."""
    q = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((16, 32)).astype(np.float32)), dim=1)
    c = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((20000, 32)).astype(np.float32)), dim=1)
    _, i0 = ft.fused_topk_raw(q, c, k=10, mode="exact")
    s1, i1 = ft.fused_topk(q, c, k=10, mode="fold", block_n=2048)
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                      for a, b in zip(i0, i1)])
    assert recall >= 0.95
    exact = (q @ c.T).gather(1, i1.long())
    np.testing.assert_allclose(s1.numpy(), exact.numpy(), atol=1e-5)


def _merge_slabs(parts, mode, block_n, k):
    """Merge per-slab (keys, global ids) lists by the kernels' total order:
    exact (key desc, row asc); fold (key desc, tile asc, row desc)."""
    out = []
    for rows in zip(*parts):
        cand = [(kk, ii) for keys, ids in rows for kk, ii in zip(keys, ids)]
        if mode == "exact":
            cand.sort(key=lambda e: (-e[0], e[1]))
        else:
            cand.sort(key=lambda e: (-e[0], e[1] // block_n, -e[1]))
        out.append([ii for _, ii in cand[:k]])
    return np.array(out)


@pytest.mark.parametrize("mode", ["exact", "fold"])
def test_slab_split_then_merge_equals_whole(rng, mode):
    """The CUDA design: slabs of whole block_n tiles searched apart, then
    merged by one total order, give the whole-corpus ids exactly, ties
    included (duplicate rows tie)."""
    base = rng.standard_normal((60, 16)).astype(np.float32)
    c = torch.from_numpy(base[rng.integers(0, 60, 2500)])
    q = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    k, block_n = 12, 256
    _, whole = ft.fused_topk_raw(q, c, k=k, mode=mode, block_n=block_n)
    parts = []
    for lo in range(0, 2500, 768):  # 3 tiles per slab, ragged last slab
        s, i = ft.fused_topk_raw(q, c[lo : lo + 768], k=k, mode=mode,
                                 block_n=block_n)
        keys = ft._monotone_i32(s).numpy().astype(np.int64)
        parts.append(list(zip(keys, i.numpy() + lo)))
    merged = _merge_slabs(parts, mode, block_n, k)
    np.testing.assert_array_equal(merged, whole.numpy())


def _order_key(qkey, rows, n, block_n):
    """The bf16 fold kernel's total order as one int64 (csrc/fold_mma.cuh):
    quantized key << 32 | (R - tile base + column), R = (n_tiles - 1) *
    block_n; a larger key is better."""
    rows = rows.long()
    base = rows // block_n * block_n
    r = (-(-n // block_n) - 1) * block_n
    return (qkey.long() << 32) | (r - base + (rows - base))


def _rows_of_key(key, n, block_n):
    """The kernel's decode: tile base R - (low - column), plus column."""
    low = key & 0xFFFFFFFF
    r = (-(-n // block_n) - 1) * block_n
    return r - low + 2 * (low % block_n)


def test_order_key_sorts_as_the_plain_fold(rng):
    """Small integer vectors make every score exact in fp32 and tie often;
    duplicated rows tie across tiles. Sorting every lane winner by the
    64-bit key gives the plain fold's ids, order included."""
    n, block_n, k = 1000, 256, 60
    q = torch.from_numpy(rng.integers(-2, 3, (6, 8)).astype(np.float32))
    base = rng.integers(-2, 3, (40, 8)).astype(np.float32)
    c = torch.from_numpy(base[rng.integers(0, 40, n)])
    s, ids = ft.fused_topk_raw(q, c, k=k, metric="dot", mode="fold",
                               block_n=block_n)
    mono = ft._monotone_i32(q @ c.T)
    keys = []
    for lo in range(0, n, block_n):
        tile = torch.full((6, block_n), ft._MIN_I32, dtype=torch.int32)
        cols = torch.arange(min(block_n, n - lo), dtype=torch.int32)
        tile[:, cols.long()] = (mono[:, lo : lo + len(cols)]
                                & ~ft._IDX_MASK) | cols
        win = tile.view(6, -1, 128).amax(dim=1)
        keys.append(_order_key(win & ~ft._IDX_MASK,
                               lo + (win & ft._IDX_MASK), n, block_n))
    top = torch.sort(torch.cat(keys, 1), dim=1, descending=True)[0][:, :k]
    np.testing.assert_array_equal(_rows_of_key(top, n, block_n).numpy(),
                                  ids.numpy())
    out = _order_key(ft._monotone_i32(s), ids, n, block_n)
    assert bool((out[:, :-1] > out[:, 1:]).all())  # strictly descending
    # the case holds ties of the quantized key across tiles
    qk = ft._monotone_i32(s)
    tiles = ids // block_n
    tie = (qk[:, :-1] == qk[:, 1:]) & (tiles[:, :-1] != tiles[:, 1:])
    assert bool(tie.any())


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_plain_fold_matches_pallas_at_main_plan(rng, metric):
    """The fold as the main path's approximate route plans it
    (``fold_plan``: 128-row tiles, 40 candidates) on a bf16 store."""
    qj, cj, qt, ct = _inputs(rng, metric, "bfloat16", nq=16, n=300)
    s_j, i_j = pallas_topk_raw(qj, cj, k=40, metric=metric, mode="fold",
                               block_q=8, block_n=128, interpret=True)
    s_t, i_t = ft.fused_topk_raw(qt, ct, k=40, metric=metric, mode="fold",
                                 block_n=128)
    same = i_t.numpy() == np.asarray(i_j)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(s_t.numpy()[same], np.asarray(s_j)[same],
                               rtol=2e-3, atol=2e-3)


def test_wrapper_validates():
    q = torch.zeros(2, 8)
    c = torch.zeros(300, 8)
    with pytest.raises(ValueError, match="fold mode supports"):
        ft.fused_topk_raw(q, c, k=129, mode="fold")
    # on a CPU tensor exact mode is the plain version, which answers past
    # the exact kernels' 2048 (on the card the entry raises there)
    s, i = ft.fused_topk_raw(q, torch.zeros(3000, 8), k=2049, mode="exact")
    assert s.shape == i.shape == (2, 2049) and i.dtype == torch.int32
    with pytest.raises(ValueError, match="share a dtype"):
        ft.fused_topk_raw(q.bfloat16(), c, k=3)
    with pytest.raises(ValueError, match="multiple of"):
        ft.fused_topk_raw(q, c, k=3, block_n=200)
    with pytest.raises(ValueError, match="dim"):
        ft.fused_topk_raw(torch.zeros(2, 4), c, k=3)
    with pytest.raises(ValueError, match="unsupported metric"):
        ft.fused_topk_raw(q, c, k=3, metric="hamming")


def test_cpu_path_counts_no_launches(rng):
    ft.reset_launches()
    q = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    ft.fused_topk(q, c, k=4, mode="fold")
    ft.fused_topk(q, c, k=4, mode="exact")
    packed = torch.zeros((200, 1), dtype=torch.int32)
    ft.binary_fused_topk(q, packed, d=8, k=4)
    ft.approx_binary_fused_topk(q, packed, d=8, k=4)
    ft.approx_binary_fused_topk(q, packed, d=8, k=150)  # the exact search
    ft.binary_exact_topk_raw(q, packed, d=8, k=4)
    ft.approx_fused_topk(q, torch.zeros((2100, 8)), k=2050)  # blocked route
    ft.binary_exact_topk_raw(q, torch.zeros((2100, 1), dtype=torch.int32),
                             d=8, k=2050)
    mask = torch.full((2,), -1, dtype=torch.int32)  # every row of 50
    ft.fused_topk(q, c, k=4, mode="fold", mask=mask)
    ft.approx_fused_topk(q, c, k=4, mask=mask)
    # the int8 and int4 routes (fold, exact, blocked) and raw entries
    codes = torch.zeros((2100, 8), dtype=torch.int8)
    nibbles = torch.zeros((2100, 4), dtype=torch.uint8)
    for k in (4, 150, 2050):
        ft.approx_sq8_fused_topk(q, codes, 0.01, k=k)
        ft.approx_sq4_fused_topk(q, nibbles, 0.1, d=8, k=k, mask=mask[:1]
                                 .repeat(66) if k == 4 else None)
    ft.sq8_fused_topk_raw(torch.zeros((2, 8), dtype=torch.int8), codes,
                          torch.tensor([0.5]), k=4, mode="exact")
    assert set(ft.launches) >= {"int8_fold", "int8_exact", "int8_blocked",
                                "int4_fold", "int4_exact", "int4_blocked"}
    assert ft.launches == dict.fromkeys(ft.launches, 0)


@pytest.mark.parametrize("n,k,rt,want", [
    (315, 10, 0.99, (128, 40)),
    (2000, 10, 0.99, (128, 40)),
    (1_000_000, 10, 0.99, (4096, 40)),
    (1_000_000, 64, 0.95, (4096, 128)),
    (3, 10, 0.99, (128, 3)),
])
def test_fold_plan(n, k, rt, want):
    assert ft.fold_plan(n, k, rt) == want


def test_approx_route_meets_recall_target(rng):
    q = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((20, 16)).astype(np.float32)), dim=1)
    c = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((3000, 16)).astype(np.float32)), dim=1)
    _, i0 = ft.fused_topk_raw(q, c, k=10, mode="exact")
    s1, i1 = ft.approx_fused_topk(q, c, k=10, recall_target=0.99)
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                      for a, b in zip(i0, i1)])
    assert recall >= 0.99
    assert bool((s1[:, :-1] >= s1[:, 1:]).all())


def test_both_kernel_libraries_build_at_once(tmp_path, monkeypatch):
    """The kernels' two libraries (without and with the row mask) come from
    one source under distinct names, and ``build_all`` starts every nvcc
    before it waits for one. The stand-in compiler marks its start, waits
    (30 s at most) until both builds have started, and writes the number
    of starts it saw: 2 in each library only if neither build had to end
    before the other began."""
    from latentrag_torch.ops import cuda_build

    names = [cuda_build.library_path(n, d) for n, d in ft.LIBRARIES]
    assert len(set(names)) == 2
    assert all(os.path.basename(p).startswith("fused_topk-") for p in names)
    fake = tmp_path / "nvcc"
    fake.write_text(
        '#!/bin/sh\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'out="$2"; dir=$(dirname "$out"); touch "$out.start"; n=0\n'
        'starts() { ls "$dir" | grep -c "[.]start$"; }\n'
        'while [ "$(starts)" -lt 2 ] && [ $n -lt 300 ]; do\n'
        '  sleep 0.1; n=$((n + 1))\n'
        'done\n'
        'echo "built $(starts)" > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    paths = cuda_build.build_all(ft.LIBRARIES)
    assert [open(p).read() for p in paths] == ["built 2\n"] * 2
    assert set(cuda_build.build_seconds) >= {"fused_topk",
                                             "fused_topk[LR_MASKED=1]"}
    assert set(cuda_build.build_messages) >= {"fused_topk",
                                              "fused_topk[LR_MASKED=1]"}
    assert cuda_build.build_all(ft.LIBRARIES) == paths  # nothing rebuilt
