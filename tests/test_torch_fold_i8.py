"""The int8 store's fold (``csrc/fold_i8_wgmma.cuh``) on the CPU: the
wrapper's slab plan as a pure function, the build's sources, and a model of
the kernel's arithmetic held to the plain fold and to the JAX package's
scores, and the split script's scratch copies of the headers. The kernel itself runs only on the card
(``tests/test_torch_cuda.py -k int8_fold``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from latentrag_tpu.ops import quantization as jq
from latentrag_torch.ops import cuda_build
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.ops import quantization as tq
from latentrag_torch.ops.topk import NEG_INF, as_bool_mask, pack_row_mask

_MAGIC = 0x4B400000  # the bits of 1.5 x 2^23 (FW_MAGIC)
_M2 = 0x7FFFFFFF & ~ft._IDX_MASK


@pytest.mark.parametrize("nq,n,block_n,slots,want", [
    (1, 8_800_000, 4096, 264, (36864, 239)),   # one query tile, many slabs
    (1024, 8_800_000, 4096, 264, (135 * 4096, 16)),
    (100, 5003, 128, 264, (128, 40)),          # ragged query tile
    (2000, 1997, 128, 264, (256, 8)),          # the main path's plan
    (2000, 315, 4096, 264, (4096, 1)),         # N < block_n: one slab
    (2000, 8_800_000, 4096, 32, (2149 * 4096, 1)),  # slots for one slab
    (65, 20000, 4096, 1, (20480, 1)),          # fewer slots than tiles
])
def test_fold_slab_plan_cases(nq, n, block_n, slots, want):
    assert ft.fold_slab_plan(nq, n, block_n, slots, ft._FW_TQ) == want


@pytest.mark.parametrize("nq", [1, 63, 65, 2000])
@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
@pytest.mark.parametrize("block_n", [128, 8192])
@pytest.mark.parametrize("slots", [1, 264])
def test_fold_slab_plan_covers_the_corpus(nq, n, block_n, slots):
    """Slabs are whole tiles and cover the corpus once; they fill the
    slots the query tiles leave, at least one slab and at most a tile
    each."""
    slab_rows, n_slabs = ft.fold_slab_plan(nq, n, block_n, slots, ft._FW_TQ)
    n_tiles = -(-n // block_n)
    q_tiles = -(-nq // ft._FW_TQ)
    assert slab_rows % block_n == 0 and slab_rows > 0
    assert (n_slabs - 1) * slab_rows < n <= n_slabs * slab_rows
    assert 1 <= n_slabs <= n_tiles
    assert n_slabs <= max(1, slots // q_tiles)


def test_build_lists_the_new_header():
    """The fused_topk library is built from the new header too, so an
    edit of it rebuilds both flavours."""
    srcs = cuda_build.sources("fused_topk")
    assert "fold_i8_wgmma.cuh" in srcs and "fold_mma.cuh" in srcs
    assert all(lib == "fused_topk" for lib, _ in ft.LIBRARIES)


def test_magic_conversion_is_exact():
    """float32(s) as the kernel forms it for |s| <= 2^22 (every int8 dot
    of d <= 256): the bits of 1.5 x 2^23 + s, less 1.5 x 2^23, equal
    float32(s) bit for bit, the sign of zero included."""
    s = np.arange(-(1 << 22), (1 << 22) + 1, dtype=np.int32)
    x = (s + np.int32(_MAGIC)).view(np.float32)
    f = x - np.float32(12582912.0)
    assert np.array_equal(f.view(np.int32),
                          s.astype(np.float32).view(np.int32))


def _kernel_model(qc, codes, fac, k, block_n, mask=None):
    """fold_i8_wgmma_kernel's arithmetic in PyTorch: each 128-row sub-tile
    J of a tile packs a score's order-preserving int with J (not the
    column) in its low 13 bits and keeps a lane's max; a lane winner's row
    is tile_base + 128 J + lane; the lists take the union's top k by
    key64 = key << 32 | (R - tile_base + column); one slab."""
    nq, n = qc.shape[0], codes.shape[0]
    R = (-(-n // block_n) - 1) * block_n
    allowed = as_bool_mask(mask, n)
    keys = []
    for base in range(0, n, block_n):
        folded = torch.full((nq, 128), ft._MIN_I32, dtype=torch.int32)
        for t0 in range(base, min(base + block_n, n), 128):
            rows = codes[t0:t0 + 128]
            dots = qc.to(torch.int32) @ rows.to(torch.int32).T
            f = (dots + _MAGIC).view(torch.float32) - 12582912.0
            b = (f * fac).view(torch.int32)
            p = (b & ~ft._IDX_MASK) ^ (((b >> 31) & _M2) ^ ((t0 - base) >> 7))
            if allowed is not None:
                p = torch.where(allowed[None, t0:t0 + rows.shape[0]], p,
                                ft._MIN_I32)
            cols = rows.shape[0]
            folded[:, :cols] = torch.maximum(folded[:, :cols], p)
        col = ((folded & ft._IDX_MASK).long() << 7) + torch.arange(128)
        k64 = ((folded & ~ft._IDX_MASK).long() << 32) + (R - base) + col
        keys.append(torch.where(folded == ft._MIN_I32, -(2**63), k64))
    top = torch.sort(torch.cat(keys, dim=1), dim=1, descending=True)[0][:, :k]
    empty = top == -(2**63)
    low = top & 0xFFFFFFFF
    row = (R - low + 2 * (low % block_n)).to(torch.int32)
    score = ft._unmonotone_f32((top >> 32).to(torch.int32))
    return (torch.where(empty, NEG_INF, score),
            torch.where(empty, -1, row))


@pytest.mark.parametrize("allowed", [None, 0.1, "few"])
@pytest.mark.parametrize("n,k,block_n", [
    (315, 40, 128), (1997, 10, 128), (5003, 128, 1024), (9000, 40, 4096)])
def test_kernel_model_matches_plain_fold(n, k, block_n, allowed):
    """The kernel's packing (the sub-tile index in place of the column)
    and its key64 give the plain fold's ids and scores bit for bit,
    ragged tiles, masks and empty slots included; the plain fold itself
    returns the JAX package's ``sq8_topk`` scores for its ids."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((37, 64)).astype(np.float32)
    codes, cs = tq.sq8_quantize(torch.from_numpy(x))
    qc, qs = tq.sq8_quantize(torch.from_numpy(q))
    fac = tq.score_factor(qs, cs)
    mask = None
    if allowed == "few":
        keep = torch.zeros(n, dtype=torch.bool)
        keep[rng.choice(n, 5, replace=False)] = True
        mask = pack_row_mask(keep)
    elif allowed is not None:
        mask = pack_row_mask(torch.from_numpy(rng.random(n) < allowed))
    s_m, i_m = _kernel_model(qc, codes, fac, k, block_n, mask)
    s_p, i_p = ft.sq8_fused_topk_raw(qc, codes, fac, k=k, mode="fold",
                                     block_n=block_n, mask=mask)
    assert torch.equal(i_m, i_p) and torch.equal(s_m, s_p)
    # those rows' scores in the JAX package (sq8_topk over every row),
    # quantized to 19 bits as the fold returns them
    import jax.numpy as jnp

    c_j, s_j = jq.sq8_quantize(jnp.asarray(x))
    js, ji = jq.sq8_topk(jnp.asarray(q), c_j, s_j, k=n)
    exact = np.zeros((37, n), np.float32)
    np.put_along_axis(exact, np.asarray(ji), np.asarray(js), axis=1)
    live = i_p >= 0
    own = torch.from_numpy(np.take_along_axis(
        exact, np.clip(i_p.numpy(), 0, None), axis=1))
    want = ft._unmonotone_f32(ft._monotone_i32(own) & ~ft._IDX_MASK)
    assert torch.equal(s_p[live], want[live])


def _split_script():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_int8_fold_split.py")
    spec = importlib.util.spec_from_file_location("torch_int8_fold_split",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SPLIT = _split_script()


@pytest.mark.parametrize("variant", _SPLIT.VARIANTS + _SPLIT.NEW_VARIANTS)
def test_split_variants_patch_the_current_headers(variant):
    """Each scratch copy of ``scripts/torch_int8_fold_split.py`` (the
    replaced instance that ``chip_smoke.py`` phase 4d times, and its
    variants) applies its patches once to the headers as they stand, and
    stops before ``fold_mma.cuh``'s C interface."""
    src = _SPLIT.scratch_source(variant)
    assert "int lr_fold_mma(" not in src
    if variant in _SPLIT.NEW_VARIANTS:
        assert "int lr_fold_i8(" in src
    else:
        assert "int lr_split_fold(" in src
