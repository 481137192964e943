"""The int8 and int4 stores' exact search on Hopper
(``csrc/exact_i8_wgmma.cuh`` to k = 256, ``csrc/exact_i8_select.cuh`` past
it; the int4 store's through the same kernels) on the CPU: the wrapper's
slab plan as a pure function, the route by k, the build's sources and
entries, a numpy model of the kernel's skip threshold, and the split
scripts' scratch copies of the replaced instances. The kernels themselves
run only on the card (``tests/test_torch_cuda.py -k int8_exact``); the
select's plan and its plain model: ``tests/test_torch_exact_i8_select.py``."""

import importlib.util
import os

import numpy as np
import pytest

from latentrag_torch.ops import cuda_build
from latentrag_torch.ops import fused_topk as ft

_INT_MIN, _INT_MAX = -(2**31), 2**31 - 1


@pytest.mark.parametrize("nq,n,slots,want", [
    (1024, 8_800_000, 264, (550_016, 16)),   # the 8.8M store, k <= 112
    (1024, 8_800_000, 132, (1_100_032, 8)),  # one block an SM (k > 112)
    (2000, 315, 264, (128, 3)),              # a slab a sub-tile
    (2000, 1997, 132, (512, 4)),             # the msmarco main at top_k 150
    (1, 5003, 264, (128, 40)),               # one query: a slab a sub-tile
    (65, 20000, 1, (20096, 1)),              # fewer slots than query tiles
    (2000, 8_800_000, 32, (8_800_000, 1)),   # slots for one slab
])
def test_exact_i8_slab_plan_cases(nq, n, slots, want):
    assert ft.exact_i8_slab_plan(nq, n, slots) == want


@pytest.mark.parametrize("nq", [1, 63, 65, 2000])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 5003, 1_000_003])
@pytest.mark.parametrize("slots", [1, 132, 264])
def test_exact_i8_slab_plan_covers_the_corpus(nq, n, slots):
    """Slabs are whole 128-row sub-tiles and cover the corpus once; they
    fill the slots the 64-query tiles leave, at least one slab and at most
    a sub-tile each."""
    slab_rows, n_slabs = ft.exact_i8_slab_plan(nq, n, slots)
    n_sub = -(-n // 128)
    q_tiles = -(-nq // 64)
    assert slab_rows % 128 == 0 and slab_rows > 0
    assert (n_slabs - 1) * slab_rows < n <= n_slabs * slab_rows
    assert 1 <= n_slabs <= n_sub
    assert n_slabs <= max(1, slots // q_tiles)


@pytest.mark.parametrize("k,want", [
    (1, "exact_i8_wgmma_kernel"), (129, "exact_i8_wgmma_kernel"),
    (160, "exact_i8_wgmma_kernel"), (256, "exact_i8_wgmma_kernel"),
    (257, "exact_i8_select_kernel"), (512, "exact_i8_select_kernel"),
    (2048, "exact_i8_select_kernel"),
])
def test_int8_exact_route_cases(k, want):
    assert ft.quantized_exact_kernel(ft._OP_I8, k) == want


@pytest.mark.parametrize("k,want", [
    (1, "exact_i8_wgmma_kernel<i4>"), (10, "exact_i8_wgmma_kernel<i4>"),
    (129, "exact_i8_wgmma_kernel<i4>"), (160, "exact_i8_wgmma_kernel<i4>"),
    (256, "exact_i8_wgmma_kernel<i4>"), (257, "exact_i8_select_kernel<i4>"),
    (512, "exact_i8_select_kernel<i4>"), (2048, "exact_i8_select_kernel<i4>"),
])
def test_int4_exact_route_cases(k, want):
    """The int4 store's exact search takes the int8 store's kernels: up to
    k = 256 ``exact_i8_wgmma_kernel`` (its stage 1 at top_k 17-32: 136-256
    candidates), past it ``exact_i8_select_kernel`` (top_k 33 on: 264 and
    more; the reranked store from top_k 9)."""
    assert ft.quantized_exact_kernel(ft._OP_I4, k) == want


def test_exact_route_by_k():
    """Every k of the exact routes: both stores up to ``EXACT_I8_MAX_K``
    (256) on ``exact_i8_wgmma_kernel`` (int4 through ``lr_exact_i4``, named
    ``exact_i8_wgmma_kernel<i4>``), past it on ``exact_i8_select_kernel``
    / ``<i4>``."""
    assert ft.EXACT_I8_MAX_K == 256
    for k in range(1, ft.EXACT_MAX_K + 1):
        kernel = ("exact_i8_wgmma_kernel" if k <= 256
                  else "exact_i8_select_kernel")
        assert ft.quantized_exact_kernel(ft._OP_I8, k) == kernel
        assert ft.quantized_exact_kernel(ft._OP_I4, k) == kernel + "<i4>"


@pytest.mark.parametrize("op", [ft._OP_BF16, ft._OP_BIN, ft._OP_F32])
def test_exact_route_refuses_float_stores(op):
    """The route by k names the quantized stores' kernels only: a float or
    binary operand kind has no int8 exact route to name."""
    with pytest.raises(ValueError):
        ft.quantized_exact_kernel(op, 160)


def test_build_lists_the_new_headers():
    """The fused_topk library is built from the new header and the
    machinery it shares with the int8 fold, so an edit of either rebuilds
    both flavours."""
    srcs = cuda_build.sources("fused_topk")
    for h in ("exact_i8_wgmma.cuh", "wgmma_i8.cuh", "fold_i8_wgmma.cuh",
              "exact_mma.cuh", "exact_select.cuh", "exact_i8_select.cuh"):
        assert h in srcs


def _csrc(name: str) -> str:
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "latentrag_torch", "csrc", name)
    with open(path, encoding="utf-8") as f:
        return f.read()


class _Fn:
    """A stand-in for a ctypes function: its declared types."""

    restype = argtypes = None


class _Lib:
    """A stand-in for a ctypes library: every attribute a ``_Fn``."""

    def __getattr__(self, name):
        fn = _Fn()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("select", [False, True])
def test_build_lists_the_int4_entry(select):
    """The library's C interface has ``lr_exact_i4`` beside
    ``lr_exact_i8`` (the same arguments, the kernel's i4 flag set), both
    libraries declare it as ``lr_exact_i8`` is declared, and the old
    template routes neither int store at any k, so no
    ``exact_mma_kernel<KP, OP_I8 | OP_I4>`` stays in the build."""
    src = _csrc("exact_i8_wgmma.cuh")
    assert src.count("int lr_exact_i4(const void* q, const void* c,") == 1
    assert "return ew_exact(q, c, factor, nq, n, d, k, slab_rows, mask, 1," \
        in src
    lib = _Lib()
    ft._declare(lib, select)
    assert lib.lr_exact_i4.argtypes == lib.lr_exact_i8.argtypes
    assert lib.lr_exact_i4.restype is lib.lr_exact_i8.restype
    assert len(lib.lr_exact_i4.argtypes) == 13
    mma = _csrc("exact_mma.cuh")
    for op in ("OP_I8", "OP_I4"):
        assert f"EM_DISPATCH_BIG(F, {op}" not in mma
        assert f"EM_DISPATCH_OP(F, {op}" not in mma
    assert mma.count("if (k < 1 || k > 2048 || op == OP_I8 || op == OP_I4) "
                     "return -1;") == 2


def _score(dots, factor):
    """float32(dot) * factor, each step rounded to nearest in fp32, as the
    kernels and the JAX package score an int32 dot."""
    return (np.asarray(dots).astype(np.float32)
            * np.float32(factor)).astype(np.float32)


def _threshold(v, factor):
    """fw_threshold's arithmetic: floor(v / factor) in float64, less 3,
    clamped to int32."""
    t = np.floor(np.float64(v) / np.float64(np.float32(factor))) - 3.0
    return np.clip(t, _INT_MIN, _INT_MAX).astype(np.int64)


@pytest.mark.parametrize("factor", np.geomspace(1e-8, 1e2, 41).tolist())
def test_skip_threshold_is_exact(factor):
    """For k-th scores v of both signs (every one the score of a dot with
    |dot| < 2^24, as a list's k-th is), the threshold t: no dot below t
    scores v or more (the score rises with the dot, so t - 1 is the one
    to check), and the least dot that scores v or more lies 0 to 4 steps
    above t. Near 2^24 neighbouring dots round to one fp32 score (unless the
    factor is a power of two): those equal scores are admitted, and the
    cases below meet some."""
    rng = np.random.default_rng(int(factor * 1e9) % 2**32)
    kth = np.concatenate([
        rng.integers(-(2**24) + 1, 2**24, 4000),
        rng.integers(-300, 300, 1000),
        (2**24 - 1) - rng.integers(0, 64, 500),
        -(2**24 - 1) + rng.integers(0, 64, 500),
        np.array([0, 1, -1, 2**22, -(2**22)]),
    ]).astype(np.int64)
    v = _score(kth, factor)
    t = _threshold(v, factor)
    assert (_score(t - 1, factor) < v).all()
    steps = np.arange(0, 6)
    reach = _score(t[:, None] + steps, factor) >= v[:, None]
    assert reach.any(axis=1).all()
    least = reach.argmax(axis=1)
    assert least.max() <= 4
    # dots below the k-th dot that round to its score: all at or above t
    tied = _score(kth - 1, factor) == v
    assert (kth[tied] - 1 >= t[tied]).all()
    if np.frexp(np.float32(factor))[0] != 0.5:  # not a power of two
        assert tied.any()


def test_skip_threshold_bounds():
    """Thresholds clamp to int32 where v / factor leaves it (a huge score
    over a tiny factor): no dot, or every dot."""
    assert _threshold(np.float32(3e38), 1e-8) == _INT_MAX
    assert _threshold(np.float32(-3e38), 1e-8) == _INT_MIN


def _split_script():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_int8_exact_split.py")
    spec = importlib.util.spec_from_file_location("torch_int8_exact_split",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SPLIT = _split_script()


def _int4_split_script():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_int4_exact_split.py")
    spec = importlib.util.spec_from_file_location("torch_int4_exact_split",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SPLIT4 = _int4_split_script()


@pytest.mark.parametrize("variant", _SPLIT.VARIANTS + _SPLIT.NEW_VARIANTS)
def test_split_variants_patch_the_current_headers(variant):
    """Each scratch copy of ``scripts/torch_int8_exact_split.py`` (the
    replaced instance that ``chip_smoke.py`` phase 4d times and its cuts,
    and the new kernel's profiled and skip-all copies) applies its patches
    once to the headers as they stand, and stops before the older headers'
    C interfaces."""
    src = _SPLIT.scratch_source(variant)
    assert "int lr_exact_mma(" not in src and "int lr_fold_mma(" not in src
    if variant in _SPLIT.NEW_VARIANTS:
        assert "int lr_exact_i8(" in src and "int lr_split_exact(" not in src
        assert ("lr_ew_prof" in src) == (variant == "new_profile")
    else:
        assert "int lr_split_exact(" in src
        assert ("lr_split_thr" in src) == (variant == "oracle")


@pytest.mark.parametrize("variant", _SPLIT4.OLD_VARIANTS
                         + _SPLIT4.NEW_VARIANTS)
def test_int4_split_variants_patch_the_current_headers(variant):
    """Each scratch copy of ``scripts/torch_int4_exact_split.py``: the
    replaced ``exact_mma_kernel<KP, OP_I4>`` (``chip_smoke.py`` phase 4d
    times ``old``) and its products cut, an int4 launcher of the KP = 128
    and 256 instances that no longer instantiates the int8 ones and stops
    before the headers' C interfaces; the new kernel's copies, the int8
    script's, with the ``lr_exact_i4`` they are launched through."""
    src = _SPLIT4.scratch_source(variant)
    assert "int lr_exact_mma(" not in src and "int lr_fold_mma(" not in src
    if variant in _SPLIT4.NEW_VARIANTS:
        assert "int lr_exact_i4(" in src and "int lr_split_exact(" not in src
        return
    launcher = src.split('extern "C" {')[-1]
    assert "int lr_split_exact(" in launcher
    assert "OP_I4" in launcher and "OP_I8" not in launcher
    assert "lr_split_thr" not in src
    cut = "asm volatile(\"\" : \"+f\"(acc[0][0])"
    assert (cut in src) == (variant == "old_noproducts")
    assert _SPLIT4.library_path(variant).endswith(".so")
