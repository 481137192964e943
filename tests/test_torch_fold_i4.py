"""The int4 store's fold on the CPU: a model of the producer warpgroup's
unpack (``fw_produce4`` in ``csrc/wgmma_i8.cuh``) held to the JAX package's
``sq4_unpack`` and its integer dots, and the split script's scratch copies
of the instance it replaced. The kernel itself runs only on the card
(``tests/test_torch_cuda.py -k int4``)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest

from latentrag_tpu.ops import quantization as jq

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_ROOT, "latentrag_torch", "csrc")
_TN = 128  # rows a sub-tile (TN)


def _byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` on uint32 arrays: result byte i is byte
    ``(sel >> 4 i) & 7`` of the 8 bytes y:x (x the low four)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _s4x8(x):
    """``fm_s4x8``: four packed bytes (uint32, low nibble first) as 8
    sign-extended int8 codes in two words."""
    x = x.astype(np.uint32)
    lo, hi = x & 0x0F0F0F0F, (x >> 4) & 0x0F0F0F0F
    a, b = _byte_perm(lo, hi, 0x5140), _byte_perm(lo, hi, 0x7362)
    a |= (a & 0x08080808) * np.uint32(0x1E)
    b |= (b & 0x08080808) * np.uint32(0x1E)
    return a, b


def _swz(r, chunk, ch):
    """``fw_swz``: byte offset of 16-byte chunk ``chunk`` of row r in rows
    of ch bytes, TMA's 64- or 128-byte swizzle."""
    if ch == 64:
        return r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4)
    return r * 128 + ((chunk ^ (r & 7)) << 4)


def _stage(packed, d, t0, dci, writes=None):
    """The s8 stage ``fw_produce4`` writes for the sub-tile at row t0 and
    dim chunk dci: thread t's piece u is row (t + 128 u) / PR, packed bytes
    b0 + 16 ((t + 128 u) % PR), zero past the rows and past w bytes,
    sign-extended into chunks 2 pc and 2 pc + 1 of the row. ``writes``
    counts the stores to each byte."""
    n, w = packed.shape
    ch = 64 if d <= 64 else 128
    pr = ch // 32
    stage = np.zeros(_TN * ch, np.uint8)
    for t in range(128):
        for u in range(_TN * pr // 128):
            v = t + 128 * u
            r, pc = v // pr, v % pr
            b = dci * (ch // 2) + 16 * pc
            piece = np.zeros(16, np.uint8)
            if t0 + r < n and b < w:
                got = packed[t0 + r, b:b + 16]
                piece[:len(got)] = got
            a, c = _s4x8(piece.view("<u4"))
            chunks = np.stack([a, c], 1).reshape(-1).astype("<u4").view(
                np.uint8)
            for j, cc in enumerate((2 * pc, 2 * pc + 1)):
                o = _swz(r, cc, ch)
                stage[o:o + 16] = chunks[16 * j:16 * j + 16]
                if writes is not None:
                    writes[o:o + 16] += 1
    return stage


def _read(stage, d):
    """The stage as wgmma reads it: [128 rows, ch dims] int8."""
    ch = 64 if d <= 64 else 128
    out = np.zeros((_TN, ch), np.int8)
    for r in range(_TN):
        for cc in range(ch // 16):
            o = _swz(r, cc, ch)
            out[r, 16 * cc:16 * cc + 16] = stage[o:o + 16].view(np.int8)
    return out


def test_sign_extension_matches_jax_over_every_byte():
    """``fm_s4x8`` over all 256 byte values equals the JAX package's
    ``sq4_unpack`` of the same bytes: low nibble the even dim, two's
    complement."""
    packed = np.arange(256, dtype=np.uint8).reshape(1, 256)
    want = np.asarray(jq.sq4_unpack(jnp.asarray(packed), 512))[0]
    a, b = _s4x8(packed.view("<u4")[0])
    got = np.stack([a, b], 1).reshape(-1).astype("<u4").view(np.int8)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("d", [33, 48, 63, 64, 65, 128, 200, 257, 384])
def test_producer_stages_match_jax(d):
    """The stages of a corpus of 300 rows (a ragged third sub-tile), read
    as wgmma reads them, hold the JAX package's sign-extended codes at every
    dim below d; the pad nibble at odd d and the bytes past the row's last
    are what the query's zero codes past d meet, and the int32 dots of
    every row against int8 query codes (zero past d, as the query tile
    holds them) equal the JAX package's dots bit for bit."""
    rng = np.random.default_rng(d)
    n, w = 300, (d + 1) // 2
    packed = rng.integers(0, 256, (n, w), dtype=np.uint8)
    packed[::7] = 0x88  # -8, the bound of the dot
    packed[3::11] = 0x77
    qc = rng.integers(-128, 128, (5, d), dtype=np.int8)
    codes = np.asarray(jq.sq4_unpack(jnp.asarray(packed), d))
    want = np.asarray(jnp.dot(jnp.asarray(codes, jnp.int32),
                              jnp.asarray(qc, jnp.int32).T))
    ch = 64 if d <= 64 else 128
    n_dch = -(-d // ch)
    qpad = np.zeros((5, n_dch * ch), np.int32)
    qpad[:, :d] = qc
    got = np.zeros((n, 5), np.int64)
    for t0 in range(0, n, _TN):
        rows = min(_TN, n - t0)
        full = np.concatenate([_read(_stage(packed, d, t0, dci), d)
                               for dci in range(n_dch)], 1)
        assert np.array_equal(full[:rows, :d], codes[t0:t0 + rows])
        assert not full[rows:].any()  # rows past n are zero
        assert not full[:, 2 * w:].any()  # dims past the row's bytes
        got[t0:t0 + rows] = full[:rows].astype(np.int64) @ qpad.T
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("d", [33, 64, 128, 384])
def test_producer_writes_every_stage_byte_once(d):
    """The 128 threads' pieces cover each stage byte exactly once, so no
    thread's chunk overwrites another's and none is left stale."""
    packed = np.zeros((_TN, (d + 1) // 2), np.uint8)
    ch = 64 if d <= 64 else 128
    for dci in range(-(-d // ch)):
        writes = np.zeros(_TN * ch, np.int64)
        _stage(packed, d, 0, dci, writes)
        assert (writes == 1).all()


def _split_script():
    path = os.path.join(_ROOT, "scripts", "torch_int4_fold_split.py")
    spec = importlib.util.spec_from_file_location("torch_int4_fold_split",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SPLIT = _split_script()


@pytest.mark.parametrize("variant", ["old", "new_skipall", "new_noproducts",
                                     "new_profile", "new_pring1",
                                     "new_pring2", "new_w2", "new_w1",
                                     "new_early", "new_sx", "new_early_sx"])
def test_split_scratch_copies(variant):
    """``scripts/torch_int4_fold_split.py``'s scratch copies: the replaced
    instance ``fold_mma_kernel<4, OP_I4>`` (which ``chip_smoke.py`` phase
    4d times) stops before ``fold_mma.cuh``'s C interface and launches
    through its own; the new kernel's cut copies come from the int8 split
    script's and keep ``lr_fold_i4``; the packed-ring copies apply each of
    their patches once to the headers as they stand."""
    src = _SPLIT.scratch_source(variant)
    assert "int lr_fold_mma(" not in src
    if variant == "old":
        assert "int lr_split_fold(" in src
        assert "fm_launch<4, OP_I4, true>" in src
    else:
        assert "int lr_fold_i4(" in src and "int lr_fold_i8(" in src
    if variant in ("new_w2", "new_w1"):
        assert "#define FW_P4_THREADS 128" not in src
    if variant.startswith("new_pring"):
        assert "fw_produce4_ring<WIDE>(sm, smem, &map" in src
        assert f"#define FW_PR_STAGES {variant[-1]}" in src


def test_library_routes_the_int4_fold_to_the_wgmma_kernel():
    """The library keeps no int4 instance of ``fold_mma_kernel``: its
    dispatch names no ``OP_I4``, and the int4 fold's C entry is
    ``lr_fold_i4`` beside ``lr_fold_i8``, on the same kernel."""
    with open(os.path.join(_CSRC, "fold_mma.cuh"), encoding="utf-8") as f:
        fold_mma = f.read()
    dispatch = fold_mma[fold_mma.index("#define FM_DISPATCH(F"):]
    dispatch = dispatch[:dispatch.index("\n\n")]
    assert "OP_I4" not in dispatch and "OP_BF16" in dispatch
    with open(os.path.join(_CSRC, "fold_i8_wgmma.cuh"),
              encoding="utf-8") as f:
        wgmma = f.read()
    assert "int lr_fold_i4(" in wgmma and "int lr_fold_i8(" in wgmma
