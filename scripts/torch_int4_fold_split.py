"""Time the int4 store's fold beside the instance it replaced on the card.

``fold_mma_kernel<4, OP_I4>`` (``latentrag_torch/csrc/fold_mma.cuh``, the
int4 instance of the bf16 fold's template) served the int4 store's stage 1
until ``fold_i8_wgmma_kernel`` took it (``lr_fold_i4``: its producer
warpgroup sign-extends the nibbles into the s8 stages the int8 store's
consumers read). This script builds a scratch copy of the old instance
from the current ``fold_mma.cuh`` (the header itself is never edited;
the list of 128, with and without the row mask) and times, on the same
seeded nibbles:

* ``old``: the old instance as it served the store;
* ``new``: the library's kernel through ``sq4_fused_topk_raw``;
* ``yardstick``: the library's int8 fold (``sq8_fused_topk_raw``) over
  the same codes unpacked to int8 (``sq4_unpack``), at the same plan:
  once a stage is sign-extended the new kernel's consumers do exactly
  this work, so the gap between ``new`` and ``yardstick`` is the unpack's;
* ``new_<cut>`` (``new_skipall``, ``new_noproducts``, ``new_onemax``,
  ``new_profile``, ...): ``scripts/torch_int8_fold_split.py``'s scratch
  copies of the new kernel, each launched through its ``lr_fold_i4``;
* ``new_pring1``, ``new_pring2``: the design the kernel did not take, a
  scratch copy whose producer gets the packed rows by TMA into a ring of
  1 or 2 packed stages (4 KB each at d = 64) in shared memory and unpacks
  them from there, in place of its warps' 16-byte loads from device
  memory (d = 64 only). One packed stage keeps 2 blocks an SM at the list
  of 128; two cost the second block;
* ``new_w2``, ``new_w1``: the unpack by 2 warps or 1 of the producer
  warpgroup (``FW_P4_THREADS`` 64 or 32) in place of its 4;
* ``new_early``: the sign extension before the wait for the slot, so
  that only the stores follow its release; ``new_sx``: the sign extension
  by a biased add in place of the multiply; ``new_early_sx``: both.

Run it from the repository's root on a machine with the card::

    python3 scripts/torch_int4_fold_split.py [--queries 1024] [--rows 8800000]
    python3 scripts/torch_int4_fold_split.py --mask 0.1
    python3 scripts/torch_int4_fold_split.py --queries 2000 --rows 315

The fold runs at the store's plan for top_k = 10 (``binary_oversample`` 8:
80 candidates, ``fold_plan`` at recall 0.95: 128). The variants are timed
in turn, ``--rounds`` rounds over all of them; a variant named twice is
timed twice a round (old, new, new, old). It prints one JSON line a
variant (the medians of the rounds' ms by CUDA events and of their device
ms by ``torch.profiler``, each round's, the slab plan and blocks an SM,
whether the answer equals ``new``'s bit for bit, the SM clock before and
after) and the instances' registers and stack bytes by ``cuobjdump
-res-usage``, and with ``--out PATH`` writes them to that JSON file.
``chip_smoke.py`` builds the ``old`` variant beside the kernels' libraries
and times it in phase 4d.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E = 4  # the list of 128: stage 1's 80 candidates at top_k = 10
LIBRARY_VARIANTS = ("new", "yardstick")  # the library's kernels, no build

_LAUNCHER = """
static size_t lr_split_smem(int d, int k) {
    const int n_dch = (d + fm_dch(OP_I4) - 1) / fm_dch(OP_I4);
    return (size_t)fm_nst(%(E)d, OP_I4) * fm_slot_bytes(OP_I4) +
           fm_qu_bytes(n_dch, OP_I4) + FM_TQ * 4 +
           (size_t)FM_PAIRS * 8 * FM_TSTRIDE * 4 +
           (size_t)FM_WARPS * 128 * 8 + (size_t)FM_TQ * k * 8;
}

extern "C" {

int lr_split_occupancy(int d, int k, int masked) {
    const size_t smem = lr_split_smem(d, k);
    return masked ? fm_occupancy<%(E)d, OP_I4, true>(smem)
                  : fm_occupancy<%(E)d, OP_I4, false>(smem);
}

int lr_split_fold(const void* q, const void* c, const float* fac,
                  const unsigned* mask, int nq, int n, int d, int k,
                  int block_n, int slab_rows, int vec, long long* part,
                  float* out_s, int* out_i, void* stream) {
    const size_t smem = lr_split_smem(d, k);
    cudaStream_t st = (cudaStream_t)stream;
    if (mask)
        return fm_launch<%(E)d, OP_I4, true>(
            q, c, fac, mask, nq, n, d, k, 0, block_n, slab_rows, vec, part,
            out_s, out_i, smem, st);
    return fm_launch<%(E)d, OP_I4, false>(
        q, c, fac, nullptr, nq, n, d, k, 0, block_n, slab_rows, vec, part,
        out_s, out_i, smem, st);
}

}  // extern "C"
""" % {"E": E}


# the packed ring's producer (d = 64, rows of 32 bytes on an aligned base),
# inserted at the end of wgmma_i8.cuh; its barriers at bytes 256 (full) and 320
# (empty) of the barrier region, the ring after the query tile
_RING_PRODUCER = r"""
#define FW_PR_STAGES %(NP)d
#define FW_PR_BYTES (FW_PR_STAGES * TN * 32)

static int fw_map_packed(CUtensorMap* map, const void* base, int w, int rows) {
    FwEncode encode = fw_encoder();
    if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
    const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)w};
    const cuuint32_t box[2] = {32u, (cuuint32_t)TN};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
               const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    return 0;
}

template <bool WIDE>
__device__ __forceinline__ void fw_produce4_ring(
    const FwRing& sm, unsigned char* smem, const CUtensorMap* pmap,
    const CUtensorMap* qmap, int n_sub, int q0, int row0, int nst,
    int qvec, unsigned qbar, int t) {
    const unsigned pfull = sm.full + 256, pempty = sm.full + 320;
    const unsigned pring = sm.qs + FW_TQ * 64;
    const unsigned char* P0 = smem + (pring - sm.full);
    if (qvec && t == 0) {
        fw_bar_expect(qbar, FW_TQ * 64);
        fw_tma(sm.qs, qmap, 0, q0, qbar);
    }
    if (t == 0)
        for (int s = 0; s < FW_PR_STAGES && s < n_sub; ++s) {
            fw_bar_expect(pfull + 8 * s, TN * 32);
            fw_tma(pring + s * TN * 32, pmap, 0, row0 + s * TN, pfull + 8 * s);
        }
    int slot = 0, ps = 0;
    unsigned phase = 0, pphase = 0;
    for (int st = 0; st < n_sub; ++st) {
        fw_bar_wait(pfull + 8 * ps, pphase);
        uint4 p[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
            p[u] = *reinterpret_cast<const uint4*>(
                P0 + ps * TN * 32 + 16 * (t + 128 * u));
        __syncwarp();
        if ((t & 31) == 0) fw_bar_arrive(pempty + 8 * ps);
        if (t == 0 && st + FW_PR_STAGES < n_sub) {
            fw_bar_wait(pempty + 8 * ps, pphase);
            fw_bar_expect(pfull + 8 * ps, TN * 32);
            fw_tma(pring + ps * TN * 32, pmap, 0,
                   row0 + (st + FW_PR_STAGES) * TN, pfull + 8 * ps);
        }
        if (++ps == FW_PR_STAGES) {
            ps = 0;
            pphase ^= 1u;
        }
        fw_bar_wait(sm.empty + 8 * slot, phase ^ 1u);
        unsigned char* P = smem + (sm.ring + slot * fw_stage_bytes(64) -
                                   sm.full);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int v = t + 128 * u, r = v >> 1, cc = 2 * (v & 1);
            const uint2 a0 = fm_s4x8(p[u].x), a1 = fm_s4x8(p[u].y);
            const uint2 a2 = fm_s4x8(p[u].z), a3 = fm_s4x8(p[u].w);
            *reinterpret_cast<uint4*>(P + fw_swz(r, cc, 64)) =
                make_uint4(a0.x, a0.y, a1.x, a1.y);
            *reinterpret_cast<uint4*>(P + fw_swz(r, cc + 1, 64)) =
                make_uint4(a2.x, a2.y, a3.x, a3.y);
        }
        fw_fence_async();
        __syncwarp();
        if ((t & 31) == 0) fw_bar_arrive(sm.full + 8 * slot);
        fw_step(slot, phase, nst);
    }
}

"""
_RING_PATCHES = [
    ("#endif  // LR_WGMMA_I8_CUH", _RING_PRODUCER + "#endif  // LR_WGMMA_I8_CUH"),
    ("    return FW_BAR_BYTES + fw_qtile_bytes(d) + FW_T_BYTES + FW_C_BYTES +",
     "    return FW_BAR_BYTES + fw_qtile_bytes(d) + FW_PR_BYTES + FW_T_BYTES +"
     " FW_C_BYTES +"),
    ("                       (size_t)nst * fw_stage_bytes(d) + fw_qtile_bytes(d);",
     "                       (size_t)nst * fw_stage_bytes(d) + fw_qtile_bytes(d)"
     " + FW_PR_BYTES;"),
    ("    if (tid == 0)\n"
     "        fw_init_ring(sm, nst, i4 ? FW_P4_THREADS / 32 : vec ? 1 : 32, "
     "qbar);",
     "    if (tid == 0) {\n"
     "        fw_init_ring(sm, nst, 4, qbar);\n"
     "        for (int s = 0; s < FW_PR_STAGES; ++s) {\n"
     "            fw_bar_init(sm.full + 256 + 8 * s, 1);\n"
     "            fw_bar_init(sm.full + 320 + 8 * s, 4);\n"
     "        }\n"
     "        asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: "
     "\"memory\");\n"
     "    }"),
    (re.compile(r"            fw_produce4<WIDE>\(sm, smem, &qmap, q,.*?tid\);",
                re.S),
     "            fw_produce4_ring<WIDE>(sm, smem, &map, &qmap, n_sub, q0, "
     "row0, nst, qvec, qbar, tid);"),
    ("    if (vec && !i4) {",
     "    if (i4 && !(d == 64 && vec)) return (int)cudaErrorInvalidValue;\n"
     "    if (i4) {\n"
     "        e = fw_map_packed(&map, c, w, n);\n"
     "        if (e) return e;\n"
     "    }\n"
     "    if (vec && !i4) {"),
]
# the sign extension done before the wait for the slot (the words pinned
# in registers by an empty asm), so that only the stores, the fence and the
# arrival follow the slot's release
_EARLY_PATCHES = [(
    """        fw_bar_wait(sm.empty + 8 * slot, phase ^ 1u);
        unsigned char* P = smem + (sm.ring + slot * fw_stage_bytes(d) -
                                   sm.full);
#pragma unroll
        for (int u = 0; u < PT; ++u) {
            const uint2 a0 = fm_s4x8(p[u].x), a1 = fm_s4x8(p[u].y);
            const uint2 a2 = fm_s4x8(p[u].z), a3 = fm_s4x8(p[u].w);
            *reinterpret_cast<uint4*>(P + u * RU * CH + o0) =
                make_uint4(a0.x, a0.y, a1.x, a1.y);
            *reinterpret_cast<uint4*>(P + u * RU * CH + o1) =
                make_uint4(a2.x, a2.y, a3.x, a3.y);
        }
""",
    """        uint4 xs[2 * PT];
#pragma unroll
        for (int u = 0; u < PT; ++u) {
            const uint2 a0 = fm_s4x8(p[u].x), a1 = fm_s4x8(p[u].y);
            const uint2 a2 = fm_s4x8(p[u].z), a3 = fm_s4x8(p[u].w);
            xs[2 * u] = make_uint4(a0.x, a0.y, a1.x, a1.y);
            xs[2 * u + 1] = make_uint4(a2.x, a2.y, a3.x, a3.y);
            asm volatile("" : "+r"(xs[2 * u].x), "+r"(xs[2 * u].y),
                         "+r"(xs[2 * u].z), "+r"(xs[2 * u].w),
                         "+r"(xs[2 * u + 1].x), "+r"(xs[2 * u + 1].y),
                         "+r"(xs[2 * u + 1].z), "+r"(xs[2 * u + 1].w));
        }
        fw_bar_wait(sm.empty + 8 * slot, phase ^ 1u);
        unsigned char* P = smem + (sm.ring + slot * fw_stage_bytes(d) -
                                   sm.full);
#pragma unroll
        for (int u = 0; u < PT; ++u) {
            *reinterpret_cast<uint4*>(P + u * RU * CH + o0) = xs[2 * u];
            *reinterpret_cast<uint4*>(P + u * RU * CH + o1) = xs[2 * u + 1];
        }
""")]
# the sign extension by a biased add, no multiply: a nibble v (in the low
# half of its byte) becomes ((v ^ 8) + 0x78) ^ 0x80, which is v - 16 for v
# >= 8 and v below, with no carry out of the byte
_SX_PATCHES = [(
    """    const unsigned lo = x & 0x0F0F0F0Fu, hi = (x >> 4) & 0x0F0F0F0Fu;
    unsigned a = __byte_perm(lo, hi, 0x5140), b = __byte_perm(lo, hi, 0x7362);
    a |= (a & 0x08080808u) * 0x1Eu;
    b |= (b & 0x08080808u) * 0x1Eu;
    return make_uint2(a, b);""",
    """    const unsigned lo = ((x & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u;
    const unsigned hi =
        (((x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u;
    return make_uint2(__byte_perm(lo, hi, 0x5140) ^ 0x80808080u,
                      __byte_perm(lo, hi, 0x7362) ^ 0x80808080u);""")]
# the unpack by fewer threads than the producer warpgroup's: the rest leave
_ONLY_P4_THREADS = ("        if (i4) {\n            fw_produce4<WIDE>(",
                    "        if (i4) {\n            if (tid < FW_P4_THREADS)\n"
                    "            fw_produce4<WIDE>(")
# this script's own scratch copies of the new kernel: the variant, the
# int8 split script's copy it starts from, and its patches
_OWN = {"new_pring1": _RING_PATCHES, "new_pring2": _RING_PATCHES,
        "new_w2": [("#define FW_P4_THREADS 128", "#define FW_P4_THREADS 64"),
                   _ONLY_P4_THREADS],
        "new_w1": [("#define FW_P4_THREADS 128", "#define FW_P4_THREADS 32"),
                   _ONLY_P4_THREADS],
        "new_early": _EARLY_PATCHES, "new_sx": _SX_PATCHES,
        "new_early_sx": _EARLY_PATCHES + _SX_PATCHES}
_OWN_NP = {"new_pring1": 1, "new_pring2": 2}


def _patch(variant: str, body: str) -> str:
    for old, new in _OWN[variant]:
        if isinstance(old, str):
            if body.count(old) != 1:
                raise RuntimeError(f"{variant}: {old!r} not found once")
            body = body.replace(old, new)
        else:
            body, hits = old.subn(lambda _m: new, body)
            if hits != 1:
                raise RuntimeError(f"{variant}: pattern found {hits} times")
    return body.replace("%(NP)d", str(_OWN_NP.get(variant, 0)))


def int8_split():
    """``scripts/torch_int8_fold_split.py`` as a module: its build and
    timing helpers and its scratch copies of the new kernel."""
    name = "torch_int8_fold_split"
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_I8 = int8_split()


def scratch_source(variant: str) -> str:
    """``old``: ``fused_topk.cu``'s prelude, ``fold_mma.cuh`` without its
    C interface (which would instantiate every operand kind) and a C
    launcher of ``fold_mma_kernel<4, OP_I4, MASK>``; ``new_<cut>``:
    ``scripts/torch_int8_fold_split.py``'s scratch copy of that name."""
    if variant in _OWN:
        return _patch(variant, _I8.scratch_source("new"))
    if variant != "old":
        return _I8.scratch_source(variant)
    csrc = os.path.join(ROOT, "latentrag_torch", "csrc")
    with open(os.path.join(csrc, "fused_topk.cu"), encoding="utf-8") as f:
        prelude = f.read().split('#include "fold_mma.cuh"')[0]
    with open(os.path.join(csrc, "fold_mma.cuh"), encoding="utf-8") as f:
        body = f.read()
    if body.count(_I8._CUT) != 1:
        raise RuntimeError("fold_mma.cuh's C interface not found once")
    return prelude + body.split(_I8._CUT)[0] + _LAUNCHER


def library_path(variant: str) -> str:
    if variant != "old" and variant not in _OWN:
        return _I8.library_path(variant)
    from latentrag_torch.ops import cuda_build

    text = scratch_source(variant)
    digest = hashlib.sha1((" ".join(cuda_build.NVCC_FLAGS) + text).encode())
    return os.path.join(cuda_build.BUILD_DIR, "split",
                        f"int4_fold_{variant}-{digest.hexdigest()[:12]}.so")


def start_build(variant: str):
    """Start ``nvcc`` on the variant's scratch copy (None if it is built or
    is the library's); ``finish_build`` waits for it."""
    if variant in LIBRARY_VARIANTS:
        return None
    if variant != "old" and variant not in _OWN:
        return _I8.start_build(variant)
    from latentrag_torch.ops import cuda_build

    out = library_path(variant)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = out[:-3] + ".cu"
    with open(src, "w", encoding="utf-8") as f:
        f.write(scratch_source(variant))
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
         os.path.join(ROOT, "latentrag_torch", "csrc"), "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


finish_build = _I8.finish_build


def load(variant: str) -> ctypes.CDLL | None:
    """The variant's scratch library with its C functions declared (None
    for the library's kernels)."""
    if variant in LIBRARY_VARIANTS:
        return None
    p, i = ctypes.c_void_p, ctypes.c_int
    if variant != "old":
        # the profile reader declared where the copy has one
        lib = (ctypes.CDLL(library_path(variant)) if variant in _OWN
               else _I8.load(variant))
        lib.lr_fold_i8_occupancy.restype = i
        lib.lr_fold_i8_occupancy.argtypes = [i, i, i]
        lib.lr_fold_i4.restype = i
        lib.lr_fold_i4.argtypes = [p, p, p] + [i] * 6 + [p] * 5
        return lib
    lib = ctypes.CDLL(library_path(variant))
    lib.lr_split_occupancy.restype = i
    lib.lr_split_occupancy.argtypes = [i, i, i]
    lib.lr_split_fold.restype = i
    lib.lr_split_fold.argtypes = [p, p, p, p] + [i] * 7 + [p] * 4
    return lib


def fold_call(torch, variant, lib, qc, packed, fac, d: int, k: int,
              block_n: int, mask=None):
    """A callable that launches the variant's fold once as the store's
    wrapper does (``fused_topk.fold_slab_plan``), and the plan (slab_rows,
    slabs, blocks an SM)."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq

    nq = qc.shape[0]
    n = packed.shape[0]
    dev = qc.device
    masked = mask is not None
    if variant == "old":
        per_sm = lib.lr_split_occupancy(d, k, int(masked))
        q_tile = ft._FM_TQ
    elif lib is not None:  # a scratch copy of the new kernel, unmasked
        per_sm = lib.lr_fold_i8_occupancy(d, k, ft._OP_I4)
        q_tile = ft._FW_TQ
    else:
        per_sm = ft._slots(dev.index, "fold_i8", d, k, ft._OP_I4,
                           masked) // ft._sm_count(dev.index)
        q_tile = ft._FW_TQ
    if per_sm <= 0:
        raise RuntimeError(f"occupancy {per_sm}")
    slab_rows, n_slabs = ft.fold_slab_plan(
        nq, n, block_n, per_sm * ft._sm_count(dev.index), q_tile)
    plan = {"slab_rows": slab_rows, "slabs": n_slabs,
            "blocks_per_sm": per_sm}
    if variant == "new":
        return (lambda: ft.sq4_fused_topk_raw(
            qc, packed, fac, d=d, k=k, mode="fold", block_n=block_n,
            mask=mask)), plan
    if variant == "yardstick":
        codes = tq.sq4_unpack(packed, d).contiguous()
        return (lambda: ft.sq8_fused_topk_raw(
            qc, codes, fac, k=k, mode="fold", block_n=block_n,
            mask=mask)), plan
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    w = -(-d // 2)
    vec = int(w % 16 == 0 and packed.data_ptr() % 16 == 0)
    mp = mask.data_ptr() if masked else None
    pp = part.data_ptr() if part is not None else None

    def call():
        st = torch.cuda.current_stream(dev).cuda_stream
        if variant == "old":
            code = lib.lr_split_fold(
                qc.data_ptr(), packed.data_ptr(), fac.data_ptr(), mp, nq, n,
                d, k, block_n, slab_rows, vec, pp, scores.data_ptr(),
                ids.data_ptr(), st)
        else:
            code = lib.lr_fold_i4(
                qc.data_ptr(), packed.data_ptr(), fac.data_ptr(), nq, n, d,
                k, block_n, slab_rows, mp, pp, scores.data_ptr(),
                ids.data_ptr(), st)
        if code:
            raise RuntimeError(f"{variant} failed: code {code}")
        return scores, ids

    return call, plan


def resources(variant: str, masked: bool) -> dict | None:
    """Registers and stack bytes of the variant's instance by ``cuobjdump
    -res-usage``: the old ``fold_mma_kernel<4, OP_I4 = 4, MASK>`` or the
    library's ``fold_i8_wgmma_kernel<4, MASK, false>``."""
    import re

    from latentrag_torch.ops import cuda_build
    from latentrag_torch.ops import fused_topk as ft

    if variant == "old":
        path = library_path("old")
        name = f"fold_mma_kernelILi4ELi4ELb{int(masked)}E"
    else:
        path = cuda_build.library_path(*ft.LIBRARIES[int(masked)])
        name = f"fold_i8_wgmma_kernelILi4ELb{int(masked)}ELb0E"
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage", path], capture_output=True,
                         text=True, timeout=120).stdout
    m = re.search(r"Function (\S*" + re.escape(name) + r"\S*):\s*\n\s*"
                  r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", out)
    if not m:
        return None
    return {"function": m.group(1), "registers": int(m.group(2)),
            "stack_bytes": int(m.group(3)), "shared_bytes": int(m.group(4)),
            "local_bytes": int(m.group(5))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=8_800_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--mask", type=float, default=None,
                    help="share of rows allowed (the row-mask instances)")
    ap.add_argument("--variants", nargs="+",
                    default=["old", "new", "new", "old", "yardstick"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="a JSON file of the records")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq
    from latentrag_torch.ops.topk import pack_row_mask

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    names = list(dict.fromkeys(args.variants))
    for s in [start_build(v) for v in names]:
        finish_build(s)
    g = torch.Generator(device="cuda").manual_seed(700)
    d = args.dim
    x = torch.nn.functional.normalize(torch.randn(
        (args.rows, d), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(torch.randn(
        (args.queries, d), generator=g, device="cuda"), dim=1)
    qc, qs = tq.sq8_quantize(q)
    packed, cs = tq.sq4_quantize(x)
    del x
    fac = tq.score_factor(qs, cs).reshape(1).contiguous()
    mask = (pack_row_mask(torch.rand(args.rows, generator=g, device="cuda")
                          < args.mask) if args.mask is not None else None)
    block_n, k = ft.fold_plan(args.rows, min(80, args.rows), 0.95)
    card = _I8.card_line()
    print(card, flush=True)
    calls = {}
    for v in names:
        calls[v] = fold_call(torch, v, load(v), qc, packed, fac, d, k,
                             block_n, mask)
    want = calls["new"][0]() if "new" in calls else None
    torch.cuda.synchronize()
    same = {}
    for v in names:
        got = calls[v][0]()
        torch.cuda.synchronize()
        same[v] = (None if want is None else bool(
            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
    rounds = {v: [] for v in names}
    clock_before = _I8.sm_clock()
    for _ in range(args.rounds):
        for v in args.variants:
            call = calls[v][0]
            dev = _I8.device_ms(torch, call)
            rounds[v].append({
                "ms": _I8.time_ms(torch, call),
                "device_ms": sum(t for nm, t in dev.items()
                                 if "fold_mma_kernel" in nm
                                 or "fold_i8_wgmma_kernel" in nm),
                "merge_ms": sum(t for nm, t in dev.items()
                                if "fold_merge_kernel" in nm)})
    clock_after = _I8.sm_clock()
    records = []
    for v in names:
        med = {key: sorted(r[key] for r in rounds[v])[len(rounds[v]) // 2]
               for key in ("ms", "device_ms", "merge_ms")}
        rec = {"variant": v, "Q": args.queries, "N": args.rows, "d": d,
               "k": k, "block_n": block_n, "mask": args.mask,
               **calls[v][1], **med, "rounds": rounds[v],
               "same_answer_as_new": same[v], "card": card,
               "sm_clock_power_temp": [clock_before, clock_after]}
        if v in ("old", "new"):
            rec["resources"] = resources(v, mask is not None)
        if v == "new_profile":
            lib = load(v)
            rec["phases"] = _I8.phase_counts(torch, lib, calls[v][0])
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
