"""Split the time of the int8 store's first exact kernel on the card.

``exact_mma_kernel<KP, OP_I8>`` (``latentrag_torch/csrc/exact_mma.cuh``,
the int8 instance of the bf16 exact search's template) served the int8
store's exact search at k <= 256 until ``exact_i8_wgmma.cuh`` replaced it.
This script builds scratch copies of it from the current ``exact_mma.cuh``
(the KP = 128 and 256 instances, with and without the row mask), each
patched as text at build time (the header itself is never edited), and
times them on the same inputs:

* ``old``: the instance as it served the store;
* ``oracle``: the flush cut: every query's threshold starts at the
  answer's k-th key (less one), so a buffer takes only the rows of the
  answer and the block flushes about once, at the slab's end;
* ``noconvert``: the conversion and compare cut (the scores leave the
  accumulators into an empty asm statement; nothing is appended);
* ``noproducts``: the products cut (the ``mma.sync`` calls emit nothing,
  so every score is 0; the stage loads, ``ldmatrix``, the conversion and
  compare stay, and after the first flush no row is appended);

and ``new``, the kernel that replaced it (``exact_i8_wgmma_kernel``, the
library's, through ``sq8_fused_topk_raw``), on the same inputs. With
``--mask`` (the share of rows allowed) ``old`` and ``new`` run their
row-mask instances. Scratch copies of the new kernel, built the same way
from ``exact_i8_wgmma.cuh`` (with ``wgmma_i8.cuh`` inlined): ``new_skipall``
(every half's vote fails: nothing is appended or flushed, the products,
the stages and the vote stay) and ``new_profile`` (clock64 spans of each
consumer warp's phases and counts of passing votes, flushes, offers and
keys appended, summed over the warps: ``lr_ew_prof`` reads them).

Run it from the repository's root on a machine with the card::

    python3 scripts/torch_int8_exact_split.py [--queries 1024] [--rows 8800000]
    python3 scripts/torch_int8_exact_split.py --variants old new new old \
        --queries 2000 --rows 1997 --ks 150
    python3 scripts/torch_int8_exact_split.py --variants new --ks 512

The variants are timed in turn, ``--rounds`` rounds over all of them at
each k (``--ks``, default 10 and 160), so that a drift of the card's clock
spreads over every variant; a variant named twice is timed twice a round
(P, C, C, P). It prints one JSON line a variant and k (the medians of the
rounds' ms by CUDA events and of their device ms by ``torch.profiler``,
the slab plan, whether the answer equals ``old``'s,
the SM clock before and after) and the old instances' registers and stack
bytes by ``cuobjdump -res-usage``, and with ``--out PATH`` writes them to
that JSON file. ``chip_smoke.py`` builds the ``old`` variant beside the
kernels' libraries and times it in phase 4d beside the kernel that
replaced it.
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
VARIANTS = ("old", "oracle", "noconvert", "noproducts")
NEW_VARIANTS = ("new_skipall", "new_profile")
_NEW = "new"  # the library's kernel, no scratch build
# new_profile's counters (lr_ew_prof), in order
PROFILE_FIELDS = (
    "wait_first_cycles", "select_first_cycles", "wait_second_cycles",
    "append_flush_first_cycles", "select_append_second_cycles",
    "flush_second_cycles",
    "warps", "flushes", "votes_passed", "unused", "queries_offered",
    "offered_keys", "chunk_merges", "appended_keys")

# each header's C interface, its one extern "C" block, which would
# instantiate every operand kind: the scratch copies stop before it
_CUT = '\nextern "C" {\n'
_PATCHES = {
    "oracle": [
        ("    if (tid < EM_QROWS) {\n"
         "        thr[tid] = EMPTY64;\n"
         "        thr_f[tid] = EM_NEG_INF;\n",
         "    if (tid < EM_QROWS) {\n"
         "        const i64 o = tid < QB && q0 + tid < nq\n"
         "                          ? lr_split_thr[q0 + tid] : EMPTY64;\n"
         "        thr[tid] = o;\n"
         "        thr_f[tid] = o == EMPTY64 ? EM_NEG_INF : em_score(o);\n"),
        # a flush never lowers the preset threshold
        ("        const i64 t = L[tid * KP + k - 1];\n",
         "        const i64 t = fm_max(L[tid * KP + k - 1], thr[tid]);\n"),
        ("// Merge every buffer that holds entries",
         "__device__ i64 lr_split_thr[4096];\n\n"
         "// Merge every buffer that holds entries")],
    "noconvert": [(
        "                float s = INT ? fm_i2f(acc[j][e], factor) : acc[j][e];\n",
        "                float s = acc[j][e];\n"
        "                asm volatile(\"\" : \"+f\"(s));\n"
        "                if (nq >= 0) continue;\n")],
    "noproducts": [
        ("                fm_mma_s8(acc[0], afr[s], b[0], b[1]);\n",
         "                asm volatile(\"\" : \"+f\"(acc[0][0]), "
         "\"+f\"(acc[0][1]), \"+f\"(acc[0][2]), \"+f\"(acc[0][3]) : "
         "\"r\"(afr[s][0]), \"r\"(afr[s][1]), \"r\"(afr[s][2]), "
         "\"r\"(afr[s][3]), \"r\"(b[0]), \"r\"(b[1]));\n"),
        ("                fm_mma_s8(acc[1], afr[s], b[2], b[3]);\n",
         "                asm volatile(\"\" : \"+f\"(acc[1][0]), "
         "\"+f\"(acc[1][1]), \"+f\"(acc[1][2]), \"+f\"(acc[1][3]) : "
         "\"r\"(b[2]), \"r\"(b[3]));\n")],
}
# the new kernel's scratch copies, patched in exact_i8_wgmma.cuh's text
_NEW_PATCHES = {
    "new_skipall": [(
        "        if (!__any_sync(FM_FULL, r[0] >= st.thr[h])) continue;  "
        "// uniform\n",
        "        if (!__any_sync(FM_FULL, r[0] >= st.thr[h]) || n >= 0) "
        "continue;\n")],
    "new_profile": [
        ("        if (!__any_sync(FM_FULL, r[0] >= st.thr[h])) continue;  "
         "// uniform\n",
         "        const bool vote = __any_sync(FM_FULL, r[0] >= st.thr[h]);\n"
         "        if (lane == 0 && vote) atomicAdd(&ew_prof[8], 1ull);\n"
         "        if (!vote) continue;\n"),
        ("            *Bq++ = key > st.kth[h] ? key : EMPTY64;\n",
         "            if (key > st.kth[h]) atomicAdd(&ew_prof[13], 1ull);\n"
         "            *Bq++ = key > st.kth[h] ? key : EMPTY64;\n"),
        ("        if (c == 0) continue;  // uniform\n",
         "        if (c == 0) continue;  // uniform\n"
         "        if (lane == 0) {\n"
         "            atomicAdd(&ew_prof[10], 1ull);\n"
         "            atomicAdd(&ew_prof[11], (u64)c);\n"
         "        }\n"),
        ("    __syncwarp();  // the appends are in\n",
         "    __syncwarp();  // the appends are in\n"
         "    if (lane == 0) atomicAdd(&ew_prof[7], 1ull);\n"),
        ("    for (int sub = 0, t0 = row0; sub < n_sub; ++sub, t0 += TN) {\n",
         "    unsigned long long pt[6] = {0, 0, 0, 0, 0, 0};\n"
         "    for (int sub = 0, t0 = row0; sub < n_sub; ++sub, t0 += TN) {\n"
         "        const unsigned long long c0 = clock64();\n"),
        ("        fw_fence_acc(acc_a);\n"
         "        if (active) EW_SELECT(0, acc_a);\n"
         "        fw_wgmma_wait<0>();\n"
         "        fw_fence_acc(acc_b);\n"
         "        fw_release(sm, slot, lane);\n",
         "        fw_fence_acc(acc_a);\n"
         "        const unsigned long long c1 = clock64();\n"
         "        if (active) EW_SELECT(0, acc_a);\n"
         "        const unsigned long long c2 = clock64();\n"
         "        fw_wgmma_wait<0>();\n"
         "        fw_fence_acc(acc_b);\n"
         "        fw_release(sm, slot, lane);\n"
         "        const unsigned long long c3 = clock64();\n"
         "        pt[0] += c1 - c0; pt[1] += c2 - c1; pt[2] += c3 - c2;\n"),
        ("        bool flush = ew_group_any(active && EW_APPEND(0, acc_a));\n",
         "        const unsigned long long a0 = clock64();\n"
         "        bool flush = ew_group_any(active && EW_APPEND(0, acc_a));\n"
         "        pt[3] += clock64() - a0;\n"),
        ("            if (flush && active) EW_FLUSH();\n"
         "            if (half == 2) break;\n"
         "            if (active) EW_SELECT(1, acc_b);\n"
         "            flush = ew_group_any(active && EW_APPEND(1, acc_b));\n",
         "            const unsigned long long f0 = clock64();\n"
         "            if (flush && active) EW_FLUSH();\n"
         "            const unsigned long long f1 = clock64();\n"
         "            if (half == 1) pt[3] += f1 - f0;\n"
         "            else pt[5] += f1 - f0;\n"
         "            if (half == 2) break;\n"
         "            if (active) EW_SELECT(1, acc_b);\n"
         "            flush = ew_group_any(active && EW_APPEND(1, acc_b));\n"
         "            pt[4] += clock64() - f1;\n"),
        ("    if (!active) return;\n    for (int r = 0; r < 16; ++r) {",
         "    if (lane == 0) {\n"
         "        for (int i = 0; i < 6; ++i) atomicAdd(&ew_prof[i], pt[i]);\n"
         "        atomicAdd(&ew_prof[6], 1ull);\n"
         "    }\n"
         "    if (!active) return;\n    for (int r = 0; r < 16; ++r) {"),
        ("    if (np == 0) return;  // uniform\n    i64 v[E];\n",
         "    if (np == 0) return;  // uniform\n"
         "    if (lane == 0 && np > 4 * E) atomicAdd(&ew_prof[12], 1ull);\n"
         "    i64 v[E];\n"),
        ("#define EW_BUF_MAX 128",
         "__device__ unsigned long long ew_prof[16];\n"
         "extern \"C\" int lr_ew_prof(unsigned long long* out, int reset) {\n"
         "    unsigned long long z[16] = {0};\n"
         "    cudaError_t e = reset ? cudaMemcpyToSymbol(ew_prof, z, "
         "sizeof(z))\n"
         "        : cudaMemcpyFromSymbol(out, ew_prof, sizeof(z));\n"
         "    return (int)e;\n}\n\n#define EW_BUF_MAX 128")],
}
_LAUNCHER = """
extern "C" {

int lr_split_occupancy(int d, int k) {
    const int kp = em_kp(k);
    const size_t smem = em_smem_bytes(d, kp, OP_I8);
    return kp == 128 ? em_occupancy<128, OP_I8, false>(smem)
                     : em_occupancy<256, OP_I8, false>(smem);
}

// mask: the allowed rows' bits (the row-mask instances), or null
int lr_split_exact(const void* q, const void* c, const float* fac, int nq,
                   int n, int d, int k, int slab_rows, int vec,
                   const unsigned* mask, long long* part, float* out_s,
                   int* out_i, void* stream) {
    if (k < 1 || k > 256) return (int)cudaErrorInvalidValue;
    const int kp = em_kp(k);
    const size_t smem = em_smem_bytes(d, kp, OP_I8);
    cudaStream_t st = (cudaStream_t)stream;
#define LR_SPLIT(KP, M)                                                       \
    em_launch<KP, OP_I8, M>(q, c, fac, mask, nq, n, d, k, 0, slab_rows, vec,  \
                            part, out_s, out_i, smem, st)
    return kp == 128 ? (mask ? LR_SPLIT(128, true) : LR_SPLIT(128, false))
                     : (mask ? LR_SPLIT(256, true) : LR_SPLIT(256, false));
#undef LR_SPLIT
}
%(ORACLE)s
}  // extern "C"
"""
_ORACLE_SETTER = """
// the oracle variant's thresholds: the answer's k-th key less one, a query
int lr_split_set_thr(const long long* keys, int nq) {
    return (int)cudaMemcpyToSymbol(lr_split_thr, keys, sizeof(i64) * nq);
}
"""


def _patched(variant: str, body: str, patches=None) -> str:
    for old, new in (patches or _PATCHES).get(variant, []):
        if body.count(old) != 1:
            raise RuntimeError(f"{variant}: {old!r} not found once")
        body = body.replace(old, new)
    return body


def _before_c_interface(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        body = f.read()
    if body.count(_CUT) != 1:
        raise RuntimeError(f"{path}'s C interface not found once")
    return body.split(_CUT)[0]


def scratch_source(variant: str) -> str:
    """One translation unit: ``fused_topk.cu``'s prelude, ``fold_mma.cuh``
    and ``exact_mma.cuh`` without their C interfaces, the latter patched
    for ``variant``, and a C launcher of ``exact_mma_kernel<KP, OP_I8,
    MASK>`` at KP = 128 and 256."""
    csrc = os.path.join(ROOT, "latentrag_torch", "csrc")
    with open(os.path.join(csrc, "fused_topk.cu"), encoding="utf-8") as f:
        prelude = f.read().split('#include "fold_mma.cuh"')[0]
    fold = _before_c_interface(os.path.join(csrc, "fold_mma.cuh"))
    exact = _before_c_interface(os.path.join(csrc, "exact_mma.cuh"))
    if variant in NEW_VARIANTS:
        # the new kernel with its shared machinery in place of the
        # #include, with its own C interface (the fold's header is not in)
        with open(os.path.join(csrc, "exact_i8_wgmma.cuh"),
                  encoding="utf-8") as f:
            text = f.read()
        with open(os.path.join(csrc, "wgmma_i8.cuh"), encoding="utf-8") as f:
            shared = f.read()
        inc = '#include "wgmma_i8.cuh"\n'
        if text.count(inc) != 1:
            raise RuntimeError("exact_i8_wgmma.cuh's include not found once")
        return (prelude + fold + exact
                + _patched(variant, text.replace(inc, shared), _NEW_PATCHES))
    launcher = _LAUNCHER % {
        "ORACLE": _ORACLE_SETTER if variant == "oracle" else ""}
    return prelude + fold + _patched(variant, exact) + launcher


def library_path(variant: str) -> str:
    from latentrag_torch.ops import cuda_build

    text = scratch_source(variant)
    digest = hashlib.sha1((" ".join(cuda_build.NVCC_FLAGS) + text).encode())
    return os.path.join(cuda_build.BUILD_DIR, "split",
                        f"int8_exact_{variant}-{digest.hexdigest()[:12]}.so")


def start_build(variant: str):
    """Start ``nvcc`` on the variant's scratch copy (None if it is built);
    ``finish_build`` waits for it."""
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


def finish_build(started) -> None:
    if started is None:
        return
    out, tmp, proc = started
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{err[-4000:]}")
    os.replace(tmp, out)


def load(variant: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(library_path(variant))
    p, i = ctypes.c_void_p, ctypes.c_int
    if variant in NEW_VARIANTS:
        lib.lr_exact_i8_occupancy.restype = i
        lib.lr_exact_i8_occupancy.argtypes = [i, i, i]
        lib.lr_exact_i8.restype = i
        lib.lr_exact_i8.argtypes = [p, p, p] + [i] * 5 + [p] * 5
        if variant == "new_profile":
            lib.lr_ew_prof.restype = i
            lib.lr_ew_prof.argtypes = [p, i]
        return lib
    lib.lr_split_occupancy.restype = i
    lib.lr_split_occupancy.argtypes = [i, i]
    lib.lr_split_exact.restype = i
    lib.lr_split_exact.argtypes = [p, p, p] + [i] * 6 + [p] * 5
    if variant == "oracle":
        lib.lr_split_set_thr.restype = i
        lib.lr_split_set_thr.argtypes = [p, i]
    return lib


def exact_call(torch, lib, qc, c, fac, k: int, mask=None):
    """A callable that launches the variant's exact search once as the
    store's wrapper did (``fused_topk._exact_slab_rows`` over m16 query
    tiles; ``mask``: the packed row mask), and the plan (slab_rows, slabs,
    blocks an SM). ``lib`` None: the library's kernel through
    ``sq8_fused_topk_raw``, with its own plan (``exact_i8_wgmma_kernel``;
    past k = 256 ``exact_mma_kernel<KP, OP_I8>``)."""
    from latentrag_torch.ops import fused_topk as ft

    nq, d = qc.shape
    n = c.shape[0]
    dev = qc.device
    if lib is None:
        masked = mask is not None
        if k > ft.EXACT_I8_MAX_K:
            slots = ft._slots(dev.index, "exact_mma", d, k, ft._OP_I8,
                              masked)
            slab_rows = ft._exact_slab_rows(
                n, -(-nq // ft._library(masked).lr_exact_mma_queries(k)),
                slots)
            n_slabs = -(-n // slab_rows)
        else:
            slots = ft._slots(dev.index, "exact_i8", d, k, ft._OP_I8, masked)
            slab_rows, n_slabs = ft.exact_i8_slab_plan(nq, n, slots)
        return (lambda: ft.sq8_fused_topk_raw(qc, c, fac, k=k, mode="exact",
                                              mask=mask),
                {"slab_rows": slab_rows, "slabs": n_slabs,
                 "blocks_per_sm": slots // ft._sm_count(dev.index)})
    new = hasattr(lib, "lr_exact_i8")
    per_sm = (lib.lr_exact_i8_occupancy(d, k, ft._OP_I8) if new
              else lib.lr_split_occupancy(d, k))
    if per_sm <= 0:
        raise RuntimeError(f"occupancy {per_sm}")
    if new:
        slab_rows, n_slabs = ft.exact_i8_slab_plan(
            nq, n, per_sm * ft._sm_count(dev.index))
    else:
        slab_rows = ft._exact_slab_rows(n, -(-nq // 16),
                                        per_sm * ft._sm_count(dev.index))
        n_slabs = -(-n // slab_rows)
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    vec = int(d % 16 == 0 and c.data_ptr() % 16 == 0)

    def call():
        if new:
            code = lib.lr_exact_i8(
                qc.data_ptr(), c.data_ptr(), fac.data_ptr(), nq, n, d, k,
                slab_rows, mask.data_ptr() if mask is not None else None,
                part.data_ptr() if part is not None else None,
                scores.data_ptr(), ids.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if code:
                raise RuntimeError(f"lr_exact_i8 failed: code {code}")
            return scores, ids
        code = lib.lr_split_exact(
            qc.data_ptr(), c.data_ptr(), fac.data_ptr(), nq, n, d, k,
            slab_rows, vec, mask.data_ptr() if mask is not None else None,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"lr_split_exact failed: code {code}")
        return scores, ids

    return call, {"slab_rows": slab_rows, "slabs": n_slabs,
                  "blocks_per_sm": per_sm}


def phase_counts(torch, lib, call) -> dict:
    """One launch of the ``new_profile`` variant: ``PROFILE_FIELDS``, the
    cycles summed over the consumer warps and the counts."""
    buf = (ctypes.c_ulonglong * 16)()
    lib.lr_ew_prof(buf, 1)
    call()
    torch.cuda.synchronize()
    if lib.lr_ew_prof(buf, 0):
        raise RuntimeError("lr_ew_prof failed")
    return dict(zip(PROFILE_FIELDS, list(buf)))


def answer_keys(torch, s, i) -> "torch.Tensor":
    """Each query's k-th key of an answer (``monotone_i32(score) << 32 |
    INT_MAX - row``) less one, the oracle variant's thresholds."""
    from latentrag_torch.ops import fused_topk as ft

    m = ft._monotone_i32(s[:, -1]).long()
    return ((m << 32) | (2**31 - 1 - i[:, -1].long())) - 1


def resource_usage(path: str) -> dict:
    """Registers, stack and shared bytes of the scratch library's
    ``exact_mma_kernel<KP, OP_I8 = 3, false>`` at KP = 128 and 256 by
    ``cuobjdump -res-usage``."""
    from latentrag_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage", path], capture_output=True,
                         text=True, timeout=120).stdout
    res = {}
    for kp in (128, 256):
        m = re.search(rf"Function (\S*exact_mma_kernelILi{kp}ELi3ELb0E\S*):"
                      r"\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) "
                      r"LOCAL:(\d+)", out)
        if m:
            res[f"KP{kp}"] = {"registers": int(m.group(2)),
                              "stack_bytes": int(m.group(3)),
                              "shared_bytes": int(m.group(4)),
                              "local_bytes": int(m.group(5))}
    return res


def _fold_split():
    """The fold's split script, for its timing helpers."""
    path = os.path.join(ROOT, "scripts", "torch_int8_fold_split.py")
    spec = importlib.util.spec_from_file_location("torch_int8_fold_split",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=8_800_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--ks", type=int, nargs="+", default=[10, 160])
    ap.add_argument("--mask", type=float, default=None,
                    help="the share of rows allowed (old and new only)")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="a JSON file of the records")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from latentrag_torch.ops import quantization as tq
    from latentrag_torch.ops.topk import pack_row_mask

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    fs = _fold_split()
    names = list(dict.fromkeys(args.variants))  # each variant once
    scratch = [v for v in names if v != _NEW]
    started = [start_build(v) for v in scratch]
    for s in started:
        finish_build(s)
    g = torch.Generator(device="cuda").manual_seed(600)
    x = torch.nn.functional.normalize(torch.randn(
        (args.rows, args.dim), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(torch.randn(
        (args.queries, args.dim), generator=g, device="cuda"), dim=1)
    qc, qs = tq.sq8_quantize(q)
    c, cs = tq.sq8_quantize(x)
    del x
    fac = tq.score_factor(qs, cs).reshape(1).contiguous()
    mask = None
    if args.mask is not None:
        if any(v in _PATCHES for v in names):
            raise SystemExit("--mask takes the variants old and new* only")
        mask = pack_row_mask(torch.rand(args.rows, generator=g,
                                        device="cuda") < args.mask)
    card = fs.card_line()
    print(card, flush=True)
    libs = {v: (None if v == _NEW else load(v)) for v in names}
    if "old" not in libs:
        libs["old"] = load("old") if os.path.exists(library_path("old")) \
            else None
    records = []
    for k in args.ks:
        calls, rounds = {}, {v: [] for v in names}
        ref = None
        if libs.get("old") is not None:
            ref_call = exact_call(torch, libs["old"], qc, c, fac, k, mask)[0]
            s_r, i_r = ref_call()
            ref = (s_r.clone(), i_r.clone())
        for v in names:
            if v == "oracle":
                keys = answer_keys(torch, *ref).contiguous()
                code = libs[v].lr_split_set_thr(keys.data_ptr(),
                                                keys.shape[0])
                if code:
                    raise RuntimeError(f"lr_split_set_thr: code {code}")
            calls[v] = exact_call(torch, libs[v], qc, c, fac, k, mask)
        same = {}
        for v in names:
            s_v, i_v = calls[v][0]()
            torch.cuda.synchronize()
            same[v] = (ref is not None and bool(torch.equal(s_v, ref[0])
                                                and torch.equal(i_v, ref[1])))
        clock_before = fs.sm_clock()
        for _ in range(args.rounds):
            for v in args.variants:
                call = calls[v][0]
                dev = fs.device_ms(torch, call)
                rounds[v].append({
                    "ms": fs.time_ms(torch, call),
                    "device_ms": sum(t for name, t in dev.items()
                                     if "exact_mma_kernel" in name
                                     or "exact_i8_wgmma_kernel" in name),
                    "merge_ms": sum(t for name, t in dev.items()
                                    if "exact_merge_kernel" in name)})
        clock_after = fs.sm_clock()
        for v in names:
            med = {key: sorted(r[key] for r in rounds[v])[len(rounds[v]) // 2]
                   for key in ("ms", "device_ms", "merge_ms")}
            rec = {"variant": v, "Q": args.queries, "N": args.rows,
                   "d": args.dim, "k": k, "mask": args.mask, **calls[v][1],
                   **med,
                   "same_answer_as_old": same[v], "rounds": rounds[v],
                   "card": card,
                   "sm_clock_power_temp": [clock_before, clock_after]}
            if v == "old":
                rec["resources"] = resource_usage(library_path(v))
            if v == "new_profile":
                rec["phases"] = phase_counts(torch, libs[v], calls[v][0])
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
