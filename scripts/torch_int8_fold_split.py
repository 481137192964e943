"""Split the time of the int8 store's first fold kernel on the card.

``fold_mma_kernel<2, OP_I8>`` (``latentrag_torch/csrc/fold_mma.cuh``, the
int8 instance of the bf16 fold's template) served the int8 store until
``fold_i8_wgmma.cuh`` replaced it. This script builds scratch copies of it
from the current ``fold_mma.cuh``, each patched as text at build time (the
header itself is never edited), and times them on the same inputs:

* ``old``: the instance as it served the store;
* ``magic``: ``fm_i2f``'s ``__int2float_rn`` replaced by the exact
  magic-constant conversion (an integer add and an fp32 subtraction);
* ``onemax``: the fold cut to one max a slot (no conversion, no key);
* ``noproducts``: the products cut (the ``mma.sync`` calls emit nothing,
  the stage loads, ``ldmatrix`` and the fold stay);

and, for the kernel that replaced it, ``fold_i8_wgmma_kernel<2>`` built
the same way from the current ``fold_i8_wgmma.cuh``: as it is (``new``),
with ``__int2float_rn`` in place of the exact conversion (``new_i2f``),
with the fold cut to one max a slot (``new_onemax``), with the products
cut (``new_noproducts``: the wgmma calls emit nothing), with every
half's fold skipped (``new_skipall``), with both halves' products awaited
before the first fold (``new_wait0``), at one block an SM
(``new_1block``) and with clock64 spans (``new_profile``).

Run it from the repository's root on a machine with the card::

    python3 scripts/torch_int8_fold_split.py [--queries 1024] [--rows 8800000]

The variants are timed in turn, ``--rounds`` rounds over all of them, so
that a drift of the card's clock spreads over every variant. It prints one
JSON line a variant (the median of the rounds' ms by CUDA events and of
their device ms by ``torch.profiler``, each round's, the slab plan, the SM
clock before and after) and the old instance's registers and stack bytes
by ``cuobjdump -res-usage``, and with ``--out PATH`` writes them to that
JSON file. ``chip_smoke.py`` builds the ``old`` variant beside the
kernels' libraries and times it in phase 4d.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("old", "magic", "onemax", "noproducts")
NEW_VARIANTS = ("new", "new_i2f", "new_onemax", "new_noproducts",
                "new_profile", "new_1block", "new_skipall", "new_wait0")
E = 2  # the list of 64: the store's 40 candidates at top_k = 10

# fold_mma.cuh's C interface, the one extern "C" block, which would
# instantiate every operand kind: the scratch copies stop before it
_CUT = '\nextern "C" {\n'
_PATCHES = {
    "magic": [(
        "    return __fmul_rn(__int2float_rn(__float_as_int(acc)), factor);",
        "    return __fmul_rn(__fsub_rn(__int_as_float(__float_as_int(acc) + "
        "0x4B400000), 12582912.0f), factor);")],
    "onemax": [
        ("for (int e = 0; e < 4; ++e) acc[j][e] = fm_i2f(acc[j][e], factor);",
         "for (int e = 0; e < 4; ++e) (void)factor;"),
        (re.compile(r"(            const int col = 8 \* j \+ h;\n).*?"
                    r"(            folded\[j\]\[2 \+ h\] = max\(folded\[j\]"
                    r"\[2 \+ h\], p1\);\n)", re.S),
         "            folded[j][h] = max(folded[j][h], "
         "__float_as_int(acc[j][h]));\n"
         "            folded[j][2 + h] = max(folded[j][2 + h], "
         "__float_as_int(acc[j][2 + h]));\n")],
    "new_i2f": [("const bool magic = d <= 256;",
                 "const bool magic = false;")],
    "new_onemax": [(
        "            folded[4 * j + e] = max(folded[4 * j + e], p);",
        "            folded[4 * j + e] = max(folded[4 * j + e], a[i]);\n"
        "            (void)p;")],
    "new_noproducts": [(
        "        fw_wgmma(a, fw_desc(qa + 32 * s, CH), "
        "fw_desc(sb + 32 * s, CH),\n                 acc || s > 0);",
        "        fw_fence_acc(a);")],
    # clock64 spans of each consumer warp's phases (the waits for the
    # products, each half's epilogue) and the halves that pass the skip
    # test, summed over the warps into fw_prof (lr_fw_prof reads them)
    "new_profile": [
        ("// key64 of a lane winner",
         "__device__ unsigned long long fw_prof[8];\n"
         "extern \"C\" int lr_fw_prof(unsigned long long* out, "
         "int reset) {\n"
         "    unsigned long long z[8] = {0};\n"
         "    cudaError_t e = reset ? "
         "cudaMemcpyToSymbol(fw_prof, z, sizeof(z))\n"
         "        : cudaMemcpyFromSymbol(out, fw_prof, sizeof(z));\n"
         "    return (int)e;\n}\n\n// key64 of a lane winner"),
        ("        pass1 = __any_sync(FM_FULL, r1[0] >= thr1);",
         "        pass1 = __any_sync(FM_FULL, r1[0] >= thr1);\n"
         "        if (lane == 0) {\n"
         "            atomicAdd(&fw_prof[6], pass0 || pass1 ? 1ull : 0ull);\n"
         "            atomicAdd(&fw_prof[7], 1ull);\n        }"),
        ("    for (int sub = 0, t0 = row0; sub < n_sub; ++sub, t0 += TN) {\n",
         "    unsigned long long pt[4] = {0, 0, 0, 0};\n"
         "    for (int sub = 0, t0 = row0; sub < n_sub; ++sub, t0 += TN) {\n"
         "        const unsigned long long c0 = clock64();\n"),
        ("        FW_EPI(0, acc_a);\n        fw_wgmma_wait<0>();\n",
         "        const unsigned long long c1 = clock64();\n"
         "        FW_EPI(0, acc_a);\n"
         "        const unsigned long long c2 = clock64();\n"
         "        fw_wgmma_wait<0>();\n"),
        ("        FW_EPI(1, acc_b);\n",
         "        const unsigned long long c3 = clock64();\n"
         "        FW_EPI(1, acc_b);\n"
         "        const unsigned long long c4 = clock64();\n"
         "        pt[0] += c1 - c0; pt[1] += c2 - c1; pt[2] += c3 - c2;\n"
         "        pt[3] += c4 - c3;\n"),
        ("    if (!active) return;\n",
         "    if (lane == 0)\n"
         "        for (int i = 0; i < 4; ++i) atomicAdd(&fw_prof[i], pt[i]);\n"
         "    if (lane == 0) atomicAdd(&fw_prof[4], 1ull);\n"
         "    if (!active) return;\n")],
    # every half skips its fold (the test runs, its answer is dropped)
    "new_skipall": [(
        "        pass1 = __any_sync(FM_FULL, r1[0] >= thr1);",
        "        pass1 = __any_sync(FM_FULL, r1[0] >= thr1) && nq < 0;\n"
        "        pass0 = pass0 && nq < 0;")],
    # both halves' products awaited before the first half's fold
    "new_wait0": [("        fw_wgmma_wait<1>();\n", "        fw_wgmma_wait<0>();\n")],
    # one block an SM (the plan's two-block budget left out)
    "new_1block": [("    const size_t budgets[2] = {(size_t)(per_sm / 2 - reserved),",
                    "    const size_t budgets[2] = {(size_t)0,")],
    "noproducts": [
        ("fm_mma_s8(acc[2 * jp], afr[s], b[0], b[1]);",
         'asm volatile("" : "+f"(acc[2 * jp][0]), "+f"(acc[2 * jp][1]), '
         '"+f"(acc[2 * jp][2]), "+f"(acc[2 * jp][3]) : "r"(afr[s][0]), '
         '"r"(afr[s][1]), "r"(afr[s][2]), "r"(afr[s][3]), "r"(b[0]), '
         '"r"(b[1]));'),
        ("fm_mma_s8(acc[2 * jp + 1], afr[s], b[2], b[3]);",
         'asm volatile("" : "+f"(acc[2 * jp + 1][0]), '
         '"+f"(acc[2 * jp + 1][1]), "+f"(acc[2 * jp + 1][2]), '
         '"+f"(acc[2 * jp + 1][3]) : "r"(b[2]), "r"(b[3]));')],
}
_LAUNCHER = """
static size_t lr_split_smem(int d, int k) {
    const int n_dch = (d + fm_dch(OP_I8) - 1) / fm_dch(OP_I8);
    return (size_t)fm_nst(%(E)d, OP_I8) * fm_slot_bytes(OP_I8) +
           fm_qu_bytes(n_dch, OP_I8) + FM_TQ * 4 +
           (size_t)FM_PAIRS * 8 * FM_TSTRIDE * 4 +
           (size_t)FM_WARPS * 128 * 8 + (size_t)FM_TQ * k * 8;
}

extern "C" {

int lr_split_occupancy(int d, int k) {
    return fm_occupancy<%(E)d, OP_I8, false>(lr_split_smem(d, k));
}

int lr_split_fold(const void* q, const void* c, const float* fac, int nq,
                  int n, int d, int k, int block_n, int slab_rows, int vec,
                  long long* part, float* out_s, int* out_i, void* stream) {
    return fm_launch<%(E)d, OP_I8, false>(
        q, c, fac, nullptr, nq, n, d, k, 0, block_n, slab_rows, vec, part,
        out_s, out_i, lr_split_smem(d, k), (cudaStream_t)stream);
}

}  // extern "C"
""" % {"E": E}


def _patched(variant: str, body: str) -> str:
    for old, new in _PATCHES.get(variant, []):
        if isinstance(old, str):
            if body.count(old) != 1:
                raise RuntimeError(f"{variant}: {old!r} not found once")
            body = body.replace(old, new)
        else:
            body, hits = old.subn(lambda _m: new, body)
            if hits != 1:
                raise RuntimeError(f"{variant}: pattern found {hits} times")
    return body


def scratch_source(variant: str) -> str:
    """One translation unit: ``fused_topk.cu``'s prelude, ``fold_mma.cuh``
    without its C interface (which would instantiate every operand kind),
    then either that header patched for ``variant`` and a C launcher of
    ``fold_mma_kernel<2, OP_I8, false>``, or (``new``, ``new_i2f``)
    ``fold_i8_wgmma.cuh`` with ``wgmma_i8.cuh`` inlined, patched, with
    its own C interface."""
    csrc = os.path.join(ROOT, "latentrag_torch", "csrc")
    with open(os.path.join(csrc, "fused_topk.cu"), encoding="utf-8") as f:
        prelude = f.read().split('#include "fold_mma.cuh"')[0]
    with open(os.path.join(csrc, "fold_mma.cuh"), encoding="utf-8") as f:
        body = f.read()
    if body.count(_CUT) != 1:
        raise RuntimeError("fold_mma.cuh's C interface not found once")
    body = body.split(_CUT)[0]
    if variant in NEW_VARIANTS:
        # the fold's header with its shared machinery (wgmma_i8.cuh) in
        # place of the #include, so that a patch may reach either
        with open(os.path.join(csrc, "fold_i8_wgmma.cuh"),
                  encoding="utf-8") as f:
            text = f.read()
        with open(os.path.join(csrc, "wgmma_i8.cuh"), encoding="utf-8") as f:
            shared = f.read()
        inc = '#include "wgmma_i8.cuh"\n'
        if text.count(inc) != 1:
            raise RuntimeError("fold_i8_wgmma.cuh's include not found once")
        return prelude + body + _patched(variant, text.replace(inc, shared))
    return prelude + _patched(variant, body) + _LAUNCHER


def library_path(variant: str) -> str:
    from latentrag_torch.ops import cuda_build

    text = scratch_source(variant)
    digest = hashlib.sha1((" ".join(cuda_build.NVCC_FLAGS) + text).encode())
    return os.path.join(cuda_build.BUILD_DIR, "split",
                        f"int8_fold_{variant}-{digest.hexdigest()[:12]}.so")


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
    if variant == "new_profile":
        lib.lr_fw_prof.restype = i
        lib.lr_fw_prof.argtypes = [p, i]
    if variant in NEW_VARIANTS:
        lib.lr_fold_i8_occupancy.restype = i
        lib.lr_fold_i8_occupancy.argtypes = [i, i, i]
        lib.lr_fold_i8.restype = i
        lib.lr_fold_i8.argtypes = [p, p, p] + [i] * 6 + [p] * 5
        return lib
    lib.lr_split_occupancy.restype = i
    lib.lr_split_occupancy.argtypes = [i, i]
    lib.lr_split_fold.restype = i
    lib.lr_split_fold.argtypes = [p, p, p] + [i] * 7 + [p] * 4
    return lib


def fold_call(torch, lib, qc, c, fac, k: int, block_n: int):
    """A callable that launches the variant's fold once as the store's
    wrapper did (the slab plan of ``fused_topk.fold_slab_plan``), and the
    plan (slab_rows, slabs, blocks an SM)."""
    from latentrag_torch.ops import fused_topk as ft

    nq, d = qc.shape
    n = c.shape[0]
    dev = qc.device
    new = hasattr(lib, "lr_fold_i8")
    per_sm = (lib.lr_fold_i8_occupancy(d, k, ft._OP_I8) if new
              else lib.lr_split_occupancy(d, k))
    if per_sm <= 0:
        raise RuntimeError(f"occupancy {per_sm}")
    slab_rows, n_slabs = ft.fold_slab_plan(
        nq, n, block_n, per_sm * ft._sm_count(dev.index),
        ft._FW_TQ if new else ft._FM_TQ)
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    vec = int(d % 16 == 0 and c.data_ptr() % 16 == 0)

    def call():
        if new:
            code = lib.lr_fold_i8(
                qc.data_ptr(), c.data_ptr(), fac.data_ptr(), nq, n, d, k,
                block_n, slab_rows, None,
                part.data_ptr() if part is not None else None,
                scores.data_ptr(), ids.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if code:
                raise RuntimeError(f"lr_fold_i8 failed: code {code}")
            return scores, ids
        code = lib.lr_split_fold(
            qc.data_ptr(), c.data_ptr(), fac.data_ptr(), nq, n, d, k,
            block_n, slab_rows, vec,
            part.data_ptr() if part is not None else None,
            scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"lr_split_fold failed: code {code}")
        return scores, ids

    return call, {"slab_rows": slab_rows, "slabs": n_slabs,
                  "blocks_per_sm": per_sm}


def phase_counts(torch, lib, call) -> dict:
    """One launch of the ``new_profile`` variant: each consumer warp's
    clock cycles in the wait for a sub-tile's first half, its fold, the
    wait for the second half and its fold and flush (summed over the
    warps), the warps, and the halves that passed the skip test of all
    the halves tested."""
    buf = (ctypes.c_ulonglong * 8)()
    lib.lr_fw_prof(buf, 1)
    call()
    torch.cuda.synchronize()
    if lib.lr_fw_prof(buf, 0):
        raise RuntimeError("lr_fw_prof failed")
    v = list(buf)
    return {"wait_first_cycles": v[0], "fold_first_cycles": v[1],
            "wait_second_cycles": v[2], "fold_second_flush_cycles": v[3],
            "warps": v[4], "halves_passed": v[6], "halves_tested": v[7]}


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of single-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, reps: int = 5) -> dict:
    """Mean device ms a call of each CUDA kernel ``fn`` launches
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us:
            out[ev.key.split("(")[0]] = us / 1e3 / reps
    return out


def resource_usage(path: str) -> dict | None:
    """Registers, stack and shared bytes of the scratch library's
    ``fold_mma_kernel<2, OP_I8 = 3, false>`` by ``cuobjdump -res-usage``."""
    from latentrag_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage", path], capture_output=True,
                         text=True, timeout=120).stdout
    m = re.search(r"Function (\S*fold_mma_kernelILi2ELi3ELb0E\S*):\s*\n\s*"
                  r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", out)
    if not m:
        return None
    return {"function": m.group(1), "registers": int(m.group(2)),
            "stack_bytes": int(m.group(3)), "shared_bytes": int(m.group(4)),
            "local_bytes": int(m.group(5))}


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=8_800_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="a JSON file of the records")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    started = [start_build(v) for v in args.variants]
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
    block_n, k = ft.fold_plan(args.rows, 10, 0.95)
    card = card_line()
    print(card, flush=True)
    calls, rounds = {}, {v: [] for v in args.variants}
    for v in args.variants:
        lib = load(v)
        calls[v] = fold_call(torch, lib, qc, c, fac, k, block_n) + (lib,)
    clock_before = sm_clock()
    for _ in range(args.rounds):
        for v in args.variants:
            call = calls[v][0]
            dev = device_ms(torch, call)
            rounds[v].append({
                "ms": time_ms(torch, call),
                "device_ms": sum(t for name, t in dev.items()
                                 if "fold_mma_kernel" in name
                                 or "fold_i8_wgmma_kernel" in name),
                "merge_ms": sum(t for name, t in dev.items()
                                if "fold_merge_kernel" in name)})
    clock_after = sm_clock()
    records = []
    for v in args.variants:
        med = {key: sorted(r[key] for r in rounds[v])[len(rounds[v]) // 2]
               for key in ("ms", "device_ms", "merge_ms")}
        rec = {"variant": v, "Q": args.queries, "N": args.rows,
               "d": args.dim, "k": k, "block_n": block_n, **calls[v][1],
               **med, "rounds": rounds[v], "card": card,
               "sm_clock_power_temp": [clock_before, clock_after]}
        if v == "old":
            rec["resources"] = resource_usage(library_path(v))
        if v == "new_profile":
            rec["phases"] = phase_counts(torch, calls[v][2], calls[v][0])
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
