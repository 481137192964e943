"""Split the time of the int stores' old exact search past k = 256, and
time the kernel that replaced it, on the card.

``exact_mma_kernel<KP, OP_I8>`` / ``<KP, OP_I4>`` at KP = 512, 1024 and
2048 (``latentrag_torch/csrc/exact_mma.cuh``, the int instances of the
bf16 exact search's template) served the int8 and int4 stores' exact
search at 256 < k <= 2048 until ``exact_i8_select_kernel``
(``csrc/exact_i8_select.cuh``: a sampled threshold, one TMA + wgmma buffer
pass over 64 queries, a sort) replaced it. This script builds scratch
copies of the old instances from the current ``exact_mma.cuh`` (with and
without the row mask; the header itself is never edited), each patched as
text at build time with ``scripts/torch_int8_exact_split.py``'s cuts, and
times, on the same seeded codes (``--store int8``) or nibbles (``int4``):

* ``old``: the instance as it served the store;
* ``oracle``: the flushes cut (every query's threshold starts at the
  answer's k-th key, less one);
* ``noconvert``: the conversion and compare cut (nothing is appended);
* ``noproducts``: the products cut (every score 0);
* ``new``: the library's kernel through ``sq8_fused_topk_raw`` /
  ``sq4_fused_topk_raw(mode="exact")``;
* ``new_m120``: the same with the sample's rank capped at 120 in place of
  256 (``fused_topk.quantized_select_plan`` replaced for the call): a
  sample of 1/32-1/40 of the rows, whose search (``exact_i8_wgmma_kernel``
  at k <= 120) runs two blocks an SM;
* ``yardstick`` (int4 only): the library's int8 search over the same codes
  unpacked to int8: the gap to ``new`` is the int4 producer's.

Run it from the repository's root on a machine with the card::

    python3 scripts/torch_int_exact_select_split.py [--store int8] \\
        [--ks 320 512 1024 2048] [--queries 1024 --rows 8800000]
    python3 scripts/torch_int_exact_select_split.py --store int4 \\
        --variants old new new old yardstick --mask 0.1 --ks 512

The variants are timed in turn, ``--rounds`` rounds over all of them at
each k, a variant named twice timed twice a round (P, C, C, P). Every
scratch copy launches once before the library's kernels in the process:
a process whose library kernels ran before any scratch kernel got their
outputs back unwritten (PERF.md section 7). It prints one JSON line a
variant and k: the medians of the rounds' ms by CUDA events and of their
device ms by ``torch.profiler`` (the call's kernels summed, and by name),
the plan (slabs, blocks an SM; ``new``: the select's route, sample stride
and rank, capacity and fallbacks), whether its first answer equals the
plain search's bit for bit, the SM clock before and after; and with
``--out PATH`` writes them to that JSON file. ``chip_smoke.py`` builds the
``old`` copies beside the kernels' libraries and times them in phase 4d.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("old", "oracle", "noconvert", "noproducts")  # scratch copies
# the library's kernels, no build
LIBRARY_VARIANTS = ("new", "new_m120", "yardstick")
STORES = {"int8": "OP_I8", "int4": "OP_I4"}


def _module(name: str):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the int8 exact search's split script (its cuts and the oracle's
# thresholds), the int8 fold's (the timing helpers)
_I8X = _module("torch_int8_exact_split")
_FS = _module("torch_int8_fold_split")

_LAUNCHER = """
extern "C" {

// queries a block of the m16 tile carries at k
int lr_split_queries(int k) { return em_qb(em_kp(k)); }

int lr_split_occupancy(int d, int k) {
    const int kp = em_kp(k);
    const size_t smem = em_smem_bytes(d, kp, %(OP)s);
    return kp == 512    ? em_occupancy<512, %(OP)s, false>(smem)
           : kp == 1024 ? em_occupancy<1024, %(OP)s, false>(smem)
                        : em_occupancy<2048, %(OP)s, false>(smem);
}

// mask: the allowed rows' bits (the row-mask instances), or null
int lr_split_exact(const void* q, const void* c, const float* fac, int nq,
                   int n, int d, int k, int slab_rows, int vec,
                   const unsigned* mask, long long* part, float* out_s,
                   int* out_i, void* stream) {
    if (k <= 256 || k > 2048) return (int)cudaErrorInvalidValue;
    const int kp = em_kp(k);
    const size_t smem = em_smem_bytes(d, kp, %(OP)s);
    cudaStream_t st = (cudaStream_t)stream;
#define LR_SPLIT(KP, M)                                                       \\
    em_launch<KP, %(OP)s, M>(q, c, fac, mask, nq, n, d, k, 0, slab_rows,     \\
                             vec, part, out_s, out_i, smem, st)
#define LR_SPLIT_KP(M)                                                        \\
    (kp == 512 ? LR_SPLIT(512, M)                                             \\
               : kp == 1024 ? LR_SPLIT(1024, M) : LR_SPLIT(2048, M))
    return mask ? LR_SPLIT_KP(true) : LR_SPLIT_KP(false);
#undef LR_SPLIT_KP
#undef LR_SPLIT
}
%(ORACLE)s
}  // extern "C"
"""


def scratch_source(variant: str, store: str = "int8") -> str:
    """One translation unit: ``fused_topk.cu``'s prelude, ``fold_mma.cuh``
    and ``exact_mma.cuh`` without their C interfaces, the latter patched
    for ``variant`` (the int8 split script's cuts), and a C launcher of
    ``exact_mma_kernel<KP, OP, MASK>`` at KP = 512, 1024 and 2048 for the
    store's operand kind."""
    if variant not in VARIANTS:
        raise ValueError(f"no scratch copy for {variant}")
    csrc = os.path.join(ROOT, "latentrag_torch", "csrc")
    with open(os.path.join(csrc, "fused_topk.cu"), encoding="utf-8") as f:
        prelude = f.read().split('#include "fold_mma.cuh"')[0]
    fold = _I8X._before_c_interface(os.path.join(csrc, "fold_mma.cuh"))
    exact = _I8X._before_c_interface(os.path.join(csrc, "exact_mma.cuh"))
    launcher = _LAUNCHER % {
        "OP": STORES[store],
        "ORACLE": _I8X._ORACLE_SETTER if variant == "oracle" else ""}
    return prelude + fold + _I8X._patched(variant, exact) + launcher


def library_path(variant: str, store: str = "int8") -> str:
    from latentrag_torch.ops import cuda_build

    text = scratch_source(variant, store)
    digest = hashlib.sha1((" ".join(cuda_build.NVCC_FLAGS) + text).encode())
    return os.path.join(
        cuda_build.BUILD_DIR, "split",
        f"{store}_exact_select_{variant}-{digest.hexdigest()[:12]}.so")


def start_build(variant: str, store: str = "int8"):
    """Start ``nvcc`` on the variant's scratch copy (None if it is built or
    is the library's); ``finish_build`` waits for it."""
    from latentrag_torch.ops import cuda_build

    if variant in LIBRARY_VARIANTS:
        return None
    out = library_path(variant, store)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    src = out[:-3] + ".cu"
    with open(src, "w", encoding="utf-8") as f:
        f.write(scratch_source(variant, store))
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
         os.path.join(ROOT, "latentrag_torch", "csrc"), "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


finish_build = _I8X.finish_build


def load(variant: str, store: str = "int8") -> ctypes.CDLL | None:
    """The variant's scratch library with its C functions declared (None
    for the library's kernels)."""
    if variant in LIBRARY_VARIANTS:
        return None
    lib = ctypes.CDLL(library_path(variant, store))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lr_split_queries.restype = i
    lib.lr_split_queries.argtypes = [i]
    lib.lr_split_occupancy.restype = i
    lib.lr_split_occupancy.argtypes = [i, i]
    lib.lr_split_exact.restype = i
    lib.lr_split_exact.argtypes = [p, p, p] + [i] * 6 + [p] * 5
    if variant == "oracle":
        lib.lr_split_set_thr.restype = i
        lib.lr_split_set_thr.argtypes = [p, i]
    return lib


def _plan_m120(nq: int, n: int, k: int) -> tuple[str, int, int, int]:
    """``fused_topk.quantized_select_plan`` with the sample's rank at most
    120: s = ceil(T / 120), m = ceil(T / s)."""
    from latentrag_torch.ops import fused_topk as ft

    route, _, _, cap = ft._buffer_plan(nq, n, k, ft._EI_CAPACITY)
    if route != "sampled":
        return route, 0, 0, cap
    target = (9 * k + 7 * cap) // 16
    stride = -(-target // 120)
    return route, stride, -(-target // stride), cap


def exact_call(torch, variant, lib, qc, c, fac, d: int, k: int, store: str,
               mask=None, rows=None):
    """A callable that launches the variant's exact search once, and its
    plan: the old instance (and its cuts) over its m16 tiles of
    ``lr_split_queries`` queries in ``fused_topk._exact_slab_rows``'s slabs,
    as the store's wrapper ran it; ``new`` the library's route (its plan
    read after the call: ``fused_topk.last_select`` and the blocks an SM of
    the buffer pass); ``yardstick`` the int8 route over ``rows``, the int4
    codes unpacked."""
    from latentrag_torch.ops import fused_topk as ft

    nq = qc.shape[0]
    n = c.shape[0]
    dev = qc.device
    sms = ft._sm_count(dev.index)
    if variant in LIBRARY_VARIANTS:
        if variant != "yardstick" and store == "int4":
            search = lambda: ft.sq4_fused_topk_raw(  # noqa: E731
                qc, c, fac, d=d, k=k, mode="exact", mask=mask)
        else:
            codes = rows if variant == "yardstick" else c
            search = lambda: ft.sq8_fused_topk_raw(  # noqa: E731
                qc, codes, fac, k=k, mode="exact", mask=mask)
        if variant != "new_m120":
            call = search
        else:
            def call():
                plan = ft.quantized_select_plan
                ft.quantized_select_plan = _plan_m120
                try:
                    return search()
                finally:
                    ft.quantized_select_plan = plan

        per_sm = ft._slots(dev.index, "exact_i8_select", d, k, ft._OP_I8,
                           mask is not None) // sms
        return call, {"blocks_per_sm": per_sm,
                      "slabs": ft.exact_i8_slab_plan(nq, n, per_sm * sms)[1]}
    per_sm = lib.lr_split_occupancy(d, k)
    if per_sm <= 0:
        raise RuntimeError(f"occupancy {per_sm}")
    slab_rows = ft._exact_slab_rows(n, -(-nq // lib.lr_split_queries(k)),
                                    per_sm * sms)
    n_slabs = -(-n // slab_rows)
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    vec = int(ft._vec(c, d, op))
    mp = mask.data_ptr() if mask is not None else None
    pp = part.data_ptr() if part is not None else None

    def call():
        code = lib.lr_split_exact(
            qc.data_ptr(), c.data_ptr(), fac.data_ptr(), nq, n, d, k,
            slab_rows, vec, mp, pp, scores.data_ptr(), ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"{variant} failed: code {code}")
        return scores, ids

    return call, {"slab_rows": slab_rows, "slabs": n_slabs,
                  "blocks_per_sm": per_sm,
                  "queries_per_block": lib.lr_split_queries(k)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", choices=sorted(STORES), default="int8")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=8_800_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--ks", type=int, nargs="+",
                    default=[320, 512, 1024, 2048])
    ap.add_argument("--mask", type=float, default=None,
                    help="the share of rows allowed (old, new, yardstick)")
    ap.add_argument("--variants", nargs="+",
                    default=["old", "new", "new", "old"])
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
    store = args.store
    names = list(dict.fromkeys(args.variants))
    if args.mask is not None and not set(names) <= {"old",
                                                    *LIBRARY_VARIANTS}:
        raise SystemExit("--mask takes the variants old, new and yardstick")
    if "yardstick" in names and store != "int4":
        raise SystemExit("the yardstick is the int4 store's")
    for s in [start_build(v, store) for v in names]:
        finish_build(s)
    g = torch.Generator(device="cuda").manual_seed(
        900 if store == "int8" else 901)
    d = args.dim
    x = torch.nn.functional.normalize(torch.randn(
        (args.rows, d), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(torch.randn(
        (args.queries, d), generator=g, device="cuda"), dim=1)
    qc, qs = tq.sq8_quantize(q)
    c, cs = tq.sq8_quantize(x) if store == "int8" else tq.sq4_quantize(x)
    del x
    fac = tq.score_factor(qs, cs).reshape(1).contiguous()
    rows = (tq.sq4_unpack(c, d).contiguous() if "yardstick" in names
            else None)
    mask = (pack_row_mask(torch.rand(args.rows, generator=g, device="cuda")
                          < args.mask) if args.mask is not None else None)
    card = _FS.card_line()
    print(card, flush=True)
    libs = {v: load(v, store) for v in names}
    op = ft._OP_I8 if store == "int8" else ft._OP_I4
    records = []
    for k in args.ks:
        calls = {v: exact_call(torch, v, libs[v], qc, c, fac, d, k, store,
                               mask, rows) for v in names}
        # the scratch copies' first answers before the library's kernels
        first = {}
        for v in sorted(names, key=lambda v: (v in LIBRARY_VARIANTS,
                                              v != "old")):
            if v == "oracle":
                keys = _I8X.answer_keys(torch, *first["old"]).contiguous()
                code = libs[v].lr_split_set_thr(keys.data_ptr(),
                                                keys.shape[0])
                if code:
                    raise RuntimeError(f"lr_split_set_thr: code {code}")
            s_v, i_v = calls[v][0]()
            first[v] = (s_v.clone(), i_v.clone())
            if v.startswith("new"):
                calls[v][1].update(select=dict(ft.last_select),
                                   fallbacks=ft.select_fallbacks(),
                                   c_kernel=ft.last_kernel)
        want = ft.quantized_fused_topk_raw_reference(
            qc, c, fac, d=d, k=k, op=op, mode="exact", mask=mask)
        same = {v: bool(torch.equal(s_v, want[0])
                        and torch.equal(i_v, want[1]))
                for v, (s_v, i_v) in first.items()}
        rounds = {v: [] for v in names}
        clock_before = _FS.sm_clock()
        for _ in range(args.rounds):
            for v in args.variants:
                call = calls[v][0]
                dev = _FS.device_ms(torch, call)
                rounds[v].append({"ms": _FS.time_ms(torch, call, reps=10),
                                  "device_ms": sum(dev.values()),
                                  "device_split": dev})
        clock_after = _FS.sm_clock()
        for v in names:
            med = {key: sorted(r[key] for r in rounds[v])[len(rounds[v]) // 2]
                   for key in ("ms", "device_ms")}
            rec = {"variant": v, "store": store, "Q": args.queries,
                   "N": args.rows, "d": d, "k": k, "mask": args.mask,
                   **calls[v][1], **med, "rounds": rounds[v],
                   "same_answer_as_plain": same[v], "card": card,
                   "sm_clock_power_temp": [clock_before, clock_after]}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
