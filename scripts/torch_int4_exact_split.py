"""Time the int4 store's exact search beside the instance it replaced.

``exact_mma_kernel<KP, OP_I4>`` (``latentrag_torch/csrc/exact_mma.cuh``,
the int4 instance of the bf16 exact search's template) served the int4
store's exact search at k <= 256 until ``exact_i8_wgmma_kernel`` took it
(``lr_exact_i4``: the int8 exact search's consumers, fed by the int4
fold's producer warpgroup, which sign-extends the nibbles into the s8
stages). This script builds scratch copies of the old instance from the
current ``exact_mma.cuh`` (the KP = 128 and 256 instances, with and
without the row mask; the header itself is never edited) and times, on
the same seeded nibbles:

* ``old``: the old instance as it served the store;
* ``old_noproducts``: the same with its products cut (the ``mma.sync``
  calls emit nothing, so every score is 0; the stage loads, the unpack
  into shared memory, ``ldmatrix``, the conversion and compare stay);
* ``new``: the library's kernel through ``sq4_fused_topk_raw``;
* ``yardstick``: the library's int8 exact search (``sq8_fused_topk_raw``)
  over the same codes unpacked to int8 (``sq4_unpack``), at the same
  plan: once a stage is sign-extended the new kernel's consumers do
  exactly this work, so the gap between ``new`` and ``yardstick`` is the
  producer's;
* ``new_skipall``, ``new_profile``: ``scripts/torch_int8_exact_split.py``'s
  scratch copies of the new kernel (every half's vote failing; clock64
  spans and counts), each launched through its ``lr_exact_i4``.

Run it from the repository's root on a machine with the card::

    python3 scripts/torch_int4_exact_split.py [--queries 1024] [--rows 8800000]
    python3 scripts/torch_int4_exact_split.py --mask 0.1 --ks 10
    python3 scripts/torch_int4_exact_split.py --queries 2000 --rows 315

The variants are timed in turn, ``--rounds`` rounds over all of them at
each k (``--ks``, default 10 and 160: the store's stage 1 at top_k 20
asks for 160); a variant named twice is timed twice a round (old, new,
new, old). It prints one JSON line a variant and k (the medians of the
rounds' ms by CUDA events and of their device ms by ``torch.profiler``,
each round's, the slab plan and blocks an SM, whether its first answer
equals the plain search's (``quantized_fused_topk_raw_reference``) bit for
bit, the SM clock before and after) and the instances' registers and
stack bytes by ``cuobjdump -res-usage``, and with ``--out
PATH`` writes them to that JSON file. ``chip_smoke.py`` builds the
``old`` variant beside the kernels' libraries and times it in phase 4d.
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
LIBRARY_VARIANTS = ("new", "yardstick")  # the library's kernels, no build
OLD_VARIANTS = ("old", "old_noproducts")  # scratch copies of the old one
NEW_VARIANTS = ("new_skipall", "new_profile")  # the int8 script's copies


def _module(name: str):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the int8 exact search's split script: its launcher of the old template
# (made an int4 one here), its products cut and its copies of the new
# kernel; the int8 fold's for the timing helpers
_I8X = _module("torch_int8_exact_split")
_FS = _module("torch_int8_fold_split")


def scratch_source(variant: str) -> str:
    """``old`` / ``old_noproducts``: ``fused_topk.cu``'s prelude,
    ``fold_mma.cuh`` and ``exact_mma.cuh`` without their C interfaces
    (``old_noproducts``: the products cut as the int8 script cuts them)
    and a C launcher of ``exact_mma_kernel<KP, OP_I4, MASK>`` at KP = 128
    and 256; ``new_<cut>``: the int8 script's scratch copy of that name."""
    if variant in NEW_VARIANTS:
        return _I8X.scratch_source(variant)
    if variant not in OLD_VARIANTS:
        raise ValueError(f"no scratch copy for {variant}")
    csrc = os.path.join(ROOT, "latentrag_torch", "csrc")
    with open(os.path.join(csrc, "fused_topk.cu"), encoding="utf-8") as f:
        prelude = f.read().split('#include "fold_mma.cuh"')[0]
    fold = _I8X._before_c_interface(os.path.join(csrc, "fold_mma.cuh"))
    exact = _I8X._before_c_interface(os.path.join(csrc, "exact_mma.cuh"))
    if variant == "old_noproducts":
        exact = _I8X._patched("noproducts", exact)
    launcher = (_I8X._LAUNCHER % {"ORACLE": ""}).replace("OP_I8", "OP_I4")
    return prelude + fold + exact + launcher


def library_path(variant: str) -> str:
    if variant in NEW_VARIANTS:
        return _I8X.library_path(variant)
    from latentrag_torch.ops import cuda_build

    text = scratch_source(variant)
    digest = hashlib.sha1((" ".join(cuda_build.NVCC_FLAGS) + text).encode())
    return os.path.join(cuda_build.BUILD_DIR, "split",
                        f"int4_exact_{variant}-{digest.hexdigest()[:12]}.so")


def start_build(variant: str):
    """Start ``nvcc`` on the variant's scratch copy (None if it is built or
    is the library's); ``finish_build`` waits for it."""
    if variant in LIBRARY_VARIANTS:
        return None
    if variant in NEW_VARIANTS:
        return _I8X.start_build(variant)
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


finish_build = _I8X.finish_build


def load(variant: str) -> ctypes.CDLL | None:
    """The variant's scratch library with its C functions declared (None
    for the library's kernels)."""
    if variant in LIBRARY_VARIANTS:
        return None
    p, i = ctypes.c_void_p, ctypes.c_int
    if variant in NEW_VARIANTS:
        lib = _I8X.load(variant)  # the profile reader where it has one
        lib.lr_exact_i4.restype = i
        lib.lr_exact_i4.argtypes = [p, p, p] + [i] * 5 + [p] * 5
        return lib
    lib = ctypes.CDLL(library_path(variant))
    lib.lr_split_occupancy.restype = i
    lib.lr_split_occupancy.argtypes = [i, i]
    lib.lr_split_exact.restype = i
    lib.lr_split_exact.argtypes = [p, p, p] + [i] * 6 + [p] * 5
    return lib


def exact_call(torch, variant, lib, qc, packed, fac, d: int, k: int,
               mask=None):
    """A callable that launches the variant's exact search once as the
    store's wrapper does, and the plan (slab_rows, slabs, blocks an SM):
    the old instance over m16 query tiles (``fused_topk._exact_slab_rows``,
    its row mask with ``mask``), the new kernel and its copies over 64-query
    tiles (``fused_topk.exact_i8_slab_plan``)."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq

    nq = qc.shape[0]
    n = packed.shape[0]
    dev = qc.device
    sms = ft._sm_count(dev.index)
    if variant in LIBRARY_VARIANTS:
        per_sm = ft._slots(dev.index, "exact_i8", d, k, ft._OP_I4,
                           mask is not None) // sms
    elif variant in NEW_VARIANTS:
        per_sm = lib.lr_exact_i8_occupancy(d, k, ft._OP_I4)
    else:
        per_sm = lib.lr_split_occupancy(d, k)
    if per_sm <= 0:
        raise RuntimeError(f"occupancy {per_sm}")
    if variant in OLD_VARIANTS:
        slab_rows = ft._exact_slab_rows(n, -(-nq // 16), per_sm * sms)
        n_slabs = -(-n // slab_rows)
    else:
        slab_rows, n_slabs = ft.exact_i8_slab_plan(nq, n, per_sm * sms)
    plan = {"slab_rows": slab_rows, "slabs": n_slabs,
            "blocks_per_sm": per_sm}
    if variant == "new":
        return (lambda: ft.sq4_fused_topk_raw(
            qc, packed, fac, d=d, k=k, mode="exact", mask=mask)), plan
    if variant == "yardstick":
        codes = tq.sq4_unpack(packed, d).contiguous()
        return (lambda: ft.sq8_fused_topk_raw(
            qc, codes, fac, k=k, mode="exact", mask=mask)), plan
    scores = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    part = (torch.empty((n_slabs, nq, k), dtype=torch.int64, device=dev)
            if n_slabs > 1 else None)
    vec = int(ft._vec(packed, d, ft._OP_I4))
    mp = mask.data_ptr() if mask is not None else None
    pp = part.data_ptr() if part is not None else None

    def call():
        st = torch.cuda.current_stream(dev).cuda_stream
        if variant in NEW_VARIANTS:
            code = lib.lr_exact_i4(
                qc.data_ptr(), packed.data_ptr(), fac.data_ptr(), nq, n, d,
                k, slab_rows, mp, pp, scores.data_ptr(), ids.data_ptr(), st)
        else:
            code = lib.lr_split_exact(
                qc.data_ptr(), packed.data_ptr(), fac.data_ptr(), nq, n, d,
                k, slab_rows, vec, mp, pp, scores.data_ptr(),
                ids.data_ptr(), st)
        if code:
            raise RuntimeError(f"{variant} failed: code {code}")
        return scores, ids

    return call, plan


def _res_usage(path: str, names: dict) -> dict:
    """Registers, stack, shared and local bytes by ``cuobjdump
    -res-usage`` of each mangled-name prefix in ``names`` (label: prefix)
    in the library at ``path``."""
    from latentrag_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage", path], capture_output=True,
                         text=True, timeout=120).stdout
    res = {}
    for label, name in names.items():
        m = re.search(r"Function (\S*" + re.escape(name) + r"\S*):\s*\n\s*"
                      r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", out)
        if m:
            res[label] = {"registers": int(m.group(2)),
                          "stack_bytes": int(m.group(3)),
                          "shared_bytes": int(m.group(4)),
                          "local_bytes": int(m.group(5))}
    return res


def resources(variant: str, masked: bool) -> dict:
    """``old``: the scratch library's ``exact_mma_kernel<KP, OP_I4 = 4,
    MASK>`` at KP 128 and 256; ``new``: the library's
    ``exact_i8_wgmma_kernel<KP, MASK, WIDE>``, its four instances of the
    flavour."""
    from latentrag_torch.ops import cuda_build
    from latentrag_torch.ops import fused_topk as ft

    m = int(masked)
    if variant == "old":
        return _res_usage(library_path("old"), {
            f"KP{kp}": f"exact_mma_kernelILi{kp}ELi4ELb{m}E"
            for kp in (128, 256)})
    return _res_usage(cuda_build.library_path(*ft.LIBRARIES[m]), {
        f"KP{kp}{'_wide' if w else ''}":
            f"exact_i8_wgmma_kernelILi{kp}ELb{m}ELb{w}E"
        for kp in (128, 256) for w in (0, 1)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=8_800_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--ks", type=int, nargs="+", default=[10, 160])
    ap.add_argument("--mask", type=float, default=None,
                    help="share of rows allowed (the row-mask instances; "
                         "old, new and yardstick only)")
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
    if args.mask is not None and not set(names) <= {"old", *LIBRARY_VARIANTS}:
        raise SystemExit("--mask takes the variants old, new and yardstick")
    for s in [start_build(v) for v in names]:
        finish_build(s)
    g = torch.Generator(device="cuda").manual_seed(800)
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
    card = _FS.card_line()
    print(card, flush=True)
    libs = {v: load(v) for v in names}
    records = []
    for k in args.ks:
        calls = {v: exact_call(torch, v, libs[v], qc, packed, fac, d, k,
                               mask) for v in names}
        # each variant's first answer, then the plain one's; the scratch
        # copies first: in a process that had loaded a scratch library but
        # launched none of its kernels, the library's exact kernels left
        # their outputs unwritten (2000 x 1997, k=160; PERF.md section 7)
        first = {}
        for v in sorted(names, key=lambda v: v in LIBRARY_VARIANTS):
            s_v, i_v = calls[v][0]()
            first[v] = (s_v.clone(), i_v.clone())
        want = ft.quantized_fused_topk_raw_reference(
            qc, packed, fac, d=d, k=k, op=ft._OP_I4, mode="exact",
            mask=mask)
        same = {v: bool(torch.equal(s_v, want[0])
                        and torch.equal(i_v, want[1]))
                for v, (s_v, i_v) in first.items()}
        rounds = {v: [] for v in names}
        clock_before = _FS.sm_clock()
        for _ in range(args.rounds):
            for v in args.variants:
                call = calls[v][0]
                dev = _FS.device_ms(torch, call)
                rounds[v].append({
                    "ms": _FS.time_ms(torch, call),
                    "device_ms": sum(t for nm, t in dev.items()
                                     if "exact_mma_kernel" in nm
                                     or "exact_i8_wgmma_kernel" in nm),
                    "merge_ms": sum(t for nm, t in dev.items()
                                    if "exact_merge_kernel" in nm)})
        clock_after = _FS.sm_clock()
        for v in names:
            med = {key: sorted(r[key] for r in rounds[v])[len(rounds[v]) // 2]
                   for key in ("ms", "device_ms", "merge_ms")}
            rec = {"variant": v, "Q": args.queries, "N": args.rows, "d": d,
                   "k": k, "mask": args.mask, **calls[v][1], **med,
                   "rounds": rounds[v], "same_answer_as_plain": same[v],
                   "card": card,
                   "sm_clock_power_temp": [clock_before, clock_after]}
            if v in ("old", "new"):
                rec["resources"] = resources(v, mask is not None)
            if v == "new_profile":
                rec["phases"] = _I8X.phase_counts(torch, libs[v],
                                                  calls[v][0])
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
