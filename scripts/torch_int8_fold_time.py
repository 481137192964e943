"""Time the int8 store's fold of one checkout of the port, on the card.

Imports ``latentrag_torch`` from ``--root`` (a checkout: this tree, or a
``git archive`` of another commit unpacked beside it), builds its kernels'
libraries there, and times ``sq8_fused_topk_raw(mode="fold")`` -- the
int8 store's search kernel, whichever kernel that checkout runs -- at the
store's plan for top_k = 10 under the msmarco config's recall_target 0.95
(``fold_plan``): Q=2000 over N=315 and 1997 (the main path's corpora), and
Q=1024 over N=8.8M (the config's corpus), unmasked and with a row mask
allowing 10 % of the rows. Inputs are seeded unit rows quantized as the
store holds them, the same in every checkout. To compare two commits, run
it on both in one call, in turns (parent, change, change, parent)::

    cd <parent> && python3 <this tree>/scripts/torch_int8_fold_time.py --root . --tag P1

Prints one JSON line a case: ms (median of CUDA-event timings of the
wrapper), host_ms (median host seconds of one wrapper call, launches
queued, not awaited), device ms a kernel (``torch.profiler``), the C
kernel that ran, the card and the build's nvcc seconds; ``--out`` appends
them to a file. Below 100,000 rows it also times the wrapper cycling over
9 copies of the inputs (``ms_9_inputs``, ``host_ms_9_inputs``): calls
whose inputs change every time, as a server's batches do.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

CASES = (  # (name, Q, N, masked)
    ("2000x315", 2000, 315, False),
    ("2000x1997", 2000, 1997, False),
    ("1024x8.8M", 1024, 8_800_000, False),
    ("2000x315 masked", 2000, 315, True),
    ("1024x8.8M masked", 1024, 8_800_000, True),
)


def _wrapper_ms(torch, calls, reps: int) -> tuple[float, float]:
    """Medians over ``reps`` calls, cycling over ``calls``: the ms between
    CUDA events around one awaited call, and the host ms of one call in a
    run of calls queued back to back."""
    times, host = [], []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        calls[i % len(calls)]()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    for i in range(reps):
        t0 = time.perf_counter()
        calls[i % len(calls)]()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2], sorted(host)[reps // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from latentrag_torch.ops import cuda_build
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq
    from latentrag_torch.ops.topk import pack_row_mask

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    assert os.path.dirname(ft.__file__).startswith(root)
    t0 = time.perf_counter()
    cuda_build.load_libraries(ft.LIBRARIES)
    build_s = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    data = {}
    for name, nq, n, masked in CASES:
        if (nq, n) not in data:
            data.clear()
            torch.cuda.empty_cache()
            g = torch.Generator(device="cuda").manual_seed(600 + n % 97)
            x = torch.nn.functional.normalize(
                torch.randn((n, 64), generator=g, device="cuda"), dim=1)
            q = torch.nn.functional.normalize(
                torch.randn((nq, 64), generator=g, device="cuda"), dim=1)
            qc, qs = tq.sq8_quantize(q)
            c, cs = tq.sq8_quantize(x)
            del x, q
            keep = torch.rand(n, generator=g, device="cuda") < 0.1
            data[(nq, n)] = (qc, c, tq.score_factor(qs, cs),
                             pack_row_mask(keep))
        qc, c, fac, words = data[(nq, n)]
        block_n, k = ft.fold_plan(n, 10, 0.95)
        mask = words if masked else None

        def call():
            return ft.sq8_fused_topk_raw(qc, c, fac, k=k, mode="fold",
                                         block_n=block_n, mask=mask)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        ran = ft.last_kernel
        ms, host_ms = _wrapper_ms(torch, [call], args.reps)
        extra = {}
        if n < 100_000:
            copies = [(qc.clone(), c.clone()) for _ in range(9)]
            calls = [functools.partial(
                ft.sq8_fused_topk_raw, q9, c9, fac, k=k, mode="fold",
                block_n=block_n, mask=mask) for q9, c9 in copies]
            for f in calls:
                f()
            extra["ms_9_inputs"], extra["host_ms_9_inputs"] = _wrapper_ms(
                torch, calls, args.reps)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        dev = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0)
            if us:
                dev[ev.key.split("(")[0]] = us / 1e3 / 5
        rec = {"tag": args.tag, "case": name, "Q": nq, "N": n, "k": k,
               "block_n": block_n, "masked": masked, "c_kernel": ran,
               "ms": ms, "host_ms": host_ms, **extra, "device_ms": dev,
               "card": card, "build_s": build_s,
               "nvcc_s": dict(cuda_build.build_seconds)}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
