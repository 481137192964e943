#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``latentrag_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``latentrag_torch/csrc``, then:

1. prints the card's name and power limit (``nvidia-smi``) and the build
   times of the kernels (nvcc) and of the C++ tokenizer's library (g++);
2. holds each kernel against its plain PyTorch version on the card: exact
   and fold modes x cosine, euclidean, whitened mahalanobis x bf16 and fp32
   stores, at the reference config (Q=2000, N=315, d=64, k=10), at
   Q=1024, N=1,000,000, d=64, k=10, at a ragged Q=37, N=5003, d=384 with
   k in {1, 64, 128}, and exact mode at k=300, the fold as the main
   path plans it (Q=2000, N=2000, 128-row tiles, 40 candidates), and exact
   mode at the main path's top_k=150 shape (Q=2000, N=1997, k=150); each
   check also holds that the C kernel that ran is the one the store's
   dtype routes to (bf16: fold_mma_kernel and exact_mma_kernel, fp32:
   their 3xTF32 instances fold_mma_kernel<f32> and exact_mma_kernel<f32>);
   and, past the exact kernel's lists (k > 2048) the exact select
   (``exact_select_kernel``, ``<f32>`` for fp32 stores) at Q=37, N=5003,
   d=384, k in {2049, 3000, 5003} over the three metrics, and at Q=1024,
   N=1M, d=64, k=4096, cosine; at each, the route the plan picks
   (``ft.last_select``: a sampled threshold and one buffer pass, or every
   row into the buffer where N <= C) equal bit for bit to the radix route
   (``route="radix"``), with the queries that fell back
   (``ft.select_fallbacks()``) recorded; then, at Q=64, N=1M, k=3000,
   corpora on which the sampled threshold fails (its rows the best of
   half the queries; rows that tie by the thousand), whose queries fall
   back to the radix passes and are held to the plain version;
2b. holds the binary fold kernel (tensor cores, ``fold_mma_kernel<bin>``)
   against its plain version: the reference and 1M shapes at d=64 and the
   ragged shape at d=384 and d=48 (pad bits), and the binary main path's
   own (Q=2000, N=1997, d=64), k in {10, 80, 128}, at block_n 4096 and at
   ``fold_plan``'s width; then the exact binary kernel
   (``exact_mma_kernel<bin>``, past 128 candidates) against ``binary_topk``
   at k from 129 to 2048, at the main path's shape at its k=160; each
   check holds which C kernel ran;
3. drives the main path through ``latentrag_torch.main.main`` at the full
   MiniLM-L6 width in bf16 with a seeded 384->512->64 VAE: synthetic data,
   2000 queries, a bf16 cosine store, top_k=10, kernel=auto; checks that the
   fold kernel served the search and the self-check and the exact kernel
   did not launch, and that the C++ WordPiece encoded every row (the
   corpus is ASCII), times the tokenizer's C++ and Python paths on the
   corpus (ids and masks must be identical), runs it once more in the same process (its search time
   warm), then runs the same pipeline with kernel=xla_exact (matmul +
   torch.topk, the oracle) and compares (recording, where their docs
   differ, the score gaps at those slots); then both again at top_k=150,
   whose search the bf16 exact kernel serves (the instance phase 2 checked
   at that shape); then all of it again over an fp32 store
   (``retrieval.store_dtype=float32``), whose fold and exact kernels are
   the 3xTF32 instances;
3b. drives the same entry point with ``retrieval.store_dtype=binary`` and
   checks that the binary kernel launched (self-check and search); on the
   same latents, the cascade with the kernel as stage 1 and with its plain
   version at the same plan must retrieve the same docs; then again at
   ``retrieval.top_k=20``, whose 160 candidates the exact binary kernel
   serves;
3c. builds a binary ``DenseRetriever`` over 1M seeded unit vectors (d=64),
   searches 1024 queries at k=10, and holds the same kernel-vs-plain
   agreement; Recall@10 against exact fp32 search is reported; then at
   top_k=300, whose 2400 candidates take the blocked route;
3d. builds a ``DenseRetriever(backend="pallas_exact")`` over 1M seeded unit
   rows (d=64), bf16 and then fp32, and searches 1024 queries at k=3000:
   the exact select (its sampled route) must serve it and agree with
   ``xla_exact``;
4. times each kernel, its plain version and torch.matmul + torch.topk at
   the kernel call's k (a yardstick the port never calls) with CUDA
   events, beside the bound, at the reference, the main path's own
   (Q=2000, N=1997, bf16 fold only) and the 1M shapes, over bf16 and fp32
   stores; the exact kernel at k=10 and k=160, and at 1M the exact select
   at k=3000 beside the blocked route and the radix route (the earlier
   design) at that k, each with its device split; each record names the C
   kernels that ran and has a profiler device split and the kernel's
   resident blocks an SM;
4b. the same for the binary fold kernel at the reference and 1M shapes
   (the yardstick reads the corpus pre-unpacked to +-1 bf16, 16x the
   bytes) with a profiler device split, the exact binary kernel at k=160
   there (split too), the blocked route at 2400 candidates over 1M, and
   the fold kernel alone over 100M packed rows;
5. prints a ``kernels`` JSON line and, last, the device line.

Every check that fails exits non-zero. Without CUDA, or without the
package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# the card's fastest rates for the work at each store's accuracy: dense bf16
# tensor cores; for fp32 stores 3xTF32 on the tensor cores, three TF32
# products (495 TFLOP/s dense) for each fp32-accurate one, which beats the
# 67 TFLOP/s of fp32 FMAs, so every fp32 kernel is held to that bound
PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3}

# tolerances of the kernel-vs-plain checks
EXACT_ID_MATCH = 0.999
EXACT_SCORE_ATOL, EXACT_SCORE_RTOL = 1e-4, 1e-5  # fp32 sums in another order
FOLD_ID_MATCH = 0.99
# candidate recall of the fold against exact, held at k=10 (the fold's
# contract case); at k=64/128 over two 4096-row tiles the 128 lanes per
# tile cannot hold the winners (the TPU fold has the same property), so
# there it is reported only
FOLD_RECALL = 0.95
MAIN_DOC_AGREE = 0.98
MAIN_METRIC_TOL = 0.01
# binary kernel vs its plain version: fold keys are 19-bit, so a sum in
# another order can move a score across one key step; rescored sign-dots
# are sums of +-bf16 values in fp32
BIN_ID_MATCH = 0.99
BIN_SCORE_ATOL, BIN_SCORE_RTOL = 1e-5, 1e-6
BIN_RECALL = 0.95  # candidate recall vs the exact sign-dot top-k, at k=10
BIN_DOC_AGREE = 0.99  # cascade with kernel vs plain stage 1, same plan
BIN_METRIC_TOL = 0.01
# k of the exact binary checks per shape (above the fold's 128; 2048 is
# the kernel's limit and clips to N=315 on the reference shape)
BIN_EXACT_KS = {"reference": (160, 2048), "1m": (160,),
                "ragged": (129, 300, 2048), "main_plan": (160,)}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def record(kind: str, **fields) -> None:
    print(json.dumps({"record": kind, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_case(torch, metric, dtype, nq, n, d, seed):
    """Prepared (queries, corpus) for ``metric`` in ``dtype`` on the card,
    from a seeded generator; mahalanobis corpora are anisotropic."""
    from latentrag_torch.ops.distances import (
        estimate_covariance, prepare_for_metric, whitening_factor,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((nq, d), generator=g, device="cuda")
    c = torch.randn((n, d), generator=g, device="cuda")
    w = None
    if metric == "mahalanobis":
        scale = torch.linspace(0.2, 5.0, d, device="cuda")
        q, c = q * scale, c * scale
        w = whitening_factor(estimate_covariance(c))
    q = prepare_for_metric(q, metric, w).to(dtype).contiguous()
    c = prepare_for_metric(c, metric, w).to(dtype).contiguous()
    return q, c


def check_kernels(torch, failures: list) -> dict:
    """Phase 2: every kernel against its plain version on the card."""
    from latentrag_torch.ops import fused_topk as ft

    worst = {"fold": 0.0, "exact": 0.0, "fold_fp32": 0.0, "exact_fp32": 0.0,
             "exact_select": 0.0, "exact_select_fp32": 0.0}
    # (label, Q, N, d, ks, fold tile width, metrics); "main_plan" is the
    # fold as the main path's approximate route runs it (ft.fold_plan at
    # N=2000, k=10), "main_exact" the exact kernel as the main path at
    # top_k=150 runs it (2000 queries over its 1997 unique contexts);
    # "exact_k_large" and "1m_k4096" the radix select past k = 2048
    metrics = ("cosine", "euclidean", "mahalanobis")
    shapes = [
        ("reference", 2000, 315, 64, [10], 4096, metrics),
        ("1m", 1024, 1_000_000, 64, [10], 4096, metrics),
        ("ragged", 37, 5003, 384, [1, 64, 128], 4096, metrics),
        ("exact_k300", 37, 5003, 384, [300], 4096, metrics),
        ("main_plan", 2000, 2000, 64, [40], 128, metrics),
        ("main_exact", 2000, 1997, 64, [150], 4096, metrics),
        ("exact_k_large", 37, 5003, 384, [2049, 3000, 5003], 4096, metrics),
        ("1m_k4096", 1024, 1_000_000, 64, [4096], 4096, ("cosine",)),
    ]
    seed = 0
    for label, nq, n, d, ks, block_n, shape_metrics in shapes:
        for metric in shape_metrics:
            for dname in ("bfloat16", "float32"):
                dtype = getattr(torch, dname)
                seed += 1
                q, c = make_case(torch, metric, dtype, nq, n, d, seed)
                for k in ks:
                    modes = ["exact"] if k > ft.FOLD_MAX_K else ["exact", "fold"]
                    ref_exact = ft.fused_topk_raw_reference(
                        q, c, k=k, metric=metric, mode="exact")
                    for mode in modes:
                        s_k, i_k = ft.fused_topk_raw(
                            q, c, k=k, metric=metric, mode=mode,
                            block_n=block_n)
                        torch.cuda.synchronize()
                        ran = ft.last_kernel
                        s_p, i_p = (ref_exact if mode == "exact" else
                                    ft.fused_topk_raw_reference(
                                        q, c, k=k, metric=metric, mode=mode,
                                        block_n=block_n))
                        same = i_k == i_p
                        id_match = same.float().mean().item()
                        if mode == "fold":  # compare exact rescored scores
                            s_k, i_k = ft.rescore_candidates(q, c, i_k, metric)
                            s_p, i_p = ft.rescore_candidates(q, c, i_p, metric)
                        err = (s_k - s_p).abs()[i_k == i_p]
                        max_err = err.max().item() if err.numel() else 0.0
                        rec = {"shape": label, "metric": metric,
                               "store": dname, "mode": mode, "k": k,
                               "block_n": block_n, "c_kernel": ran,
                               "id_match": id_match, "max_abs_err": max_err}
                        # each store runs its instance of the tensor-core
                        # kernels: bf16, or fp32 in 3xTF32; exact mode past
                        # the lists' 2048 the radix select
                        select = mode == "exact" and min(k, n) > ft.EXACT_MAX_K
                        want = ("exact_select_kernel" if select
                                else f"{mode}_mma_kernel") + (
                            "<f32>" if dname == "float32" else "")
                        ok = ran.split("+")[0] == want
                        if mode == "exact" and label == "1m_k4096":
                            # ranks 1-4096 of 1M scores lie ~1e-5 apart,
                            # so two fp32 sum orders swap neighbours that
                            # differ in the last bits: the slot-by-slot id
                            # match is reported; held are the id sets and
                            # every slot's score (the j-th best of each)
                            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
                            rec["set_match"] = set_match(torch, i_k, i_p)
                            slot_err = (s_k - s_p).abs()
                            rec["slot_max_abs_err"] = slot_err.max().item()
                            ok = ok and bool((slot_err <= tol).all()) and (
                                rec["set_match"] >= EXACT_ID_MATCH)
                        elif mode == "exact":
                            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
                            within = bool(((s_k - s_p).abs() <= tol)[same].all())
                            ok = ok and id_match >= EXACT_ID_MATCH and within
                        else:
                            ex = ref_exact[1]
                            hits = (i_k[:, :, None] == ex[:, None, :]).any(-1)
                            recall = hits.float().mean().item()
                            rec["recall_vs_exact"] = recall
                            ok = ok and id_match >= FOLD_ID_MATCH and (
                                k != 10 or recall >= FOLD_RECALL)
                        if select:  # the plan's route against the radix route
                            rec["route"] = ft.last_select["route"]
                            rec["fallbacks"] = ft.select_fallbacks()
                            s_r, i_r = select_route(ft, q, c, k, metric, "radix")
                            rec["same_as_radix"] = torch.equal(i_k, i_r) and (
                                torch.equal(s_k.view(torch.int32),
                                            s_r.view(torch.int32)))
                            ok = ok and rec["same_as_radix"]
                        key = ("exact_select" if select else mode) + (
                            "_fp32" if dname == "float32" else "")
                        worst[key] = max(worst[key], max_err)
                        if (label, metric) == ("main_exact", "cosine"):
                            worst[f"main_exact_kernel_{dname}"] = ran
                        rec["ok"] = ok
                        record("kernel_check", **rec)
                        if not ok:
                            failures.append(f"kernel check {rec}")
                del q, c
                torch.cuda.empty_cache()
    return worst


def select_route(ft, q, c, k, metric, route):
    """``fused_topk_raw(mode="exact")`` past 2048 on the exact select's
    private ``route`` (``"radix"``: the radix select for every query)."""
    return ft._fused_topk_raw_cuda(q, c, None, k,
                                   ft._metric_kind(metric) == "euclidean",
                                   "exact", 4096, route=route)


def check_select_fallbacks(torch, failures: list) -> None:
    """Phase 2, the exact select's fallback: at Q=64, N=1M, d=64, k=3000,
    corpora on which the sampled threshold fails. "overshoot": the sampled
    rows (every s-th, s from the plan) are the best rows of the even
    queries, whose thresholds pass fewer than k keys, and score like any
    row for the odd ones; "ties": every row one of 40 vectors, so more
    than C keys share the threshold's score. The plain version holds the
    answer (the 1M limits of phase 2), the radix route holds it bit for
    bit, and the device's fallback count must be the queries built to
    fall back."""
    from latentrag_torch.ops import fused_topk as ft

    nq, n, d, k = 64, 1_000_000, 64, 3000
    for case in ("overshoot", "ties"):
        for dname in ("bfloat16", "float32"):
            g = torch.Generator(device="cuda").manual_seed(61)
            q = torch.randn((nq, d), generator=g, device="cuda")
            if case == "ties":
                base = torch.randn((40, d), generator=g, device="cuda")
                pick = torch.randint(0, 40, (n,), generator=g, device="cuda")
                c, fall = base[pick], nq
            else:
                c = torch.randn((n, d), generator=g, device="cuda")
                c[:, 0] = 0.0
                c[::ft._select_plan(nq, n, k)[1], 0] = 20.0
                q[:, 0] = 0.0
                q[::2, 0] = 1.0
                fall = nq // 2
            dtype = getattr(torch, dname)
            q, c = q.to(dtype).contiguous(), c.to(dtype).contiguous()
            s_k, i_k = ft.fused_topk_raw(q, c, k=k, mode="exact")
            torch.cuda.synchronize()
            rec = {"case": case, "store": dname, "Q": nq, "N": n, "d": d,
                   "k": k, "c_kernel": ft.last_kernel, **ft.last_select,
                   "fallbacks": ft.select_fallbacks(), "want_fallbacks": fall}
            s_p, i_p = ft.fused_topk_raw_reference(q, c, k=k, mode="exact")
            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
            slot_err = (s_k - s_p).abs()
            rec["slot_id_match"] = (i_k == i_p).float().mean().item()
            rec["set_match"] = set_match(torch, i_k, i_p)
            rec["slot_max_abs_err"] = slot_err.max().item()
            s_r, i_r = select_route(ft, q, c, k, "cosine", "radix")
            rec["same_as_radix"] = torch.equal(i_k, i_r) and torch.equal(
                s_k.view(torch.int32), s_r.view(torch.int32))
            rec["ok"] = (rec["route"] == "sampled" and rec["fallbacks"] == fall
                         and rec["same_as_radix"]
                         and rec["set_match"] >= EXACT_ID_MATCH
                         and bool((slot_err <= tol).all()))
            record("select_fallback_check", **rec)
            if not rec["ok"]:
                failures.append(f"exact select fallback check {rec}")
            del q, c, s_k, i_k, s_p, i_p, s_r, i_r
            torch.cuda.empty_cache()


def set_match(torch, got, want) -> float:
    """Share of the ids of ``want`` [Q, k] found in the same row of
    ``got``."""
    n = int(max(got.max().item(), want.max().item())) + 1
    off = torch.arange(got.shape[0], device=got.device)[:, None] * n
    return torch.isin(want.long() + off, got.long() + off).float().mean().item()


def check_exact_select_store(torch, failures: list, store: str) -> int:
    """Phase 3d: ``DenseRetriever(backend="pallas_exact")`` over 1M seeded
    unit rows (d=64) in a ``store`` store searched at Q=1024, k=3000, past
    the exact kernel's lists: the radix select must serve the search, and
    its ids agree with the ``xla_exact`` oracle's on the same store.
    Returns the search's launches of the exact entry."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.retrieval import DenseRetriever

    n, nq, d, k = 1_000_000, 1024, 64, 3000
    g = torch.Generator(device="cuda").manual_seed(41)
    x = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((nq, d), generator=g, device="cuda"), dim=1)
    r = DenseRetriever(backend="pallas_exact", store_dtype=store,
                       device="cuda")
    r.build(x, [""] * n)
    torch.cuda.synchronize()
    ft.reset_launches()
    t0 = time.perf_counter()
    s_k, i_k = (torch.from_numpy(a).cuda() for a in r.search(q, k))
    search_s = time.perf_counter() - t0
    launches, ran = dict(ft.launches), ft.last_kernel
    plan, fallbacks = dict(ft.last_select), ft.select_fallbacks()
    r.backend = "xla_exact"
    s_o, i_o = (torch.from_numpy(a).cuda() for a in r.search(q, k))
    same = (i_k == i_o).float().mean().item()
    found = set_match(torch, i_k, i_o)
    tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_o.abs()
    slot_err = (s_k - s_o).abs()
    tag = "<f32>" if store == "float32" else ""
    # the sampled route: the exact kernel takes the sample's scores first
    want = f"exact_select_kernel{tag}+exact_mma_kernel{tag}"
    ok = (launches["exact"] >= 1 and ran == want and found >= EXACT_ID_MATCH
          and bool((slot_err <= tol).all()) and bool(torch.isfinite(s_k).all()))
    record("exact_select_store", store=store, N=n, Q=nq, d=d, k=k,
           search_s=search_s, launches=launches, c_kernel=ran, plan=plan,
           fallbacks=fallbacks, slot_id_match=same, set_match=found,
           slot_max_abs_err=slot_err.max().item(), ok=ok)
    if not ok:
        failures.append(f"pallas_exact at k={k} over a 1M {store} store: "
                        f"launches {launches}, kernel {ran}, set match "
                        f"{found}, slot score error {slot_err.max().item()}")
    del x, q, r, s_k, i_k, s_o, i_o
    torch.cuda.empty_cache()
    return launches["exact"]


def write_vae(torch, path: str) -> None:
    from latentrag_torch.models import VariationalAutoencoder

    torch.manual_seed(1234)
    torch.save(VariationalAutoencoder(384, 64, 512).state_dict(), path)


def main_overrides(workdir: str, kernel: str, store: str,
                   top_k: int = 10) -> list:
    return [
        "data.dataset=synthetic", "data.max_samples=2000",
        "encoder.dtype=bfloat16",
        f"models.vae.checkpoint={workdir}/vae.pth",
        f"retrieval.store_dtype={store}", "retrieval.metric=cosine",
        f"retrieval.top_k={top_k}", f"retrieval.kernel={kernel}",
        f"paths.data_dir={workdir}/data",
        f"paths.checkpoints_dir={workdir}/ckpt",
        f"paths.logs_dir={workdir}/logs",
        f"retrieval.index_path={workdir}/index",
        "logging.log_to_file=false", "logging.level=WARNING",
    ]


def run_main(torch, workdir: str, kernel: str,
             store: str = "bfloat16", top_k: int = 10) -> dict:
    from latentrag_torch import main as cli

    results: list = []
    argv = ["--ae_type", "vae", "--device", "cuda", "--tag",
            f"smoke_{kernel}_{store}_{top_k}", "--set",
            *main_overrides(workdir, kernel, store, top_k)]
    t0 = time.perf_counter()
    rc = cli.main(argv, results=results)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0 or len(results) != 1:
        fail(f"main({kernel}, {store}, top_k={top_k}) returned {rc} with "
             f"{len(results)} results")
    res = results[0]
    res["wall_s"] = wall
    return res


def check_main_path(torch, failures: list, exact_kernel: str,
                    store: str = "bfloat16") -> tuple[dict, dict, dict]:
    """Phase 3: the entry point at full MiniLM-L6 width over a ``store``
    (bf16 or fp32) store; returns the fused kernels' launch counts from the
    kernel=auto runs at top_k=10 and top_k=150, and the top_k=10 oracle's
    result. ``exact_kernel`` names the C kernels phase 2 checked at the
    top_k=150 search's shape for this store."""
    import numpy as np

    from latentrag_torch.data import tokenizer
    from latentrag_torch.ops import fused_topk as ft

    tag = "" if store == "bfloat16" else "_fp32"
    with tempfile.TemporaryDirectory(prefix="lr_smoke_") as wd:
        write_vae(torch, f"{wd}/vae.pth")
        ft.reset_launches()
        tokenizer.reset_rows_served()
        res = run_main(torch, wd, "auto", store)
        main_launches = dict(ft.launches)
        rows = dict(tokenizer.rows_served)
        ran10 = ft.last_kernel
        again = run_main(torch, wd, "auto", store)  # the same run, warm
        oracle = run_main(torch, wd, "xla_exact", store)
        if store == "bfloat16":
            encode_breakdown(torch, wd, failures)
        # top_k=150: past the fold's 128, the exact kernel's search
        ft.reset_launches()
        res150 = run_main(torch, wd, "auto", store, top_k=150)
        launches150 = dict(ft.launches)
        ran150 = ft.last_kernel
        oracle150 = run_main(torch, wd, "xla_exact", store, top_k=150)
    for r, k in ((res, 10), (res150, 150)):
        ds = np.asarray(r["doc_scores"])
        if ds.shape != (r["n_queries"], k) or not np.isfinite(ds).all():
            failures.append(f"{store} doc_scores at top_k={k}: shape "
                            f"{ds.shape} or non-finite values")
    if res["dim_in"] != 384 or res["dim_out"] != 64:
        failures.append(f"dims {res['dim_in']}->{res['dim_out']}")
    agree = slot_agreement(res["retrieved_doc_ids"],
                           oracle["retrieved_doc_ids"])
    agree150 = slot_agreement(res150["retrieved_doc_ids"],
                              oracle150["retrieved_doc_ids"])
    deltas, deltas150 = ({
        m: abs(r["retrieval_metrics"][m]["mean"]
               - o["retrieval_metrics"][m]["mean"])
        for m in r["retrieval_metrics"]
    } for r, o in ((res, oracle), (res150, oracle150)))
    record(
        "main_path" + tag, store=store, n_queries=res["n_queries"],
        n_corpus=res["n_corpus"], dim_in=res["dim_in"],
        dim_out=res["dim_out"],
        metrics={m: v["mean"] for m, v in res["retrieval_metrics"].items()},
        timings_s=res["timings"], wall_s=res["wall_s"],
        launches=main_launches, c_kernel=ran10, tokenizer_rows=rows,
        second_run_search_s=again["timings"]["search_s"],
    )
    # the ASCII synthetic corpus and queries: every row through the C++
    # WordPiece
    if rows["native"] == 0 or rows["python"] != 0:
        failures.append(f"the {store} main path's rows were not all served "
                        f"by the C++ tokenizer: {rows}")
    record(
        "main_path" + tag + "_oracle", kernel="xla_exact",
        metrics={m: v["mean"] for m, v in oracle["retrieval_metrics"].items()},
        timings_s=oracle["timings"], doc_id_agreement=agree,
        metric_deltas=deltas, misses=slot_misses(res, oracle),
    )
    record(
        "main_path" + tag + "_top_k_150", launches=launches150,
        c_kernel=ran150,
        metrics={m: v["mean"] for m, v in res150["retrieval_metrics"].items()},
        oracle_metrics={m: v["mean"] for m, v in
                        oracle150["retrieval_metrics"].items()},
        timings_s=res150["timings"], oracle_timings_s=oracle150["timings"],
        doc_id_agreement=agree150, metric_deltas=deltas150,
        misses=slot_misses(res150, oracle150),
    )
    # the self-check searches as the queries do: the fold serves both
    fold_kernel = "fold_mma_kernel" + ("<f32>" if tag else "")
    if main_launches["fold"] < 2 or ran10.split("+")[0] != fold_kernel:
        failures.append(f"the {store} fold kernel did not serve the main "
                        f"path's search and self-check: {main_launches}, "
                        f"last kernel {ran10}")
    if main_launches["exact"] != 0:
        failures.append(f"the exact kernel launched at top_k=10 ({store}): "
                        f"{main_launches}")
    if launches150["exact"] < 1 or ran150 != exact_kernel:
        failures.append(f"the {store} exact kernel phase 2 checked "
                        f"({exact_kernel}) did not serve top_k=150: "
                        f"{launches150}, last kernel {ran150}")
    for k, a, dl in ((10, agree, deltas), (150, agree150, deltas150)):
        if a < MAIN_DOC_AGREE:
            failures.append(f"{store} top_k={k} doc id agreement {a} < "
                            f"{MAIN_DOC_AGREE}")
        if max(dl.values()) > MAIN_METRIC_TOL:
            failures.append(f"{store} top_k={k} metric deltas {dl} > "
                            f"{MAIN_METRIC_TOL}")
    return main_launches, oracle, launches150


def encode_breakdown(torch, workdir: str, failures: list) -> None:
    """Split the main path's corpus encode into host tokenization and the
    encoder on the card: the same texts, tokenizer, widths, chunks and
    shape buckets as the run, the two halves timed apart. The texts are
    tokenized by the C++ path the run takes and, for comparison, by the
    Python path; their ids and masks must be identical."""
    import numpy as np

    from latentrag_torch.data import (
        WordPieceTokenizer, get_examples, load_evaluation_data,
        resolve_tokenizer,
    )
    from latentrag_torch.models.encoder import SentenceEncoder
    from latentrag_torch.models.encoder.minilm import (
        _bucket_batch, _bucket_length,
    )
    from latentrag_torch.utils import Config, apply_overrides

    cfg = apply_overrides(Config(), ["data.dataset=synthetic",
                                     "data.max_samples=2000",
                                     "encoder.dtype=bfloat16"])
    ecfg = cfg.encoder
    _, corpus, _ = load_evaluation_data(get_examples(cfg))
    tok = resolve_tokenizer(f"{workdir}/data", ecfg.vocab_size, corpus)
    py_tok = WordPieceTokenizer(tok.vocab, lowercase=tok.lowercase,
                                max_word_chars=tok.max_word_chars,
                                native=False)
    enc = SentenceEncoder(tok, ecfg, device="cuda")

    def tokenize(t):
        t0 = time.perf_counter()
        out = []
        for i in range(0, len(corpus), ecfg.batch_size):
            ids, mask = t.encode_batch(corpus[i : i + ecfg.batch_size],
                                       max_length=ecfg.max_length)
            nb = _bucket_batch(ids.shape[0])
            nl = _bucket_length(ids.shape[1], ecfg.max_length)
            pad = ((0, nb - ids.shape[0]), (0, nl - ids.shape[1]))
            out.append((np.pad(ids, pad, constant_values=t.pad_id),
                        np.pad(mask, pad)))
        return time.perf_counter() - t0, out

    tok_s, batches = tokenize(tok)
    py_s, py_batches = tokenize(py_tok)
    same = len(batches) == len(py_batches) and all(
        np.array_equal(a, b) for x, y in zip(batches, py_batches)
        for a, b in zip(x, y))
    if not same:
        failures.append("the C++ and Python tokenizers disagree on the "
                        "main path's corpus")
    dev = [(torch.from_numpy(i).long().cuda(), torch.from_numpy(m).cuda())
           for i, m in batches]
    with torch.no_grad():
        enc.module(*dev[0])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ids, mask in dev:
            enc.module(ids, mask)
        torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    record("encode_breakdown", texts=len(corpus), batches=len(batches),
           tokenize_s=tok_s, tokenize_python_s=py_s, ids_identical=same,
           model_s=model_s)


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_split(torch, fn, reps: int = 5) -> dict | None:
    """Mean device ms of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls after a warm-up; None when the
    profiler records no device time here."""
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
    return out or None


def bound(nq, n, d, k, dname) -> tuple[float, str]:
    size = 2 if dname == "bfloat16" else 4
    by_bytes = (nq * d * size + n * d * size + nq * k * 8) / HBM_BYTES_PER_S
    by_ops = 2.0 * nq * n * d / PEAK_OPS[dname]
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def blocks_per_sm(ft, kernel: str, dev: int, d: int, k: int, op: int) -> int:
    """Resident blocks an SM of the fold or exact tensor-core kernel (past
    k = 2048 the radix select) for operand kind ``op`` at (d, k)."""
    name = {"fold": "fold_mma", "exact": "exact_mma"}[kernel]
    if kernel == "exact" and k > ft.EXACT_MAX_K:
        name = "exact_select"
    return ft._slots(dev, name, d, k, op) // ft._sm_count(dev)


# phase 4's calls: (store, shape, Q, N, d, cases); the fold at the plan,
# the exact kernel at k=10 and k=160, the radix select at k=3000
TIMED = (
    ("bfloat16", "reference", 2000, 315, 64, ("fold", "exact", "exact_k160")),
    ("bfloat16", "main_plan", 2000, 1997, 64, ("fold",)),
    ("bfloat16", "1m", 1024, 1_000_000, 64,
     ("fold", "exact", "exact_k160", "exact_k3000")),
    ("float32", "reference", 2000, 315, 64, ("fold", "exact", "exact_k160")),
    ("float32", "1m", 1024, 1_000_000, 64,
     ("fold", "exact", "exact_k160", "exact_k3000")),
)


def time_kernels(torch) -> dict:
    """Phase 4: kernel, plain and library times, cosine, over bf16 stores
    (the main path's) and fp32 stores, at the reference shape, the main
    path's own (2000 queries over its 1997 unique contexts; bf16 fold only)
    and 1M. The fold runs as the approximate route plans it
    (``ft.fold_plan``: tile width and 4x candidates at recall_target 0.99);
    the exact kernel at k=10 and at k=160 (a float store's search past the
    fold's 128). The library call (``torch.matmul`` in the store's dtype,
    fp32 sums, then ``torch.topk``) is timed beside each kernel call at
    that call's k; each call also gets a profiler device split and the
    kernel's resident blocks an SM. At k=3000 (the radix select) the
    blocked route of the approximate search is timed beside it. Keys:
    (shape, case) for bf16, (shape, case + "_fp32") for fp32."""
    from latentrag_torch.ops import fused_topk as ft

    out = {}
    for store, label, nq, n, d, cases in TIMED:
        q, c = make_case(torch, "cosine", getattr(torch, store), nq, n, d,
                         99 if store == "bfloat16" else 98)
        block_n, cand = ft.fold_plan(n, 10, 0.99)
        for case in cases:
            mode = "fold" if case == "fold" else "exact"
            kk, bn = {"fold": (cand, block_n), "exact": (10, 4096),
                      "exact_k160": (160, 4096),
                      "exact_k3000": (3000, 4096)}[case]
            big = kk > ft.EXACT_MAX_K
            lib_ms = time_ms(torch, lambda: torch.topk(
                torch.matmul(q, c.T).float(), kk, dim=1),
                reps=10 if big else 25)
            kern = time_ms(torch, lambda: ft.fused_topk_raw(
                q, c, k=kk, metric="cosine", mode=mode, block_n=bn),
                reps=10 if big else 25)
            ran = ft.last_kernel
            plain = time_ms(torch, lambda: ft.fused_topk_raw_reference(
                q, c, k=kk, metric="cosine", mode=mode, block_n=bn),
                reps=3 if big else 20, warmup=1)
            b_ms, b_by = bound(nq, n, d, kk, store)
            rec = {"shape": label, "mode": mode, "Q": nq, "N": n, "d": d,
                   "k": kk, "block_n": bn, "store": store,
                   "c_kernel": ran, "ms": kern, "plain_ms": plain,
                   "library_ms": lib_ms, "library_k": kk, "bound_ms": b_ms,
                   "bound_by": b_by}
            if big:  # the approximate route's answer at this k
                rec["plan"] = dict(ft.last_select)
                rec["fallbacks"] = ft.select_fallbacks()
                rec["blocked_ms"] = time_ms(torch, lambda: ft.approx_fused_topk(
                    q, c, k=kk, metric="cosine"), reps=5, warmup=1)
                # the radix route, the earlier design, in the same run
                radix = lambda: select_route(ft, q, c, kk, "cosine", "radix")  # noqa: E731
                rec["radix_ms"] = time_ms(torch, radix, reps=10)
                rec["radix_device_ms"] = device_split(torch, radix)
            # device ms of each kernel the call launches
            rec["device_ms"] = device_split(torch, lambda: ft.fused_topk_raw(
                q, c, k=kk, metric="cosine", mode=mode, block_n=bn))
            op = ft._OP_F32 if store == "float32" else ft._OP_BF16
            rec["blocks_per_sm"] = blocks_per_sm(
                ft, mode, q.device.index, d, min(kk, n), op)
            record("kernel_time", **rec)
            out[(label, case + ("_fp32" if store == "float32" else ""))] = rec
        del q, c
        torch.cuda.empty_cache()
    return out


def binary_case(torch, nq, n, d, seed):
    """Unit queries and the packed sign words of a seeded corpus, made on
    the card."""
    from latentrag_torch.ops.binary import binary_quantize

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.nn.functional.normalize(
        torch.randn((nq, d), generator=g, device="cuda"), dim=1)
    c = torch.randn((n, d), generator=g, device="cuda")
    return q, binary_quantize(c)


def check_binary_kernel(torch, failures: list) -> dict:
    """Phase 2b: the binary fold kernel against its plain version, then the
    exact binary kernel against ``binary_topk``; returns the largest
    rescored-score error at equal ids of the fold and the largest score
    error of the exact kernel."""
    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft

    worst = {"binary_fold": 0.0, "binary_exact": 0.0}
    # "main_plan" is the binary main path's stage 1 (1997 unique contexts):
    # the fold at k=128 on fold_plan's 128-row tile, the exact kernel at
    # k=160 over four 512-row slabs and its merge
    shapes = [("reference", 2000, 315, 64), ("1m", 1024, 1_000_000, 64),
              ("ragged", 37, 5003, 384), ("ragged", 37, 5003, 48),
              ("main_plan", 2000, 1997, 64)]
    for seed, (label, nq, n, d) in enumerate(shapes, start=200):
        q, pk = binary_case(torch, nq, n, d, seed)
        exact_i = tb.binary_topk(q, pk, d, 10)[1]
        for k in (10, 80, 128):
            for block_n in sorted({4096, ft.fold_plan(n, k, 0.99)[0]}):
                _, i_k = ft.binary_fused_topk_raw(q, pk, d=d, k=k,
                                                  block_n=block_n)
                torch.cuda.synchronize()
                ran = ft.last_kernel
                _, i_p = ft.binary_fused_topk_raw_reference(
                    q, pk, d=d, k=k, block_n=block_n)
                id_match = (i_k == i_p).float().mean().item()
                s_k, j_k = ft.rescore_binary_candidates(q, pk, i_k, d)
                s_p, j_p = ft.rescore_binary_candidates(q, pk, i_p, d)
                eq = j_k == j_p
                err = (s_k - s_p).abs()[eq]
                max_err = err.max().item() if err.numel() else 0.0
                tol = BIN_SCORE_ATOL + BIN_SCORE_RTOL * s_p.abs()[eq]
                rec = {"shape": label, "Q": nq, "N": n, "d": d, "k": k,
                       "block_n": block_n, "c_kernel": ran,
                       "id_match": id_match, "max_abs_err": max_err}
                ok = (ran.startswith("fold_mma_kernel<bin>")
                      and id_match >= BIN_ID_MATCH
                      and bool((err <= tol).all()))
                if k == 10:
                    hits = (i_k[:, :, None] == exact_i[:, None, :]).any(-1)
                    rec["recall_vs_exact"] = hits.float().mean().item()
                    ok = ok and rec["recall_vs_exact"] >= BIN_RECALL
                rec["ok"] = ok
                record("binary_kernel_check", **rec)
                worst["binary_fold"] = max(worst["binary_fold"], max_err)
                if not ok:
                    failures.append(f"binary kernel check {rec}")
        # the exact flavour, past the fold's 128 candidates (k clips to N)
        for k in BIN_EXACT_KS[label]:
            s_k, i_k = ft.binary_exact_topk_raw(q, pk, d=d, k=k)
            torch.cuda.synchronize()
            ran = ft.last_kernel
            s_p, i_p = tb.binary_topk(q, pk, d, k)
            same = i_k == i_p
            id_match = same.float().mean().item()
            err = (s_k - s_p).abs()[same]
            max_err = err.max().item() if err.numel() else 0.0
            tol = BIN_SCORE_ATOL + BIN_SCORE_RTOL * s_p.abs()[same]
            ok = (ran.startswith("exact_mma_kernel<bin>")
                  and id_match >= EXACT_ID_MATCH and bool((err <= tol).all()))
            rec = {"shape": label, "Q": nq, "N": n, "d": d, "k": k,
                   "k_eff": int(i_k.shape[1]), "c_kernel": ran,
                   "id_match": id_match, "max_abs_err": max_err, "ok": ok}
            record("binary_exact_check", **rec)
            worst["binary_exact"] = max(worst["binary_exact"], max_err)
            if not ok:
                failures.append(f"binary exact check {rec}")
        del q, pk
        torch.cuda.empty_cache()
    return worst


def plain_cascade(torch, r, queries, k):
    """The binary store's search with the plain version of the kernel as
    stage 1, at the plan the store uses on the card (above 128 candidates
    the exact search's plain version), and the same stage 2. Returns host
    numpy (scores, ids)."""
    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.distances import prepare_for_metric
    from latentrag_torch.retrieval.rescore import exact_rescore_topk

    q = prepare_for_metric(torch.as_tensor(queries).float().cuda(),
                           r.metric, r._whitener)
    ok = min(r.binary_oversample * k, r._corpus_n)
    if ok > ft.FOLD_MAX_K:
        idx = tb.binary_topk(q, r._corpus, r._dim, ok)[1]
    else:
        block_n, cand = ft.fold_plan(r._corpus_n, ok,
                                     r._effective_recall_target(k))
        _, idx = ft.binary_fused_topk_raw_reference(q, r._corpus, d=r._dim,
                                                    k=cand, block_n=block_n)
        _, idx = ft.rescore_binary_candidates(q, r._corpus, idx, r._dim)
    return exact_rescore_topk(
        q.cpu().numpy(), lambda i: r._rescore_host[i],
        idx[:, :ok].cpu().numpy(), k, metric="dot", scale=r._corpus_scale)


def search_split(torch, r, queries, k) -> dict:
    """Seconds of one binary-store search and of its stage 1 alone (the
    kernel route, synchronised); the rest is the host's stage 2."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.distances import prepare_for_metric

    q = torch.as_tensor(queries).float().cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.search(q, k)
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ft.approx_binary_fused_topk(
        prepare_for_metric(q, r.metric, r._whitener), r._corpus, d=r._dim,
        k=min(r.binary_oversample * k, r._corpus_n),
        recall_target=r._effective_recall_target(k))
    torch.cuda.synchronize()
    return {"search_s": search_s, "stage1_s": time.perf_counter() - t0}


def slot_agreement(a, b) -> float:
    """Share of equal entries, position by position, of two id tables."""
    slots = sum(len(rb) for rb in b)
    same = sum(sum(1 for x, y in zip(ra, rb) if x == y)
               for ra, rb in zip(a, b))
    return same / max(slots, 1)


def slot_misses(r: dict, o: dict) -> dict:
    """Where a main run's doc ids differ from the oracle's, slot by slot:
    how many slots, the share of the oracle's docs found at any slot of the
    same query, and the largest score gap between the two runs at such a
    slot (both rank by fp32 scores of the rows they chose, so a swap of
    near-tied docs shows a gap at the size of fp32 rounding, a missed doc
    a larger one)."""
    import numpy as np

    k = np.asarray(o["doc_scores"]).shape[1]
    ids_r, ids_o = (np.asarray([row + [-1] * (k - len(row))
                                for row in x["retrieved_doc_ids"]])
                    for x in (r, o))
    diff = ids_r != ids_o
    gaps = np.abs(np.asarray(r["doc_scores"], np.float64)
                  - np.asarray(o["doc_scores"], np.float64))[diff]
    found = (ids_o[:, :, None] == ids_r[:, None, :]).any(-1)
    return {"slots": int(diff.sum()),
            "set_agreement": float(found.mean()),
            "max_score_gap": float(gaps.max()) if gaps.size else 0.0}


def check_binary_main_path(torch, failures: list, oracle: dict,
                           top_k: int = 10) -> dict:
    """Phase 3b: ``main`` with the binary store at ``top_k``; returns the
    launch counts of that run. Stage 1 asks for binary_oversample x top_k
    candidates: the fold serves up to 128 (80 at top_k=10), the exact
    binary kernel more (160 at top_k=20)."""
    import numpy as np

    from latentrag_torch.data import get_examples, load_evaluation_data
    from latentrag_torch.evaluation import evaluate_retrieval
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.pipeline import PipelineRunner
    from latentrag_torch.retrieval import build_retriever
    from latentrag_torch.utils import Config, apply_overrides

    with tempfile.TemporaryDirectory(prefix="lr_smoke_bin_") as wd:
        write_vae(torch, f"{wd}/vae.pth")
        ft.reset_launches()
        res = run_main(torch, wd, "auto", store="binary", top_k=top_k)
        main_launches = dict(ft.launches)
        ran = ft.last_kernel  # the search's stage 1 launched last
        # the same latents, through the port's own compressor
        cfg = apply_overrides(Config(), main_overrides(wd, "auto", "binary",
                                                       top_k))
        queries, corpus, relevant = load_evaluation_data(get_examples(cfg))
        comp = PipelineRunner(cfg, ae_type="vae",
                              device="cuda")._ensure_compressor(corpus)
        c_emb = comp.encode_text(list(corpus))
        q_emb = comp.encode_text(list(queries))
        r = build_retriever(c_emb, list(corpus), None, cfg.retrieval,
                            device="cuda")
        _, i_kern = r.search(q_emb, top_k)
        _, i_plain = plain_cascade(torch, r, q_emb, top_k)
        split = search_split(torch, r, q_emb, top_k)
    ds = np.asarray(res["doc_scores"])
    if ds.shape != (res["n_queries"], top_k) or not np.isfinite(ds).all():
        failures.append(f"binary doc_scores shape {ds.shape} or non-finite")
    names = cfg.evaluation.retrieval_metrics
    rows = lambda ids: [[int(j) for j in row if j >= 0] for row in ids]  # noqa: E731
    m_kern = evaluate_retrieval(rows(i_kern), list(relevant), metrics=names)
    m_plain = evaluate_retrieval(rows(i_plain), list(relevant), metrics=names)
    agree = slot_agreement(rows(i_kern), rows(i_plain))
    deltas = {m: abs(m_kern[m]["mean"] - m_plain[m]["mean"]) for m in m_kern}
    record(
        "binary_main_path", top_k=top_k, n_queries=res["n_queries"],
        n_corpus=res["n_corpus"], dim_out=res["dim_out"],
        metrics={m: v["mean"] for m, v in res["retrieval_metrics"].items()},
        bf16_oracle_metrics={m: v["mean"] for m, v in
                             oracle["retrieval_metrics"].items()},
        timings_s=res["timings"], wall_s=res["wall_s"],
        launches=main_launches, c_kernel=ran,
        kernel_vs_plain_stage1_doc_agreement=agree,
        kernel_vs_plain_stage1_metric_deltas=deltas,
        rerun_vs_main_doc_agreement=slot_agreement(
            rows(i_kern), res["retrieved_doc_ids"]),
        rerun_search_split=split,
    )
    # the self-check runs the fold; the search runs the fold up to 128
    # candidates and the exact binary kernel past them
    exact = r.binary_oversample * top_k > ft.FOLD_MAX_K
    want = {"binary_fold": 1, "binary_exact": 1} if exact else {
        "binary_fold": 2}
    if any(main_launches[key] < n for key, n in want.items()):
        failures.append(
            f"binary main path at top_k={top_k} launched {main_launches} "
            f"(want at least {want}: self-check + search)")
    if not (ran or "").startswith(
            "exact_mma_kernel<bin>" if exact else "fold_mma_kernel<bin>"):
        failures.append(f"binary main path at top_k={top_k} ran {ran}")
    if agree < BIN_DOC_AGREE:
        failures.append(f"binary stage-1 doc agreement {agree} < "
                        f"{BIN_DOC_AGREE}")
    if max(deltas.values()) > BIN_METRIC_TOL:
        failures.append(f"binary metric deltas {deltas} > {BIN_METRIC_TOL}")
    return main_launches


def check_binary_capacity(torch, failures: list) -> None:
    """Phase 3c: a binary DenseRetriever over 1M seeded unit vectors, at
    k=10 and at k=300 (2400 candidates: the blocked route)."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.topk import exact_topk
    from latentrag_torch.retrieval import DenseRetriever

    n, nq, d, k = 1_000_000, 1024, 64, 10
    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((nq, d), generator=g, device="cuda"), dim=1)
    r = DenseRetriever(store_dtype="binary", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.build(x, [""] * n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _, i_kern = r.search(q, k)  # also the warm-up
    split = search_split(torch, r, q, k)
    _, i_plain = plain_cascade(torch, r, q, k)
    exact_i = exact_topk(q, x, k=k, metric="cosine")[1].cpu().numpy()
    recall = float(sum(len(set(a) & set(b)) for a, b in
                       zip(i_kern.tolist(), exact_i.tolist())) / (nq * k))
    agree = slot_agreement(i_kern.tolist(), i_plain.tolist())
    record("binary_capacity", N=n, Q=nq, d=d, k=k, build_s=build_s,
           **split, device_bytes=r._corpus.numel() * 4,
           host_rescore_bytes=int(r._rescore_host.nbytes),
           recall_at_10_vs_fp32_exact=recall,
           kernel_vs_plain_stage1_agreement=agree)
    if agree < BIN_DOC_AGREE:
        failures.append(f"1M binary stage-1 agreement {agree} < "
                        f"{BIN_DOC_AGREE}")
    ft.reset_launches()
    _, i300 = r.search(q, 300)
    launches300 = dict(ft.launches)
    split300 = search_split(torch, r, q, 300)
    _, i300_plain = plain_cascade(torch, r, q, 300)
    agree300 = slot_agreement(i300.tolist(), i300_plain.tolist())
    record("binary_capacity_top_k_300", N=n, Q=nq, d=d, k=300,
           candidates=min(r.binary_oversample * 300, n), **split300,
           launches=launches300, kernel_vs_plain_stage1_agreement=agree300)
    if launches300["binary_blocked"] < 1:
        failures.append(f"the 1M binary store at top_k=300 did not take "
                        f"the blocked route: {launches300}")
    if agree300 < BIN_DOC_AGREE:
        failures.append(f"1M binary top_k=300 stage-1 agreement {agree300} "
                        f"< {BIN_DOC_AGREE}")
    del x, q, r
    torch.cuda.empty_cache()


def binary_bound(nq, n, d, k) -> tuple[float, str]:
    """The TPU kernel's own cost model (pallas_topk.py:484-491): bf16
    queries, packed words and the [Q, k] output read or written once, and
    2*Q*N*d operations at the bf16 tensor-core peak."""
    words = -(-d // 32)
    by_bytes = (nq * d * 2 + n * words * 4 + nq * k * 8) / HBM_BYTES_PER_S
    by_ops = 2.0 * nq * n * d / PEAK_OPS["bfloat16"]
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def time_binary(torch) -> dict:
    """Phase 4b: the binary fold kernel, its plain version and the
    yardstick (torch.matmul + torch.topk over the corpus pre-unpacked to
    +-1 bf16), at the candidates and tile width the store plans (ok = 8 x
    10) and at k=10 with the 4096-row tile, with a profiler device split at
    the plan; the exact binary kernel at k=160 (the store's stage 1 at
    top_k=20) beside its plain version ``binary_topk`` and the yardstick at
    that k, with a device split; at 1M the blocked route at 2400
    candidates (the store's stage 1 at top_k=300; itself plain PyTorch,
    so its plain time is its own); then the fold kernel alone over 100M
    rows."""
    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft

    out = {}
    d = 64
    for label, nq, n in (("reference", 2000, 315), ("1m", 1024, 1_000_000)):
        q, pk = binary_case(torch, nq, n, d, 77)
        qb = q.bfloat16()
        pm1 = tb.binary_unpack(pk, d).bfloat16()
        block_n, cand = ft.fold_plan(n, min(80, n), 0.99)
        for kk, bn, tag in ((cand, block_n, "plan"), (10, 4096, "k10")):
            lib_ms = time_ms(torch, lambda: torch.topk(
                torch.matmul(qb, pm1.T).float(), kk, dim=1))
            kern = time_ms(torch, lambda: ft.binary_fused_topk_raw(
                q, pk, d=d, k=kk, block_n=bn))
            ran = ft.last_kernel
            plain = time_ms(torch, lambda: ft.binary_fused_topk_raw_reference(
                q, pk, d=d, k=kk, block_n=bn), reps=20, warmup=1)
            b_ms, b_by = binary_bound(nq, n, d, kk)
            rec = {"shape": label, "case": tag, "Q": nq, "N": n, "d": d,
                   "k": kk, "block_n": bn, "c_kernel": ran, "ms": kern,
                   "plain_ms": plain, "library_ms": lib_ms,
                   "library_k": kk, "library_reads_bytes_x": 16,
                   "bound_ms": b_ms, "bound_by": b_by}
            if tag == "plan":
                rec["device_ms"] = device_split(
                    torch, lambda: ft.binary_fused_topk_raw(
                        q, pk, d=d, k=kk, block_n=bn))
                rec["blocks_per_sm"] = blocks_per_sm(
                    ft, "fold", q.device.index, d, kk, ft._OP_BIN)
            record("binary_kernel_time", **rec)
            out[(label, tag)] = rec
        kk = 160
        lib_ms = time_ms(torch, lambda: torch.topk(
            torch.matmul(qb, pm1.T).float(), kk, dim=1))
        kern = time_ms(torch, lambda: ft.binary_exact_topk_raw(
            q, pk, d=d, k=kk))
        ran = ft.last_kernel
        plain = time_ms(torch, lambda: tb.binary_topk(q, pk, d, kk),
                        reps=20, warmup=1)
        b_ms, b_by = binary_bound(nq, n, d, min(kk, n))
        rec = {"shape": label, "case": "exact160", "Q": nq, "N": n, "d": d,
               "k": kk, "c_kernel": ran, "ms": kern, "plain_ms": plain,
               "library_ms": lib_ms, "library_k": kk,
               "library_reads_bytes_x": 16, "bound_ms": b_ms,
               "bound_by": b_by,
               "device_ms": device_split(torch, lambda: ft.binary_exact_topk_raw(
                   q, pk, d=d, k=kk)),
               "blocks_per_sm": blocks_per_sm(ft, "exact", q.device.index, d,
                                              min(kk, n), ft._OP_BIN)}
        record("binary_kernel_time", **rec)
        out[(label, "exact160")] = rec
        if label == "1m":
            kk = 2400
            lib_ms = time_ms(torch, lambda: torch.topk(
                torch.matmul(qb, pm1.T).float(), kk, dim=1), reps=5)
            kern = time_ms(torch, lambda: ft.approx_binary_fused_topk(
                q, pk, d=d, k=kk), reps=5, warmup=1)
            b_ms, b_by = binary_bound(nq, n, d, kk)
            rec = {"shape": label, "case": "blocked2400", "Q": nq, "N": n,
                   "d": d, "k": kk, "c_kernel": None, "ms": kern,
                   "plain_ms": kern, "library_ms": lib_ms, "library_k": kk,
                   "library_reads_bytes_x": 16, "bound_ms": b_ms,
                   "bound_by": b_by}
            record("binary_kernel_time", **rec)
            out[(label, "blocked2400")] = rec
        del q, pk, qb, pm1
        torch.cuda.empty_cache()
    nq, n = 1024, 100_000_000
    g = torch.Generator(device="cuda").manual_seed(5)
    pk = torch.randint(-2**31, 2**31, (n, d // 32), generator=g,
                       device="cuda", dtype=torch.int64).to(torch.int32)
    q = torch.nn.functional.normalize(
        torch.randn((nq, d), generator=g, device="cuda"), dim=1)
    block_n, cand = ft.fold_plan(n, 80, 0.99)
    kern = time_ms(torch, lambda: ft.binary_fused_topk_raw(
        q, pk, d=d, k=cand, block_n=block_n), reps=5, warmup=1)
    b_ms, b_by = binary_bound(nq, n, d, cand)
    rec = {"shape": "100m", "case": "plan", "Q": nq, "N": n, "d": d,
           "k": cand, "block_n": block_n, "c_kernel": ft.last_kernel,
           "ms": kern, "plain_ms": None, "library_ms": None,
           "library_not_timed": "its fp32 score matrix would be 410 GB",
           "packed_bytes": pk.numel() * 4,
           "bound_ms": b_ms, "bound_by": b_by}
    record("binary_kernel_time", **rec)
    out[("100m", "plan")] = rec
    del pk, q
    torch.cuda.empty_cache()
    return out


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "latentrag_torch", "csrc")):
        fail("latentrag_torch/ is not beside this script; run it from a "
             "checkout of the repository")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a card")
    sys.path.insert(0, root)
    t_start = time.perf_counter()

    from latentrag_torch.ops import cuda_build
    from latentrag_torch.utils import native

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cuda_build.load_library("fused_topk")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_library()  # the C++ tokenizer's library, g++
    record("build", card=card, torch=torch.__version__,
           cuda=torch.version.cuda, build_s=build_s,
           nvcc_s=cuda_build.build_seconds.get("fused_topk"),
           host_library_s=time.perf_counter() - t0)

    failures: list = []
    worst = check_kernels(torch, failures)
    check_select_fallbacks(torch, failures)
    worst.update(check_binary_kernel(torch, failures))
    if failures:
        fail("; ".join(failures[:5]))
    launches, oracle, launches150 = check_main_path(
        torch, failures, worst.pop("main_exact_kernel_bfloat16"))
    if failures:
        fail("; ".join(failures))
    launches["exact"] = launches150["exact"]  # the bf16 main at top_k=150
    # the same runs over an fp32 store: its kernels' main path
    launches32, _, launches32_150 = check_main_path(
        torch, failures, worst.pop("main_exact_kernel_float32"), "float32")
    if failures:
        fail("; ".join(failures))
    launches["fold_fp32"] = launches32["fold"]
    launches["exact_fp32"] = launches32_150["exact"]
    launches["binary_fold"] = check_binary_main_path(
        torch, failures, oracle)["binary_fold"]
    if failures:
        fail("; ".join(failures))
    launches["binary_exact"] = check_binary_main_path(
        torch, failures, oracle, top_k=20)["binary_exact"]
    if failures:
        fail("; ".join(failures))
    check_binary_capacity(torch, failures)
    if failures:
        fail("; ".join(failures))
    for store, tag in (("bfloat16", ""), ("float32", "_fp32")):
        launches["exact_select" + tag] = check_exact_select_store(
            torch, failures, store)
    if failures:
        fail("; ".join(failures))
    times = time_kernels(torch)
    times.update(time_binary(torch))

    kernels = []
    for mode, fn_line, source in (("fold", 162, "fold_mma.cuh"),
                                  ("exact", 182, "exact_mma.cuh")):
        for tag, store in (("", "bf16"), ("_fp32", "fp32")):
            t = times[("reference", mode + tag)]
            kernels.append({
                "name": f"fused_topk_{mode}{tag}",
                "route": "cuda",
                "source": f"latentrag_torch/csrc/{source}",
                "replaces": f"latentrag_tpu/ops/pallas_topk.py:{fn_line}",
                "launches": launches[mode + tag],
                "max_abs_err": worst[mode + tag],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "shape": f"Q=2000 N=315 d=64 k={t['k']} "
                         f"block_n={t['block_n']} {store} cosine",
            })
    for tag, store in (("", "bf16"), ("_fp32", "fp32")):
        t = times[("1m", "exact_k3000" + tag)]
        kernels.append({
            "name": f"fused_topk_exact_select{tag}",
            "route": "cuda",
            "source": "latentrag_torch/csrc/exact_select.cuh",
            "replaces": "latentrag_tpu/ops/pallas_topk.py:182",
            "launches": launches["exact_select" + tag],
            "max_abs_err": worst["exact_select" + tag],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"Q=1024 N=1000000 d=64 k={t['k']} {store} cosine",
        })
    t = times[("reference", "plan")]
    kernels.append({
        "name": "binary_fused_topk_fold",
        "route": "cuda",
        "source": "latentrag_torch/csrc/fold_mma.cuh",
        "replaces": "latentrag_tpu/ops/pallas_topk.py:354",
        "launches": launches["binary_fold"],
        "max_abs_err": worst["binary_fold"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": f"Q=2000 N=315 d=64 k={t['k']} block_n={t['block_n']} "
                 "packed sign words, bf16 queries",
    })
    t = times[("reference", "exact160")]
    kernels.append({
        "name": "binary_exact_topk",
        "route": "cuda",
        "source": "latentrag_torch/csrc/exact_mma.cuh",
        # the store's exact sign-dot stage 1 (latentrag_tpu/retrieval/
        # dense.py:1172), past the fold's 128 candidates
        "replaces": "latentrag_tpu/ops/binary.py:129",
        "launches": launches["binary_exact"],
        "max_abs_err": worst["binary_exact"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": f"Q=2000 N=315 d=64 k={t['k']} packed sign words, "
                 "bf16 queries",
    })
    if "jax" in sys.modules:
        fail("jax was imported")
    record("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
