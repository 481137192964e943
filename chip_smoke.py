#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``latentrag_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``latentrag_torch/csrc``, then:

1. prints the card's name and power limit (``nvidia-smi``) and the build
   times of the kernels (nvcc: two libraries, without and with the row
   mask, built at once) and of the C++ tokenizer's library (g++);
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
   back to the radix passes and are held to the plain version; and the
   batch buckets a served search brings, Q in {8, 64}, at the main path's
   fold plan (N=1997) and at 1M (k=10 and 40), cosine, both stores;
2b. holds the binary fold kernel (tensor cores, ``fold_mma_kernel<bin>``)
   against its plain version: the reference and 1M shapes at d=64 and the
   ragged shape at d=384 and d=48 (pad bits), and the binary main path's
   own (Q=2000, N=1997, d=64), k in {10, 80, 128}, at block_n 4096 and at
   ``fold_plan``'s width; then the exact binary kernel
   (``exact_mma_kernel<bin>``, past 128 candidates) against ``binary_topk``
   at k from 129 to 2048, at the main path's shape at its k=160; each
   check holds which C kernel ran;
2c. holds the row-mask instances (a filtered search: ``fold_mma_kernel<E,
   OP, true>``, ``exact_mma_kernel<KP, OP, true>``) against their masked
   plain versions at Q=2000, N=315, d=64 and Q=37, N=5003, d=384, with 1,
   10, 50 and 100 % of the rows allowed, fewer than k and none: the fold
   at the plan, the exact kernel at k=10 and 160, bf16 and fp32 stores,
   the binary fold at 128 candidates and the exact binary kernel at
   k=160; empty slots must be (NEG_INF, -1) and every id allowed;
2d. holds the int8 and int4 kernels (``fold_mma_kernel<E, OP_I8 / OP_I4>``,
   ``exact_mma_kernel<KP, ...>``, on ``mma.sync`` s8) and their row-mask
   instances against their plain versions at the main path's shape
   (Q=2000, N=1997, d=64): the fold at the store's plan for top_k=10 under
   the msmarco config's recall_target 0.95, the exact kernel at k=10 and
   160, unmasked and with 10 % of the rows allowed; scores are exact
   integer dots times one factor, so the exact kernels must equal their
   plain versions bit for bit and the fold its plain fold (ids >= 99 %,
   scores bit for bit at equal ids);
2e. holds the device IVF's scan (``ivf_scan_kernel``, ``csrc/ivf_scan.cu``)
   against ``ivf_scan_reference``: int8, bf16, fp32, int4 and binary
   blocks over clustered ~20k-row corpora at cap 64 and 512 (d=64; also
   48 and 384 for the float blocks, 63 for int4), with appended blocks, a
   sentinel probe slot, Q in {1, 8, 64}, unmasked and with 1, 10, 100 %
   and none of the rows allowed: int8 / int4 bit for bit, float and
   binary within the exact kernels' limits;
3. drives the main path through ``latentrag_torch.main.main`` at the full
   MiniLM-L6 width in bf16 with a seeded 384->512->64 VAE: synthetic data,
   2000 queries, a bf16 cosine store, top_k=10, kernel=auto; checks that the
   fold kernel served the search and the self-check and the exact kernel
   did not launch, and that the C++ WordPiece encoded every row (the
   corpus is ASCII), times the tokenizer's C++ and Python paths on the
   corpus (ids and masks must be identical), runs it once more in the same process (its search time
   warm), then runs the same pipeline with kernel=xla_exact (matmul +
   torch.topk, the oracle) and compares (recording, where their docs
   differ, the score gaps at those slots); every run persists its store at
   its own ``retrieval.index_path``, and the repeated run must warm-boot
   from the first one's (3a: it logs the load and the skipped rebuild and
   returns the same doc ids and metrics); on that store, loaded through
   ``load_retriever``, filtered searches at top_k=10 and 150 must run the
   masked fold and exact kernels and agree with ``xla_exact``'s filtered
   search, and each masked kernel is held to its masked plain version on
   that path's own inputs and mask (3e); then both again at top_k=150,
   whose search the bf16 exact kernel serves (the instance phase 2 checked
   at that shape); then all of it again over an fp32 store
   (``retrieval.store_dtype=float32``), whose fold and exact kernels are
   the 3xTF32 instances;
3b. drives the same entry point with ``retrieval.store_dtype=binary`` and
   checks that the binary kernel launched (self-check and search); on the
   same latents, the cascade with the kernel as stage 1 and with its plain
   version at the same plan must retrieve the same docs; then again at
   ``retrieval.top_k=20``, whose 160 candidates the exact binary kernel
   serves; at each top_k a filtered search whose stage 1 runs the masked
   kernel, held to the masked plain stage 1 (3e);
3c. builds a binary ``DenseRetriever`` over 1M seeded unit vectors (d=64),
   searches 1024 queries at k=10, and holds the same kernel-vs-plain
   agreement; Recall@10 against exact fp32 search is reported; then at
   top_k=300, whose 2400 candidates take the blocked route; then with a
   ``{"where": ...}`` filter on its metadata (a tenth of the rows; 3e);
   then 3f and 3g on that store;
3f. saves a 1M-row store (binary above, and a bf16 one over 1M seeded unit
   rows) to a temporary directory, timed, with its bytes on disk, loads it
   into a fresh retriever (the warm boot, timed against the cold build),
   and holds the loaded search to the built one's bit for bit;
3g. on the loaded 1M store, which persists each mutation: ``add`` 1000
   rows (each must retrieve itself top-1), ``remove`` the queries' top-1
   docs and half the added rows (none may come back; every survivor keeps
   its score bit for bit), reload and hold the row count;
3i. drives ``latentrag_torch.main --config configs/msmarco_v5e8.yaml
   --ae_type dae`` (the repo's MS-MARCO-scale config: the int8 store,
   recall_target 0.95, block_size 1048576, shard_corpus on one card) with
   a seeded 384->512->64 DAE .pth and 2000 synthetic examples: the int8
   fold must serve its search and self-check, the same run with the
   kernels' plain versions must give the same doc ids (by set at ties) and
   metrics, and ``python -m latentrag_torch.serve`` on that config boots
   warm and answers a JSONL search;
3j. builds an int8 and then an int4 ``DenseRetriever`` over 8.8M seeded
   unit rows, d=64 (the config's corpus scale: 563 MB of int8 codes, or
   282 MB of nibbles on the card and 563 MB of SQ8 codes on the host), and
   searches 1024 queries at k=10 (the fold), at 160 candidates (the exact
   kernel) and both with a doc_ids filter (the masked instances): each
   search equal bit for bit to the same search with the kernels' plain
   versions, and >= 99 % by set to the exact plain search in 1M-row
   blocks; Recall@10 against exact fp32 search reported; then saved,
   loaded and searched again bit for bit;
3k. the msmarco int8 store with its documented IVF (``ivf_nlist=8192``, cap
   512) over 8.8M seeded clustered rows (``check_ivf_deployment``: the
   build split, the routes the store's size gives, each routed search one
   ``ivf_scan`` launch and equal bit for bit to the plain scan, the
   exhaustive route above the traffic guard, the full probe equal to the
   exact search, a filter, the warm boot from the sidecars without
   k-means, add and remove), then the int4 and binary cascades' stage 1
   through the IVF over 1M rows (``check_ivf_cascades``);
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
   the fold kernel alone over 100M packed rows, beside the library
   yardstick run in 1M-row blocks;
4c. the masked kernels with 10 % of the rows allowed at the reference and
   1M shapes (bf16 and fp32 fold and exact, binary fold and exact), each
   beside the same call unmasked, its masked plain version and the masked
   library call (``torch.topk(torch.where(mask, torch.matmul(q, c.T)
   .float(), -inf), k)``), with the bound (the mask adds N/8 bytes);
4d. times the int8 and int4 kernels (fold at the plan, exact at k=10 and
   160, the masked fold and exact at 10 % allowed) at Q=2000, N=315 and
   at Q=1024, N=8.8M, beside their plain versions, the library yardstick
   ``torch._int_mm`` + ``torch.topk`` in 1M-row blocks (int4: over its
   codes unpacked to int8), the bound (bytes over 3.35 TB/s, or 2 Q N d
   over 1,979 TOPS of int8), a profiler device split and the resident
   blocks an SM;
4e. (inside 3k, on its store) times ``ivf_scan`` at Q=1 and 8 with the
   auto budget and Q=64 with the pinned budgets: the wrapper (CUDA events)
   and the kernel (profiler), its plain version, its bound (the probed
   rows, their ids and the scores once over 3.35 TB/s), the library
   yardstick (``index_select`` + fp32 ``bmm`` + ``torch.topk``), the IVF
   search call's other steps, and the whole call beside the exhaustive
   int8 search of the same queries;
3h. (run last, so that its server threads and profiled load do not
   touch phase 4's device splits) serves the bf16 main path's store (a
   copy of what its first run persisted, with that run's data_dir, so the
   tokenizer is the file it wrote) through ``latentrag_torch.serve`` in this process: ``boot``
   must warm-boot and encode nothing; then ``make_handle`` and
   ``serve_http`` on 127.0.0.1 take 1024 single-query searches at k=10
   from 64 concurrent clients (a subprocess), first with every request
   its own search (``--batch-window-ms 0``), then coalesced (2 ms, at
   most 64), recording QPS, client p50/p99 latency, the search calls and
   their sizes, and the fold and exact launches; every response must be
   its own query's with k hits, the served ids must agree on >= 99 % of
   slots with the same queries encoded and searched in one direct call
   and on >= 98 % with ``xla_exact`` on the same store, each search call
   must launch the fold once and the exact kernel never, and coalesced
   calls must be fewer than the requests, each of 8, 16, 32 or 64; then
   8 texts added over HTTP must each come back top-1 on their own text,
   be gone after their removal, and /stats and /healthz follow the row
   count; then the same server warm-boots a 1M-row bf16 store of seeded
   unit rows (lazy texts, the fold at tile 4096) and takes the coalesced
   load again (recall@10 against ``xla_exact`` reported); last, ``python
   -m latentrag_torch.serve --device cuda`` answers three JSONL lines (a
   search, a bad request, stats) with three JSON lines, logging to
   stderr only;
3l. (after 3h) the same server warm-boots the 3k store from its sidecars
   and serves 256 single-query requests carrying ``"nprobe": 64`` at
   window 0 (QPS, p50/p99; ids held to direct searches; /stats carries
   ``ivf_recall_estimate``; a bad "nprobe" gets the JAX server's 400);
5. prints a ``kernels`` JSON line and, last, the device line.

Every check that fails exits non-zero. Without CUDA, or without the
package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

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
    # the batches a served search brings (phase 3h): one query at window
    # 0 (15 of the fold's 16-query tile padding) and the coalesced
    # buckets; the fold at the main path's plan and at 1M (tile 4096;
    # k=10, and the 40 candidates its plan asks for), cosine
    for nq in SERVE_QUERY_COUNTS:
        shapes += [
            (f"serve_main_q{nq}", nq, 1997, 64, [40], 128, ("cosine",)),
            (f"serve_1m_q{nq}", nq, 1_000_000, 64, [10, 40], 4096,
             ("cosine",)),
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
    """The main path's config: each kernel and top_k persists its store at
    its own ``retrieval.index_path``, so a run warm-boots only from a run
    of its own kind."""
    return [
        "data.dataset=synthetic", "data.max_samples=2000",
        "encoder.dtype=bfloat16",
        f"models.vae.checkpoint={workdir}/vae.pth",
        f"retrieval.store_dtype={store}", "retrieval.metric=cosine",
        f"retrieval.top_k={top_k}", f"retrieval.kernel={kernel}",
        f"paths.data_dir={workdir}/data",
        f"paths.checkpoints_dir={workdir}/ckpt",
        f"paths.logs_dir={workdir}/logs",
        f"retrieval.index_path={workdir}/index_{kernel}_{top_k}",
        "logging.log_to_file=false", "logging.level=WARNING",
    ]


class _Lines(logging.Handler):
    """The messages of one logger during a run."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list = []

    def emit(self, rec):
        self.lines.append(rec.getMessage())


def run_main(torch, workdir: str, kernel: str,
             store: str = "bfloat16", top_k: int = 10) -> dict:
    """One ``main`` run; ``res["retrieval_log"]`` holds the retriever's
    INFO lines (load, save, skip)."""
    from latentrag_torch import main as cli

    lg = logging.getLogger("latentrag_torch.retrieval")
    lines, level = _Lines(), lg.level
    lg.addHandler(lines)
    lg.setLevel(logging.INFO)
    try:
        res = _run_main(torch, cli, workdir, kernel, store, top_k)
    finally:
        lg.removeHandler(lines)
        lg.setLevel(level)
    res["retrieval_log"] = lines.lines
    return res


def _run_main(torch, cli, workdir, kernel, store, top_k) -> dict:
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
                    store: str = "bfloat16",
                    workdir: str | None = None) -> tuple[dict, dict, dict]:
    """Phase 3: the entry point at full MiniLM-L6 width over a ``store``
    (bf16 or fp32) store; returns the fused kernels' launch counts from the
    kernel=auto runs at top_k=10 and top_k=150, and the top_k=10 oracle's
    result. ``exact_kernel`` names the C kernels phase 2 checked at the
    top_k=150 search's shape for this store. The runs' data and stores go
    to ``workdir`` when given (phase 3h serves them), else to a temporary
    directory."""
    import numpy as np

    from latentrag_torch.data import tokenizer
    from latentrag_torch.ops import fused_topk as ft

    tag = "" if store == "bfloat16" else "_fp32"
    with tempfile.TemporaryDirectory(prefix="lr_smoke_") as tmp:
        wd = workdir or tmp
        write_vae(torch, f"{wd}/vae.pth")
        ft.reset_launches()
        tokenizer.reset_rows_served()
        res = run_main(torch, wd, "auto", store)
        main_launches = dict(ft.launches)
        rows = dict(tokenizer.rows_served)
        ran10 = ft.last_kernel
        # the same run again on its store: a warm boot (phase 3a)
        again = run_main(torch, wd, "auto", store)
        filtered = check_filtered_search(
            torch, failures, main_overrides(wd, "auto", store), store)
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
    # phase 3a: the second run loaded the store and skipped the build and
    # its self-check; its docs and metrics are the first run's
    warm = {
        "loaded": any(x.startswith("index loaded from")
                      for x in again["retrieval_log"]),
        "skipped": "index compatible; skipping rebuild"
                   in again["retrieval_log"],
        "persisted_first": any(x.startswith("index persisted to")
                               for x in res["retrieval_log"]),
        "same_doc_ids": again["retrieved_doc_ids"] == res["retrieved_doc_ids"],
        "same_metrics": again["retrieval_metrics"] == res["retrieval_metrics"],
    }
    record("warm_boot" + tag, store=store,
           cold_build_index_s=res["timings"]["build_index_s"],
           warm_build_index_s=again["timings"]["build_index_s"],
           cold_wall_s=res["wall_s"], warm_wall_s=again["wall_s"],
           retrieval_log=again["retrieval_log"], **warm)
    if not all(warm.values()):
        failures.append(f"the {store} main path's second run did not warm "
                        f"boot as the first left it: {warm}")
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
    return main_launches, oracle, launches150, filtered


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


def bound(nq, n, d, k, dname, extra_bytes=0) -> tuple[float, str]:
    """The least time of a call: its bytes (queries, corpus, [Q, k] output
    and ``extra_bytes``, e.g. a row mask's n/8) over the memory rate, or its
    2 Q N d operations over the store's peak, whichever is larger."""
    size = 2 if dname == "bfloat16" else 4
    by_bytes = (nq * d * size + n * d * size + nq * k * 8 + extra_bytes) \
        / HBM_BYTES_PER_S
    by_ops = 2.0 * nq * n * d / PEAK_OPS[dname]
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def blocks_per_sm(ft, kernel: str, dev: int, d: int, k: int, op: int,
                  masked: bool = False) -> int:
    """Resident blocks an SM of the fold or exact tensor-core kernel (past
    k = 2048 the radix select) for operand kind ``op`` at (d, k), the
    row-mask instance if ``masked``."""
    name = {"fold": "fold_mma", "exact": "exact_mma"}[kernel]
    if kernel == "exact" and k > ft.EXACT_MAX_K:
        name = "exact_select"
    return ft._slots(dev, name, d, k, op, masked) // ft._sm_count(dev)


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


def plain_cascade(torch, r, queries, k, mask=None):
    """The binary store's search with the plain version of the kernel as
    stage 1, at the plan the store uses on the card (above 128 candidates
    the exact search's plain version), and the same stage 2; ``mask`` (the
    packed words of a filter) restricts stage 1 as the store's does.
    Returns host numpy (scores, ids)."""
    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.distances import prepare_for_metric
    from latentrag_torch.retrieval.rescore import exact_rescore_topk

    q = prepare_for_metric(torch.as_tensor(queries).float().cuda(),
                           r.metric, r._whitener)
    ok = min(r.binary_oversample * k, r._corpus_n)
    if ok > ft.FOLD_MAX_K:
        s1, idx = tb.binary_topk(q, r._corpus, r._dim, ok, mask=mask)
        idx = torch.where(s1 > -1e37, idx, -1)
    else:
        block_n, cand = ft.fold_plan(r._corpus_n, ok,
                                     r._effective_recall_target(k))
        _, idx = ft.binary_fused_topk_raw_reference(
            q, r._corpus, d=r._dim, k=cand, block_n=block_n, mask=mask)
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
        # the same latents, through the port's own compressor, into a
        # retriever that persists nothing
        cfg = apply_overrides(Config(), main_overrides(
            wd, "auto", "binary", top_k) + ["retrieval.index_path="])
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
        # phase 3e: a filtered search, stage 1 on the masked kernel
        spec = {"exclude_doc_ids": list(range(0, r._corpus_n, 3))}
        ft.reset_launches()
        _, i_filt = r.search(q_emb, top_k, filter=spec)
        filtered = dict(ft.launches)
        ran_filt = ft.last_kernel
        _, i_filt_plain = plain_cascade(torch, r, q_emb, top_k,
                                        mask=r._filter_device_mask(spec))
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
    agree_filt = slot_agreement(rows(i_filt), rows(i_filt_plain))
    only_allowed = all(int(i) % 3 for i in i_filt.ravel() if i >= 0)
    record("binary_filtered_search", top_k=top_k, filter="exclude_doc_ids",
           allowed=r._corpus_n - len(spec["exclude_doc_ids"]),
           launches=filtered, c_kernel=ran_filt,
           kernel_vs_plain_stage1_doc_agreement=agree_filt,
           only_allowed=only_allowed)
    want_filt = "binary_exact" if r.binary_oversample * top_k > \
        ft.FOLD_MAX_K else "binary_fold"
    if (filtered["masked"] != 1 or filtered[want_filt] != 1
            or agree_filt < BIN_DOC_AGREE or not only_allowed):
        failures.append(f"binary filtered search at top_k={top_k}: "
                        f"{filtered}, agreement {agree_filt}, only allowed "
                        f"{only_allowed}")
    main_launches["filtered"] = filtered
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
    # a metadata field for the where filter of phase 3e
    metadata = [{"shard": i % 10} for i in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.build(x, [""] * n, metadata=metadata)
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
    # phase 3e at 1M: a where filter (a tenth of the rows), stage 1 on the
    # masked binary fold
    spec = {"where": {"shard": 3}}
    ft.reset_launches()
    _, i_w = r.search(q, k, filter=spec)
    launches_w = dict(ft.launches)
    _, i_w_plain = plain_cascade(torch, r, q, k,
                                 mask=r._filter_device_mask(spec))
    agree_w = slot_agreement(i_w.tolist(), i_w_plain.tolist())
    only = all(int(i) % 10 == 3 for i in i_w.ravel() if i >= 0)
    record("binary_capacity_filtered", N=n, Q=nq, k=k, filter=spec,
           launches=launches_w, c_kernel=ft.last_kernel, only_allowed=only,
           kernel_vs_plain_stage1_agreement=agree_w)
    if launches_w["masked"] != 1 or not only or agree_w < BIN_DOC_AGREE:
        failures.append(f"the 1M binary where-filter: {launches_w}, only "
                        f"allowed {only}, agreement {agree_w}")
    del x
    check_store_round_trip(torch, failures, r, q, build_s, "binary", spec)
    del q, r
    torch.cuda.empty_cache()


def binary_bound(nq, n, d, k, extra_bytes=0) -> tuple[float, str]:
    """The TPU kernel's own cost model (pallas_topk.py:484-491): bf16
    queries, packed words and the [Q, k] output read or written once (and
    ``extra_bytes``), and 2*Q*N*d operations at the bf16 tensor-core
    peak."""
    words = -(-d // 32)
    by_bytes = (nq * d * 2 + n * words * 4 + nq * k * 8 + extra_bytes) \
        / HBM_BYTES_PER_S
    by_ops = 2.0 * nq * n * d / PEAK_OPS["bfloat16"]
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def blocked_library_topk(torch, q, pk, d, k, block=1 << 20):
    """The library yardstick over a packed store too large for one score
    matrix: ``binary_topk``'s blocking with the library's calls, each block
    of rows unpacked to +-1 bf16 and scored by ``torch.matmul``, its top k
    by ``torch.topk``, merged with the running list."""
    from latentrag_torch.ops import binary as tb

    qb = q.bfloat16()
    run_s = run_i = None
    for base in range(0, pk.shape[0], block):
        pm1 = tb.binary_unpack(pk[base : base + block], d).bfloat16()
        s, i = torch.topk(torch.matmul(qb, pm1.T).float(), k, dim=1)
        i = i + base
        if run_s is not None:
            s, sel = torch.topk(torch.cat([run_s, s], 1), k, dim=1)
            i = torch.gather(torch.cat([run_i, i], 1), 1, sel)
        run_s, run_i = s, i
    return run_s, run_i


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
    ran = ft.last_kernel
    lib = time_ms(torch, lambda: blocked_library_topk(torch, q, pk, d, cand),
                  reps=2, warmup=1)
    rec = {"shape": "100m", "case": "plan", "Q": nq, "N": n, "d": d,
           "k": cand, "block_n": block_n, "c_kernel": ran,
           "ms": kern, "plain_ms": None, "library_ms": lib,
           "library": "blocked: 1M-row blocks unpacked to +-1 bf16, "
                      "torch.matmul + torch.topk, merged",
           "packed_bytes": pk.numel() * 4,
           "bound_ms": b_ms, "bound_by": b_by}
    record("binary_kernel_time", **rec)
    out[("100m", "plan")] = rec
    del pk, q
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- the row mask

# allowed shares of the masked checks, and the card tests' shapes for them:
# (label, Q, N, d), the reference config and a ragged one at d=384
MASK_ALLOWED = (0.01, 0.1, 0.5, 1.0, "fewer_than_k", "none")
MASK_SHAPES = (("reference", 2000, 315, 64), ("d384", 37, 5003, 384))


def row_mask(torch, n, allowed, k, seed):
    """A seeded bool row mask on the card and its packed int32 words: a
    share of the rows allowed, k // 2 rows (fewer than k), or none."""
    from latentrag_torch.ops.topk import pack_row_mask

    g = torch.Generator(device="cuda").manual_seed(seed)
    if allowed in ("none", "fewer_than_k"):
        m = torch.zeros(n, dtype=torch.bool, device="cuda")
        if allowed == "fewer_than_k":
            m[torch.randperm(n, generator=g, device="cuda")[: max(1, k // 2)]] = True
    else:
        m = torch.rand(n, generator=g, device="cuda") < allowed
    return m, pack_row_mask(m)


def masked_match(torch, m, s_k, i_k, s_p, i_p):
    """A masked kernel call against its plain version: (the same empty
    slots, as (NEG_INF, -1), and allowed rows only; the share of equal ids
    among the live slots; the largest score error at equal ids)."""
    from latentrag_torch.ops.topk import NEG_INF

    live = i_k >= 0
    ok = (torch.equal(i_k < 0, i_p < 0)
          and bool((s_k[~live] == NEG_INF).all())
          and bool(m[i_k[live].long()].all()))
    same = (i_k == i_p) & live
    err = (s_k - s_p).abs()[same]
    n_live = live.sum().item()
    return (ok, same.sum().item() / n_live if n_live else 1.0,
            err.max().item() if err.numel() else 0.0)


def check_masked_kernels(torch, failures: list) -> dict:
    """Phase 2c: the row mask in the fold and exact kernels
    (``fold_mma_kernel<E, OP, true>``, ``exact_mma_kernel<KP, OP, true>``)
    against their masked plain versions, at the reference shape and at
    Q=37, N=5003, d=384, with 1, 10, 50 and 100 % of the rows allowed, a
    mask that allows fewer than k rows and one that allows none: the fold
    at the approximate route's plan (40 candidates), the exact kernel at
    k=10 and 160 (the approximate route past the fold's 128), over bf16 and
    fp32 stores, cosine and euclidean; the binary fold at 128 candidates
    and the exact binary kernel at k=160. Empty slots must be (NEG_INF, -1)
    in both; returns the largest score error at equal ids per instance."""
    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft

    worst = {}
    seed = 400
    for label, nq, n, d in MASK_SHAPES:
        for dname in ("bfloat16", "float32"):
            for metric in ("cosine", "euclidean"):
                seed += 1
                q, c = make_case(torch, metric, getattr(torch, dname), nq, n,
                                 d, seed)
                for mode, k in (("fold", 40), ("exact", 10), ("exact", 160)):
                    block_n = ft.fold_plan(n, 10, 0.99)[0] if mode == "fold" \
                        else 4096
                    for allowed in MASK_ALLOWED:
                        m, words = row_mask(torch, n, allowed, k, seed)
                        s_k, i_k = ft.fused_topk_raw(
                            q, c, k=k, metric=metric, mode=mode,
                            block_n=block_n, mask=words)
                        torch.cuda.synchronize()
                        ran = ft.last_kernel
                        s_p, i_p = ft.fused_topk_raw_reference(
                            q, c, k=k, metric=metric, mode=mode,
                            block_n=block_n, mask=words)
                        if mode == "fold":  # compare exact rescored scores
                            s_k, i_k = ft.rescore_candidates(q, c, i_k, metric)
                            s_p, i_p = ft.rescore_candidates(q, c, i_p, metric)
                        ok, id_match, max_err = masked_match(
                            torch, m, s_k, i_k, s_p, i_p)
                        want = f"{mode}_mma_kernel" + (
                            "<f32>" if dname == "float32" else "") + "<mask>"
                        ok = ok and ran.split("+")[0] == want and id_match >= (
                            FOLD_ID_MATCH if mode == "fold" else EXACT_ID_MATCH)
                        if mode == "exact":
                            same = (i_k == i_p) & (i_k >= 0)
                            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
                            ok = ok and bool(((s_k - s_p).abs() <= tol)[same].all())
                        key = mode + ("_fp32" if dname == "float32" else "") \
                            + "_masked"
                        worst[key] = max(worst.get(key, 0.0), max_err)
                        rec = {"shape": label, "metric": metric, "store": dname,
                               "mode": mode, "k": k, "block_n": block_n,
                               "allowed": allowed, "c_kernel": ran,
                               "id_match": id_match, "max_abs_err": max_err,
                               "empty_slots": int((i_k < 0).sum()), "ok": ok}
                        record("masked_kernel_check", **rec)
                        if not ok:
                            failures.append(f"masked kernel check {rec}")
                del q, c
        q, pk = binary_case(torch, nq, n, d, seed + 50)
        for kernel, k in (("fold", 128), ("exact", 160)):
            for allowed in MASK_ALLOWED:
                m, words = row_mask(torch, n, allowed, k, seed)
                if kernel == "fold":
                    block_n = ft.fold_plan(n, 16, 0.99)[0]
                    _, i_k = ft.binary_fused_topk_raw(
                        q, pk, d=d, k=k, block_n=block_n, mask=words)
                    ran = ft.last_kernel
                    _, i_p = ft.binary_fused_topk_raw_reference(
                        q, pk, d=d, k=k, block_n=block_n, mask=words)
                    s_k, i_k = ft.rescore_binary_candidates(q, pk, i_k, d)
                    s_p, i_p = ft.rescore_binary_candidates(q, pk, i_p, d)
                else:
                    s_k, i_k = ft.binary_exact_topk_raw(q, pk, d=d, k=k,
                                                        mask=words)
                    ran = ft.last_kernel
                    s_p, i_p = tb.binary_topk(q, pk, d, k, mask=m)
                    i_p = torch.where(s_p > -1e37, i_p, -1)
                torch.cuda.synchronize()
                ok, id_match, max_err = masked_match(torch, m, s_k, i_k,
                                                     s_p, i_p)
                ok = ok and ran.split("+")[0] == (
                    f"{kernel}_mma_kernel<bin><mask>") and id_match >= (
                    BIN_ID_MATCH if kernel == "fold" else EXACT_ID_MATCH)
                key = f"binary_{kernel}_masked"
                worst[key] = max(worst.get(key, 0.0), max_err)
                rec = {"shape": label, "kernel": f"binary_{kernel}", "k": k,
                       "allowed": allowed, "c_kernel": ran,
                       "id_match": id_match, "max_abs_err": max_err,
                       "empty_slots": int((i_k < 0).sum()), "ok": ok}
                record("masked_binary_check", **rec)
                if not ok:
                    failures.append(f"masked binary check {rec}")
        del q, pk
    torch.cuda.empty_cache()
    return worst


def check_filtered_search(torch, failures: list, overrides: list,
                          store: str) -> dict:
    """Phase 3e: a filtered search through the user's entry points on the
    store the main path persisted: ``load_retriever`` warm-boots it, then
    ``search(..., filter=)`` at top_k=10 (the masked fold) and top_k=150
    (the masked exact kernel), held to the ``xla_exact`` oracle's filtered
    search over the same store. The queries are stored rows (with a little
    noise) whose own rows the filter excludes. Then each masked kernel is
    held to its masked plain version on this path's own inputs
    (``check_filtered_kernels``). Returns the launch counts of the filtered
    kernel=auto searches."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.retrieval import load_retriever
    from latentrag_torch.utils import Config, apply_overrides

    cfg = apply_overrides(Config(), overrides)
    r = load_retriever(cfg.retrieval, device="cuda")
    o = load_retriever(apply_overrides(
        Config(), overrides + ["retrieval.kernel=xla_exact"]).retrieval,
        device="cuda")
    if r is None or o is None:
        failures.append(f"the {store} main path's store did not load")
        return dict(ft.launches)
    n = r._corpus_n
    g = torch.Generator(device="cuda").manual_seed(17)
    q = r._corpus[: min(n, 1024) : 2].float()
    q = q + 0.01 * torch.randn(q.shape, generator=g, device="cuda")
    specs = {10: {"exclude_doc_ids": list(range(0, n, 2))},
             150: {"doc_ids": list(range(1, n, 5))}}
    ft.reset_launches()
    got = {k: r.search(q, k, filter=spec) for k, spec in specs.items()}
    launches = dict(ft.launches)
    kernels = ft.last_kernel
    for k, spec in specs.items():
        _, i_r = got[k]
        _, i_o = o.search(q, k, filter=spec)
        allowed = set(spec.get("doc_ids") or
                      set(range(n)) - set(spec["exclude_doc_ids"]))
        agree = slot_agreement(i_r.tolist(), i_o.tolist())
        only_allowed = all(int(i) in allowed for i in i_r.ravel() if i >= 0)
        record("filtered_search" + ("" if store == "bfloat16" else "_fp32"),
               store=store, top_k=k, n=n, queries=int(q.shape[0]),
               filter=next(iter(spec)), allowed=len(allowed),
               doc_id_agreement_vs_xla_exact=agree, only_allowed=only_allowed,
               launches=launches, c_kernel=kernels)
        if agree < MAIN_DOC_AGREE or not only_allowed:
            failures.append(f"{store} filtered search at top_k={k}: "
                            f"agreement {agree}, only allowed {only_allowed}")
    if launches["masked"] != 2 or launches["fold"] != 1 or (
            launches["exact"] != 1):
        failures.append(f"the {store} filtered searches did not run the "
                        f"masked fold and exact kernels: {launches}")
    check_filtered_kernels(torch, failures, r, q, specs, store)
    return launches


def check_filtered_kernels(torch, failures: list, r, q, specs: dict,
                           store: str) -> None:
    """Phase 3e's masked kernels against their masked plain versions on the
    filtered searches' own inputs: ``r``'s prepared queries and store, and
    the mask words it cached for each of ``specs`` (top_k -> filter); the
    fold at the plan's candidate count with phase 2c's limits, the exact
    kernel past the fold's k with the large-corpus limits of phase 2
    (ids by set, every slot's score): the main path's latents lie close
    (neighbouring scores ~1e-5 apart, some tied), so two correct sum
    orders swap neighbours, and the unmasked kernel, recorded beside it on
    the same inputs, matches its plain version slot by slot no better."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.distances import prepare_for_metric
    from latentrag_torch.ops.topk import as_bool_mask

    n = r._corpus_n
    qp = prepare_for_metric(q, r.metric, r._whitener).to(
        r._corpus.dtype).contiguous()
    tag = "<f32>" if store == "float32" else ""
    for k, spec in specs.items():
        words = r._filter_device_mask(spec)
        m = as_bool_mask(words, n)
        if k <= ft.FOLD_MAX_K:
            mode = "fold"
            block_n, kk = ft.fold_plan(n, k, r._effective_recall_target(k))
        else:
            mode, block_n, kk = "exact", 4096, k
        s_k, i_k = ft.fused_topk_raw(qp, r._corpus, k=kk, metric=r.metric,
                                     mode=mode, block_n=block_n, mask=words)
        torch.cuda.synchronize()
        ran = ft.last_kernel
        s_p, i_p = ft.fused_topk_raw_reference(
            qp, r._corpus, k=kk, metric=r.metric, mode=mode, block_n=block_n,
            mask=words)
        if mode == "fold":  # compare exact rescored scores
            s_k, i_k = ft.rescore_candidates(qp, r._corpus, i_k, r.metric)
            s_p, i_p = ft.rescore_candidates(qp, r._corpus, i_p, r.metric)
        ok, id_match, max_err = masked_match(torch, m, s_k, i_k, s_p, i_p)
        rec = {"store": store, "top_k": k, "mode": mode, "k": kk,
               "block_n": block_n, "Q": int(qp.shape[0]), "N": n,
               "d": int(qp.shape[1]), "allowed": int(m.sum()),
               "c_kernel": ran, "id_match": id_match, "max_abs_err": max_err,
               "empty_slots": int((i_k < 0).sum())}
        ok = ok and ran.split("+")[0] == f"{mode}_mma_kernel{tag}<mask>"
        if mode == "fold":
            ok = ok and id_match >= FOLD_ID_MATCH
        else:
            slot_err = (s_k - s_p).abs()
            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
            rec["set_match"] = set_match(torch, i_k, i_p)
            rec["slot_max_abs_err"] = slot_err.max().item()
            ok = (ok and rec["set_match"] >= EXACT_ID_MATCH
                  and bool((slot_err <= tol).all()))
            u_k = ft.fused_topk_raw(qp, r._corpus, k=kk, metric=r.metric,
                                    mode=mode)[1]
            u_p = ft.fused_topk_raw_reference(qp, r._corpus, k=kk,
                                              metric=r.metric, mode=mode)[1]
            rec["unmasked_id_match"] = (u_k == u_p).float().mean().item()
        rec["ok"] = ok
        record("filtered_kernel_check", **rec)
        if not ok:
            failures.append(f"filtered-path masked kernel check {rec}")


def store_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def check_store_round_trip(torch, failures: list, r, q, build_s: float,
                           label: str, spec: dict | None = None) -> None:
    """Phases 3f and 3g on a built 1M store ``r``: save it (timed, bytes
    on disk), load it into a fresh retriever (the warm boot, timed against
    the cold build) whose search (``spec``'s filter too) must equal the
    built one's bit for bit; then, on the loaded retriever, which persists
    every mutation, ``add`` 1000 rows (each must retrieve itself top-1) and
    ``remove`` the probes' top-1 hits and 500 of the added rows (none may
    come back, and every survivor keeps its score bit for bit); a reload
    holds the mutated row count. The store lives in a temporary directory,
    deleted after."""
    import numpy as np

    from latentrag_torch.retrieval import DenseRetriever

    k = 10
    with tempfile.TemporaryDirectory(prefix="lr_smoke_store_") as path:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r._save(path)
        save_s = time.perf_counter() - t0
        disk = store_bytes(path)
        t0 = time.perf_counter()
        r2 = DenseRetriever(metric=r.metric, backend=r.backend,
                            store_dtype=r.store_dtype, index_path=path,
                            device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = {}
        for name, f in (("plain", None), ("filtered", spec)):
            if name == "filtered" and spec is None:
                continue
            s1, i1 = r.search(q, k, filter=f)
            s2, i2 = r2.search(q, k, filter=f)
            same[name] = bool(np.array_equal(i1, i2) and np.array_equal(
                s1.view(np.int32), s2.view(np.int32)))
        record("store_round_trip", store=label, N=r._corpus_n, Q=int(q.shape[0]),
               k=k, cold_build_s=build_s, save_s=save_s,
               warm_boot_load_s=load_s, bytes_on_disk=disk,
               loaded=r2.is_built, search_bit_identical=same)
        if not r2.is_built or not all(same.values()):
            failures.append(f"the 1M {label} store did not round-trip: "
                            f"loaded {r2.is_built}, identical {same}")
            return
        del r
        # mutation on the card, persisted at every step
        n0 = r2._corpus_n
        g = torch.Generator(device="cuda").manual_seed(23)
        new = torch.nn.functional.normalize(
            torch.randn((1000, q.shape[1]), generator=g, device="cuda"), dim=1)
        new_ids = list(range(10**8, 10**8 + 1000))
        s_before, i_before = r2.search(q, k)
        ids_before = np.asarray(r2.doc_ids)[np.maximum(i_before, 0)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2.add(new, [f"added {i}" for i in range(1000)], doc_ids=new_ids)
        add_s = time.perf_counter() - t0
        _, i_self = r2.search(new, 1)
        self_top1 = float(np.mean(np.asarray(r2.doc_ids)[i_self[:, 0]]
                                  == np.asarray(new_ids)))
        drop = set(ids_before[:, 0].tolist()) | set(new_ids[::2])
        t0 = time.perf_counter()
        removed = r2.remove(list(drop))
        remove_s = time.perf_counter() - t0
        s_after, i_after = r2.search(q, k)
        ids_after = np.asarray(r2.doc_ids)[np.maximum(i_after, 0)]
        came_back = int(sum(int(i) in drop for i in ids_after.ravel()))
        _, i_gone = r2.search(new[::2], 1)
        came_back += int(sum(r2.doc_ids[int(i)] in drop
                             for i in i_gone[:, 0]))
        changed = compared = 0
        for qi in range(ids_after.shape[0]):
            before = dict(zip(ids_before[qi].tolist(), s_before[qi].tolist()))
            for doc, sc in zip(ids_after[qi].tolist(), s_after[qi].tolist()):
                if doc in before:
                    compared += 1
                    changed += int(before[doc] != sc)
        r3 = DenseRetriever(metric=r2.metric, backend=r2.backend,
                            store_dtype=r2.store_dtype, index_path=path,
                            device="cuda")
        record("mutation", store=label, N=n0, added=1000, removed=removed,
               add_s=add_s, remove_s=remove_s, added_self_top1=self_top1,
               removed_came_back=came_back, survivors_compared=compared,
               survivor_scores_changed=changed,
               reloaded_n=r3._corpus_n,
               live_mutations=(r3.fingerprint or {}).get("live_mutations"))
        if (self_top1 < 1.0 or came_back or changed or compared == 0
                or r3._corpus_n != n0 + 1000 - removed
                or r3.fingerprint.get("live_mutations") != 2):
            failures.append(f"the 1M {label} store's add/remove: top-1 "
                            f"{self_top1}, came back {came_back}, changed "
                            f"{changed}/{compared}, reloaded {r3._corpus_n}")
        del r2, r3
    torch.cuda.empty_cache()


def check_bf16_store_at_scale(torch, failures: list) -> None:
    """Phase 3f for a bf16 store: a DenseRetriever over 1M seeded unit
    rows (d=64), built cold, then ``check_store_round_trip``."""
    from latentrag_torch.retrieval import DenseRetriever

    g = torch.Generator(device="cuda").manual_seed(41)
    x = torch.nn.functional.normalize(
        torch.randn((1_000_000, 64), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((1024, 64), generator=g, device="cuda"), dim=1)
    r = DenseRetriever(store_dtype="bfloat16", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.build(x, [""] * x.shape[0])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del x
    check_store_round_trip(torch, failures, r, q, build_s, "bfloat16")


# ------------------------------------------------- the int8 and int4 stores

MSMARCO_CONFIG = "configs/msmarco_v5e8.yaml"
QUANT_STORES = ("int8", "int4")
# the config's corpus (msmarco_v5e8.yaml:1-2: ~8.8M MS-MARCO passages)
CAPACITY_ROWS = 8_800_000
CAPACITY_RT = 0.95  # the config's recall_target
QUANT_BLOCK = 1 << 20  # the config's block_size: the plain searches' blocks
# the store's answer against the exact plain search (sq8_topk / sq4_topk):
# the fold may drop a row (the route's recall); by set at ties
QUANT_EXACT_AGREE = 0.99
PEAK_INT8_OPS = 1979e12  # dense int8 tensor cores


def quant_op(ft, store: str) -> int:
    return ft._OP_I8 if store == "int8" else ft._OP_I4


def quant_case(torch, store, nq, n, d, seed):
    """Seeded unit queries and corpus on the card, quantized as the store
    holds them: (queries, their SQ8 codes, the corpus's int8 codes or int4
    nibbles, the score factor, the corpus's scale)."""
    from latentrag_torch.ops import quantization as tq

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((nq, d), generator=g, device="cuda"), dim=1)
    qc, qs = tq.sq8_quantize(q)
    c, cs = tq.sq8_quantize(x) if store == "int8" else tq.sq4_quantize(x)
    return q, qc, c, tq.score_factor(qs, cs), cs


def quant_kernel(ft, store, qc, c, fac, d, **kw):
    """The int8 or int4 kernel's wrapper (a CUDA tensor: the kernel)."""
    if store == "int8":
        return ft.sq8_fused_topk_raw(qc, c, fac, **kw)
    return ft.sq4_fused_topk_raw(qc, c, fac, d=d, **kw)


def quant_plain(ft, store, qc, c, fac, d, **kw):
    """The same call's plain PyTorch version, on the card."""
    return ft.quantized_fused_topk_raw_reference(
        qc, c, fac, d=d, op=quant_op(ft, store), **kw)


def quant_fold_plan(ft, store, n, top_k=10, rt=CAPACITY_RT):
    """(tile, candidates) of the fold as the store plans it at top_k: the
    int8 store asks for top_k, the int4 store's stage 1 for 8 x top_k."""
    return ft.fold_plan(n, top_k if store == "int8" else min(8 * top_k, n),
                        rt)


@contextlib.contextmanager
def plain_quantized(ft):
    """Within it, the int8 and int4 routes run their kernels' plain
    versions (on the card), so that a store's search can be held to the
    same search without the kernels."""
    real = ft._quantized_raw

    def plain(q_codes, corpus, factor, *, d, k, op, mode, block_n, mask):
        return ft.quantized_fused_topk_raw_reference(
            q_codes, corpus, factor, d=d, k=k, op=op, mode=mode,
            block_n=block_n, mask=mask)

    ft._quantized_raw = plain
    try:
        yield
    finally:
        ft._quantized_raw = real


def check_quantized_kernels(torch, failures: list) -> dict:
    """Phase 2d: the int8 and int4 fold and exact kernels
    (``fold_mma_kernel<E, OP_I8 / OP_I4>``, ``exact_mma_kernel<KP, ...>``)
    and their row-mask instances (10 % of the rows allowed) against their
    plain versions at the main path's corpus (N=1997, d=64): the fold at
    the store's plan for top_k=10 under the msmarco config's recall_target
    0.95 (int8: 40 candidates; int4: stage 1's 128 for 80), the exact
    kernel at k=10 and k=160, each at every batch the main path brings:
    Q=2000 (the pipeline), Q=1 (the build's self-check, one served query;
    63 of the 64-query tile padding) and the server's coalesced 8-64, each
    batch quantized with its own SQ8 scale. Scores are exact int32 dots
    times one fp32 factor, so the exact kernels must equal their plain
    versions bit for bit (ids and scores) and the fold its plain fold on
    >= 99 % of ids, bit for bit at equal ids. Returns the largest score
    error at equal ids a kernel (0.0 expected)."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq

    worst = {}
    n, d = 1997, 64
    for si, store in enumerate(QUANT_STORES):
        q, _, c, _, cs = quant_case(torch, store, 2000, n, d, 510 + si)
        block_n, cand = quant_fold_plan(ft, store, n)
        for nq in SERVE_QUERY_COUNTS + (2000,):
            qc, qs = tq.sq8_quantize(q[:nq])
            fac = tq.score_factor(qs, cs)
            for masked in (False, True):
                m, words = (row_mask(torch, n, 0.1, 10, 520 + si) if masked
                            else (None, None))
                for mode, k, bn in (("fold", cand, block_n),
                                    ("exact", 10, 4096),
                                    ("exact", 160, 4096)):
                    ft.reset_launches()
                    s_k, i_k = quant_kernel(ft, store, qc, c, fac, d, k=k,
                                            mode=mode, block_n=bn,
                                            mask=words)
                    torch.cuda.synchronize()
                    ran, launched = ft.last_kernel, dict(ft.launches)
                    s_p, i_p = quant_plain(ft, store, qc, c, fac, d, k=k,
                                           mode=mode, block_n=bn, mask=words)
                    same = i_k == i_p
                    id_match = same.float().mean().item()
                    err = (s_k - s_p).abs()[same & (i_k >= 0)]
                    max_err = err.max().item() if err.numel() else 0.0
                    tag = "<i8>" if store == "int8" else "<i4>"
                    want = (f"{mode}_mma_kernel{tag}"
                            + ("<mask>" if masked else ""))
                    ok = (ran.split("+")[0] == want and max_err == 0.0
                          and launched[f"{store}_{mode}"] == 1
                          and launched["masked"] == int(masked))
                    if mode == "exact":
                        ok = (ok and torch.equal(i_k, i_p)
                              and torch.equal(s_k, s_p))
                    else:
                        ok = ok and id_match >= FOLD_ID_MATCH
                    if masked:
                        ok = ok and masked_match(torch, m, s_k, i_k, s_p,
                                                 i_p)[0]
                    key = f"{store}_{mode}" + ("_masked" if masked else "")
                    worst[key] = max(worst.get(key, 0.0), max_err)
                    rec = {"store": store, "mode": mode, "k": k,
                           "block_n": bn, "Q": nq, "N": n, "d": d,
                           "masked": masked, "c_kernel": ran,
                           "id_match": id_match, "max_abs_err": max_err,
                           "ok": ok}
                    record("quant_kernel_check", **rec)
                    if not ok:
                        failures.append(f"quantized kernel check {rec}")
            del qc
        del q, c
    torch.cuda.empty_cache()
    return worst


def write_dae(torch, path: str) -> None:
    from latentrag_torch.models import DenoisingAutoencoder

    torch.manual_seed(1235)
    torch.save(DenoisingAutoencoder(384, 64, 512).state_dict(), path)


def msmarco_overrides(workdir: str, index: str) -> list:
    """What a run of ``configs/msmarco_v5e8.yaml`` needs on this machine:
    the seeded DAE checkpoint, paths in ``workdir``, and the main path's
    2000 synthetic examples (the config's own ``max_samples`` is null,
    200 examples); every retrieval setting is the config's."""
    return [
        "data.max_samples=2000", f"models.dae.checkpoint={workdir}/dae.pth",
        f"paths.data_dir={workdir}/data",
        f"paths.checkpoints_dir={workdir}/ckpt",
        f"paths.logs_dir={workdir}/logs",
        f"retrieval.index_path={workdir}/{index}",
        "logging.log_to_file=false", "logging.level=WARNING",
    ]


def run_msmarco(torch, workdir: str, index: str) -> dict:
    from latentrag_torch import main as cli

    root = os.path.dirname(os.path.abspath(__file__))
    results: list = []
    t0 = time.perf_counter()
    rc = cli.main(["--config", os.path.join(root, MSMARCO_CONFIG),
                   "--ae_type", "dae", "--device", "cuda", "--tag",
                   f"smoke_msmarco_{index}", "--set",
                   *msmarco_overrides(workdir, index)], results=results)
    torch.cuda.synchronize()
    if rc != 0 or len(results) != 1:
        fail(f"main --config {MSMARCO_CONFIG} returned {rc} with "
             f"{len(results)} results")
    res = results[0]
    res["wall_s"] = time.perf_counter() - t0
    return res


def check_msmarco_main(torch, failures: list) -> dict:
    """Phase 3i: ``latentrag_torch.main --config configs/msmarco_v5e8.yaml
    --ae_type dae`` on the card (MiniLM-L6 bf16, a seeded 384->512->64
    DAE, 2000 synthetic examples, the config's int8 store at recall_target
    0.95 and block_size 1048576, shard_corpus served on one card): the
    int8 fold must serve its search and self-check and the exact kernel
    not launch; the same run with the kernels' plain versions must give
    the same doc ids (by set at ties) and metrics; then ``python -m
    latentrag_torch.serve`` boots the same config warm from the first
    run's store and answers one JSONL search. Returns the int8 fold's
    launches in the first run."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="lr_smoke_msmarco_") as wd:
        write_dae(torch, f"{wd}/dae.pth")
        ft.reset_launches()
        res = run_msmarco(torch, wd, "index")
        launches, ran = dict(ft.launches), ft.last_kernel
        with plain_quantized(ft):
            ft.reset_launches()
            plain = run_msmarco(torch, wd, "index_plain")
            plain_launches = dict(ft.launches)
        same = float(tq.same_ids_at_ties(
            res["doc_scores"], res["retrieved_doc_ids"], plain["doc_scores"],
            plain["retrieved_doc_ids"]).mean())
        ds = np.asarray(res["doc_scores"])
        rec = {"config": MSMARCO_CONFIG, "n_queries": res["n_queries"],
               "n_corpus": res["n_corpus"], "dim_in": res["dim_in"],
               "dim_out": res["dim_out"], "launches": launches,
               "c_kernel": ran, "plain_launches": plain_launches,
               "metrics": {m: v["mean"]
                           for m, v in res["retrieval_metrics"].items()},
               "plain_metrics": {m: v["mean"] for m, v in
                                 plain["retrieval_metrics"].items()},
               "timings_s": res["timings"], "wall_s": res["wall_s"],
               "rows_same_by_set_at_ties": same}
        ok = (launches["int8_fold"] >= 2 and launches["int8_exact"] == 0
              and ran.split("+")[0] == "fold_mma_kernel<i8>"
              and not any(plain_launches.values()) and same == 1.0
              and rec["metrics"] == rec["plain_metrics"]
              and res["dim_in"] == 384 and res["dim_out"] == 64
              and ds.shape == (res["n_queries"], 10)
              and bool(np.isfinite(ds).all()))
        rec["ok"] = ok
        record("msmarco_main_path", **rec)
        if not ok:
            failures.append(f"the msmarco int8 main path: {rec}")
        # the server, as users start it, over the first run's store
        line = json.dumps({"query": "what is a telescope", "k": 10})
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "latentrag_torch.serve", "--config",
             os.path.join(root, MSMARCO_CONFIG), "--device", "cuda",
             "--ae_type", "dae", "--set", *msmarco_overrides(wd, "index"),
             "logging.level=INFO"],
            input=line + "\n", capture_output=True, text=True, timeout=600,
            cwd=root)
        try:
            resp = [json.loads(x) for x in out.stdout.splitlines()
                    if x.strip()]
        except ValueError:
            resp = None
        hits = (resp[0].get("results", [{}])[0].get("hits", [])
                if resp else [])
        ok = (out.returncode == 0 and resp is not None and len(resp) == 1
              and len(hits) == 10 and "warm boot in" in out.stderr)
        record("msmarco_serve_cli", rc=out.returncode,
               wall_s=time.perf_counter() - t0, hits=len(hits), ok=ok,
               stderr_tail=out.stderr[-600:])
        if not ok:
            failures.append(f"the msmarco serve CLI: rc {out.returncode}, "
                            f"{len(hits)} hits, {out.stderr[-300:]}")
    return launches


def capacity_search(torch, ft, r, q, k, spec=None) -> dict:
    """One search of a quantized store: seconds, launches, C kernel, and
    the same search with the kernels' plain versions."""
    torch.cuda.synchronize()
    ft.reset_launches()
    t0 = time.perf_counter()
    s, i = r.search(q, k, filter=spec)
    secs = time.perf_counter() - t0
    out = {"s": s, "i": i, "search_s": secs, "launches": dict(ft.launches),
           "c_kernel": ft.last_kernel}
    with plain_quantized(ft):
        out["plain"] = r.search(q, k, filter=spec)
    return out


def check_quantized_capacity(torch, failures: list, store: str) -> dict:
    """Phase 3j: a ``DenseRetriever(store_dtype=store)`` over 8.8M seeded
    unit rows, d=64 (the msmarco config's corpus scale; int8: 563 MB of
    codes on the card; int4: 282 MB of nibbles on the card, 563 MB of SQ8
    codes on the host), recall_target 0.95 and block_size 1048576 as the
    config sets them; 1024 queries at k=10 (the fold), at k=160 (int8) /
    20 (int4: 160 candidates; the exact kernel), and both again with a
    doc_ids filter allowing a tenth of the rows (the masked instances).
    Each search must equal the same search with the kernels' plain
    versions bit for bit (ids by set at ties) and agree with the exact
    plain search (``sq8_topk`` / ``sq4_topk`` in 1M-row blocks) on >= 99 %
    of rows by set; Recall@10 against exact fp32 search is reported. The
    store is then saved, loaded into a fresh retriever, and searched again
    bit for bit. Returns each search's launches."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq
    from latentrag_torch.ops.distances import prepare_for_metric
    from latentrag_torch.ops.topk import exact_topk
    from latentrag_torch.retrieval import DenseRetriever
    from latentrag_torch.retrieval.rescore import exact_rescore_topk

    n, nq, d = CAPACITY_ROWS, 1024, 64
    g = torch.Generator(device="cuda").manual_seed(
        61 if store == "int8" else 62)
    x = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device="cuda"), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn((nq, d), generator=g, device="cuda"), dim=1)
    r = DenseRetriever(store_dtype=store, recall_target=CAPACITY_RT,
                       block_size=QUANT_BLOCK, device="cuda")
    torch.cuda.synchronize()
    ft.reset_launches()
    t0 = time.perf_counter()
    r.build(x, [""] * n)
    torch.cuda.synchronize()
    build_s, build_launches = time.perf_counter() - t0, dict(ft.launches)
    exact_i = exact_topk(q, x, k=10, block_size=QUANT_BLOCK)[1].cpu().numpy()
    qp = prepare_for_metric(q, r.metric)  # the queries as the store meets them
    del x
    torch.cuda.empty_cache()
    spec = {"doc_ids": list(range(0, n, 10))}
    k_exact = 160 if store == "int8" else 20
    out = {}
    for name, k, f in (("fold", 10, None), ("exact", k_exact, None),
                       ("fold_masked", 10, spec),
                       ("exact_masked", k_exact, spec)):
        res = capacity_search(torch, ft, r, q, k, f)
        s, i = res["s"], res["i"]
        s_p, i_p = res["plain"]
        plain_same = float(tq.same_ids_at_ties(s, i, s_p, i_p).mean())
        # the exact plain search in 1M-row blocks (int4: its stage 1, then
        # the store's own host rescore)
        mask = r._filter_device_mask(f) if f else None
        if store == "int8":
            s_x, i_x = tq.sq8_topk(qp, r._corpus, r._corpus_scale, k,
                                   block_size=QUANT_BLOCK, mask=mask)
            s_x, i_x = s_x.cpu().numpy(), i_x.cpu().numpy()
        else:
            ok_ = min(r.binary_oversample * k, r._corpus_n)
            s1, cand = tq.sq4_topk(qp, r._corpus, r._sq4_scale, d, ok_,
                                   block_size=QUANT_BLOCK, mask=mask)
            cand = torch.where(s1 > -1e37, cand, -1)
            s_x, i_x = exact_rescore_topk(
                qp.cpu().numpy(), lambda idx: r._rescore_host[idx],
                cand.cpu().numpy(), k, metric="dot", scale=r._corpus_scale)
        exact_agree = float(np.mean([
            len(set(a.tolist()) & set(b.tolist())) / k
            for a, b in zip(i, i_x)]))
        want = ("fold" if name.startswith("fold") else "exact") + "_mma_kernel" \
            + ("<i8>" if store == "int8" else "<i4>") \
            + ("<mask>" if f else "")
        key = f"{store}_{'fold' if name.startswith('fold') else 'exact'}"
        rec = {"store": store, "search": name, "N": n, "Q": nq, "k": k,
               "search_s": res["search_s"], "launches": res["launches"],
               "c_kernel": res["c_kernel"],
               "plain_rows_same_by_set_at_ties": plain_same,
               "exact_plain_agreement": exact_agree}
        if name == "fold":
            rec["recall_at_10_vs_fp32_exact"] = float(np.mean([
                len(set(a.tolist()) & set(b.tolist())) / 10
                for a, b in zip(i, exact_i)]))
        if f:
            rec["only_allowed"] = bool(all(int(v) % 10 == 0
                                           for v in i.ravel() if v >= 0))
        ok = (res["c_kernel"].split("+")[0] == want
              and res["launches"][key] == 1
              and res["launches"]["masked"] == int(bool(f))
              and plain_same == 1.0 and exact_agree >= QUANT_EXACT_AGREE
              and rec.get("only_allowed", True))
        rec["ok"] = ok
        record("quant_capacity_search", **rec)
        if not ok:
            failures.append(f"the 8.8M {store} store's {name} search: {rec}")
        out[name] = res["launches"]
        out.setdefault("first", (s, i))
    s0, i0 = out.pop("first")
    host_bytes = int(r._rescore_host.nbytes) if r._rescore_host is not None \
        else 0
    with tempfile.TemporaryDirectory(prefix="lr_smoke_store_") as path:
        t0 = time.perf_counter()
        r._save(path)
        save_s = time.perf_counter() - t0
        disk = store_bytes(path)
        t0 = time.perf_counter()
        r2 = DenseRetriever(store_dtype=store, recall_target=CAPACITY_RT,
                            block_size=QUANT_BLOCK, index_path=path,
                            device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        s2, i2 = r2.search(q, 10)
        same_codes = r2.is_built and torch.equal(r._corpus, r2._corpus)
        if store == "int4":
            same_codes = same_codes and np.array_equal(
                r._rescore_host, r2._rescore_host) and (
                r._sq4_scale == r2._sq4_scale)
        rec = {"store": store, "N": n, "build_s": build_s,
               "build_launches": build_launches,
               "device_bytes": r._corpus.numel() * r._corpus.element_size(),
               "host_rescore_bytes": host_bytes, "save_s": save_s,
               "warm_boot_load_s": load_s, "bytes_on_disk": disk,
               "same_codes": bool(same_codes),
               "same_scale": r._corpus_scale == r2._corpus_scale,
               "ids_bit_identical": bool(np.array_equal(i0, i2)),
               "scores_bit_identical": bool(np.array_equal(
                   np.asarray(s0).view(np.int32),
                   np.asarray(s2).view(np.int32)))}
        rec["ok"] = ok = (rec["same_codes"] and rec["same_scale"]
                          and rec["ids_bit_identical"]
                          and rec["scores_bit_identical"])
        record("quant_capacity_store", **rec)
        if not ok:
            failures.append(f"the 8.8M {store} store's round trip: {rec}")
        del r2
    del r, q, qp
    torch.cuda.empty_cache()
    return out


def quant_bound(nq, n, d, k, store, extra_bytes=0) -> tuple[float, str]:
    """The least time of an int8 / int4 call: the query codes, the corpus
    (d or ceil(d/2) bytes a row), the [Q, k] output (and ``extra_bytes``,
    a row mask's N/8) once over the memory rate, or 2 Q N d operations at
    the int8 tensor-core peak, whichever is larger."""
    row = d if store == "int8" else -(-d // 2)
    by_bytes = (nq * d + n * row + nq * k * 8 + extra_bytes) / HBM_BYTES_PER_S
    by_ops = 2.0 * nq * n * d / PEAK_INT8_OPS
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def int_mm_topk(torch, qc, rows, fac, k, mask=None, block=QUANT_BLOCK):
    """The library yardstick the port never calls: ``torch._int_mm`` (int8
    x int8 -> int32, cuBLAS) of the query codes against the int8 code
    rows, times the factor, then ``torch.topk``, in blocks of ``block``
    rows merged with the running list (one score matrix of 1024 x 8.8M
    would be 36 GB). A block pads to a multiple of 8 rows, as ``_int_mm``
    needs, with rows that never win."""
    run_s = run_i = None
    for base in range(0, rows.shape[0], block):
        blk = rows[base : base + block]
        pad = (-blk.shape[0]) % 8
        if pad:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, pad))
        s = torch._int_mm(qc, blk.T).float() * fac
        s = s[:, : blk.shape[0] - pad]
        if mask is not None:
            s = torch.where(mask[None, base : base + s.shape[1]], s,
                            float("-inf"))
        s, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        i = i + base
        if run_s is not None:
            s, sel = torch.topk(torch.cat([run_s, s], 1), k, dim=1)
            i = torch.gather(torch.cat([run_i, i], 1), 1, sel)
        run_s, run_i = s, i
    return run_s, run_i


def time_quantized(torch) -> dict:
    """Phase 4d: the int8 and int4 kernels at the reference shape (Q=2000,
    N=315) and the capacity shape (Q=1024, N=8.8M), d=64: the fold at the
    store's plan for top_k=10 (int8: 40 candidates; int4: 128), the exact
    kernel at k=10 and k=160, and the fold and exact k=10 row-mask
    instances with 10 % of the rows allowed; each beside its plain version
    (at 8.8M one call), the library yardstick ``int_mm_topk`` at the
    call's k (int4: over its codes unpacked to int8), the bound
    (``quant_bound``), a profiler device split and the resident blocks an
    SM. Keys: (shape, store + "_" + case)."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq

    out = {}
    for label, nq, n in (("reference", 2000, 315),
                         ("capacity", 1024, CAPACITY_ROWS)):
        big = n > QUANT_BLOCK
        for si, store in enumerate(QUANT_STORES):
            d = 64
            _, qc, c, fac, _ = quant_case(torch, store, nq, n, d, 600 + si)
            rows = c if store == "int8" else tq.sq4_unpack(c, d)
            m, words = row_mask(torch, n, 0.1, 10, 610 + si)
            block_n, cand = quant_fold_plan(ft, store, n)
            for case, mode, k, bn, masked in (
                    ("fold", "fold", cand, block_n, False),
                    ("exact", "exact", 10, 4096, False),
                    ("exact_k160", "exact", 160, 4096, False),
                    ("fold_masked", "fold", cand, block_n, True),
                    ("exact_masked", "exact", 10, 4096, True)):
                mk = words if masked else None
                call = lambda: quant_kernel(  # noqa: E731
                    ft, store, qc, c, fac, d, k=k, mode=mode, block_n=bn,
                    mask=mk)
                kern = time_ms(torch, call)
                ran = ft.last_kernel
                plain = time_ms(torch, lambda: quant_plain(
                    ft, store, qc, c, fac, d, k=k, mode=mode, block_n=bn,
                    mask=mk), reps=1 if big else 10, warmup=0 if big else 1)
                lib = time_ms(torch, lambda: int_mm_topk(
                    torch, qc, rows, fac, k, m if masked else None),
                    reps=5 if big else 25)
                b_ms, b_by = quant_bound(nq, n, d, k, store,
                                         n / 8 if masked else 0)
                rec = {"shape": label, "store": store, "case": case,
                       "mode": mode, "Q": nq, "N": n, "d": d, "k": k,
                       "block_n": bn, "masked": masked, "c_kernel": ran,
                       "ms": kern, "plain_ms": plain, "library_ms": lib,
                       "library_k": k, "bound_ms": b_ms, "bound_by": b_by,
                       "device_ms": device_split(torch, call),
                       "blocks_per_sm": blocks_per_sm(
                           ft, mode, qc.device.index, d, min(k, n),
                           quant_op(ft, store), masked)}
                record("quant_kernel_time", **rec)
                out[(label, f"{store}_{case}")] = rec
            del qc, c, rows
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ the device IVF

IVF_NLIST = 8192  # docs/DEPLOYMENT.md's setting for the msmarco store
IVF_CAP = 512
IVF_SPREAD = 0.08  # scripts/ivf_bench.py's mixture: 4 x nlist centres
IVF_PINNED = 64  # the served probes' budget (phase 3l)
IVF_CASCADE_ROWS = 1_000_000
IVF_CASCADE_NLIST = 1024
IVF_ANCHOR_AGREE = 0.999  # full probe vs the exact plain search, by set
IVF_BIN_AGREE = 0.99  # binary cascade: kernel vs plain scan, ids
IVF_SERVE_REQUESTS = 256
IVF_SCAN_KINDS = ("int8", "bfloat16", "float32", "int4", "binary")
IVF_SCAN_MASKS = (None, 0.01, 0.1, 1.0, "none")


def ivf_mixture(torch, n, d, n_centers, seed, centers=None):
    """Seeded clustered unit rows on the card, as scripts/ivf_bench.py
    builds its corpora: unit centres, each row a centre plus
    ``IVF_SPREAD`` Gaussian noise, normalized. Returns (rows, centres)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if centers is None:
        centers = torch.nn.functional.normalize(
            torch.randn((n_centers, d), generator=g, device="cuda"), dim=1)
    x = torch.empty((n, d), device="cuda")
    for base in range(0, n, 1 << 22):  # bounded temporaries
        m = min(1 << 22, n - base)
        which = torch.randint(0, centers.shape[0], (m,), generator=g,
                              device="cuda")
        x[base : base + m] = torch.nn.functional.normalize(
            centers[which] + IVF_SPREAD * torch.randn(
                (m, d), generator=g, device="cuda"), dim=1)
    return x, centers


def ivf_rows(torch, x, kind):
    """``x`` as the store of ``kind`` holds it: (rows, scale, dim)."""
    from latentrag_torch.ops import quantization as tq
    from latentrag_torch.ops.binary import binary_quantize

    if kind == "int8":
        c, s = tq.sq8_quantize(x)
        return c, float(s), 0
    if kind == "int4":
        c, s = tq.sq4_quantize(x)
        return c, float(s), x.shape[1]
    if kind == "binary":
        return binary_quantize(x), None, x.shape[1]
    return x.to(getattr(torch, kind)).contiguous(), None, 0


def ivf_operands(torch, kind, q, scale):
    """The scan's queries for ``kind`` and its factor."""
    from latentrag_torch.ops import quantization as tq

    if kind in ("int8", "int4"):
        qc, qs = tq.sq8_quantize(q)
        return qc.contiguous(), tq.score_factor(qs, scale)
    if kind == "float32":
        return q.contiguous(), None
    return q.to(torch.bfloat16).contiguous(), None


def ivf_scan_match(torch, kind, got, want):
    """(ok, ids equal share, max |score error| at live slots) of the
    kernel's (scores, ids) against the plain version's."""
    s_k, i_k = got
    s_p, i_p = want
    ids_eq = (i_k == i_p).float().mean().item()
    live = (i_p >= 0) & (i_k == i_p)
    empty_ok = bool(((s_k == -3.4e38) == (i_k < 0)).all()
                    and ((s_p == -3.4e38) == (i_p < 0)).all())
    err = (s_k - s_p).abs()[live]
    worst = float(err.max()) if err.numel() else 0.0
    if kind in ("int8", "int4"):
        ok = torch.equal(i_k, i_p) and torch.equal(
            s_k.view(torch.int32), s_p.view(torch.int32))
    else:
        atol, rtol = ((BIN_SCORE_ATOL, BIN_SCORE_RTOL) if kind == "binary"
                      else (EXACT_SCORE_ATOL, EXACT_SCORE_RTOL))
        ok = ids_eq >= EXACT_ID_MATCH and bool(
            (err <= atol + rtol * s_p.abs()[live]).all())
    return ok and empty_ok, ids_eq, worst


def check_ivf_scan(torch, failures: list) -> dict:
    """Phase 2e: ``ivf_scan`` against ``ivf_scan_reference`` on the card,
    every operand kind (int8, bf16, fp32, int4, binary), unmasked and
    masked (1, 10, 100 % allowed, none allowed), Q = 1, 8 and 64, over
    clustered corpora of ~20k rows at cap 64 and 512: d = 64 for every
    kind, d = 48 and 384 for the float blocks (48: element loads; 384:
    wide 16-byte rows), d = 63 for int4 (an odd width, element loads);
    each index with 500 rows appended as blocks at the tail, each probe
    set the 16 best blocks plus a sentinel slot (never read). int8 / int4
    bit for bit; float and binary as phase 2's exact kernels; empty slots
    (NEG_INF, -1) on both sides; the C kernel's name as the kind routes.
    Euclidean scores for the float kinds at Q = 8. Returns the worst
    score error."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.ops.kmeans import assign_clusters
    from latentrag_torch.ops.quantization import sq4_quantize_with_scale
    from latentrag_torch.ops.topk import pack_row_mask

    t_phase = time.perf_counter()
    tags = {"int8": "<i8>", "bfloat16": "", "float32": "<f32>",
            "int4": "<i4>", "binary": "<bin>"}
    worst, checks, bad = 0.0, 0, 0
    cases = [(kind, 64) for kind in IVF_SCAN_KINDS] + [
        ("bfloat16", 48), ("bfloat16", 384), ("float32", 48),
        ("float32", 384), ("int4", 63)]
    for ci, (kind, d) in enumerate(cases):
        x, cent = ivf_mixture(torch, 20_000, d, 64, 700 + ci)
        extra, _ = ivf_mixture(torch, 500, d, 64, 800 + ci, centers=cent)
        assign = assign_clusters(x, cent)
        rows, scale, dim = ivf_rows(torch, x, kind)
        if kind in ("int8", "int4"):  # at the store's own scale
            lim = 127 if kind == "int8" else 7
            codes = torch.clamp(torch.round(extra / scale), -lim, lim)
            new_rows = codes.to(torch.int8) if kind == "int8" else \
                sq4_quantize_with_scale(extra, scale)
        else:
            new_rows = ivf_rows(torch, extra, kind)[0]
        n_total = 20_500
        for cap in (64, 512):
            idx = tivf.ivf_build_from_assign(rows, cent, assign, cap)
            idx = tivf.ivf_append(idx, new_rows, 20_000, dim=dim)
            for nq in (1, 8, 64):
                q, _ = ivf_mixture(torch, nq, d, 64, 900 + nq, centers=cent)
                qv, fac = ivf_operands(torch, kind, q, scale)
                sel = tivf._coarse(q @ idx.centroids.T, idx, 16, True, None)
                sel = torch.cat([sel, torch.full((nq, 1), idx.nblocks,
                                                 dtype=torch.int32,
                                                 device="cuda")], 1)
                for mi, allowed in enumerate(IVF_SCAN_MASKS):
                    m = None
                    if allowed is not None:
                        g = torch.Generator(device="cuda").manual_seed(mi)
                        keep = (torch.rand(n_total, generator=g, device="cuda")
                                < (0.0 if allowed == "none" else allowed))
                        m = pack_row_mask(keep)
                    for euclid in ((False, True) if kind in (
                            "bfloat16", "float32") and nq == 8
                            and allowed is None else (False,)):
                        kw = dict(dim=dim, factor=fac, mask=m, euclid=euclid)
                        before = ft.launches["ivf_scan"]
                        got = tivf.ivf_scan(qv, idx.blocks, idx.block_ids,
                                            sel, **kw)
                        torch.cuda.synchronize()
                        ran = ft.last_kernel
                        launched = ft.launches["ivf_scan"] - before
                        want = tivf.ivf_scan_reference(
                            qv, idx.blocks, idx.block_ids, sel, **kw)
                        ok, ids_eq, err = ivf_scan_match(torch, kind, got,
                                                         want)
                        name = f"ivf_scan_kernel{tags[kind]}" + (
                            "<mask>" if m is not None else "")
                        ok = ok and ran == name and launched == 1
                        if allowed == "none":
                            ok = ok and bool((got[1] == -1).all())
                        worst = max(worst, err)
                        checks += 1
                        if not ok:
                            bad += 1
                            rec = {"kind": kind, "d": d, "cap": cap,
                                   "Q": nq, "allowed": allowed,
                                   "euclid": euclid, "ids_equal": ids_eq,
                                   "max_abs_err": err, "c_kernel": ran,
                                   "launches": launched}
                            record("ivf_scan_check", ok=False, **rec)
                            failures.append(f"ivf_scan vs plain: {rec}")
        del x, extra, rows, new_rows, idx
    torch.cuda.empty_cache()
    record("ivf_scan_check", ok=not bad, checks=checks,
           max_abs_err=worst, phase_s=time.perf_counter() - t_phase)
    return {"ivf_scan": worst}


@contextlib.contextmanager
def plain_ivf_scan():
    """Within it, ``ivf_search`` scores with ``ivf_scan_reference`` (on the
    card), so a search can be held to the same search without the
    kernel."""
    from latentrag_torch.ops import ivf as tivf

    real = tivf.ivf_scan
    tivf.ivf_scan = tivf.ivf_scan_reference
    try:
        yield
    finally:
        tivf.ivf_scan = real


def same_bits(a, b) -> bool:
    import numpy as np

    (s_a, i_a), (s_b, i_b) = a, b
    return bool(np.array_equal(np.asarray(i_a), np.asarray(i_b))
                and np.array_equal(np.asarray(s_a, np.float32).view(np.int32),
                                   np.asarray(s_b, np.float32).view(np.int32)))


def ivf_route_search(torch, ft, r, q, k, nprobe=None, spec=None) -> dict:
    """One search with its launches, seconds, C kernel, and the same
    search on the plain scan."""
    torch.cuda.synchronize()
    ft.reset_launches()
    t0 = time.perf_counter()
    s, i = r.search(q, k, filter=spec, nprobe=nprobe)
    out = {"s": s, "i": i, "search_s": time.perf_counter() - t0,
           "launches": dict(ft.launches), "c_kernel": ft.last_kernel}
    with plain_ivf_scan():
        out["plain"] = r.search(q, k, filter=spec, nprobe=nprobe)
    return out


def ivf_scan_bound(torch, idx, sel, ids, row_bytes) -> tuple[float, str]:
    """The least time of a scan: the distinct probed blocks' live rows
    and their 4-byte ids read once, the [Q, S*cap] scores and ids written
    once, over the memory rate (2 d operations a row byte at most: far
    under the card's ridge)."""
    blocks = torch.unique(sel)
    blocks = blocks[blocks < idx.nblocks].long()
    live = int((idx.block_ids[blocks] >= 0).sum())
    nbytes = (live * row_bytes + blocks.numel() * idx.cap * 4
              + ids.numel() * 8 + sel.numel() * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def ivf_library(torch, qv, fac, blocks, sel, k):
    """The library yardstick the port never calls: ``index_select`` of the
    probed blocks, one fp32 ``bmm`` (the int8 codes as fp32, exact below
    2^24), ``torch.topk``."""
    nq, s_n = sel.shape
    nb, cap, w = blocks.shape
    rows = blocks.index_select(0, sel.clamp(max=nb - 1).reshape(-1).long())
    rows = rows.reshape(nq, s_n * cap, w).float()
    s = torch.bmm(rows, qv.float()[:, :, None])[..., 0]
    if fac is not None:
        s = s * fac
    return torch.topk(s, k, dim=1)


def time_ivf(torch, r, cases) -> dict:
    """Phase 4e on the 3k store: for each (label, queries, pinned nprobe),
    the scan at the search's own probe set (wrapper ms by CUDA events,
    device ms by the profiler), its plain version, its bound, the library
    yardstick, and the whole IVF search call beside the exhaustive int8
    search of the same queries on the same store."""
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.ops.distances import prepare_for_metric

    out = {}
    idx = r._ensure_ivf()
    for label, q, nprobe in cases:
        qp = prepare_for_metric(q.float(), r.metric)
        budget = (min(1 << (nprobe - 1).bit_length(), idx.nblocks)
                  if nprobe else tivf.auto_nprobe(idx.nblocks))
        sel = tivf._coarse(qp @ idx.centroids.T, idx, budget, False,
                           r._ivf_mlb[1])
        qv, fac = ivf_operands(torch, "int8", qp, r._corpus_scale)
        call = lambda: tivf.ivf_scan(  # noqa: E731
            qv, idx.blocks, idx.block_ids, sel, factor=fac)
        s, ids = call()
        b_ms, b_by = ivf_scan_bound(torch, idx, sel, ids, idx.row_width)
        # the search call's other device steps, alone: the coarse stage
        # (centroid scores, the list or block top-k, the expansion), the
        # queries' SQ8 codes, the select over the scan's slots
        split = {
            "coarse_ms": time_ms(torch, lambda: tivf._coarse(
                qp @ idx.centroids.T, idx, budget, False, r._ivf_mlb[1])),
            "quantize_ms": time_ms(torch, lambda: ivf_operands(
                torch, "int8", qp, r._corpus_scale)),
            "select_ms": time_ms(torch, lambda: tivf._top_lower(s, 10)),
        }
        rec = {"case": label, "Q": int(q.shape[0]), "nprobe": budget,
               "probed_blocks": int(sel.shape[1]),
               "slots": int(ids.shape[1]),
               "live_slots": int((ids >= 0).sum()),
               "ms": time_ms(torch, call),
               "device_ms": device_split(torch, call),
               "plain_ms": time_ms(torch, lambda: tivf.ivf_scan_reference(
                   qv, idx.blocks, idx.block_ids, sel, factor=fac), reps=3,
                   warmup=1),
               "library_ms": time_ms(torch, lambda: ivf_library(
                   torch, qv, fac, idx.blocks, sel, 10), reps=5),
               "bound_ms": b_ms, "bound_by": b_by, **split,
               "search_ms": time_ms(torch, lambda: r.search(
                   q, 10, nprobe=nprobe), reps=10)}
        nlist = r.ivf_nlist
        r.ivf_nlist = 0  # the same store's exhaustive route
        try:
            rec["exhaustive_search_ms"] = time_ms(
                torch, lambda: r.search(q, 10), reps=10)
        finally:
            r.ivf_nlist = nlist
        record("ivf_kernel_time", card=card_line(), **rec)
        out[label] = rec
    return out


def check_ivf_deployment(torch, failures: list, workdir: str) -> dict:
    """Phase 3k: the msmarco int8 store with the IVF its documentation
    names (configs/msmarco_v5e8.yaml:28-37, docs/DEPLOYMENT.md:60-63:
    ``ivf_nlist=8192``, cap 512) over 8.8M x 64 seeded clustered rows (4 x
    nlist centres, spread 0.08), persisted at ``workdir/ivf_store`` (phase
    3l serves it). Records the build split, the layout and the recall
    estimate; works out the routes from the built store and holds them:
    Q = 1 and 8 at the auto budget and Q = 64 with pinned budgets go
    through one ``ivf_scan`` launch and no fold, each equal bit for bit to
    the same search on the plain scan (overlap with the exhaustive route
    reported); Q = 64 at the auto budget and Q = 1024 stay exhaustive;
    the full probe with ``exact_select`` equals the exact plain search by
    set on >= 99.9 % of rows; a doc_ids filter (a tenth of the rows) runs
    the masked scan and returns only allowed ids; a second retriever on
    the same path restores the layout from the sidecars without k-means
    and answers bit for bit; 1000 added rows append to the layout and
    each comes back top-1 on itself at the auto budget (at 64, reported);
    a remove drops the IVF. Phase 4e's
    timings run on this store. Returns the ivf_scan launches of the
    searches driven here and the timings."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.ops import quantization as tq
    from latentrag_torch.ops.distances import prepare_for_metric
    from latentrag_torch.retrieval import DenseRetriever

    t_phase = time.perf_counter()
    n, d = CAPACITY_ROWS, 64
    path = f"{workdir}/ivf_store"
    kw = dict(store_dtype="int8", backend="xla", recall_target=CAPACITY_RT,
              block_size=QUANT_BLOCK, ivf_nlist=IVF_NLIST, ivf_cap=IVF_CAP,
              device="cuda")
    x, centers = ivf_mixture(torch, n, d, 4 * IVF_NLIST, 71)
    torch.cuda.reset_peak_memory_stats()
    r = DenseRetriever(index_path=path, **kw)
    t0 = time.perf_counter()
    r.build(x, [""] * n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del x
    torch.cuda.empty_cache()
    idx = r._ivf_index
    b2l = idx.block2list.cpu().numpy()
    rows_est = n // IVF_CAP
    auto_est = tivf.auto_nprobe(max(1, rows_est))
    auto = tivf.auto_nprobe(idx.nblocks)
    routes = {f"Q={nq}": r._ivf_eligible(nq, "xla") for nq in
              (1, 8, 12, 13, 64, 1024)}
    build = {"N": n, "nlist": IVF_NLIST, "cap": IVF_CAP,
             "build_and_save_s": build_s, **r._ivf_build_info,
             "nblocks": idx.nblocks,
             "max_list_blocks": int(np.bincount(b2l).max()),
             "empty_lists": int(IVF_NLIST - len(np.unique(b2l))),
             "ivf_recall_estimate": r._ivf_recall_estimate,
             "auto_nprobe": auto, "guard_nprobe_estimate": auto_est,
             "guard_rows": n // 4, "routes": routes,
             "corpus_bytes": r._corpus.numel(),
             "ivf_block_bytes": idx.blocks.numel(),
             "peak_device_bytes": torch.cuda.max_memory_allocated()}
    record("ivf_build", card=card_line(), **build)
    if not (routes["Q=1"] and routes["Q=8"] and not routes["Q=64"]
            and not routes["Q=1024"]):
        failures.append(f"the IVF's routes at 8.8M: {routes}")
    qs = {nq: ivf_mixture(torch, nq, d, 0, 72 + nq, centers=centers)[0]
          for nq in (1, 8, 64, 1024)}
    launches = 0
    routed = [("Q=1 auto", 1, None), ("Q=8 auto", 8, None),
              ("Q=64 pinned 64", 64, IVF_PINNED), ("Q=64 pinned auto", 64,
                                                   auto)]
    first = {}
    for label, nq, nprobe in routed:
        res = ivf_route_search(torch, ft, r, qs[nq], 10, nprobe)
        launches += res["launches"]["ivf_scan"]
        with_ivf = r.ivf_nlist
        r.ivf_nlist = 0
        s_x, i_x = r.search(qs[nq], 10)  # the exhaustive route
        r.ivf_nlist = with_ivf
        rec = {"case": label, "Q": nq, "nprobe": nprobe,
               "search_s": res["search_s"], "launches": {
                   k: v for k, v in res["launches"].items() if v},
               "c_kernel": res["c_kernel"],
               "plain_scan_bit_identical": same_bits(
                   (res["s"], res["i"]), res["plain"]),
               "overlap_with_exhaustive": float(np.mean([
                   len(set(a.tolist()) & set(b.tolist())) / 10
                   for a, b in zip(res["i"], i_x)]))}
        ok = (res["launches"]["ivf_scan"] == 1
              and res["launches"]["int8_fold"] == 0
              and res["launches"]["int8_exact"] == 0
              and rec["plain_scan_bit_identical"]
              and (res["c_kernel"] or "").startswith("ivf_scan_kernel<i8>"))
        record("ivf_search", ok=ok, **rec)
        if not ok:
            failures.append(f"the 8.8M IVF search {label}: {rec}")
        first[label] = (res["s"], res["i"])
    for label, nq in (("Q=64 auto", 64), ("Q=1024", 1024)):
        torch.cuda.synchronize()
        ft.reset_launches()
        r.search(qs[nq], 10)
        got = dict(ft.launches)
        ok = got["ivf_scan"] == 0 and got["int8_fold"] >= 1
        record("ivf_search", ok=ok, case=label, Q=nq, launches={
            k: v for k, v in got.items() if v})
        if not ok:
            failures.append(f"the 8.8M store at {label} left the exhaustive "
                            f"route: {got}")
    # the differential anchor: every block probed, exact select
    qp = prepare_for_metric(qs[8], r.metric)
    ft.reset_launches()
    s_a, i_a = tivf.ivf_search(qp, idx, k=10, nprobe=idx.nblocks,
                               scale=r._corpus_scale, exact_select=True)
    launches += ft.launches["ivf_scan"]
    s_x, i_x = tq.sq8_topk(qp, r._corpus, r._corpus_scale, 10,
                           block_size=QUANT_BLOCK)
    anchor = float(tq.same_ids_at_ties(s_a, i_a, s_x, i_x).mean())
    record("ivf_anchor", Q=8, nprobe=idx.nblocks, rows_same_by_set=anchor)
    if anchor < IVF_ANCHOR_AGREE:
        failures.append(f"the full IVF probe vs the exact plain search: "
                        f"{anchor} of rows")
    # a filter: a tenth of the rows, the masked scan
    spec = {"doc_ids": list(range(0, n, 10))}
    res = ivf_route_search(torch, ft, r, qs[8], 10, None, spec)
    launches += res["launches"]["ivf_scan"]
    ids = res["i"]
    frec = {"search_s": res["search_s"], "c_kernel": res["c_kernel"],
            "launches": {k: v for k, v in res["launches"].items() if v},
            "only_allowed": bool(all(int(v) % 10 == 0 for v in ids.ravel()
                                     if v >= 0)),
            "plain_scan_bit_identical": same_bits((res["s"], ids),
                                                  res["plain"])}
    ok = (res["launches"]["ivf_scan"] == 1 and res["launches"]["masked"] == 1
          and frec["only_allowed"] and frec["plain_scan_bit_identical"])
    record("ivf_filtered", ok=ok, **frec)
    if not ok:
        failures.append(f"the filtered 8.8M IVF search: {frec}")
    # the warm boot: the sidecars, no k-means, the same answers
    real_kmeans = tivf.kmeans

    def refuse(*a, **k):
        raise RuntimeError("k-means ran on a warm boot")

    tivf.kmeans = refuse
    try:
        t0 = time.perf_counter()
        r2 = DenseRetriever(index_path=path, **kw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        again = {label: r2.search(qs[nq], 10, nprobe=nprobe)
                 for label, nq, nprobe in routed}
    finally:
        tivf.kmeans = real_kmeans
    wrec = {"load_s": load_s, "restore": r2._ivf_build_info,
            "recall_estimate": r2._ivf_recall_estimate,
            "bit_identical": all(same_bits(first[k], again[k])
                                 for k in first)}
    ok = (r2._ivf_build_info.get("restored") is True
          and wrec["bit_identical"]
          and r2._ivf_recall_estimate == r._ivf_recall_estimate)
    record("ivf_warm_boot", ok=ok, **wrec)
    if not ok:
        failures.append(f"the 8.8M IVF warm boot: {wrec}")
    times = time_ivf(torch, r2, [("Q=1 auto", qs[1], None),
                                 ("Q=8 auto", qs[8], None),
                                 ("Q=64 pinned 64", qs[64], IVF_PINNED),
                                 ("Q=64 pinned auto", qs[64], auto)])
    del r2
    torch.cuda.empty_cache()
    # add 1000 rows to the built retriever (its texts a list: a loaded
    # store's lazy texts would materialise 8.8M strings first), not
    # persisted (the CPU tests hold the append's save)
    r.index_path = None
    new, _ = ivf_mixture(torch, 1000, d, 0, 79, centers=centers)
    nb = r._ivf_index.nblocks
    t0 = time.perf_counter()
    r.add(new, [""] * 1000)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    arec = {"add_s": add_s, "appended": r._ivf_appended,
            "nblocks": [nb, r._ivf_index.nblocks]}
    ft.reset_launches()
    for budget in (auto, IVF_PINNED):  # held at the auto budget
        top1 = []
        for base in range(0, 1000, r.ivf_query_limit):
            _, i = r.search(new[base : base + r.ivf_query_limit], 1,
                            nprobe=budget)
            top1 += (i[:, 0] == np.arange(n + base, n + base + len(i))
                     ).tolist()
        arec[f"top1_on_itself_nprobe_{budget}"] = float(np.mean(top1))
    launches += ft.launches["ivf_scan"]
    arec["scan_launches"] = ft.launches["ivf_scan"]
    r.remove([0])
    arec["ivf_after_remove"] = r._ivf_index is not None
    ok = (arec["appended"] == 1000 and arec["nblocks"][1] > nb
          and arec[f"top1_on_itself_nprobe_{auto}"] == 1.0
          and not arec["ivf_after_remove"])
    record("ivf_mutation", ok=ok, **arec)
    if not ok:
        failures.append(f"the 8.8M IVF add/remove: {arec}")
    del r, qs, new
    torch.cuda.empty_cache()
    record("ivf_deployment", phase_s=time.perf_counter() - t_phase)
    return {"launches": launches, "times": times, "auto": auto}


def check_ivf_cascades(torch, failures: list) -> int:
    """Phase 3k, the cascades: int4 and binary stores over a 1M-row
    clustered mixture with ``ivf_nlist=1024`` (cap 512); stage 1 (8 x k
    candidates) through the IVF at Q = 1 and 8 with the auto budget and
    at Q = 64 pinned to it, one ``ivf_scan`` launch a search and no fold;
    int4 equal bit for bit to the same search on the plain scan, binary on
    >= 99 % of ids. Returns the ivf_scan launches."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.retrieval import DenseRetriever

    t_phase = time.perf_counter()
    n, d = IVF_CASCADE_ROWS, 64
    x, centers = ivf_mixture(torch, n, d, 4 * IVF_CASCADE_NLIST, 81)
    launches = 0
    for store in ("int4", "binary"):
        r = DenseRetriever(store_dtype=store, backend="xla",
                           recall_target=CAPACITY_RT,
                           block_size=QUANT_BLOCK,
                           ivf_nlist=IVF_CASCADE_NLIST, ivf_cap=IVF_CAP,
                           device="cuda")
        t0 = time.perf_counter()
        r.build(x, [""] * n)
        r._ensure_ivf()  # the layout and its recall probe, before the counts
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        auto = tivf.auto_nprobe(max(1, n // IVF_CAP))
        for nq, nprobe in ((1, None), (8, None), (64, auto)):
            q = ivf_mixture(torch, nq, d, 0, 90 + nq, centers=centers)[0]
            res = ivf_route_search(torch, ft, r, q, 10, nprobe)
            launches += res["launches"]["ivf_scan"]
            if store == "int4":
                agree = float(same_bits((res["s"], res["i"]), res["plain"]))
            else:
                agree = float(np.mean(res["i"] == res["plain"][1]))
            rec = {"store": store, "Q": nq, "nprobe": nprobe,
                   "build_s": build_s if nq == 1 else None,
                   "ivf_build": r._ivf_build_info if nq == 1 else None,
                   "recall_estimate": r._ivf_recall_estimate,
                   "search_s": res["search_s"], "c_kernel": res["c_kernel"],
                   "launches": {k: v for k, v in res["launches"].items()
                                if v},
                   "plain_scan_agreement": agree}
            exhaustive = sum(v for key, v in res["launches"].items()
                             if key.startswith(store + "_"))
            ok = (res["launches"]["ivf_scan"] == 1 and exhaustive == 0
                  and agree >= (1.0 if store == "int4" else IVF_BIN_AGREE))
            record("ivf_cascade", ok=ok, **rec)
            if not ok:
                failures.append(f"the 1M {store} cascade's IVF stage 1: "
                                f"{rec}")
        del r
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    record("ivf_cascades", phase_s=time.perf_counter() - t_phase)
    return launches


def check_ivf_serving(torch, failures: list, workdir: str) -> int:
    """Phase 3l: the server (``latentrag_torch.serve``'s boot and HTTP
    handler, in this process as phase 3h runs it) warm-boots the 3k store
    from its sidecars with the main path's encoder and a 64-d VAE, then
    serves 256 single-query requests carrying ``"nprobe": 64`` at window
    0 from 64 clients: each answer's ids match the same query encoded
    alone and searched directly with ``nprobe=64`` on >= 99 % of slots,
    every search call launches ``ivf_scan`` once and no fold, /stats
    carries ``ivf_recall_estimate``, and a request whose "nprobe" is not a
    positive integer gets the JAX server's 400 text. Records QPS and the
    client p50/p99. Returns the ivf_scan launches of the load."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    queries = eval_queries(IVF_SERVE_REQUESTS)
    cfg = apply_overrides(load_config(None), main_overrides(
        workdir, "xla", "int8") + [
        f"retrieval.index_path={workdir}/ivf_store",
        f"retrieval.ivf_nlist={IVF_NLIST}", f"retrieval.ivf_cap={IVF_CAP}",
        f"retrieval.recall_target={CAPACITY_RT}",
        f"retrieval.block_size={QUANT_BLOCK}"])
    server_env, spy, boot_rec = boot_server(torch, cfg, failures, "IVF")
    retriever = server_env[2]
    with running_server(cfg, server_env, 0.0) as srv:
        warm = serve_load(queries[:8], srv.port, extra={"nprobe": IVF_PINNED})
        spy.reset()
        ft.reset_launches()
        res = serve_load(queries, srv.port, extra={"nprobe": IVF_PINNED})
        got = dict(ft.launches)
        calls = list(spy.sizes)
        stats = http_json(srv.port, "GET", "/stats")
        bad = http_json(srv.port, "POST", "/search",
                        {"query": queries[0], "nprobe": 0})
    direct = []
    for qtext in queries:
        emb = spy.encode([qtext])
        _, i = spy.search(emb, SERVE_K, nprobe=IVF_PINNED)
        direct.append([retriever.doc_ids[j] for j in i[0] if j >= 0])
    served = [(r or {}).get("ids", []) for r in res["responses"]]
    errors = [r for r in res["responses"] if not r or "ids" not in r]
    lat = np.asarray([x for x in res["latency_ms"] if x is not None])
    rec = {"boot": boot_rec, "requests": len(queries), "nprobe": IVF_PINNED,
           "warmup_wall_s": warm["wall_s"],
           "qps": len(queries) / res["wall_s"], "wall_s": res["wall_s"],
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "search_calls": len(calls), "encode_s": spy.encode_s,
           "search_s": spy.search_s,
           "launches": {k: v for k, v in got.items() if v},
           "direct_agreement": slot_agreement(served, direct),
           "ivf_recall_estimate": stats.get("ivf_recall_estimate"),
           "bad_nprobe": [bad.get("status"), bad.get("error")],
           "failed_requests": len(errors),
           "first_failure": errors[0] if errors else None,
           "phase_s": time.perf_counter() - t_phase}
    ok = (not errors and rec["direct_agreement"] >= SERVE_DIRECT_AGREE
          and got["ivf_scan"] == len(calls) == len(queries)
          and got["int8_fold"] == 0
          and rec["ivf_recall_estimate"] is not None
          and rec["bad_nprobe"] == [
              400, 'ValueError: "nprobe" must be a positive integer'])
    record("ivf_serve", card=card_line(), ok=ok, **rec)
    if not ok:
        failures.append(f"the served IVF probes: {rec}")
    del server_env, spy, retriever
    torch.cuda.empty_cache()
    return got["ivf_scan"]


# ------------------------------------------------------------ phase 3h

SERVE_REQUESTS = 1024
SERVE_CLIENTS = 64
SERVE_WARMUP_W0 = 16  # window 0's warm-up burst (see timed_load)
SERVE_K = 10
SERVE_DIRECT_AGREE = 0.99  # served ids vs one direct call, slot by slot
SERVE_SIZES = (8, 16, 32, 64)  # the coalesced batches' encoder buckets
SERVE_QUERY_COUNTS = (1,) + SERVE_SIZES  # window 0's, and the coalesced
SERVE_1M_ROWS = 1_000_000

# the load's clients, a process of their own so that their interpreter
# time does not compete with the server's threads: argv port, requests,
# clients, k; stdin the queries (JSON); stdout one JSON object with the
# wall time, each request's latency (ms, send to last byte) and what each
# response held
SERVE_CLIENT = r"""
import http.client, json, sys, threading, time
port, n, clients, k = (int(a) for a in sys.argv[1:5])
extra = json.loads(sys.argv[5]) if len(sys.argv) > 5 else {}
queries = json.load(sys.stdin)
lat, resp, nxt, lock = [None] * n, [None] * n, [0], threading.Lock()
start = threading.Barrier(clients + 1)

def work():
    start.wait()
    while True:
        with lock:
            i = nxt[0]
            nxt[0] += 1
        if i >= n:
            return
        body = json.dumps({"query": queries[i % len(queries)], "k": k,
                           **extra})
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/search", body,
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            out = json.loads(r.read())
        finally:
            conn.close()
        lat[i] = (time.perf_counter() - t0) * 1e3
        if r.status == 200:
            res = out["results"][0]
            resp[i] = {"query": res["query"],
                       "ids": [h["doc_id"] for h in res["hits"]]}
        else:
            resp[i] = {"status": r.status, "error": out.get("error")}

threads = [threading.Thread(target=work) for _ in range(clients)]
for t in threads:
    t.start()
start.wait()
t0 = time.perf_counter()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
json.dump({"wall_s": wall, "latency_ms": lat, "responses": resp},
          sys.stdout)
"""


def serve_load(queries, port: int, k: int = SERVE_K,
               clients: int = SERVE_CLIENTS, extra: dict | None = None) -> dict:
    """``len(queries)`` single-query searches from ``clients`` concurrent
    clients in a subprocess (each request's body with ``extra``'s keys);
    its JSON result."""
    out = subprocess.run(
        [sys.executable, "-c", SERVE_CLIENT, str(port), str(len(queries)),
         str(clients), str(k), json.dumps(extra or {})],
        input=json.dumps(list(queries)), capture_output=True, text=True,
        timeout=600)
    if out.returncode != 0:
        fail(f"the serve load's clients failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


class ServeSpy:
    """Counts and times a booted server's ``retriever.search`` (the batch
    sizes it gets) and ``compressor.encode_text`` (synchronised, so its
    time is the encode's), as ``tests/test_serving.py`` spies on search.
    ``search`` and ``encode`` stay the originals, for direct calls."""

    def __init__(self, torch, retriever, compressor):
        self.search, self.encode = retriever.search, compressor.encode_text
        self.reset()

        # the original's signature stays visible: the server reads it
        # (inspect) to accept "filter" and "nprobe"
        @functools.wraps(self.search)
        def search(q_emb, k, **kw):
            t0 = time.perf_counter()
            out = self.search(q_emb, k, **kw)
            self.search_s += time.perf_counter() - t0
            self.sizes.append(int(q_emb.shape[0]))
            return out

        def encode(texts):
            t0 = time.perf_counter()
            emb = self.encode(texts)
            torch.cuda.synchronize()
            self.encode_s += time.perf_counter() - t0
            return emb

        retriever.search = search
        compressor.encode_text = encode

    def reset(self) -> None:
        self.sizes: list = []
        self.search_s = self.encode_s = 0.0


def serve_args(window_ms: float):
    return SimpleNamespace(ae_type="vae", generate=False, cold_boot=False,
                           device="cuda", batch_window_ms=window_ms,
                           max_batch=64, http=0)


def boot_server(torch, cfg, failures: list, label: str):
    """``serve.boot`` in this process; it must warm-boot and encode
    nothing. Returns (runner, compressor, retriever, spy, boot record)."""
    from latentrag_torch import serve
    from latentrag_torch.retrieval import EmbeddingCompressor

    encoded = []
    orig = EmbeddingCompressor.encode_text

    def encode_spy(self, texts):
        encoded.append(len(texts))
        return orig(self, texts)

    EmbeddingCompressor.encode_text = encode_spy
    loggers = SimpleNamespace(main=logging.getLogger("latentrag_torch.main"))
    t0 = time.perf_counter()
    try:
        runner, compressor, retriever, mode = serve.boot(
            cfg, serve_args(0), loggers)
    finally:
        EmbeddingCompressor.encode_text = orig
    torch.cuda.synchronize()
    rec = {"boot": mode, "boot_s": time.perf_counter() - t0,
           "encode_calls_at_boot": encoded, "n_docs": len(retriever.texts),
           "texts": type(retriever.texts).__name__}
    if mode != "warm" or encoded:
        failures.append(f"the {label} server did not warm-boot without an "
                        f"encode: {rec}")
    spy = ServeSpy(torch, retriever, compressor)
    return (runner, compressor, retriever, mode, loggers), spy, rec


@contextlib.contextmanager
def running_server(cfg, server_env, window_ms: float):
    """``make_handle`` at ``window_ms`` behind a started HTTP server
    (``serve.running_http``), stopped with its batcher on exit; yields
    (port, window_ms)."""
    from latentrag_torch import serve

    runner, compressor, retriever, mode, loggers = server_env
    handle = serve.make_handle(cfg, serve_args(window_ms), runner,
                               compressor, retriever, mode)
    with serve.running_http(handle, retriever, mode, "127.0.0.1", 0,
                            loggers) as server:
        yield SimpleNamespace(port=server.server_address[1],
                              window_ms=window_ms)


def timed_load(torch, srv, spy, queries) -> dict:
    """A warm-up burst under the profiler (the device's busy share of its
    wall time: the timed load runs without the profiler), then the timed
    load with the counts at 0: QPS, client latency percentiles, the search
    calls' sizes, the fold and exact launches, and the host time in encode
    and search."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from latentrag_torch.ops import fused_topk as ft

    # the warm-up: one request a client when the window is on, so that
    # the coalesced load's largest batch (64) is warm before the timed
    # load (a first batch of 64 costs ~0.4 s); at window 0, where every
    # search is one query, fewer, as the profiler costs 70-95 ms a
    # request there
    warmup = SERVE_CLIENTS if srv.window_ms > 0 else SERVE_WARMUP_W0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = serve_load(queries[:warmup], srv.port)["wall_s"]
    busy_us = sum(getattr(ev, "device_time_total", 0) or 0
                  for ev in prof.key_averages())
    profiled_s = time.perf_counter() - t0
    spy.reset()
    ft.reset_launches()
    res = serve_load(queries, srv.port)
    launches = dict(ft.launches)
    calls, encode_s, search_s = list(spy.sizes), spy.encode_s, spy.search_s
    lat = np.asarray([x for x in res["latency_ms"] if x is not None])
    sizes = {}
    for n in calls:
        sizes[n] = sizes.get(n, 0) + 1
    return {
        "window_ms": srv.window_ms, "requests": len(queries),
        "clients": SERVE_CLIENTS, "k": SERVE_K,
        "qps": len(queries) / res["wall_s"], "wall_s": res["wall_s"],
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(lat.mean()), "max_ms": float(lat.max()),
        "search_calls": len(calls), "search_sizes": sizes,
        "encode_s": encode_s, "search_s": search_s,
        "launches": {key: launches[key] for key in ("fold", "exact")},
        "c_kernel": ft.last_kernel,
        "device_busy_share": busy_us / 1e6 / wall,
        "profiled_requests": warmup, "profiled_wall_s": wall,
        "profiled_s": profiled_s,
        "responses": res["responses"],
    }


def check_load(load: dict, queries, failures: list, label: str) -> None:
    """Phase 3h (iii) on one load: each response is its own query's, with
    k hits; one fold launch a search call, no exact launch; with the
    window on, fewer calls than requests, each of an encoder bucket."""
    resp = load["responses"]
    bad = [i for i, r in enumerate(resp)
           if r is None or r.get("query") != queries[i]
           or len(r.get("ids", ())) != SERVE_K]
    load["bad_responses"] = len(bad)
    if bad:
        failures.append(f"{label}: {len(bad)} responses without their own "
                        f"query or k hits, first {resp[bad[0]]}")
    if (load["launches"]["fold"] != load["search_calls"]
            or load["launches"]["exact"] != 0
            or not (load["c_kernel"] or "").startswith("fold_mma_kernel")):
        failures.append(f"{label}: launches {load['launches']} for "
                        f"{load['search_calls']} search calls, last "
                        f"kernel {load['c_kernel']}")
    if load["window_ms"] > 0 and (
            load["search_calls"] >= load["requests"]
            or set(load["search_sizes"]) - set(SERVE_SIZES)):
        failures.append(f"{label}: coalesced calls {load['search_calls']} "
                        f"of sizes {load['search_sizes']}")


def reference_ids(retriever, spy, queries, index: str):
    """The doc ids of the queries encoded and searched in one direct call
    on the served retriever (the originals, not the spies), and searched
    by ``xla_exact`` over the same store loaded from ``index``."""
    from latentrag_torch.retrieval import DenseRetriever

    emb = spy.encode(queries)
    exact = DenseRetriever(backend="xla_exact", store_dtype="bfloat16",
                           index_path=index, device="cuda")
    out = []
    for r, search in ((retriever, spy.search), (exact, exact.search)):
        _, idx = search(emb, SERVE_K)
        out.append([[r.doc_ids[j] for j in row if j >= 0] for row in idx])
    return out


def http_json(port: int, method: str, path: str, body=None) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return {"status": r.status, **json.loads(r.read())}
    finally:
        conn.close()


def check_http_mutation(port: int, n_docs: int, failures: list) -> dict:
    """Phase 3h (iv): 8 texts added over HTTP each come back top-1 on
    their own text, are gone after the remove, and /stats and /healthz
    follow the row count."""
    texts = [f"zzqx served probe {i} on quasar {7919 * (i + 3)} nebula"
             for i in range(8)]
    ids = list(range(10**9, 10**9 + 8))
    added = http_json(port, "POST", "/add", {"texts": texts, "doc_ids": ids})
    found = http_json(port, "POST", "/search",
                      {"queries": texts, "k": SERVE_K})
    stats_added = http_json(port, "GET", "/stats")
    health_added = http_json(port, "GET", "/healthz")
    removed = http_json(port, "POST", "/remove", {"doc_ids": ids})
    gone = http_json(port, "POST", "/search",
                     {"queries": texts, "k": SERVE_K})
    stats = http_json(port, "GET", "/stats")
    health = http_json(port, "GET", "/healthz")
    top1 = [r["hits"][0]["doc_id"] for r in found.get("results", [])]
    came_back = sum(h["doc_id"] in ids for r in gone.get("results", [])
                    for h in r["hits"])
    rec = {"added": added.get("added"), "n_total_added": added.get("n_total"),
           "top1_is_added": top1 == ids, "removed": removed.get("removed"),
           "n_total_removed": removed.get("n_total"), "came_back": came_back,
           "stats_n_docs": [stats_added.get("n_docs"), stats.get("n_docs")],
           "healthz_n_docs": [health_added.get("n_docs"),
                              health.get("n_docs")]}
    want = [n_docs + 8, n_docs]
    if not (rec["added"] == 8 and rec["n_total_added"] == n_docs + 8
            and rec["top1_is_added"] and rec["removed"] == 8
            and rec["n_total_removed"] == n_docs and came_back == 0
            and rec["stats_n_docs"] == want
            and rec["healthz_n_docs"] == want):
        failures.append(f"add/remove over HTTP: {rec}")
    return rec


def check_serving(torch, failures: list, workdir: str) -> dict:
    """Phase 3h on the main path's store (a copy of what phase 3's first
    bf16 run persisted, with its data_dir's tokenizer): a warm boot at
    full width, 1024 concurrent single-query searches at window 0 and 2
    ms, each held to one direct call and to ``xla_exact``, then add and
    remove over HTTP; then a 1M-row store and the CLI. Returns the fold
    launches of each timed load."""
    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    queries = eval_queries(SERVE_REQUESTS)
    index = f"{workdir}/serve_index"
    shutil.copytree(f"{workdir}/index_auto_10", index)
    cfg = apply_overrides(load_config(None), main_overrides(
        workdir, "auto", "bfloat16") + [f"retrieval.index_path={index}"])
    server_env, spy, boot_rec = boot_server(torch, cfg, failures, "main")
    retriever = server_env[2]
    loads = {}
    for window in (0.0, 2.0):
        with running_server(cfg, server_env, window) as srv:
            loads[window] = load = timed_load(torch, srv, spy, queries)
            check_load(load, queries, failures, f"serve window {window}")
            if window > 0:
                mutation = check_http_mutation(srv.port, boot_rec["n_docs"],
                                               failures)
    # a request's two device steps alone, the server idle: one query and
    # a full batch
    alone = {}
    for n in (1, 64):
        qs = queries[:n]
        emb = spy.encode(qs)
        alone[f"encode_{n}_ms"] = time_ms(torch, lambda: spy.encode(qs),
                                          reps=10)
        alone[f"search_{n}_ms"] = time_ms(
            torch, lambda: spy.search(emb, SERVE_K), reps=10)
    direct, oracle = reference_ids(retriever, spy, queries, index)
    for load in loads.values():
        served = [r["ids"] for r in load.pop("responses")]
        load["direct_agreement"] = slot_agreement(served, direct)
        load["exact_agreement"] = slot_agreement(served, oracle)
        if (load["direct_agreement"] < SERVE_DIRECT_AGREE
                or load["exact_agreement"] < MAIN_DOC_AGREE):
            failures.append(
                f"served ids at window {load['window_ms']}: "
                f"{load['direct_agreement']} of slots as the direct call "
                f"(>= {SERVE_DIRECT_AGREE}), {load['exact_agreement']} as "
                f"xla_exact (>= {MAIN_DOC_AGREE})")
    record("serve", card=card_line(), store="bfloat16", **boot_rec,
           loads=list(loads.values()), mutation=mutation,
           speedup_qps=loads[2.0]["qps"] / loads[0.0]["qps"], alone=alone,
           phase_s=time.perf_counter() - t_phase)
    del server_env, spy, retriever
    launches = {"serve_w0": loads[0.0]["launches"]["fold"],
                "serve_w2": loads[2.0]["launches"]["fold"]}
    launches["serve_1m"] = check_serving_1m(torch, failures, workdir,
                                            queries)
    check_serve_cli(failures, workdir, queries[0])
    torch.cuda.empty_cache()
    return launches


def eval_queries(n: int) -> list:
    """The first ``n`` queries of the main path's synthetic eval set."""
    from latentrag_torch.data import load_evaluation_data, synthetic_examples

    queries, _, _ = load_evaluation_data(synthetic_examples(2000))
    return list(queries[:n])


def check_serving_1m(torch, failures: list, workdir: str, queries) -> int:
    """Phase 3h (v): a 1M-row bf16 store of seeded unit rows (d=64) saved
    at its own index_path, warm-booted by the same server (texts stay
    lazy; the fold at tile 4096), loaded with the window on; served ids
    held to one direct call, recall@10 against ``xla_exact`` reported."""
    from latentrag_torch.retrieval import DenseRetriever
    from latentrag_torch.retrieval.dense import make_fingerprint
    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    index = f"{workdir}/serve_index_1m"
    cfg = apply_overrides(load_config(None), main_overrides(
        workdir, "auto", "bfloat16") + [f"retrieval.index_path={index}"])
    g = torch.Generator(device="cuda").manual_seed(53)
    x = torch.nn.functional.normalize(
        torch.randn((SERVE_1M_ROWS, 64), generator=g, device="cuda"), dim=1)
    r = DenseRetriever(store_dtype="bfloat16", index_path=index,
                       device="cuda")
    t0 = time.perf_counter()
    r.build(x, [""] * x.shape[0], fingerprint=make_fingerprint(
        d=64, embedding_model=cfg.encoder.name, ae_type="vae",
        latent_dim=64))
    torch.cuda.synchronize()
    build_save_s = time.perf_counter() - t0
    del r, x
    torch.cuda.empty_cache()
    server_env, spy, boot_rec = boot_server(torch, cfg, failures, "1M")
    retriever = server_env[2]
    with running_server(cfg, server_env, 2.0) as srv:
        load = timed_load(torch, srv, spy, queries)
    check_load(load, queries, failures, "serve 1M")
    direct, oracle = reference_ids(retriever, spy, queries, index)
    served = [r["ids"] for r in load.pop("responses")]
    load["direct_agreement"] = slot_agreement(served, direct)
    load["recall_at_10_vs_exact"] = sum(
        len(set(s) & set(o)) for s, o in zip(served, oracle)) / sum(
        len(o) for o in oracle)
    boot_rec["texts_after_load"] = type(retriever.texts).__name__
    record("serve_1m", card=card_line(), store="bfloat16",
           build_and_save_s=build_save_s, **boot_rec, load=load,
           phase_s=time.perf_counter() - t_phase)
    if load["direct_agreement"] < SERVE_DIRECT_AGREE or (
            boot_rec["texts_after_load"] != "LazyTexts"):
        failures.append(f"the 1M server: {load['direct_agreement']} of "
                        f"slots as the direct call, texts "
                        f"{boot_rec['texts_after_load']}")
    del server_env, spy, retriever
    torch.cuda.empty_cache()
    return load["launches"]["fold"]


def check_serve_cli(failures: list, workdir: str, query: str) -> None:
    """Phase 3h (vi): ``python -m latentrag_torch.serve --device cuda``
    as users start it, over JSONL on a copy of the main path's store: a
    search, a bad request and a stats request give three JSON lines on
    stdout, one of them an error, rc 0, and the logs on stderr."""
    root = os.path.dirname(os.path.abspath(__file__))
    index = f"{workdir}/serve_index_cli"
    shutil.copytree(f"{workdir}/index_auto_10", index)
    overrides = main_overrides(workdir, "auto", "bfloat16") + [
        f"retrieval.index_path={index}", "logging.level=INFO"]
    lines = [json.dumps({"query": query, "k": SERVE_K}),
             json.dumps({"queries": "a bare string"}),
             json.dumps({"stats": True})]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "latentrag_torch.serve", "--device", "cuda",
         "--ae_type", "vae", "--set", *overrides],
        input="".join(x + "\n" for x in lines), capture_output=True,
        text=True, timeout=600, cwd=root)
    wall = time.perf_counter() - t0
    try:
        resp = [json.loads(x) for x in out.stdout.splitlines() if x.strip()]
    except ValueError:
        resp = None
    rec = {"rc": out.returncode, "wall_s": wall, "stdout_lines":
           len(out.stdout.splitlines()), "json_lines": resp is not None,
           "stderr_tail": out.stderr[-600:]}
    ok = out.returncode == 0 and resp is not None and len(resp) == 3
    if ok:
        hits = resp[0].get("results", [{}])[0].get("hits", [])
        rec.update(hits=len(hits), error=resp[1].get("error"),
                   boot=resp[2].get("boot"), n_docs=resp[2].get("n_docs"))
        ok = (len(hits) == SERVE_K and "error" in resp[1]
              and "error" not in resp[0] and resp[2].get("boot") == "warm"
              and "warm boot in" in out.stderr)
    record("serve_cli", **rec)
    if not ok:
        failures.append(f"the serve CLI: {rec}")


def time_masked(torch) -> dict:
    """Phase 4c: the masked kernels with 10 % of the rows allowed, cosine,
    at the reference shape and at 1024 x 1M: the fold at the plan and the
    exact kernel at k=10 over bf16 and fp32 stores, the binary fold at the
    binary store's plan (80 candidates) and the exact binary kernel at
    k=160; each beside the same call unmasked in the same run, its masked
    plain version and the masked library call (``torch.topk`` of
    ``torch.where(mask, torch.matmul(q, c.T).float(), -inf)``; binary: the
    corpus pre-unpacked to +-1 bf16), with the bound (the mask's n/8 bytes
    added). Keys: (shape, kernel)."""
    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft

    out = {}
    d = 64
    ninf = float("-inf")
    for label, nq, n in (("reference", 2000, 315), ("1m", 1024, 1_000_000)):
        m, words = row_mask(torch, n, 0.1, 10, 7)
        big = n > 10_000
        for dname in ("bfloat16", "float32"):
            q, c = make_case(torch, "cosine", getattr(torch, dname), nq, n,
                             d, 97)
            block_n, cand = ft.fold_plan(n, 10, 0.99)
            for mode, kk, bn in (("fold", cand, block_n), ("exact", 10, 4096)):
                call = lambda w: ft.fused_topk_raw(  # noqa: E731
                    q, c, k=kk, metric="cosine", mode=mode, block_n=bn,
                    mask=w)
                kern = time_ms(torch, lambda: call(words))
                ran = ft.last_kernel
                unmasked = time_ms(torch, lambda: call(None))
                plain = time_ms(torch, lambda: ft.fused_topk_raw_reference(
                    q, c, k=kk, metric="cosine", mode=mode, block_n=bn,
                    mask=words), reps=3 if big else 10, warmup=1)
                lib = time_ms(torch, lambda: torch.topk(torch.where(
                    m, torch.matmul(q, c.T).float(), ninf), kk, dim=1),
                    reps=10 if big else 25)
                b_ms, b_by = bound(nq, n, d, kk, dname, extra_bytes=n / 8)
                tag = mode + ("_fp32" if dname == "float32" else "")
                rec = {"shape": label, "kernel": tag, "Q": nq, "N": n, "d": d,
                       "k": kk, "block_n": bn, "allowed": 0.1,
                       "c_kernel": ran, "ms": kern, "unmasked_ms": unmasked,
                       "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "device_ms": device_split(torch, lambda: call(words))}
                record("masked_kernel_time", **rec)
                out[(label, tag)] = rec
            del q, c
            torch.cuda.empty_cache()
        q, pk = binary_case(torch, nq, n, d, 78)
        qb = q.bfloat16()
        pm1 = tb.binary_unpack(pk, d).bfloat16()
        block_n, cand = ft.fold_plan(n, min(80, n), 0.99)
        for kernel, kk in (("binary_fold", cand), ("binary_exact", 160)):
            if kernel == "binary_fold":
                call = lambda w: ft.binary_fused_topk_raw(  # noqa: E731
                    q, pk, d=d, k=kk, block_n=block_n, mask=w)
                plain_fn = lambda: ft.binary_fused_topk_raw_reference(  # noqa: E731
                    q, pk, d=d, k=kk, block_n=block_n, mask=words)
            else:
                call = lambda w: ft.binary_exact_topk_raw(  # noqa: E731
                    q, pk, d=d, k=kk, mask=w)
                plain_fn = lambda: tb.binary_topk(q, pk, d, kk, mask=m)  # noqa: E731
            kern = time_ms(torch, lambda: call(words))
            ran = ft.last_kernel
            unmasked = time_ms(torch, lambda: call(None))
            plain = time_ms(torch, plain_fn, reps=3 if big else 10, warmup=1)
            lib = time_ms(torch, lambda: torch.topk(torch.where(
                m, torch.matmul(qb, pm1.T).float(), ninf), kk, dim=1),
                reps=10 if big else 25)
            b_ms, b_by = binary_bound(nq, n, d, min(kk, n), extra_bytes=n / 8)
            rec = {"shape": label, "kernel": kernel, "Q": nq, "N": n, "d": d,
                   "k": kk, "allowed": 0.1, "c_kernel": ran, "ms": kern,
                   "unmasked_ms": unmasked, "plain_ms": plain,
                   "library_ms": lib, "library_reads_bytes_x": 16,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "device_ms": device_split(torch, lambda: call(words))}
            record("masked_kernel_time", **rec)
            out[(label, kernel)] = rec
        del q, pk, qb, pm1, m, words
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
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import ivf as tivf
    from latentrag_torch.utils import native

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    # the kernels' three libraries (the fold and exact kernels without and
    # with the row mask, the IVF's scan), by three nvcc processes at once
    cuda_build.load_libraries(ft.LIBRARIES + tivf.LIBRARIES)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_library()  # the C++ tokenizer's library, g++
    record("build", card=card, torch=torch.__version__,
           cuda=torch.version.cuda, build_s=build_s,
           nvcc_s=dict(cuda_build.build_seconds),
           host_library_s=time.perf_counter() - t0)

    failures: list = []
    worst = check_kernels(torch, failures)
    check_select_fallbacks(torch, failures)
    worst.update(check_binary_kernel(torch, failures))
    worst.update(check_masked_kernels(torch, failures))
    worst.update(check_quantized_kernels(torch, failures))
    worst.update(check_ivf_scan(torch, failures))
    if failures:
        fail("; ".join(failures[:5]))
    # the bf16 main path's data and stores outlive it: phase 3h serves them
    main_wd = tempfile.mkdtemp(prefix="lr_smoke_")
    atexit.register(shutil.rmtree, main_wd, True)
    launches, oracle, launches150, filtered = check_main_path(
        torch, failures, worst.pop("main_exact_kernel_bfloat16"),
        workdir=main_wd)
    if failures:
        fail("; ".join(failures))
    launches["exact"] = launches150["exact"]  # the bf16 main at top_k=150
    # the masked instances' path: the filtered searches on the main path's
    # store, each kernel launched once there and only with a mask
    launches["fold_masked"] = filtered["fold"]
    launches["exact_masked"] = filtered["exact"]
    # the same runs over an fp32 store: its kernels' main path
    launches32, _, launches32_150, filtered32 = check_main_path(
        torch, failures, worst.pop("main_exact_kernel_float32"), "float32")
    if failures:
        fail("; ".join(failures))
    launches["fold_fp32"] = launches32["fold"]
    launches["exact_fp32"] = launches32_150["exact"]
    launches["fold_fp32_masked"] = filtered32["fold"]
    launches["exact_fp32_masked"] = filtered32["exact"]
    bin10 = check_binary_main_path(torch, failures, oracle)
    launches["binary_fold"] = bin10["binary_fold"]
    launches["binary_fold_masked"] = bin10["filtered"]["binary_fold"]
    if failures:
        fail("; ".join(failures))
    bin20 = check_binary_main_path(torch, failures, oracle, top_k=20)
    launches["binary_exact"] = bin20["binary_exact"]
    launches["binary_exact_masked"] = bin20["filtered"]["binary_exact"]
    if failures:
        fail("; ".join(failures))
    check_binary_capacity(torch, failures)
    if failures:
        fail("; ".join(failures))
    check_bf16_store_at_scale(torch, failures)
    if failures:
        fail("; ".join(failures))
    for store, tag in (("bfloat16", ""), ("float32", "_fp32")):
        launches["exact_select" + tag] = check_exact_select_store(
            torch, failures, store)
    if failures:
        fail("; ".join(failures))
    # the int8 store's main path (the msmarco config), then both quantized
    # stores at the config's corpus scale
    launches["int8_fold"] = check_msmarco_main(torch, failures)["int8_fold"]
    if failures:
        fail("; ".join(failures))
    for store in QUANT_STORES:
        cap = check_quantized_capacity(torch, failures, store)
        if failures:
            fail("; ".join(failures))
        for name, counts in cap.items():
            kernel = "fold" if name.startswith("fold") else "exact"
            key = f"{store}_{kernel}" + ("_masked" if "masked" in name else "")
            if store != "int8" or key != "int8_fold":
                launches[key] = counts[f"{store}_{kernel}"]
    # the device IVF: the msmarco store with its documented IVF (phase
    # 3k, with phase 4e's timings on it), then the cascades' stage 1
    ivf = check_ivf_deployment(torch, failures, main_wd)
    if failures:
        fail("; ".join(failures))
    ivf["launches"] += check_ivf_cascades(torch, failures)
    if failures:
        fail("; ".join(failures))
    times = time_kernels(torch)
    times.update(time_binary(torch))
    masked_times = time_masked(torch)
    quant_times = time_quantized(torch)
    # phase 3h runs last: its server threads and its profiled load must not
    # touch phase 4's device splits
    serve_launches = check_serving(torch, failures, main_wd)
    if failures:
        fail("; ".join(failures))
    # phase 3l: the 3k store served with per-request probe budgets
    ivf_serve_launches = check_ivf_serving(torch, failures, main_wd)
    if failures:
        fail("; ".join(failures))

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
    # the served searches' launches (phase 3h), each load with its counts
    # at 0: the bf16 fold serves them all
    kernels[0]["serve_launches"] = serve_launches
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
    # the masked instances (a filtered search), timed at the reference
    # shape with 10 % of the rows allowed
    for name, key, fn_line, source, shape in (
        ("fused_topk_fold_masked", "fold", 162, "fold_mma.cuh", "bf16"),
        ("fused_topk_fold_fp32_masked", "fold_fp32", 162, "fold_mma.cuh",
         "fp32"),
        ("fused_topk_exact_masked", "exact", 182, "exact_mma.cuh", "bf16"),
        ("fused_topk_exact_fp32_masked", "exact_fp32", 182, "exact_mma.cuh",
         "fp32"),
        ("binary_fused_topk_fold_masked", "binary_fold", 354,
         "fold_mma.cuh", "packed sign words, bf16 queries"),
        ("binary_exact_topk_masked", "binary_exact", None, "exact_mma.cuh",
         "packed sign words, bf16 queries"),
    ):
        t = masked_times[("reference", key)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"latentrag_torch/csrc/{source}",
            "replaces": (f"latentrag_tpu/ops/pallas_topk.py:{fn_line}"
                         if fn_line else "latentrag_tpu/ops/binary.py:129"),
            "launches": launches[key + "_masked"],
            "max_abs_err": worst[key + "_masked"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"Q=2000 N=315 d=64 k={t['k']} {shape} cosine, row "
                     "mask allowing 10 %",
        })
    # the int8 and int4 stores' kernels (the JAX package scores them in
    # XLA: sq8_topk, sq4_topk), timed at the reference and capacity shapes
    for store, fn_line, tag in (("int8", 35, "sq8"), ("int4", 147, "sq4")):
        for kernel, source in (("fold", "fold_mma.cuh"),
                               ("exact", "exact_mma.cuh")):
            for masked in ("", "_masked"):
                key = f"{store}_{kernel}{masked}"
                t = quant_times[("reference", key)]
                big = quant_times[("capacity", key)]
                kernels.append({
                    "name": f"{tag}_fused_topk_{kernel}{masked}",
                    "route": "cuda",
                    "source": f"latentrag_torch/csrc/{source}",
                    "replaces": f"latentrag_tpu/ops/quantization.py:{fn_line}",
                    "launches": launches[key],
                    "max_abs_err": worst[key],
                    "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"],
                    "shape": f"Q=2000 N=315 d=64 k={t['k']} {store} codes, "
                             "int8 query codes"
                             + (", row mask allowing 10 %" if masked else ""),
                    "capacity": {f: big[f] for f in (
                        "Q", "N", "k", "ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by")},
                })
    # the device IVF's scan (the JAX package scores the probed blocks in
    # XLA there: score_group), timed on the 3k store at Q=8, auto budget
    t = ivf["times"]["Q=8 auto"]
    kernels.append({
        "name": "ivf_scan",
        "route": "cuda",
        "source": "latentrag_torch/csrc/ivf_scan.cu",
        "replaces": "latentrag_tpu/ops/ivf.py:771",
        "launches": ivf["launches"],
        "serve_launches": ivf_serve_launches,
        "max_abs_err": worst["ivf_scan"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": f"Q=8 nprobe={t['nprobe']} ({t['probed_blocks']} blocks "
                 f"x {IVF_CAP}) over {CAPACITY_ROWS} int8 rows, d=64, "
                 f"nlist={IVF_NLIST}",
        "timings": [{f: r[f] for f in (
            "case", "Q", "nprobe", "probed_blocks", "ms", "device_ms",
            "plain_ms", "library_ms", "bound_ms", "search_ms",
            "exhaustive_search_ms")} for r in ivf["times"].values()],
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
