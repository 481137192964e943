#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``latentrag_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``latentrag_torch/csrc``, then:

1. prints the card's name and power limit (``nvidia-smi``) and the build time;
2. holds each kernel against its plain PyTorch version on the card: exact
   and fold modes x cosine, euclidean, whitened mahalanobis x bf16 and fp32
   stores, at the reference config (Q=2000, N=315, d=64, k=10), at
   Q=1024, N=1,000,000, d=64, k=10, at a ragged Q=37, N=5003, d=384 with
   k in {1, 64, 128}, and exact mode at k=300;
2b. holds the binary fold kernel against its plain version: the reference
   and 1M shapes at d=64 and the ragged shape at d=384 and d=48 (pad
   bits), k in {10, 80, 128}, at block_n 4096 and at ``fold_plan``'s width;
3. drives the main path through ``latentrag_torch.main.main`` at the full
   MiniLM-L6 width in bf16 with a seeded 384->512->64 VAE: synthetic data,
   2000 queries, a bf16 cosine store, top_k=10, kernel=auto; checks that the
   fused kernels launched during that run, then runs the same pipeline with
   kernel=xla_exact (matmul + torch.topk, the oracle) and compares;
3b. drives the same entry point with ``retrieval.store_dtype=binary`` and
   checks that the binary kernel launched (self-check and search); on the
   same latents, the cascade with the kernel as stage 1 and with its plain
   version at the same plan must retrieve the same docs;
3c. builds a binary ``DenseRetriever`` over 1M seeded unit vectors (d=64),
   searches 1024 queries at k=10, and holds the same kernel-vs-plain
   agreement; Recall@10 against exact fp32 search is reported;
4. times each kernel, its plain version and torch.matmul + torch.topk (a
   yardstick the port never calls) with CUDA events, beside the bound;
4b. the same for the binary kernel at the reference and 1M shapes (the
   yardstick reads the corpus pre-unpacked to +-1 bf16, 16x the bytes),
   and the kernel alone over 100M packed rows;
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
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 FMA

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

    worst = {"fold": 0.0, "exact": 0.0}
    # (label, Q, N, d, ks, fold tile width); "main_plan" is the fold as the
    # main path's approximate route runs it (ft.fold_plan at N=2000, k=10)
    shapes = [
        ("reference", 2000, 315, 64, [10], 4096),
        ("1m", 1024, 1_000_000, 64, [10], 4096),
        ("ragged", 37, 5003, 384, [1, 64, 128], 4096),
        ("exact_k300", 37, 5003, 384, [300], 4096),
        ("main_plan", 2000, 2000, 64, [40], 128),
    ]
    seed = 0
    for label, nq, n, d, ks, block_n in shapes:
        for metric in ("cosine", "euclidean", "mahalanobis"):
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
                               "block_n": block_n,
                               "id_match": id_match, "max_abs_err": max_err}
                        ok = True
                        if mode == "exact":
                            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
                            within = bool(((s_k - s_p).abs() <= tol)[same].all())
                            ok = id_match >= EXACT_ID_MATCH and within
                        else:
                            ex = ref_exact[1]
                            hits = (i_k[:, :, None] == ex[:, None, :]).any(-1)
                            recall = hits.float().mean().item()
                            rec["recall_vs_exact"] = recall
                            ok = id_match >= FOLD_ID_MATCH and (
                                k != 10 or recall >= FOLD_RECALL)
                        worst[mode] = max(worst[mode], max_err)
                        rec["ok"] = ok
                        record("kernel_check", **rec)
                        if not ok:
                            failures.append(f"kernel check {rec}")
                del q, c
                torch.cuda.empty_cache()
    return worst


def write_vae(torch, path: str) -> None:
    from latentrag_torch.models import VariationalAutoencoder

    torch.manual_seed(1234)
    torch.save(VariationalAutoencoder(384, 64, 512).state_dict(), path)


def main_overrides(workdir: str, kernel: str, store: str) -> list:
    return [
        "data.dataset=synthetic", "data.max_samples=2000",
        "encoder.dtype=bfloat16",
        f"models.vae.checkpoint={workdir}/vae.pth",
        f"retrieval.store_dtype={store}", "retrieval.metric=cosine",
        "retrieval.top_k=10", f"retrieval.kernel={kernel}",
        f"paths.data_dir={workdir}/data",
        f"paths.checkpoints_dir={workdir}/ckpt",
        f"paths.logs_dir={workdir}/logs",
        f"retrieval.index_path={workdir}/index",
        "logging.log_to_file=false", "logging.level=WARNING",
    ]


def run_main(torch, workdir: str, kernel: str,
             store: str = "bfloat16") -> dict:
    from latentrag_torch import main as cli

    results: list = []
    argv = ["--ae_type", "vae", "--device", "cuda", "--tag",
            f"smoke_{kernel}_{store}", "--set",
            *main_overrides(workdir, kernel, store)]
    t0 = time.perf_counter()
    rc = cli.main(argv, results=results)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0 or len(results) != 1:
        fail(f"main({kernel}, {store}) returned {rc} with {len(results)} "
             "results")
    res = results[0]
    res["wall_s"] = wall
    return res


def check_main_path(torch, failures: list) -> tuple[dict, dict]:
    """Phase 3: the entry point at full MiniLM-L6 width; returns the fused
    kernels' launch counts from the kernel=auto run and the oracle's
    result."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft

    with tempfile.TemporaryDirectory(prefix="lr_smoke_") as wd:
        write_vae(torch, f"{wd}/vae.pth")
        ft.reset_launches()
        res = run_main(torch, wd, "auto")
        main_launches = dict(ft.launches)
        oracle = run_main(torch, wd, "xla_exact")
        encode_breakdown(torch, wd)
    ds = np.asarray(res["doc_scores"])
    if ds.shape != (res["n_queries"], 10) or not np.isfinite(ds).all():
        failures.append(f"doc_scores shape {ds.shape} or non-finite values")
    if res["dim_in"] != 384 or res["dim_out"] != 64:
        failures.append(f"dims {res['dim_in']}->{res['dim_out']}")
    a, b = res["retrieved_doc_ids"], oracle["retrieved_doc_ids"]
    slots = sum(len(r) for r in b)
    agree = sum(
        sum(1 for x, y in zip(ra, rb) if x == y) for ra, rb in zip(a, b)
    ) / max(slots, 1)
    deltas = {
        m: abs(res["retrieval_metrics"][m]["mean"]
               - oracle["retrieval_metrics"][m]["mean"])
        for m in res["retrieval_metrics"]
    }
    record(
        "main_path", n_queries=res["n_queries"], n_corpus=res["n_corpus"],
        dim_in=res["dim_in"], dim_out=res["dim_out"],
        metrics={m: v["mean"] for m, v in res["retrieval_metrics"].items()},
        timings_s=res["timings"], wall_s=res["wall_s"],
        launches=main_launches,
    )
    record(
        "main_path_oracle", kernel="xla_exact",
        metrics={m: v["mean"] for m, v in oracle["retrieval_metrics"].items()},
        timings_s=oracle["timings"], doc_id_agreement=agree,
        metric_deltas=deltas,
    )
    if main_launches["fold"] < 1:
        failures.append("the fold kernel did not launch on the main path")
    if main_launches["exact"] < 1:
        failures.append("the exact kernel (self-check) did not launch")
    if agree < MAIN_DOC_AGREE:
        failures.append(f"doc id agreement {agree} < {MAIN_DOC_AGREE}")
    if max(deltas.values()) > MAIN_METRIC_TOL:
        failures.append(f"metric deltas {deltas} > {MAIN_METRIC_TOL}")
    return main_launches, oracle


def encode_breakdown(torch, workdir: str) -> None:
    """Split the main path's corpus encode into host tokenization and the
    encoder on the card: the same texts, tokenizer, widths, chunks and
    shape buckets as the run, the two halves timed apart."""
    import numpy as np

    from latentrag_torch.data import (
        get_examples, load_evaluation_data, resolve_tokenizer,
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
    enc = SentenceEncoder(tok, ecfg, device="cuda")
    t0 = time.perf_counter()
    batches = []
    for i in range(0, len(corpus), ecfg.batch_size):
        ids, mask = tok.encode_batch(corpus[i : i + ecfg.batch_size],
                                     max_length=ecfg.max_length)
        nb = _bucket_batch(ids.shape[0])
        nl = _bucket_length(ids.shape[1], ecfg.max_length)
        pad = ((0, nb - ids.shape[0]), (0, nl - ids.shape[1]))
        batches.append((np.pad(ids, pad, constant_values=tok.pad_id),
                        np.pad(mask, pad)))
    tok_s = time.perf_counter() - t0
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
           tokenize_s=tok_s, model_s=model_s)


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


def bound(nq, n, d, k, dname) -> tuple[float, str]:
    size = 2 if dname == "bfloat16" else 4
    by_bytes = (nq * d * size + n * d * size + nq * k * 8) / HBM_BYTES_PER_S
    by_ops = 2.0 * nq * n * d / PEAK_OPS[dname]
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def time_kernels(torch) -> dict:
    """Phase 4: kernel, plain and library times at the two reference
    shapes, bf16 cosine store (the main path's). The fold runs as the
    approximate route plans it (``ft.fold_plan``: tile width and 4x
    candidates at recall_target 0.99); the exact kernel at k=10."""
    from latentrag_torch.ops import fused_topk as ft

    out = {}
    for label, nq, n, d in (("reference", 2000, 315, 64),
                            ("1m", 1024, 1_000_000, 64)):
        k = 10
        q, c = make_case(torch, "cosine", torch.bfloat16, nq, n, d, 99)
        lib_ms = time_ms(
            torch, lambda: torch.topk(torch.matmul(q, c.T).float(), k, dim=1))
        block_n, cand = ft.fold_plan(n, k, 0.99)
        for mode, kk, bn in (("fold", cand, block_n), ("exact", k, 4096)):
            kern = time_ms(torch, lambda: ft.fused_topk_raw(
                q, c, k=kk, metric="cosine", mode=mode, block_n=bn))
            plain = time_ms(torch, lambda: ft.fused_topk_raw_reference(
                q, c, k=kk, metric="cosine", mode=mode, block_n=bn),
                reps=20, warmup=1)
            b_ms, b_by = bound(nq, n, d, kk, "bfloat16")
            rec = {"shape": label, "mode": mode, "Q": nq, "N": n, "d": d,
                   "k": kk, "block_n": bn, "store": "bfloat16", "ms": kern,
                   "plain_ms": plain, "library_ms": lib_ms,
                   "library_k": k, "bound_ms": b_ms, "bound_by": b_by}
            record("kernel_time", **rec)
            out[(label, mode)] = rec
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


def check_binary_kernel(torch, failures: list) -> float:
    """Phase 2b: the binary fold kernel against its plain version; returns
    the largest rescored-score error at equal ids."""
    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft

    worst = 0.0
    shapes = [("reference", 2000, 315, 64), ("1m", 1024, 1_000_000, 64),
              ("ragged", 37, 5003, 384), ("ragged", 37, 5003, 48)]
    for seed, (label, nq, n, d) in enumerate(shapes, start=200):
        q, pk = binary_case(torch, nq, n, d, seed)
        exact_i = tb.binary_topk(q, pk, d, 10)[1]
        for k in (10, 80, 128):
            for block_n in sorted({4096, ft.fold_plan(n, k, 0.99)[0]}):
                _, i_k = ft.binary_fused_topk_raw(q, pk, d=d, k=k,
                                                  block_n=block_n)
                torch.cuda.synchronize()
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
                       "block_n": block_n, "id_match": id_match,
                       "max_abs_err": max_err}
                ok = id_match >= BIN_ID_MATCH and bool((err <= tol).all())
                if k == 10:
                    hits = (i_k[:, :, None] == exact_i[:, None, :]).any(-1)
                    rec["recall_vs_exact"] = hits.float().mean().item()
                    ok = ok and rec["recall_vs_exact"] >= BIN_RECALL
                rec["ok"] = ok
                record("binary_kernel_check", **rec)
                worst = max(worst, max_err)
                if not ok:
                    failures.append(f"binary kernel check {rec}")
        del q, pk
        torch.cuda.empty_cache()
    return worst


def plain_cascade(torch, r, queries, k):
    """The binary store's search with the plain version of the kernel as
    stage 1, at the plan the store uses on the card, and the same stage 2.
    Returns host numpy (scores, ids)."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.distances import prepare_for_metric
    from latentrag_torch.retrieval.rescore import exact_rescore_topk

    q = prepare_for_metric(torch.as_tensor(queries).float().cuda(),
                           r.metric, r._whitener)
    ok = min(r.binary_oversample * k, r._corpus_n)
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


def check_binary_main_path(torch, failures: list, oracle: dict) -> dict:
    """Phase 3b: ``main`` with the binary store; returns the launch counts
    of that run."""
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
        res = run_main(torch, wd, "auto", store="binary")
        main_launches = dict(ft.launches)
        # the same latents, through the port's own compressor
        cfg = apply_overrides(Config(), main_overrides(wd, "auto", "binary"))
        queries, corpus, relevant = load_evaluation_data(get_examples(cfg))
        comp = PipelineRunner(cfg, ae_type="vae",
                              device="cuda")._ensure_compressor(corpus)
        c_emb = comp.encode_text(list(corpus))
        q_emb = comp.encode_text(list(queries))
        r = build_retriever(c_emb, list(corpus), None, cfg.retrieval,
                            device="cuda")
        _, i_kern = r.search(q_emb, 10)
        _, i_plain = plain_cascade(torch, r, q_emb, 10)
        split = search_split(torch, r, q_emb, 10)
    ds = np.asarray(res["doc_scores"])
    if ds.shape != (res["n_queries"], 10) or not np.isfinite(ds).all():
        failures.append(f"binary doc_scores shape {ds.shape} or non-finite")
    names = cfg.evaluation.retrieval_metrics
    rows = lambda ids: [[int(j) for j in row if j >= 0] for row in ids]  # noqa: E731
    m_kern = evaluate_retrieval(rows(i_kern), list(relevant), metrics=names)
    m_plain = evaluate_retrieval(rows(i_plain), list(relevant), metrics=names)
    agree = slot_agreement(rows(i_kern), rows(i_plain))
    deltas = {m: abs(m_kern[m]["mean"] - m_plain[m]["mean"]) for m in m_kern}
    record(
        "binary_main_path", n_queries=res["n_queries"],
        n_corpus=res["n_corpus"], dim_out=res["dim_out"],
        metrics={m: v["mean"] for m, v in res["retrieval_metrics"].items()},
        bf16_oracle_metrics={m: v["mean"] for m, v in
                             oracle["retrieval_metrics"].items()},
        timings_s=res["timings"], wall_s=res["wall_s"],
        launches=main_launches,
        kernel_vs_plain_stage1_doc_agreement=agree,
        kernel_vs_plain_stage1_metric_deltas=deltas,
        rerun_vs_main_doc_agreement=slot_agreement(
            rows(i_kern), res["retrieved_doc_ids"]),
        rerun_search_split=split,
    )
    if main_launches["binary_fold"] < 2:
        failures.append(
            f"binary kernel launched {main_launches['binary_fold']} times "
            "on the binary main path (want self-check + search)")
    if agree < BIN_DOC_AGREE:
        failures.append(f"binary stage-1 doc agreement {agree} < "
                        f"{BIN_DOC_AGREE}")
    if max(deltas.values()) > BIN_METRIC_TOL:
        failures.append(f"binary metric deltas {deltas} > {BIN_METRIC_TOL}")
    return main_launches


def check_binary_capacity(torch, failures: list) -> None:
    """Phase 3c: a binary DenseRetriever over 1M seeded unit vectors."""
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
    """Phase 4b: the binary kernel, its plain version and the yardstick
    (torch.matmul + torch.topk over the corpus pre-unpacked to +-1 bf16),
    at the candidates and tile width the store plans (ok = 8 x 10) and at
    k=10 with the 4096-row tile; then the kernel alone over 100M rows."""
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
            plain = time_ms(torch, lambda: ft.binary_fused_topk_raw_reference(
                q, pk, d=d, k=kk, block_n=bn), reps=20, warmup=1)
            b_ms, b_by = binary_bound(nq, n, d, kk)
            rec = {"shape": label, "case": tag, "Q": nq, "N": n, "d": d,
                   "k": kk, "block_n": bn, "ms": kern, "plain_ms": plain,
                   "library_ms": lib_ms, "library_reads_bytes_x": 16,
                   "bound_ms": b_ms, "bound_by": b_by}
            record("binary_kernel_time", **rec)
            out[(label, tag)] = rec
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
           "k": cand, "block_n": block_n, "ms": kern, "plain_ms": None,
           "library_ms": None, "packed_bytes": pk.numel() * 4,
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

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cuda_build.load_library("fused_topk")
    record("build", card=card, torch=torch.__version__,
           cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
           nvcc_s=cuda_build.build_seconds.get("fused_topk"))

    failures: list = []
    worst = check_kernels(torch, failures)
    worst["binary_fold"] = check_binary_kernel(torch, failures)
    if failures:
        fail("; ".join(failures[:5]))
    launches, oracle = check_main_path(torch, failures)
    if failures:
        fail("; ".join(failures))
    launches["binary_fold"] = check_binary_main_path(
        torch, failures, oracle)["binary_fold"]
    if failures:
        fail("; ".join(failures))
    check_binary_capacity(torch, failures)
    if failures:
        fail("; ".join(failures))
    times = time_kernels(torch)
    times.update(time_binary(torch))

    kernels = []
    for mode, fn_line in (("fold", 162), ("exact", 182)):
        t = times[("reference", mode)]
        kernels.append({
            "name": f"fused_topk_{mode}",
            "route": "cuda",
            "source": "latentrag_torch/csrc/fused_topk.cu",
            "replaces": f"latentrag_tpu/ops/pallas_topk.py:{fn_line}",
            "launches": launches[mode],
            "max_abs_err": worst[mode],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"Q=2000 N=315 d=64 k={t['k']} block_n={t['block_n']} "
                     "bf16 cosine",
        })
    t = times[("reference", "plan")]
    kernels.append({
        "name": "binary_fused_topk_fold",
        "route": "cuda",
        "source": "latentrag_torch/csrc/fused_topk.cu",
        "replaces": "latentrag_tpu/ops/pallas_topk.py:354",
        "launches": launches["binary_fold"],
        "max_abs_err": worst["binary_fold"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": f"Q=2000 N=315 d=64 k={t['k']} block_n={t['block_n']} "
                 "packed sign words, bf16 queries",
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
