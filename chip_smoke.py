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
2f. holds the fp32 fold at the HNSW build's shape (the first 4096 rows of
   the 1M lowrank corpus of 3m as queries over all of it, the plan
   ``knn_graph`` asks for at k + 1 = 65: tile 4096, 128 candidates, the
   list-of-128 instance ``fold_mma_kernel<f32>``) to its plain version
   with phase 2's fold limits, and that block's ``knn_graph`` lists to the
   plain exact lists (neighbour recall >= 0.95); the same at the main
   path's size, its first 1997 rows over themselves (tile 128: every row
   a lane winner, 16 slabs merged);
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
4f. (after 4) times 2f's call: the wrapper, its plain version, the
   library call at 128, the profiler's device split, the bound, and the
   instance's registers and stack bytes (``cuobjdump -res-usage`` on the
   built library);
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
3m. (after 3l) the ANN tiers over 1M x 64 lowrank unit rows (after
   ``scripts/backend_sweep.py``: rank 16, noise 0.05) through
   ``ANNRetriever`` with ``auto`` builds on the card: HNSW (M 32, efC
   200, knn_k 64) must launch the fp32 fold ceil(N / 4096) = 245 times and
   nothing else, reach Recall@10 >= 0.98 at efS 128 on 1024 held-out
   queries against the exact search on the card (efS 64 reported), and
   answer bit for bit after a save and a warm load; IVF-PQ (nlist 4096, m
   16, 8 bits, 15 iterations, trained and encoded on the card) reports
   Recall@10 at nprobe 32 and 64 and refined 4x and 8x at 64, held >= 0.95
   at 8x; each with its build split and search QPS;
3n. ``main --set retrieval.backend=hnsw`` and ``ivfpq`` on the main path
   (fp32 rows), each twice: the second run loads the first one's store
   and returns its doc ids, the cold HNSW run launches the fold once and
   the warm one nothing; on the cold HNSW run's own latents, the fold at
   its plan (Q = N = 1997, tile 128, 128 candidates) against its plain
   version (candidate sets >= 0.999; slots reported beside the plain
   fold's own match under another fp32 sum order), its k-NN lists vs
   exact (>= 0.95), and one-thread graphs from the fold's lists, from
   exact lists and by the beam build: the fold's lists may cost the
   graph <= 0.005 of Recall@10 at efS 64; the run's docs hold >= 0.70 of
   the fp32 ``xla_exact`` oracle's (by set) and, at efS 2048 (>= N),
   >= 0.95 by slot (IVF-PQ's reported); then ``python -m
   latentrag_torch.serve`` over a copy of the HNSW store: a search, a
   filtered search, an add found top-1, and the refusals of "remove" and
   "nprobe" (the JAX server's text);
3o. ``main --set retrieval.rerank=cross`` on the main path with a seeded
   cross-encoder at the MiniLM-L6 geometry (bf16), written by the port as
   ``reranker.msgpack`` with a sidecar (pair length 128, query budget
   64) and its head along the pooled outputs' main variation (logits of
   unit spread): candidate_k 40, the fold launched for search and
   self-check and the exact kernel not at all, the reranker's weights on
   the card, the run's docs and doc scores bit for bit MaxSim's over its
   own logits, its 80,000 logits within RERANK_BAND of the same pairs in
   fp32 mode and spread over more than 10 bands, 256 pairs scored alone
   within 1e-5 (relative) of their batched logits, the run's docs MaxSim's
   over the fp32 logits on >= 98 % of slots (a swap within twice the bf16
   gap counting as agreement), and a second run warm-booting its store
   with the same docs (rerank seconds, pairs/s and the rerank's share of
   the run recorded);
3p. ``main --set chunking.enabled=true`` over a ``jsonl:`` corpus of the
   2000 synthetic questions whose documents are each a passage and its 5
   successors' (~200 tokens), at the config's windows: sliding chunks,
   the same with ``xla_exact``, semantic chunks with the reranker;
   n_chunks >= 2 x n_corpus, candidate_k 30 and 40, ids all documents'
   and none twice in a query, the fold launched, and the sliding run's
   docs on >= 98 % of slots the xla_exact run's (ties within 1e-6
   counting as agreement), with fp64 MaxSim over the run's own stored
   chunks as the witness that every differing slot is such a tie;
3q. the reranked server over 3o's store: the JSONL CLI (a search, a bad
   request, stats), then 256 single-query HTTP searches from 64 clients
   at window 0 and 2 ms: each response its own query's with k hits, one
   fold launch a search call, the served ids on >= 99 % of slots one
   direct encode + search + rescore's (QPS, p50/p99, the rescore's
   seconds under the lock recorded);
3r. ``main --generate --set generation.provider=extractive
   evaluation.generation_metrics=[METEOR]`` on the main path at its own
   index_path (the card machine has neither sacrebleu nor rouge-score):
   2000 answers, each ``extractive_answer`` recomputed on the host from
   the run's own search, the docs, doc scores and metrics bit for bit the
   same run's without ``--generate`` on the store it left, METEOR inside
   its CI, the fold for search and self-check and the exact kernel never;
   then a warm ``main --profile``, whose trace must name the fold kernel;
3s. ``main --ae_type none --benchmark bm25 sbert vae dpr --generate``
   with ``retrieval.index_path`` unset: no system may report an error,
   bm25 Recall@10 >= 0.99, sbert's and vae's docs bit for bit those of
   ``main --ae_type none`` / 3r's ``main``, DPR's (seeded towers, metric
   dot over unnormalized [CLS] rows) >= 98 % of slots ``xla_exact``'s over
   the same store, the fold at DPR's own plan held to its plain version
   with phase 2's fold limits, a p-value for every pair, and the fold
   launched for search and self-check by each dense system and DPR;
3t. the JSONL CLI with ``--generate`` (a generating search, a plain one,
   a malformed line), then 64 generating HTTP searches at window 2 ms
   over 3h's store: every answer ``extractive_answer`` over its own hits,
   none unasked, one fold launch a search call;
3u. ``python -m latentrag_torch.training.train --ae_type vae|dae|cae``
   in this process on the card, 50 epochs each on the synthetic 2000
   examples (MiniLM-L6 at full width, bf16, the 384->512->64 AEs; the
   early stop may end a run sooner): the weights and every batch on the
   card, the last epoch's val loss below the first's; one train step of the trained VAE on the card (fp32, TF32
   off) against the same step on the CPU from the same model, optimizer
   state, batch and eps (loss within 1e-5 relative, params within 1e-6);
   a 2-epoch DAE run resumed to 4 continuing at epoch 2 with Adam's step
   count; then ``main --ae_type <ae>`` over each trained checkpoint by
   its default name (the fold for search and self-check, the exact kernel
   never), the trained VAE's docs on >= 98 % of slots ``xla_exact``'s;
3v. ``train_encoder`` for 1 epoch, then ``main --ae_type none`` loading
   ``encoder.msgpack``; ``train_dpr`` for 1 epoch, then ``main
   --benchmark dpr``, whose towers must equal the written msgpacks, with
   DPR's fold at its own plan held to its plain version;
3w. ``train_reranker`` for 1 epoch on 512 pairs, then the reranked
   ``main`` over its checkpoint (no fitted head): candidate_k 40, the
   reranker's weights the trained ones, the run's docs bit for bit
   MaxSim's over its own logits (each trainer's steps/s, samples/s,
   seconds an epoch and peak device memory recorded);
3x. outside inputs: the seeded MiniLM-L6 (full width) written as a Hugging
   Face ``BertModel`` directory (config.json, model.safetensors, a
   vocab.txt of 4000 pseudo-words) and 2000 MS MARCO-shaped queries of 10
   passages (40-80 words, one selected; ~20,000 unique passages), then
   ``main --config configs/msmarco_v5e8.yaml --ae_type dae --set
   data.dataset=msmarco:<jsonl> encoder.name=<dir>`` in a fresh
   checkpoints_dir: ``encoder.msgpack`` holds the written tensors bit for
   bit and vocab.txt was copied, the corpus is the loader's (distractors
   included), the int8 fold serves search and self-check and the exact
   kernel nothing, the same run on the plain versions gives the same doc
   ids (by set at ties) and metrics, and a warm run loads the msgpack,
   converts nothing and returns the same ids; then ``main --set
   data.dataset=cloze:<txt>`` (2000 of those passages) over the converted
   encoder, its docs on >= 98 % of slots ``xla_exact``'s;
3y. a seeded cross-encoder (full width) written as an HF
   ``BertForSequenceClassification`` directory ("bert." prefix, 1 label)
   and converted into ``reranker.msgpack``: its logits on 64 pairs equal
   bit for bit those of a ``CrossEncoderModel`` built from the written
   state dict; then the reranked ``main`` over 500 cloze queries;
3z. ``python -m latentrag_torch.doctor`` over 3x's store and checkpoints
   (exit 0, one JSON line, platform and kernels pass) and, at the same
   time, over a copy whose doc-ids sidecar is corrupted (exit 1, the
   store's FAIL); ``visualize_compressed_vs_original(make_plots=False)``
   over 1000 of 3x's (query, positive) embeddings and DAE latents on the
   card, the same recall as on the CPU; ``reconstruction_mse`` and
   ``summarise_sizes`` over the 3x store;
5a. the sharded top-k (``latentrag_torch.parallel``) on a mesh of four
   shards of cuda:0 over 1,000,003 seeded rows (d=64, Q=1024): bf16
   (cosine, and euclidean: the pad-row case) and fp32 stores at k=10
   (the fold), 160 (the exact kernel) and 3000 (the exact select), int8
   and binary stores at 10 and 160, a 10 % row mask at 10 and 160; each
   search launches its kernel once a shard (4), each shard's call is held
   to the kernel's plain version, the exact routes to the unsharded exact
   route, the fold routes by candidate recall; no pad or masked row
   comes back; the sharded and unsharded searches are timed;
5b. the main path at full width through ``PipelineRunner(mesh=<those 4
   shards>)`` with ``retrieval.shard_corpus``: the bf16 store at top_k
   10 and 150 against the unsharded ``xla_exact`` oracle, the binary
   store at 10 and 20 against the unsharded binary run, the 4-shard
   encode against the unsharded one, the store saved as ``sharded/``,
   warm-booted, mutated and passed by the doctor; then ``main --set
   retrieval.shard_corpus=true`` on the one card, equal to the unsharded
   run bit for bit;
5c. the ring k-NN graph over 200,000 x 64 fp32 rows in 4 shards: the
   approximate ring (the fp32 fold, 4 launches a step) against
   ``knn_graph``'s exact lists, the exact ring equal to them;
5d. two processes on gloo (``scripts/torch_multiproc_worker.py``), two
   shards each on cuda:0: their sharded exact bf16 and SQ8 searches bit
   for bit this process's 4-shard search; the store both saved loads
   here on 4 shards and on one device and searches as they did;
6. prints a ``kernels`` JSON line (each kernel's ``sharded_launches`` from
   5a-5c) and, last, the device line.

Every check that fails exits non-zero. Without CUDA, or without the
package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
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


@contextlib.contextmanager
def logged(name: str):
    """The INFO messages of logger ``name`` while open."""
    lg = logging.getLogger(name)
    lines, level = _Lines(), lg.level
    lg.addHandler(lines)
    lg.setLevel(logging.INFO)
    try:
        yield lines.lines
    finally:
        lg.removeHandler(lines)
        lg.setLevel(level)


def run_main(torch, workdir: str, kernel: str,
             store: str = "bfloat16", top_k: int = 10,
             extra: tuple = (), flags: tuple = ()) -> dict:
    """One ``main`` run (``extra``: overrides after the main path's;
    ``flags``: options before them, such as ``--generate``);
    ``res["retrieval_log"]`` holds the retriever's INFO lines (load, save,
    skip)."""
    from latentrag_torch import main as cli

    with logged("latentrag_torch.retrieval") as lines:
        res = _run_main(torch, cli, workdir, kernel, store, top_k, extra,
                        flags)
    res["retrieval_log"] = lines
    return res


def _run_main(torch, cli, workdir, kernel, store, top_k, extra=(),
              flags=()) -> dict:
    results: list = []
    argv = ["--ae_type", "vae", "--device", "cuda", "--tag",
            f"smoke_{kernel}_{store}_{top_k}", *flags, "--set",
            *main_overrides(workdir, kernel, store, top_k), *extra]
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


# ------------------------------------------------------------ the ANN tiers

ANN_ROWS = 1_000_000  # docs/BACKENDS_200K.md's 1M x 64 cell for both tiers
ANN_D = 64
ANN_QUERIES = 1024  # held-out queries from the corpus's manifold
ANN_M, ANN_EFC, ANN_KNN_K = 32, 200, 64  # the JAX package's operating point
ANN_QUERY_BLOCK = 4096  # knn_graph's query rows a fold launch
ANN_MAIN_ROWS = 1997  # the main path's contexts: its k-NN stage's one block
KNN_RECALL = 0.95  # one block's lists vs the plain exact lists
HNSW_RECALL = 0.98  # Recall@10 at efS 128 vs the exact search
IVFPQ_NLIST, IVFPQ_M, IVFPQ_NBITS, IVFPQ_ITERS = 4096, 16, 8, 15
IVFPQ_RECALL = 0.95  # Recall@10 at nprobe 64, refine 8
# The HNSW main path (3n). Its latents are near-collinear (pairwise
# cosine 0.984-0.9998) and its queries lie off the rows' cap; there the
# k-NN-assembled graph of the shared C++ finds 0.7223 of the exact top 10
# at the default efS 64 from exact lists, in either package, and the beam
# build 0.9315 (tests/test_torch_ann.py::test_main_path_latents_recall_
# matches_jax), so the default's limit is set from that reading:
ANN_MAIN_RECALL = 0.70  # the main run's docs vs xla_exact's, by set
ANN_LIST_COST = 0.005  # fold lists' graph recall below exact lists'
# the fold's candidate sets vs its plain version's on those latents: a
# row's 128 candidates span ~4 19-bit keys, so two fp32 sum orders of the
# plain fold alone agree on only ~0.98 of slots; sets are held
ANN_FOLD_SET_MATCH = EXACT_ID_MATCH
# doc ids vs xla_exact by slot at efS >= N, where the beam reaches every
# linked row: the scores' order, whatever the graph
ANN_MAIN_AGREE = 0.95
ANN_MAIN_EF_ALL = 2048  # >= the main path's 1997 rows


@functools.cache
def ann_rows():
    """(corpus [1M, 64], queries [1024, 64]) fp32 unit rows, numpy, after
    ``scripts/backend_sweep.py``'s lowrank data: rows of a seeded rank-16
    projection plus 0.05 noise; the queries drawn from the same
    projection."""
    import numpy as np

    rng = np.random.default_rng(0)
    rank = ANN_D // 4
    proj = rng.standard_normal((rank, ANN_D)).astype(np.float32)
    n = ANN_ROWS + ANN_QUERIES
    x = rng.standard_normal((n, rank)).astype(np.float32) @ proj
    x += 0.05 * rng.standard_normal((n, ANN_D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x[:ANN_ROWS], np.ascontiguousarray(x[ANN_ROWS:])


def resource_usage(path: str, mangled: str) -> dict | None:
    """Registers and stack frame (spill) bytes of one kernel instance in a
    built library, as ``cuobjdump -res-usage`` reads them; None when the
    tool or the instance is not found."""
    import re

    from latentrag_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    try:
        out = subprocess.run([tool, "-res-usage", path], capture_output=True,
                             text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"Function (\S*" + re.escape(mangled) + r"\S*):\s*\n\s*"
                  r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", out)
    if not m:
        return None
    return {"function": m.group(1), "registers": int(m.group(2)),
            "stack_bytes": int(m.group(3)), "local_bytes": int(m.group(5))}


def knn_block(torch):
    """The 1M corpus on the card, its first 4096 rows (the k-NN stage's
    first query block) and the plan ``knn_graph`` asks for at k + 1 = 65
    and recall 0.95: (corpus, queries, tile width, candidates)."""
    from latentrag_torch.ops import fused_topk as ft

    corpus, _ = ann_rows()
    c = torch.tensor(corpus, device="cuda")
    block_n, cand = ft.fold_plan(ANN_ROWS, ANN_KNN_K + 1, 0.95)
    return c, c[:ANN_QUERY_BLOCK], block_n, cand


def fold_against_plain(torch, q, c) -> dict:
    """The fp32 fold as ``knn_graph`` plans it over ``c`` (k + 1 = 65,
    recall 0.95) against its plain version on the card: the plan, the C
    kernel that ran, the slot-by-slot id match and the largest rescored
    score error at equal ids, and whether phase 2's fold limits hold."""
    from latentrag_torch.ops import fused_topk as ft

    block_n, cand = ft.fold_plan(c.shape[0], ANN_KNN_K + 1, 0.95)
    s_k, i_k = ft.fused_topk_raw(q, c, k=cand, metric="cosine",
                                 mode="fold", block_n=block_n)
    torch.cuda.synchronize()
    ran = ft.last_kernel
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=cand, metric="cosine",
                                           mode="fold", block_n=block_n)
    id_match = (i_k == i_p).float().mean().item()
    sets = set_match(torch, i_k, i_p)
    s_k, i_k = ft.rescore_candidates(q, c, i_k, "cosine")
    s_p, i_p = ft.rescore_candidates(q, c, i_p, "cosine")
    err = (s_k - s_p).abs()[i_k == i_p]
    rec = {"Q": int(q.shape[0]), "N": int(c.shape[0]), "d": int(c.shape[1]),
           "k": cand, "block_n": block_n, "store": "float32",
           "c_kernel": ran, "id_match": id_match, "set_match": sets,
           "max_abs_err": err.max().item() if err.numel() else 0.0}
    rec["kernel_ok"] = (ran.split("+")[0] == "fold_mma_kernel<f32>"
                        and cand == 128 and id_match >= FOLD_ID_MATCH)
    return rec


def knn_list_recall(torch, q, c) -> dict:
    """Neighbour recall of the k-NN lists of the rows ``q`` (the first
    rows of ``c``) from ``knn_graph``'s approximate route (the fold,
    rescored) against the plain exact lists, self stripped; and whether
    every list is free of its own row."""
    import numpy as np

    from latentrag_torch.ops import knn
    from latentrag_torch.ops.topk import approx_topk, exact_topk

    kk = ANN_KNN_K + 1
    _, got = approx_topk(q, c, k=kk, metric="cosine", recall_target=0.95)
    _, want = exact_topk(q, c, k=kk, metric="cosine")
    got = knn.strip_self(got.cpu().numpy(), 0, ANN_KNN_K)
    want = knn.strip_self(want.cpu().numpy(), 0, ANN_KNN_K)
    return {"knn_recall": float(
                (got[:, :, None] == want[:, None, :]).any(-1).mean()),
            "self_free": bool(
                (got != np.arange(got.shape[0])[:, None]).all())}


def check_knn_fold(torch, failures: list) -> float:
    """Phase 2f: the fp32 fold at the HNSW builds' shapes against its
    plain version with phase 2's fold limits, at ``knn_graph``'s plan
    (k + 1 = 65, 128 candidates): the first 4096 rows of the 1M corpus as
    queries over all of it (tile 4096), and a corpus of the main path's
    size, its first 1997 rows, over itself (tile 128: every row is a
    lane winner and 16 slabs merge); then each block's ``knn_graph``
    lists against the plain exact lists by neighbour recall. Returns the
    largest score error at equal ids."""
    c, q, _, _ = knn_block(torch)
    worst = 0.0
    for case, qc, cc, plan in (
            ("1m", q, c, (4096, 128)),
            ("main_size", c[:ANN_MAIN_ROWS], c[:ANN_MAIN_ROWS], (128, 128))):
        rec = {"case": case, **fold_against_plain(torch, qc, cc)}
        rec.update(knn_list_recall(torch, qc, cc))
        ok = (rec.pop("kernel_ok") and (rec["block_n"], rec["k"]) == plan
              and rec["knn_recall"] >= KNN_RECALL and rec["self_free"])
        rec["ok"] = ok
        record("knn_fold_check", **rec)
        worst = max(worst, rec["max_abs_err"])
        if not ok:
            failures.append(f"the knn build's fp32 fold: {rec}")
    del c, q
    torch.cuda.empty_cache()
    return worst


def time_knn_fold(torch) -> dict:
    """Phase 4f (with phase 4's other device splits: a profiler session
    opened before the main path's runs left every later one without
    device time): the call ``knn_graph`` makes a query block, its plain
    version and the library call (``torch.topk`` of ``torch.matmul`` at
    128), with the profiler's device split, the bound, and the instance's
    registers and stack bytes."""
    from latentrag_torch.ops import cuda_build
    from latentrag_torch.ops import fused_topk as ft

    c, q, block_n, cand = knn_block(torch)
    fold = lambda: ft.fused_topk_raw(q, c, k=cand, metric="cosine",  # noqa: E731
                                     mode="fold", block_n=block_n)
    t = {"ms": time_ms(torch, fold, reps=10),
         "plain_ms": time_ms(torch, lambda: ft.fused_topk_raw_reference(
             q, c, k=cand, metric="cosine", mode="fold", block_n=block_n),
             reps=3, warmup=1),
         "library_ms": time_ms(torch, lambda: torch.topk(
             torch.matmul(q, c.T), cand, dim=1), reps=5, warmup=1),
         "device_ms": device_split(torch, fold),
         "blocks_per_sm": blocks_per_sm(ft, "fold", q.device.index, ANN_D,
                                        cand, ft._OP_F32)}
    t["bound_ms"], t["bound_by"] = bound(ANN_QUERY_BLOCK, ANN_ROWS, ANN_D,
                                         cand, "float32")
    # fold_mma_kernel<4, OP_F32 = 2, false>: the list-of-128 fp32 instance
    t["resources"] = resource_usage(
        cuda_build.library_path(*ft.LIBRARIES[0]),
        "fold_mma_kernelILi4ELi2ELb0E")
    t.update(Q=ANN_QUERY_BLOCK, N=ANN_ROWS, k=cand, block_n=block_n,
             launches_per_build=-(-ANN_ROWS // ANN_QUERY_BLOCK))
    record("knn_fold_time", card=card_line(), **t)
    del c, q
    torch.cuda.empty_cache()
    return t


def ann_recall(got, true) -> float:
    return float(sum(len(set(g[g >= 0].tolist()) & set(t.tolist()))
                     for g, t in zip(got, true)) / true.size)


def timed_search(r, q, k=10) -> tuple:
    t0 = time.perf_counter()
    s, i = r.search(q, k)
    return s, i, time.perf_counter() - t0


def check_ann_tiers(torch, failures: list) -> int:
    """Phase 3m: both ANN tiers over the 1M x 64 lowrank rows through
    ``ANNRetriever`` with ``auto`` builds on the card. HNSW (M 32, efC
    200, knn_k 64): the k-NN stage launches the fp32 fold once a 4096-row
    block and nothing else; Recall@10 of the 1024 held-out queries
    against the exact search on the card at efS 64 (reported) and 128
    (held); a save and a warm load answer bit for bit. IVF-PQ (nlist
    4096, m 16, 8 bits, 15 iterations, trained and encoded on the card):
    recall unrefined at nprobe 32 and 64 and refined 4x and 8x at 64
    (held at 8x). Returns the build's fold launches."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.topk import exact_topk
    from latentrag_torch.retrieval.ann_retriever import ANNRetriever
    from latentrag_torch.utils.config import RetrievalConfig

    t_phase = time.perf_counter()
    corpus, queries = ann_rows()
    qd = torch.tensor(queries, device="cuda")
    cd = torch.tensor(corpus, device="cuda")
    _, true = exact_topk(qd, cd, k=10, metric="cosine")
    true = true.cpu().numpy()
    del qd, cd
    torch.cuda.empty_cache()
    texts = [""] * ANN_ROWS
    rec: dict = {"N": ANN_ROWS, "d": ANN_D, "queries": ANN_QUERIES}
    with tempfile.TemporaryDirectory(prefix="lr_ann_") as tmp:
        cfg = RetrievalConfig(backend="hnsw", index_path=f"{tmp}/ix",
                              hnsw_m=ANN_M, hnsw_ef_construction=ANN_EFC,
                              hnsw_knn_k=ANN_KNN_K, hnsw_build="auto")
        r = ANNRetriever(cfg, "hnsw", device="cuda")
        ft.reset_launches()
        t0 = time.perf_counter()
        r.build(corpus, texts)
        rec["hnsw_build_s"] = time.perf_counter() - t0
        launches = dict(ft.launches)
        rec["hnsw_launches"] = {k: v for k, v in launches.items() if v}
        rec["hnsw_c_kernel"] = ft.last_kernel
        rec["hnsw_split"] = r.build_split
        # build() saves after its stages: the rest of its wall time
        rec["hnsw_save_s"] = rec["hnsw_build_s"] - sum(
            v for x, v in r.build_split.items() if x.endswith("_s"))
        for ef in (64, 128):
            r.cfg = dataclasses.replace(r.cfg, hnsw_ef_search=ef)
            _, ids, wall = timed_search(r, queries)
            rec[f"hnsw_recall_ef{ef}"] = ann_recall(ids, true)
            rec[f"hnsw_qps_ef{ef}"] = ANN_QUERIES / wall
        s0, i0 = r.search(queries, 10)
        t0 = time.perf_counter()
        warm = ANNRetriever(cfg, "hnsw", device="cuda")
        loaded = warm.load_persisted()
        rec["hnsw_load_s"] = time.perf_counter() - t0
        warm.cfg = dataclasses.replace(warm.cfg, hnsw_ef_search=128)
        s1, i1 = warm.search(queries, 10)
        rec["hnsw_round_trip"] = loaded and np.array_equal(i0, i1) and (
            np.array_equal(s0.view(np.int32), s1.view(np.int32)))
        del r, warm
    want = {"fold": -(-ANN_ROWS // ANN_QUERY_BLOCK)}
    ok_hnsw = (rec["hnsw_launches"] == want
               and rec["hnsw_c_kernel"].split("+")[0]
               == "fold_mma_kernel<f32>"
               and rec["hnsw_split"].get("mode") == "knn"
               and rec["hnsw_recall_ef128"] >= HNSW_RECALL
               and rec["hnsw_round_trip"])
    cfg = RetrievalConfig(backend="ivfpq", index_path="",
                          ivfpq_nlist=IVFPQ_NLIST, ivfpq_m=IVFPQ_M,
                          ivfpq_nbits=IVFPQ_NBITS, ivfpq_build="auto",
                          ivfpq_train_iters=IVFPQ_ITERS, ivfpq_refine=8)
    r = ANNRetriever(cfg, "ivfpq", device="cuda")
    ft.reset_launches()
    t0 = time.perf_counter()
    r.build(corpus, texts)
    rec["ivfpq_build_s"] = time.perf_counter() - t0
    rec["ivfpq_split"] = r.build_split
    rec["ivfpq_launches"] = {k: v for k, v in ft.launches.items() if v}
    for nprobe in (32, 64):
        t0 = time.perf_counter()
        _, ids = r._index.search(queries, 10, nprobe=nprobe)
        wall = time.perf_counter() - t0
        rec[f"ivfpq_recall_np{nprobe}"] = ann_recall(ids, true)
        rec[f"ivfpq_qps_np{nprobe}"] = ANN_QUERIES / wall
    r.cfg = dataclasses.replace(r.cfg, ivfpq_nprobe=64)
    for refine in (4, 8):
        r._refine = refine
        _, ids, wall = timed_search(r, queries)
        rec[f"ivfpq_recall_np64_refine{refine}"] = ann_recall(ids, true)
        rec[f"ivfpq_qps_np64_refine{refine}"] = ANN_QUERIES / wall
    del r
    ok_ivfpq = (rec["ivfpq_split"].get("mode") == "device"
                and rec["ivfpq_recall_np64_refine8"] >= IVFPQ_RECALL)
    rec.update(phase_s=time.perf_counter() - t_phase, ok_hnsw=ok_hnsw,
               ok_ivfpq=ok_ivfpq)
    record("ann_tiers", card=card_line(), **rec)
    if not (ok_hnsw and ok_ivfpq):
        failures.append(f"the 1M ANN tiers: {rec}")
    return launches["fold"]


@contextlib.contextmanager
def ann_inputs():
    """The first build's rows and the first search's queries that reach
    ``ANNRetriever`` inside the block, as host fp32 (``seen["corpus"]``,
    ``seen["queries"]``)."""
    import numpy as np

    from latentrag_torch.retrieval.ann_retriever import ANNRetriever

    seen: dict = {}
    build, search = ANNRetriever.build, ANNRetriever.search

    def host(x):
        return np.asarray(x.float().cpu() if hasattr(x, "cpu") else x,
                          dtype=np.float32)

    def spy_build(self, embeddings, *a, **kw):
        seen.setdefault("corpus", host(embeddings))
        return build(self, embeddings, *a, **kw)

    def spy_search(self, queries, *a, **kw):
        seen.setdefault("queries", host(queries))
        return search(self, queries, *a, **kw)

    ANNRetriever.build, ANNRetriever.search = spy_build, spy_search
    try:
        yield seen
    finally:
        ANNRetriever.build, ANNRetriever.search = build, search


def check_ann_main_graphs(torch, corpus, queries) -> dict:
    """Phase 3n's HNSW check on the main path's own latents (the cold
    run's rows and queries, normalized as ``ANNRetriever`` does): the fold
    at that k-NN stage's plan (Q = N = 1997, tile 128, 128 candidates)
    against its plain version, its ``knn_graph`` lists against the plain
    exact lists, and Recall@10 against the exact search at the default
    efS of three graphs over the same rows, each built on one thread (so
    bit for bit repeatable): assembled by ``HNSWIndex.from_knn`` from the
    fold's lists and from the exact lists, and built by the C++ beam
    insertion. Also the latents' geometry: the range of the rows' pairwise
    cosines and the mean best cosine of a row (to another row) and of a
    query (to a row)."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import knn
    from latentrag_torch.ops.topk import exact_topk
    from latentrag_torch.retrieval.ann import HNSWIndex
    from latentrag_torch.utils.config import RetrievalConfig

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

    cn, qn = unit(corpus), unit(queries)
    cd, qd = torch.tensor(cn, device="cuda"), torch.tensor(qn, device="cuda")
    rec = {"case": "main_latents", **fold_against_plain(torch, cd, cd),
           **knn_list_recall(torch, cd, cd)}
    # the plain fold against itself over the dims in reverse order (the
    # same products summed in another fp32 order): the slot-by-slot match
    # any two fp32 roundings reach where a row's 128 candidates span ~4
    # 19-bit keys and ~100 rows share the 128th's key
    block_n, cand = ft.fold_plan(cn.shape[0], ANN_KNN_K + 1, 0.95)
    _, i_p = ft.fused_topk_raw_reference(cd, cd, k=cand, metric="cosine",
                                         mode="fold", block_n=block_n)
    _, i_r = ft.fused_topk_raw_reference(
        cd.flip(1).contiguous(), cd.flip(1).contiguous(), k=cand,
        metric="cosine", mode="fold", block_n=block_n)
    rec["plain_reordered_id_match"] = (i_r == i_p).float().mean().item()
    rec["plain_reordered_set_match"] = set_match(torch, i_r, i_p)
    cos = cd @ cd.T
    off = cos[~torch.eye(cos.shape[0], dtype=torch.bool, device="cuda")]
    rec["row_cosine_range"] = [off.min().item(), off.max().item()]
    rec["row_best_cosine"] = cos.fill_diagonal_(-2).max(1).values.mean().item()
    best_q, true = exact_topk(qd, cd, k=10, metric="cosine")
    rec["query_best_cosine"] = best_q[:, 0].mean().item()
    true = true.cpu().numpy()
    cfg = RetrievalConfig()
    knn_k = cfg.hnsw_knn_k or 2 * cfg.hnsw_m
    kw = {"M": cfg.hnsw_m, "ef_construction": cfg.hnsw_ef_construction,
          "ef_search": cfg.hnsw_ef_search}
    beam = HNSWIndex(cn.shape[1], **kw)
    beam.add(cn, nthreads=1)
    graphs = {"fold_lists": HNSWIndex.from_knn(
                  cn, knn.knn_graph(cd, knn_k), nthreads=1, **kw),
              "exact_lists": HNSWIndex.from_knn(
                  cn, knn.knn_graph(cd, knn_k, exact=True), nthreads=1, **kw),
              "beam": beam}
    rec["graph_recall"] = {
        name: ann_recall(ix.search(qn, 10, nthreads=1)[1], true)
        for name, ix in graphs.items()}
    rec["ef_search"] = cfg.hnsw_ef_search
    del cd, qd, cos, off, i_p, i_r
    torch.cuda.empty_cache()
    return rec


def ann_overrides(workdir: str, backend: str) -> list:
    """The main path's fp32 config with the ANN ``backend``, its store at
    ``<workdir>/index_<backend>`` (files ``index_<backend>.<backend>*``)."""
    return [f"retrieval.backend={backend}",
            f"retrieval.index_path={workdir}/index_{backend}"]


def check_ann_main(torch, failures: list, workdir: str, oracle: dict) -> int:
    """Phase 3n: ``main --set retrieval.backend=hnsw`` and ``ivfpq`` over
    the main path (MiniLM-L6 bf16, 384->512->64 VAE, 1997 contexts), each
    run twice: the second run logs "<kind> index loaded from" and returns
    the first run's doc ids; the cold HNSW build launches the fp32 fold
    once (its k-NN stage) and the warm one nothing. HNSW: the cold run's
    latents through ``check_ann_main_graphs`` (the fold at that run's
    plan against its plain version, its lists, and the graphs they make);
    its docs must hold >= 0.70 of the fp32 ``xla_exact`` oracle's at the
    default efS (by set; by slot reported), and a third run on the same
    store at efS 2048 (>= N) must agree on >= 0.95 of slots. IVF-PQ's
    agreement is reported. Then the JSONL server over a copy of the HNSW
    store: a search, a filtered search, an add found top-1, and the
    "remove" and "nprobe" refusals. Returns the cold HNSW run's fold
    launches."""
    from latentrag_torch.ops import fused_topk as ft

    t_phase = time.perf_counter()
    rec: dict = {}
    fold = 0
    for backend in ("hnsw", "ivfpq"):
        runs = []
        for _ in range(2):
            ft.reset_launches()
            with ann_inputs() as seen:
                res = run_main(torch, workdir, "auto", "float32",
                               extra=ann_overrides(workdir, backend))
            runs.append((res, {k: v for k, v in ft.launches.items() if v},
                         seen))
        (cold, cold_l, cold_in), (warm, warm_l, _) = runs
        loaded = [x for x in warm["retrieval_log"]
                  if x.startswith(f"{backend} index loaded from")]
        r = {"launches": [cold_l, warm_l],
             "timings_s": [cold["timings"], warm["timings"]],
             "metrics": {m: v["mean"]
                         for m, v in cold["retrieval_metrics"].items()},
             "warm_loaded": bool(loaded) and not any(
                 x.startswith(f"{backend} index loaded from")
                 for x in cold["retrieval_log"]),
             "same_doc_ids": warm["retrieved_doc_ids"]
             == cold["retrieved_doc_ids"],
             "oracle_agreement": slot_agreement(
                 cold["retrieved_doc_ids"], oracle["retrieved_doc_ids"]),
             "oracle_recall": sum(
                 len(set(a) & set(b)) for a, b in zip(
                     cold["retrieved_doc_ids"], oracle["retrieved_doc_ids"]))
             / max(sum(len(b) for b in oracle["retrieved_doc_ids"]), 1)}
        ok = r["warm_loaded"] and r["same_doc_ids"] and not warm_l
        if backend == "hnsw":
            fold = cold_l.get("fold", 0)
            g = check_ann_main_graphs(torch, cold_in["corpus"],
                                      cold_in["queries"])
            g.pop("kernel_ok")  # slots: held by sets here (see above)
            g["ok"] = (g["c_kernel"].split("+")[0] == "fold_mma_kernel<f32>"
                       and (g["block_n"], g["k"]) == (128, 128)
                       and g["set_match"] >= ANN_FOLD_SET_MATCH
                       and g["knn_recall"] >= KNN_RECALL and g["self_free"]
                       and g["graph_recall"]["fold_lists"]
                       >= g["graph_recall"]["exact_lists"] - ANN_LIST_COST)
            r["graphs"] = g
            wide = run_main(torch, workdir, "auto", "float32",
                            extra=ann_overrides(workdir, backend) + [
                                f"retrieval.hnsw_ef_search={ANN_MAIN_EF_ALL}"])
            r["oracle_agreement_ef_all"] = slot_agreement(
                wide["retrieved_doc_ids"], oracle["retrieved_doc_ids"])
            ok = ok and cold_l == {"fold": 1} and g["ok"] and (
                r["oracle_recall"] >= ANN_MAIN_RECALL) and (
                r["oracle_agreement_ef_all"] >= ANN_MAIN_AGREE)
        else:
            ok = ok and not cold_l
        r["ok"] = ok
        rec[backend] = r
        if not ok:
            failures.append(f"the {backend} main path: {r}")
    rec["serve"] = check_ann_serve(failures, workdir)
    rec["phase_s"] = time.perf_counter() - t_phase
    record("ann_main_path", card=card_line(), **rec)
    return fold


def check_ann_serve(failures: list, workdir: str) -> dict:
    """Phase 3n's server: ``python -m latentrag_torch.serve`` warm-booted
    from a copy of the HNSW main path's store, over JSONL."""
    root = os.path.dirname(os.path.abspath(__file__))
    index = f"{workdir}/serve_hnsw/index_hnsw"
    os.makedirs(os.path.dirname(index), exist_ok=True)
    for name in os.listdir(workdir):
        if name.startswith("index_hnsw."):
            shutil.copy(f"{workdir}/{name}", os.path.dirname(index))
    overrides = main_overrides(workdir, "auto", "float32") + [
        "retrieval.backend=hnsw", f"retrieval.index_path={index}",
        "logging.level=INFO"]
    query = eval_queries(1)[0]
    added = "zzqx a freshly added note about quasars"
    lines = [json.dumps({"query": query, "k": SERVE_K}),
             json.dumps({"query": query, "k": SERVE_K,
                         "filter": {"doc_ids": [0, 5, 7, 11]}}),
             json.dumps({"add": {"texts": [added], "doc_ids": [90001]}}),
             json.dumps({"query": added, "k": 3}),
             json.dumps({"remove": {"doc_ids": [90001]}}),
             json.dumps({"query": query, "nprobe": 8}),
             json.dumps({"stats": True})]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "latentrag_torch.serve", "--device", "cuda",
         "--ae_type", "vae", "--set", *overrides],
        input="".join(x + "\n" for x in lines), capture_output=True,
        text=True, timeout=600, cwd=root)
    rec = {"rc": out.returncode, "wall_s": time.perf_counter() - t0,
           "stderr_tail": out.stderr[-600:]}
    try:
        resp = [json.loads(x) for x in out.stdout.splitlines() if x.strip()]
    except ValueError:
        resp = []
    ok = out.returncode == 0 and len(resp) == len(lines)
    if ok:
        hits = [resp[i].get("results", [{}])[0].get("hits", [])
                for i in (0, 1, 3)]
        rec.update(hits=[len(h) for h in hits],
                   filtered_ids=[h["doc_id"] for h in hits[1]],
                   added_top1=hits[2][0]["doc_id"] if hits[2] else None,
                   remove_error=resp[4].get("error"),
                   nprobe_error=resp[5].get("error"),
                   boot=resp[6].get("boot"), n_docs=resp[6].get("n_docs"))
        ok = (rec["hits"][0] == SERVE_K
              and set(rec["filtered_ids"]) <= {0, 5, 7, 11}
              and len(rec["filtered_ids"]) == 4
              and rec["added_top1"] == 90001
              and "does not support remove" in (rec["remove_error"] or "")
              and rec["nprobe_error"] == (
                  'ValueError: "nprobe" requires the dense backend with '
                  "retrieval.ivf_nlist > 0 (the device IVF tier)")
              and rec["boot"] == "warm"
              and "hnsw index warm-loaded from" in out.stderr)
    rec["ok"] = ok
    if not ok:
        failures.append(f"the HNSW server: {rec}")
    return rec


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
            if "answer" in res:
                resp[i].update(answer=res["answer"],
                               texts=[h["text"] for h in res["hits"]])
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
        self.rescores: list = []  # a ``rescore_calls`` list, when attached
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
        self.rescores.clear()


def serve_args(window_ms: float, generate: bool = False):
    return SimpleNamespace(ae_type="vae", generate=generate, cold_boot=False,
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
def running_server(cfg, server_env, window_ms: float,
                   generate: bool = False):
    """``make_handle`` at ``window_ms`` (started with ``--generate`` when
    ``generate``) behind a started HTTP server (``serve.running_http``),
    stopped with its batcher on exit; yields (port, window_ms)."""
    from latentrag_torch import serve

    runner, compressor, retriever, mode, loggers = server_env
    handle = serve.make_handle(cfg, serve_args(window_ms, generate), runner,
                               compressor, retriever, mode)
    with serve.running_http(handle, retriever, mode, "127.0.0.1", 0,
                            loggers) as server:
        yield SimpleNamespace(port=server.server_address[1],
                              window_ms=window_ms)


def timed_load(torch, srv, spy, queries, profiled: bool = True,
               extra: dict | None = None) -> dict:
    """A warm-up burst under the profiler (the device's busy share of its
    wall time: the timed load runs without the profiler; ``profiled``
    False: no profiler, no busy share), then the timed load with the
    counts at 0: QPS, client latency percentiles, the search calls' sizes,
    the fold and exact launches, and the host time in encode and
    search. ``extra``: keys every request's body carries."""
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
    busy = None
    if profiled:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = serve_load(queries[:warmup], srv.port,
                              extra=extra)["wall_s"]
        busy = sum(getattr(ev, "device_time_total", 0) or 0
                   for ev in prof.key_averages()) / 1e6 / wall
    else:
        wall = serve_load(queries[:warmup], srv.port, extra=extra)["wall_s"]
    profiled_s = time.perf_counter() - t0
    spy.reset()
    ft.reset_launches()
    res = serve_load(queries, srv.port, extra=extra)
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
        "device_busy_share": busy,
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


def check_serve_cli(failures: list, workdir: str, query: str,
                    source: str = "index_auto_10", extra: tuple = (),
                    label: str = "serve_cli") -> None:
    """Phase 3h (vi): ``python -m latentrag_torch.serve --device cuda``
    as users start it, over JSONL on a copy of the main path's store
    (``source``, with ``extra`` overrides: 3q's reranked server): a
    search, a bad request and a stats request give three JSON lines on
    stdout, one of them an error, rc 0, and the logs on stderr."""
    root = os.path.dirname(os.path.abspath(__file__))
    index = f"{workdir}/{label}_index"
    shutil.copytree(f"{workdir}/{source}", index)
    overrides = main_overrides(workdir, "auto", "bfloat16") + [
        *extra, f"retrieval.index_path={index}", "logging.level=INFO"]
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
                   boot=resp[2].get("boot"), n_docs=resp[2].get("n_docs"),
                   rerank=resp[2].get("rerank"))
        ok = (len(hits) == SERVE_K and "error" in resp[1]
              and "error" not in resp[0] and resp[2].get("boot") == "warm"
              and rec["rerank"] == ("cross" if extra else "none")
              and "warm boot in" in out.stderr)
    record(label, **rec)
    if not ok:
        failures.append(f"the serve CLI ({label}): {rec}")


# ------------------------------------- phases 3o-3q: reranking and chunking

# the reranker of 3o-3q: a seeded cross-encoder at the encoder config's
# MiniLM-L6 geometry (384 wide, 6 layers, 12 heads, MLP 1536, bf16), written
# by the port as <checkpoints_dir>/reranker.msgpack with a sidecar pinning
# the JAX trainer's default pair length (128) and query budget (64)
RERANK_SEED = 2024
RERANK_MAX_LENGTH = 128
RERANK_QUERY_MAX = 64
# the head is fitted to RERANK_FIT_PAIRS pairs: along the top principal
# direction of their pooled outputs, scaled to logits of mean 0, std 1
RERANK_FIT_PAIRS = 512
# |bf16 logit - fp32 logit| of one pair; the logits must spread over more
# than 10 bands, so the band is not their spread. With the fitted head the
# 80,000 pairs' gaps reach 0.0758 over a spread of 4.74 (H100 80GB HBM3,
# 700 W)
RERANK_BAND = 0.15
RERANK_SAMPLED = 256  # pairs scored one a call (bucket invariance)
# |alone - batched| over max(1, |logit|): the trunk's bf16 values agree
# across batch buckets, the fp32 pooler and head sum in other orders
RERANK_SINGLE_REL = 1e-5
# the run's docs vs MaxSim over the fp32 logits, slot by slot, where a slot
# also agrees when its doc's fp32 score is within twice the run's largest
# bf16 gap of the fp32 list's at that slot: a swap that the bf16 rounding
# explains (each logit moves by at most that gap); the plain slot
# agreement is recorded beside it
RERANK_DOC_AGREE = 0.98
CHUNK_SUCCESSORS = 5  # 3p's documents: a passage and its 5 successors'
# sliding chunks, the fold vs xla_exact as stage 1, slot by slot, where a
# slot also agrees when the two runs' doc scores there are within
# CHUNK_TIE_TOL: overlapping chunks of near-collinear latents tie to fp32
# rounding, and the two routes sum in other orders (a few ulps at ~1); fp64
# MaxSim over the run's stored chunks ties 820 of the 839 differing slots
# exactly and the rest within 9.9e-8 (H100 80GB HBM3, 700 W)
CHUNK_DOC_AGREE = 0.98
CHUNK_TIE_TOL = 1e-6
SERVE_RERANK_REQUESTS = 256


def write_reranker(torch, workdir: str) -> dict:
    """The seeded cross-encoder, written by the port in the JAX package's
    format beside the main path's checkpoints; returns the file's facts."""
    from latentrag_torch.data.tokenizer import resolve_tokenizer
    from latentrag_torch.models.encoder.cross import CrossEncoderScorer
    from latentrag_torch.retrieval.reranker import save_reranker
    from latentrag_torch.utils import apply_overrides, load_config

    cfg = apply_overrides(load_config(None),
                          main_overrides(workdir, "auto", "bfloat16"))
    tok = resolve_tokenizer(cfg.paths.data_dir, cfg.encoder.vocab_size)
    scorer = CrossEncoderScorer(tok, cfg.encoder, seed=RERANK_SEED,
                                device="cuda")
    fit_head(torch, scorer)
    path = save_reranker(cfg, scorer, max_length=RERANK_MAX_LENGTH,
                         query_max=RERANK_QUERY_MAX)
    rec = {"path": path, "bytes": os.path.getsize(path),
           "params": sum(p.numel() for p in scorer.module.parameters()),
           "geometry": [cfg.encoder.hidden_dim, cfg.encoder.num_layers,
                        cfg.encoder.num_heads, cfg.encoder.mlp_dim,
                        cfg.encoder.dtype]}
    del scorer
    torch.cuda.empty_cache()
    return rec


def fit_head(torch, scorer) -> None:
    """Point the seeded scorer's head along the top principal direction of
    its pooled outputs over RERANK_FIT_PAIRS seeded (question, context)
    pairs of the synthetic examples, scaled so their logits have mean 0
    and std 1. A random head reads a direction in which the pairs barely
    differ, so its logits' spread is near the bf16 rounding."""
    import numpy as np

    from latentrag_torch.data import synthetic_examples
    from latentrag_torch.models.encoder.cross import encode_pairs

    examples = synthetic_examples(2000)
    rng = np.random.default_rng(RERANK_SEED)
    qi, di = (rng.integers(0, len(examples), RERANK_FIT_PAIRS)
              for _ in range(2))
    arrays = encode_pairs(
        scorer.tokenizer, [examples[i]["question"] for i in qi],
        [examples[i]["context"] for i in di],
        max_length=RERANK_MAX_LENGTH, query_max=RERANK_QUERY_MAX)
    head = scorer.module.classifier
    with torch.no_grad():
        pooled = scorer.module.pool(*(torch.from_numpy(a).to(
            scorer.device, torch.long) for a in arrays)).double()
        v = torch.linalg.svd(pooled - pooled.mean(dim=0),
                             full_matrices=False).Vh[0]
        proj = pooled @ v
        head.weight.copy_((v / proj.std())[None].float())
        head.bias.fill_(float(-proj.mean() / proj.std()))


@contextlib.contextmanager
def search_calls():
    """Every ``DenseRetriever.search`` call while open: its retriever, the
    queries it got, k and what it returned."""
    from latentrag_torch.retrieval.dense import DenseRetriever

    calls: list = []
    orig = DenseRetriever.search

    @functools.wraps(orig)
    def spy(self, queries, k, *args, **kw):
        out = orig(self, queries, k, *args, **kw)
        calls.append(SimpleNamespace(retriever=self, queries=queries, k=k,
                                     out=out))
        return out

    DenseRetriever.search = spy
    try:
        yield calls
    finally:
        DenseRetriever.search = orig


@contextlib.contextmanager
def rescore_calls():
    """Every ``CrossEncoderReranker.rescore_candidates`` call while open:
    its reranker, inputs, result and host seconds (the result is host
    numpy, so the card has finished when it returns)."""
    from latentrag_torch.retrieval import reranker as rr

    calls: list = []
    orig = rr.CrossEncoderReranker.rescore_candidates

    def spy(self, queries, idx, texts):
        t0 = time.perf_counter()
        out = orig(self, queries, idx, texts)
        calls.append(SimpleNamespace(
            reranker=self, queries=list(queries), idx=idx, texts=texts,
            out=out, s=time.perf_counter() - t0))
        return out

    rr.CrossEncoderReranker.rescore_candidates = spy
    try:
        yield calls
    finally:
        rr.CrossEncoderReranker.rescore_candidates = orig


def run_counted(torch, workdir: str, kernel: str, extra=(),
                flags=()) -> tuple:
    """A bf16 ``run_main`` with the kernels' counts at 0 just before it;
    returns the result and the counts it left (those above 0)."""
    from latentrag_torch.ops import fused_topk as ft

    ft.reset_launches()
    res = run_main(torch, workdir, kernel, extra=tuple(extra),
                   flags=tuple(flags))
    return res, {k: v for k, v in ft.launches.items() if v}


def rounding_agreement(ids, ref_ids, ref_scores, score_of, tol) -> float:
    """Share of slots where ``ids`` hold ``ref_ids``' doc, or a doc whose
    reference score (``score_of[q][doc]``) is within ``tol`` of the
    reference list's score at that slot."""
    same = slots = 0
    for q, (row, ref, ref_s) in enumerate(zip(ids, ref_ids, ref_scores)):
        for r, doc in enumerate(ref):
            slots += 1
            got = row[r] if r < len(row) else None
            same += got == doc or (got is not None and abs(
                score_of[q].get(got, float("-inf")) - ref_s[r]) <= tol)
    return same / max(slots, 1)


def check_rerank_main(torch, failures: list, workdir: str) -> int:
    """Phase 3o: ``main --ae_type vae --set retrieval.rerank=cross`` on the
    main path (the synthetic 2000 examples, MiniLM-L6 bf16, the seeded VAE)
    with the seeded full-width cross-encoder, top_k 10, its store at its
    own index_path: candidate_k 40; the fold serves search and self-check,
    the exact kernel nothing; the reranker's weights on the card; the run's
    docs and doc scores bit for bit MaxSim's over its own logits (the
    rescore -> MaxSim plumbing); its 80,000-pair logit matrix within
    RERANK_BAND of the same pairs scored in fp32 mode on the card, and
    spread over more than 10 bands; 256 sampled pairs, each scored alone,
    within RERANK_SINGLE_REL of their batched logits; the run's docs on
    >= 98 % of slots MaxSim's over the fp32 logits; a second run warm-boots
    the store and returns the same docs. Returns the cold run's fold
    launches."""
    import numpy as np

    from latentrag_torch.models.encoder.cross import CrossEncoderScorer
    from latentrag_torch.pipeline import aggregate_docs
    from latentrag_torch.retrieval.reranker import CrossEncoderReranker

    t_phase = time.perf_counter()
    written = write_reranker(torch, workdir)
    extra = ["retrieval.rerank=cross",
             f"retrieval.index_path={workdir}/index_rerank"]
    with rescore_calls() as calls:
        res, launches = run_counted(torch, workdir, "auto", extra)
        again, again_launches = run_counted(torch, workdir, "auto", extra)
    call = calls[0]
    scorer = call.reranker.scorer
    live = call.idx >= 0
    # the same pairs in fp32 mode on the card
    twin = CrossEncoderScorer(
        scorer.tokenizer, dataclasses.replace(scorer.cfg, dtype="float32"),
        state_dict=scorer.module.state_dict(), query_max=scorer.query_max,
        device="cuda")
    t0 = time.perf_counter()
    exact = CrossEncoderReranker(twin).rescore_candidates(
        call.queries, call.idx, call.texts)
    fp32_s = time.perf_counter() - t0
    del twin
    gap = np.abs(call.out[live].astype(np.float64) - exact[live])
    own_scores, own_docs = aggregate_docs(
        call.out, call.idx, range(len(call.texts)), res["top_k"],
        scorer.device)
    plumbing = (own_docs == res["retrieved_doc_ids"]
                and np.array_equal(own_scores, res["doc_scores"]))
    fp32_scores, fp32_docs = aggregate_docs(
        exact, call.idx, range(len(call.texts)), res["top_k"], scorer.device)
    agree = slot_agreement(res["retrieved_doc_ids"], fp32_docs)
    score_of = [dict(zip(row[ok].tolist(), s[ok].tolist()))
                for row, s, ok in zip(call.idx, exact, live)]
    agree_rounding = rounding_agreement(
        res["retrieved_doc_ids"], fp32_docs, fp32_scores, score_of,
        2 * float(gap.max()))
    # bucket invariance: pairs scored one a call (batch bucket 8, the
    # pair's own length bucket) against their slots of the run's matrix
    rows, cols = np.nonzero(live)
    pick = np.random.default_rng(15).choice(rows.size, RERANK_SAMPLED,
                                            replace=False)
    single = np.asarray([
        scorer.score_pairs([call.queries[rows[p]]],
                           [call.texts[call.idx[rows[p], cols[p]]]])[0]
        for p in pick])
    single_gap = np.abs(single - call.out[rows[pick], cols[pick]])
    logits = call.out[live]
    pairs = int(live.sum())
    rerank_s = res["timings"]["rerank_s"]
    rec = {
        "card": card_line(), "reranker": written,
        "pair_length": scorer.cfg.max_length, "query_max": scorer.query_max,
        "on_card": all(p.is_cuda for p in scorer.module.parameters()),
        "n_queries": res["n_queries"], "n_corpus": res["n_corpus"],
        "candidate_k": res["candidate_k"], "pairs": pairs,
        "launches": launches, "again_launches": again_launches,
        "rerank_s": rerank_s, "pairs_per_s": pairs / rerank_s,
        "rerank_share": rerank_s / res["wall_s"], "wall_s": res["wall_s"],
        "timings_s": res["timings"], "again_timings_s": again["timings"],
        "metrics": {m: v["mean"] for m, v in res["retrieval_metrics"].items()},
        "logit_range": [float(logits.min()), float(logits.max())],
        "logit_std": float(logits.std()),
        "fp32_logit_ptp": float(np.ptp(exact[live])),
        "docs_bit_for_bit_maxsim_of_own_logits": plumbing,
        "fp32_s": fp32_s, "fp32_max_gap": float(gap.max()),
        "fp32_p99_gap": float(np.percentile(gap, 99)),
        "fp32_doc_agreement": agree,
        "fp32_doc_agreement_within_rounding": agree_rounding,
        "single_max_gap": float(single_gap.max()),
        "single_max_rel_gap": float((single_gap / np.maximum(
            1.0, np.abs(single))).max()),
        "warm": {"skipped": "index compatible; skipping rebuild"
                            in again["retrieval_log"],
                 "same_doc_ids": again["retrieved_doc_ids"]
                 == res["retrieved_doc_ids"],
                 "rescored": len(calls) == 2},
    }
    rec["ok"] = ok = (
        rec["on_card"] and rec["candidate_k"] == 40
        and pairs == res["n_queries"] * 40
        and launches.get("fold", 0) >= 2 and "exact" not in launches
        and "exact" not in again_launches
        and plumbing
        and rec["fp32_max_gap"] <= RERANK_BAND
        and rec["fp32_logit_ptp"] > 10 * RERANK_BAND
        and rec["single_max_rel_gap"] <= RERANK_SINGLE_REL
        and agree_rounding >= RERANK_DOC_AGREE
        and all(rec["warm"].values()))
    rec["phase_s"] = time.perf_counter() - t_phase
    record("rerank_main_path", **rec)
    if not ok:
        failures.append(f"the reranked main path: {rec}")
    del call, calls, scorer
    torch.cuda.empty_cache()
    return launches.get("fold", 0)


def write_chunked_corpus(workdir: str) -> str:
    """Phase 3p's ``jsonl:`` corpus: each of the synthetic 2000 examples
    keeps its question and answer, and its context becomes its own passage
    followed by its CHUNK_SUCCESSORS successors' (wrapping at the end), so
    the answer span stays where it was."""
    from latentrag_torch.data import synthetic_examples

    examples = synthetic_examples(2000)
    n = len(examples)
    path = f"{workdir}/chunked.jsonl"
    with open(path, "w") as f:
        for i, ex in enumerate(examples):
            context = " ".join(examples[(i + j) % n]["context"]
                               for j in range(CHUNK_SUCCESSORS + 1))
            assert context[ex["answer_start"]:].startswith(ex["answer_text"])
            f.write(json.dumps({**ex, "context": context}) + "\n")
    return path


def check_chunked_main(torch, failures: list, workdir: str) -> dict:
    """Phase 3p: ``main --set chunking.enabled=true`` over the ``jsonl:``
    corpus of ``write_chunked_corpus`` (2000 questions, documents of about
    six passages) at the config's windows (128 tokens, stride 64, min 48):
    sliding chunks, the same with ``xla_exact`` as stage 1, and semantic
    chunks with the reranker of 3o. Each run: n_chunks >= 2 x n_corpus,
    candidate_k 30 (40 with the reranker), every returned id a document's,
    none twice in a query, the fold launched (auto); the sliding run's
    docs on >= 98 % of slots the xla_exact run's, a slot also agreeing
    where the two runs' doc scores tie within CHUNK_TIE_TOL, and at every
    slot where the docs differ, fp64 MaxSim over the sliding run's own
    stored chunks (``tie_witness``) scores the two docs within
    CHUNK_TIE_TOL. Returns the auto runs' fold launches."""
    import numpy as np

    from latentrag_torch.data import load_evaluation_data, load_jsonl_examples
    from latentrag_torch.data.tokenizer import resolve_tokenizer

    t_phase = time.perf_counter()
    corpus = write_chunked_corpus(workdir)
    base = [f"data.dataset=jsonl:{corpus}", "chunking.enabled=true"]
    runs = {}
    searched: list = []
    for name, kernel, extra in (
        ("sliding", "auto", ["chunking.mode=sliding"]),
        ("sliding_exact", "xla_exact", ["chunking.mode=sliding"]),
        ("semantic_rerank", "auto", ["chunking.mode=semantic",
                                     "retrieval.rerank=cross"]),
    ):
        with search_calls() as calls:
            res, launches = run_counted(
                torch, workdir, kernel, base + extra
                + [f"retrieval.index_path={workdir}/index_{name}"])
        searched.append(calls[-1])
        rows = res["retrieved_doc_ids"]
        runs[name] = res
        rec = {
            "candidate_k": res["candidate_k"], "n_corpus": res["n_corpus"],
            "n_chunks": res["n_chunks"], "n_queries": res["n_queries"],
            "chunks_per_doc": res["n_chunks"] / res["n_corpus"],
            "launches": launches, "timings_s": res["timings"],
            "wall_s": res["wall_s"],
            "split": {k: v / res["wall_s"] for k, v in res["timings"].items()},
            "metrics": {m: v["mean"]
                        for m, v in res["retrieval_metrics"].items()},
            "valid_ids": all(0 <= d < res["n_corpus"] for r in rows
                             for d in r),
            "no_duplicates": all(len(r) == len(set(r)) for r in rows),
            "full_rows": all(len(r) == res["top_k"] for r in rows),
        }
        want_k = 40 if name == "semantic_rerank" else 30
        ok = (rec["n_chunks"] >= 2 * rec["n_corpus"]
              and rec["candidate_k"] == want_k and rec["valid_ids"]
              and rec["no_duplicates"] and rec["full_rows"])
        if kernel == "auto":
            ok = ok and launches.get("fold", 0) >= 2 and (
                "exact" not in launches)
        rec["ok"] = ok
        runs[name + "_rec"] = rec
        if not ok:
            failures.append(f"the chunked main path ({name}): {rec}")
    fold_run, exact_run = runs["sliding"], runs["sliding_exact"]
    agree = slot_agreement(fold_run["retrieved_doc_ids"],
                           exact_run["retrieved_doc_ids"])
    gaps = np.abs(np.asarray(fold_run["doc_scores"], np.float64)
                  - np.asarray(exact_run["doc_scores"], np.float64))
    tied = np.asarray([
        [a == b or g <= CHUNK_TIE_TOL for a, b, g in zip(ra, rb, rg)]
        for ra, rb, rg in zip(fold_run["retrieved_doc_ids"],
                              exact_run["retrieved_doc_ids"], gaps)])
    agree_ties = float(tied.mean())
    if agree_ties < CHUNK_DOC_AGREE:
        failures.append(f"sliding chunks: the fold's docs on {agree} of "
                        f"slots xla_exact's, {agree_ties} with ties (>= "
                        f"{CHUNK_DOC_AGREE})")
    witness = tie_witness(torch, searched[0], fold_run, exact_run)
    if witness["max_fp64_gap"] > CHUNK_TIE_TOL:
        failures.append(f"sliding chunks: fp64 MaxSim does not tie the "
                        f"differing docs: {witness}")
    tok = resolve_tokenizer(f"{workdir}/data", 30522)
    _, docs, _ = load_evaluation_data(load_jsonl_examples(corpus))
    lengths = np.asarray([len(tok.encode(d, add_special_tokens=False).ids)
                          for d in docs])
    record("chunked_main_path", card=card_line(),
           doc_tokens={"mean": float(lengths.mean()),
                       "min": int(lengths.min()), "max": int(lengths.max())},
           sliding=runs["sliding_rec"],
           sliding_exact=runs["sliding_exact_rec"],
           semantic_rerank=runs["semantic_rerank_rec"],
           sliding_vs_exact_agreement=agree,
           sliding_vs_exact_agreement_with_ties=agree_ties,
           tie_witness=witness,
           misses=slot_misses(fold_run, exact_run),
           phase_s=time.perf_counter() - t_phase)
    return {"sliding": runs["sliding_rec"]["launches"].get("fold", 0),
            "semantic_rerank":
                runs["semantic_rerank_rec"]["launches"].get("fold", 0)}


def tie_witness(torch, call, run_a: dict, run_b: dict) -> dict:
    """At each slot where two runs over one chunked store return other
    docs, the gap between those two docs' fp64 MaxSim scores: the search
    ``call``'s queries, prepared as the retriever prepares them and cast to
    its store's dtype, against its stored chunk rows, every product exact
    in fp64. Gaps at fp32 rounding say the differing docs are ties; a
    missed doc shows a larger gap."""
    import numpy as np

    from latentrag_torch.ops.distances import prepare_for_metric

    r = call.retriever
    q = prepare_for_metric(
        torch.as_tensor(call.queries).to(r.device, torch.float32),
        r.metric, r._whitener).to(r._corpus.dtype)
    chunk = q.double() @ r._corpus.double().T
    n_docs = max(r.doc_ids) + 1
    doc = torch.as_tensor(r.doc_ids, device=r.device).expand_as(chunk)
    maxsim = torch.full((chunk.shape[0], n_docs), float("-inf"),
                        dtype=torch.float64, device=r.device).scatter_reduce(
        1, doc, chunk, "amax").cpu().numpy()
    gaps = [abs(maxsim[qi, a] - maxsim[qi, b])
            for qi, (ra, rb) in enumerate(zip(run_a["retrieved_doc_ids"],
                                              run_b["retrieved_doc_ids"]))
            for a, b in zip(ra, rb) if a != b]
    gaps = np.asarray(gaps, np.float64)
    return {"differing_slots": int(gaps.size),
            "max_fp64_gap": float(gaps.max()) if gaps.size else 0.0,
            "exact_fp64_ties": int((gaps == 0).sum())}


def check_rerank_serving(torch, failures: list, workdir: str) -> dict:
    """Phase 3q: the reranked server over (copies of) 3o's store: the JSONL
    CLI (a search, a bad request, stats; rc 0), then ``make_handle`` behind
    HTTP in this process with 256 single-query searches, k 10, from 64
    clients at window 0 and 2 ms: every response its own query's with k
    hits, the fold launched once a search call and the exact kernel never,
    the served ids on >= 99 % of slots those of one direct encode + search
    + rescore of the same queries; QPS, p50/p99 and the rescore's seconds
    under the lock recorded. Returns each load's fold launches."""
    import numpy as np

    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    overrides = ["retrieval.rerank=cross"]
    check_serve_cli(failures, workdir, eval_queries(1)[0],
                    source="index_rerank", extra=overrides,
                    label="serve_cli_rerank")
    index = f"{workdir}/serve_index_rerank"
    shutil.copytree(f"{workdir}/index_rerank", index)
    cfg = apply_overrides(load_config(None), main_overrides(
        workdir, "auto", "bfloat16") + overrides + [
        f"retrieval.index_path={index}"])
    queries = eval_queries(SERVE_RERANK_REQUESTS)
    server_env, spy, boot_rec = boot_server(torch, cfg, failures, "reranked")
    runner, _, retriever = server_env[:3]
    reranker = runner._ensure_reranker()  # the instance make_handle takes
    loads = {}
    for window in (0.0, 2.0):
        with running_server(cfg, server_env, window) as srv, \
                rescore_calls() as spy.rescores:
            # the timed load's rescores: timed_load empties the list
            # after its warm-up (``spy.reset``)
            load = timed_load(torch, srv, spy, queries, profiled=False)
            # the rescore's host seconds under the lock in the timed load
            # (it returns host numpy, so they include the card's work)
            rerank_s = sum(c.s for c in spy.rescores)
            load.update(rerank_s=rerank_s, rerank_pairs=sum(
                int((c.idx >= 0).sum()) for c in spy.rescores),
                rerank_share=rerank_s / load["wall_s"])
            check_load(load, queries, failures,
                       f"reranked serve window {window}")
            loads[window] = load
    spy.rescores = []
    emb = spy.encode(queries)
    _, idx = spy.search(emb, 4 * SERVE_K)
    scores = reranker.rescore_candidates(queries, idx, retriever.texts)
    order = np.argsort(-scores, axis=1)[:, :SERVE_K]
    top = np.take_along_axis(np.asarray(idx), order, axis=1)
    direct = [[retriever.doc_ids[j] for j in row if j >= 0] for row in top]
    for load in loads.values():
        served = [r["ids"] for r in load.pop("responses")]
        load["direct_agreement"] = slot_agreement(served, direct)
        if load["direct_agreement"] < SERVE_DIRECT_AGREE:
            failures.append(
                f"reranked served ids at window {load['window_ms']}: "
                f"{load['direct_agreement']} of slots as the direct call "
                f"(>= {SERVE_DIRECT_AGREE})")
    record("serve_rerank", card=card_line(), **boot_rec,
           loads=list(loads.values()), phase_s=time.perf_counter() - t_phase)
    del server_env, spy, retriever, reranker
    torch.cuda.empty_cache()
    return {f"serve_rerank_w{int(w)}": load["launches"]["fold"]
            for w, load in loads.items()}


# ------------------------ phases 3r-3t: generation, the benchmark harness

# the card machine has neither sacrebleu nor rouge-score, so the generated
# runs score with METEOR, which needs no package
GENERATE_OVERRIDES = ("generation.provider=extractive",
                      "evaluation.generation_metrics=[METEOR]")
BENCH_SYSTEMS = ("bm25", "sbert", "vae", "dpr")
BM25_RECALL = 0.99  # Recall@10 of the bm25 system (1.0 on the CPU)
SERVE_GENERATE_REQUESTS = 64


def expected_answers(retriever, idx, retrieved, queries,
                     max_chunks: int, budget_tokens: int) -> list:
    """The answers of an extractive ``--generate`` run recomputed on the
    host from its own search: each query's candidate chunks in search
    order that belong to one of its retrieved docs, at most ``max_chunks``
    a doc, truncated to the generator's character budget."""
    from latentrag_torch.generation import (
        GeneratorSettings,
        RAGGenerator,
        extractive_answer,
    )

    truncate = RAGGenerator(GeneratorSettings(
        max_context_tokens=budget_tokens))._truncate_docs
    out = []
    for q, row, top in zip(queries, idx, retrieved):
        per, chosen = {}, []
        for j in row:
            if j < 0:
                continue
            doc = retriever.doc_ids[j]
            if doc in top and per.get(doc, 0) < max_chunks:
                per[doc] = per.get(doc, 0) + 1
                chosen.append(retriever.texts[j])
        out.append(extractive_answer(q, truncate(chosen)))
    return out


def check_generate_main(torch, failures: list, workdir: str) -> dict:
    """Phase 3r: ``main --ae_type vae --generate --set
    generation.provider=extractive evaluation.generation_metrics=[METEOR]``
    on the main path, its store at its own index_path (cold: the fold
    serves search and self-check, the exact kernel nothing): 2000 answers,
    each equal to ``extractive_answer`` recomputed on the host from the
    run's own search; the doc ids, doc scores and metrics bit for bit
    those of the same run without ``--generate`` on the store it left
    (warm); METEOR's mean inside its bootstrap CI. Then one warm ``main
    --profile``: its trace names the fold kernel. Returns the generated
    run's fold launches and its doc ids."""
    from latentrag_torch.data import load_evaluation_data, synthetic_examples
    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    index = f"retrieval.index_path={workdir}/index_generate"
    with search_calls() as calls:
        gen, launches = run_counted(torch, workdir, "auto",
                                    (*GENERATE_OVERRIDES, index),
                                    ("--generate",))
        plain, plain_launches = run_counted(torch, workdir, "auto", (index,))
    cfg = apply_overrides(load_config(None), main_overrides(
        workdir, "auto", "bfloat16") + list(GENERATE_OVERRIDES))
    queries, _, _ = load_evaluation_data(synthetic_examples(2000))
    call = calls[0]
    t0 = time.perf_counter()
    want = expected_answers(
        call.retriever, call.out[1], gen["retrieved_doc_ids"], queries,
        cfg.retrieval.max_chunks_per_doc, cfg.generation.max_context_tokens)
    recompute_s = time.perf_counter() - t0
    answers = gen.get("answers", [])
    meteor = gen.get("generation_metrics", {}).get("METEOR", {})
    rec = {
        "card": card_line(), "n_queries": gen["n_queries"],
        "answers": len(answers),
        "answers_as_recomputed": sum(a == b for a, b in zip(answers, want)),
        "empty_answers": sum(not a for a in answers),
        "same_doc_ids": gen["retrieved_doc_ids"] == plain["retrieved_doc_ids"],
        "same_doc_scores": bool(torch.equal(
            torch.as_tensor(gen["doc_scores"]),
            torch.as_tensor(plain["doc_scores"]))),
        "same_metrics": gen["retrieval_metrics"] == plain["retrieval_metrics"],
        "plain_warm": "index compatible; skipping rebuild"
                      in plain["retrieval_log"],
        "meteor": meteor, "launches": launches,
        "plain_launches": plain_launches,
        "generate_s": gen["timings"].get("generate_s"),
        "generation_eval_s": gen["timings"].get("generation_eval_s"),
        "recompute_s": recompute_s, "wall_s": gen["wall_s"],
        "plain_wall_s": plain["wall_s"], "timings_s": gen["timings"],
        "metrics": {m: v["mean"] for m, v in gen["retrieval_metrics"].items()},
    }
    ok = (rec["answers"] == rec["n_queries"] == 2000
          and rec["answers_as_recomputed"] == 2000
          and rec["same_doc_ids"] and rec["same_doc_scores"]
          and rec["same_metrics"] and rec["plain_warm"]
          and set(gen.get("generation_metrics", {})) == {"METEOR"}
          and meteor.get("ci_low", 1.0) <= meteor.get("mean", -1.0)
          <= meteor.get("ci_high", -1.0)
          and launches.get("fold", 0) >= 2 and "exact" not in launches)
    # the profiler over a warm run of the same path: its trace file must
    # name the card's fold kernel
    trace_dir = f"{workdir}/trace_generate"
    prof, prof_launches = run_counted(
        torch, workdir, "auto", (index,), ("--profile", trace_dir))
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
              if f.endswith(".json")] if os.path.isdir(trace_dir) else []
    named = False
    for path in traces:
        with open(path, encoding="utf-8") as f:
            named = named or "fold_mma_kernel" in f.read()
    rec["profile"] = {"traces": len(traces),
                      "bytes": sum(os.path.getsize(p) for p in traces),
                      "names_fold_mma_kernel": named,
                      "wall_s": prof["wall_s"], "launches": prof_launches}
    ok = ok and len(traces) == 1 and named
    shutil.rmtree(trace_dir, ignore_errors=True)
    rec["ok"] = ok
    rec["phase_s"] = time.perf_counter() - t_phase
    record("generate_main_path", **rec)
    if not ok:
        failures.append(f"the generated main path: {rec}")
    return {"launches": launches.get("fold", 0),
            "vae_doc_ids": plain["retrieved_doc_ids"]}


@contextlib.contextmanager
def counted_calls(owner, name: str, calls: list):
    """Wrap ``owner.name`` while open: each call appends its arguments,
    result, host seconds and the kernels' launches it made."""
    from latentrag_torch.ops import fused_topk as ft

    orig = getattr(owner, name)

    @functools.wraps(orig)
    def spy(*args, **kw):
        before = dict(ft.launches)
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        calls.append(SimpleNamespace(
            name=name, args=args, out=out, s=time.perf_counter() - t0,
            launches={k: v - before[k] for k, v in ft.launches.items()
                      if v != before[k]}))
        return out

    setattr(owner, name, spy)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def dpr_fold_check(torch, r, q) -> dict:
    """The bf16 fold on the DPR store's own prepared queries and rows
    (metric dot over unnormalized [CLS] rows), at the plan its search
    takes, against its plain version with phase 2's fold limits."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.distances import prepare_for_metric

    d = r.dense
    qp = prepare_for_metric(q.float(), d.metric, d._whitener).to(
        d._corpus.dtype).contiguous()
    c = d._corpus
    k = SERVE_K
    block_n, cand = ft.fold_plan(c.shape[0], k, d._effective_recall_target(k))
    s_k, i_k = ft.fused_topk_raw(qp, c, k=cand, metric=d.metric, mode="fold",
                                 block_n=block_n)
    torch.cuda.synchronize()
    ran = ft.last_kernel
    s_p, i_p = ft.fused_topk_raw_reference(qp, c, k=cand, metric=d.metric,
                                           mode="fold", block_n=block_n)
    _, ex = ft.fused_topk_raw_reference(qp, c, k=cand, metric=d.metric,
                                        mode="exact")
    id_match = (i_k == i_p).float().mean().item()
    recall = (i_k[:, :, None] == ex[:, None, :]).any(-1).float().mean().item()
    s_k, i_k = ft.rescore_candidates(qp, c, i_k, d.metric)
    s_p, i_p = ft.rescore_candidates(qp, c, i_p, d.metric)
    err = (s_k - s_p).abs()[i_k == i_p]
    rec = {"Q": int(qp.shape[0]), "N": int(c.shape[0]), "d": int(c.shape[1]),
           "metric": d.metric, "store": str(c.dtype), "k": cand,
           "block_n": block_n, "c_kernel": ran, "id_match": id_match,
           "recall_vs_exact": recall,
           "max_abs_err": err.max().item() if err.numel() else 0.0,
           "row_norm_mean": c.float().norm(dim=1).mean().item()}
    rec["ok"] = ((ran or "").split("+")[0] == "fold_mma_kernel"
                 and id_match >= FOLD_ID_MATCH)
    return rec


def check_benchmark(torch, failures: list, workdir: str,
                    vae_doc_ids) -> dict:
    """Phase 3s: ``main --ae_type none --benchmark bm25 sbert vae dpr
    --generate`` (extractive, METEOR) on the main path's data, with
    ``retrieval.index_path`` unset, so each dense system builds its own
    store: no system may report an error; bm25 Recall@10 >= 0.99; sbert's
    and vae's doc ids bit for bit those of ``main --ae_type none`` and 3r's
    ``main --ae_type vae``; dpr's (seeded towers, metric dot over
    unnormalized [CLS] rows, bf16 store) on >= 98 % of slots those of
    ``xla_exact`` over the same store, and the fold there held to its plain
    version; a p-value for every pair of systems; fold >= 2 and exact 0
    for each dense system and for dpr. Returns each system's fold
    launches and the DPR fold check's largest error."""
    from latentrag_torch import main as cli
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.pipeline import PipelineRunner
    from latentrag_torch.retrieval import BM25Retriever
    from latentrag_torch.retrieval.dpr import DPRRetriever
    from latentrag_torch.training import train_dpr

    t_phase = time.perf_counter()
    overrides = main_overrides(workdir, "auto", "bfloat16") + [
        "retrieval.index_path="]
    runs, bm25, dpr, towers = [], [], [], []
    results: list = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(counted_calls(PipelineRunner, "process", runs))
        stack.enter_context(counted_calls(BM25Retriever, "search", bm25))
        stack.enter_context(counted_calls(DPRRetriever, "build_index", dpr))
        stack.enter_context(counted_calls(DPRRetriever, "search", dpr))
        stack.enter_context(counted_calls(train_dpr, "build_dpr_encoders",
                                          towers))
        ft.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["--ae_type", "none", "--device", "cuda", "--benchmark",
                       *BENCH_SYSTEMS, "--generate", "--set", *overrides,
                       *GENERATE_OVERRIDES], results=results)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ft.launches.items() if v}
    if rc != 0 or len(results) != 1:
        fail(f"main --benchmark returned {rc} with {len(results)} results")
    out = results[0]
    # the same config through main --ae_type none (sbert's twin)
    plain: list = []
    t0 = time.perf_counter()
    cli.main(["--ae_type", "none", "--device", "cuda", "--set", *overrides],
             results=plain)
    plain_s = time.perf_counter() - t0
    by_ae = {run.args[0].ae_type: run for run in runs}
    dpr_search = [c for c in dpr if c.name == "search"][0]
    r, queries = dpr_search.args[0], dpr_search.args[1]
    q = r.q_encoder.encode_batch(list(queries))
    again = r.dense.search(q, SERVE_K)[1]
    backend = r.dense.backend
    r.dense.backend = "xla_exact"  # the oracle over the same store
    try:
        oracle = r.dense.search(q, SERVE_K)[1]
    finally:
        r.dense.backend = backend
    ids = [[j for j in row if j >= 0] for row in dpr_search.out[1]]
    fold = dpr_fold_check(torch, r, q)
    systems = {s: res for s, res in out.items() if not s.startswith("_")}
    pairs = len(BENCH_SYSTEMS) * (len(BENCH_SYSTEMS) - 1) // 2
    dpr_launches = {}
    for c in dpr:
        for k, v in c.launches.items():
            dpr_launches[k] = dpr_launches.get(k, 0) + v
    rec = {
        "card": card_line(), "wall_s": wall, "launches": launches,
        "errors": {s: res["error"] for s, res in systems.items()
                   if "error" in res},
        "metrics": {s: {m: v["mean"] for m, v in res.get("metrics",
                                                         {}).items()}
                    for s, res in systems.items()},
        "generation": {s: res.get("generation_metrics")
                       for s, res in systems.items()},
        "system_launches": {
            "sbert": by_ae["none"].launches if "none" in by_ae else None,
            "vae": by_ae["vae"].launches if "vae" in by_ae else None,
            "dpr": dpr_launches,
            "bm25": sum(sum(c.launches.values()) for c in bm25)},
        "seconds": {"bm25_search": sum(c.s for c in bm25),
                    "sbert": by_ae["none"].s if "none" in by_ae else None,
                    "vae": by_ae["vae"].s if "vae" in by_ae else None,
                    "dpr_towers": sum(c.s for c in towers),
                    "dpr_build_search": sum(c.s for c in dpr),
                    "main_none": plain_s},
        "sbert_as_main": by_ae["none"].out["retrieved_doc_ids"]
        == plain[0]["retrieved_doc_ids"] if "none" in by_ae else False,
        "vae_as_main": by_ae["vae"].out["retrieved_doc_ids"] == vae_doc_ids
        if "vae" in by_ae else False,
        "dpr_repeatable": bool((again == dpr_search.out[1]).all()),
        "dpr_vs_exact": slot_agreement(ids, [[j for j in row if j >= 0]
                                             for row in oracle]),
        "dpr_fold": fold,
        "deltas_pairs": {m: sum("p_value" in e for e in d.values())
                         for m, d in out.get("_deltas", {}).items()},
        "generation_deltas": "_generation_deltas" in out,
    }
    if "vae" in by_ae and not rec["vae_as_main"]:
        rec["vae_slot_agreement"] = slot_agreement(
            by_ae["vae"].out["retrieved_doc_ids"], vae_doc_ids)
    sys_l = rec["system_launches"]
    ok = (not rec["errors"] and set(systems) == set(BENCH_SYSTEMS)
          and rec["metrics"]["bm25"].get("Recall@10", 0.0) >= BM25_RECALL
          and rec["sbert_as_main"] and rec["vae_as_main"]
          and rec["dpr_repeatable"] and rec["dpr_vs_exact"] >= MAIN_DOC_AGREE
          and fold["ok"]
          and rec["deltas_pairs"]
          and all(n == pairs for n in rec["deltas_pairs"].values())
          and all((sys_l[s] or {}).get("fold", 0) >= 2
                  and "exact" not in (sys_l[s] or {})
                  for s in ("sbert", "vae", "dpr"))
          and sys_l["bm25"] == 0)
    rec["ok"] = ok
    rec["phase_s"] = time.perf_counter() - t_phase
    record("benchmark", **rec)
    if not ok:
        failures.append(f"the benchmark harness: {rec}")
    del r, q, runs, dpr, towers
    torch.cuda.empty_cache()
    return {"launches": {f"benchmark_{s}": (sys_l[s] or {}).get("fold", 0)
                         for s in ("sbert", "vae", "dpr")},
            "dpr_max_abs_err": fold["max_abs_err"]}


def check_generate_serving(torch, failures: list, workdir: str) -> dict:
    """Phase 3t: ``python -m latentrag_torch.serve --generate --set
    generation.provider=extractive`` over a copy of 3h's store: a search
    with ``"generate": true``, one without and a malformed line give three
    JSON lines, rc 0; then ``make_handle`` (started with ``--generate``)
    behind HTTP at window 2 ms takes 64 single-query searches with
    ``"generate": true`` from 64 clients. Every answer is
    ``extractive_answer`` over its own hits' texts; no answer comes
    without ``"generate"``; one fold launch a search call. Returns the
    load's fold launches."""
    from latentrag_torch.generation import RAGGenerator, extractive_answer
    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    truncate = RAGGenerator()._truncate_docs
    queries = eval_queries(SERVE_GENERATE_REQUESTS)
    index = f"{workdir}/serve_generate_cli_index"
    shutil.copytree(f"{workdir}/serve_index", index)
    overrides = main_overrides(workdir, "auto", "bfloat16") + [
        "generation.provider=extractive", f"retrieval.index_path={index}",
        "logging.level=INFO"]
    lines = [json.dumps({"query": queries[0], "k": SERVE_K,
                         "generate": True}),
             json.dumps({"query": queries[1], "k": SERVE_K}),
             "not json"]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "latentrag_torch.serve", "--device", "cuda",
         "--ae_type", "vae", "--generate", "--set", *overrides],
        input="".join(x + "\n" for x in lines), capture_output=True,
        text=True, timeout=600, cwd=root)
    cli_s = time.perf_counter() - t0
    try:
        resp = [json.loads(x) for x in out.stdout.splitlines() if x.strip()]
    except ValueError:
        resp = None
    cli = {"rc": out.returncode, "wall_s": cli_s,
           "json_lines": None if resp is None else len(resp),
           "stderr_tail": out.stderr[-600:]}
    ok = out.returncode == 0 and resp is not None and len(resp) == 3
    if ok:
        first = resp[0].get("results", [{}])[0]
        second = resp[1].get("results", [{}])[0]
        cli.update(
            hits=len(first.get("hits", [])),
            answer=first.get("answer"),
            answer_as_recomputed=first.get("answer") == extractive_answer(
                queries[0], truncate([h["text"] for h in first["hits"]])),
            unasked_answer="answer" in second, error=resp[2].get("error"))
        ok = (cli["hits"] == SERVE_K and bool(cli["answer"])
              and cli["answer_as_recomputed"] and not cli["unasked_answer"]
              and len(second.get("hits", [])) == SERVE_K
              and "error" in resp[2])
    if not ok:
        failures.append(f"the generating serve CLI: {cli}")
    # HTTP, the window on
    http_index = f"{workdir}/serve_generate_index"
    shutil.copytree(f"{workdir}/serve_index", http_index)
    cfg = apply_overrides(load_config(None), main_overrides(
        workdir, "auto", "bfloat16") + [
        "generation.provider=extractive",
        f"retrieval.index_path={http_index}"])
    server_env, spy, boot_rec = boot_server(torch, cfg, failures,
                                            "generating")
    with running_server(cfg, server_env, 2.0, generate=True) as srv:
        load = timed_load(torch, srv, spy, queries, profiled=False,
                          extra={"generate": True})
    check_load(load, queries, failures, "generating serve window 2.0")
    resp = load.pop("responses")
    load["answers_as_recomputed"] = sum(
        r is not None and "answer" in r and r["answer"] == extractive_answer(
            r["query"], truncate(r["texts"])) for r in resp)
    if load["answers_as_recomputed"] != len(queries):
        failures.append(f"generating serve: {load['answers_as_recomputed']} "
                        f"of {len(queries)} answers as recomputed")
    record("serve_generate", card=card_line(), cli=cli, **boot_rec,
           load=load, phase_s=time.perf_counter() - t_phase)
    del server_env, spy
    torch.cuda.empty_cache()
    return {"serve_generate_w2": load["launches"]["fold"]}


# --------------------------------- phases 3u-3w: training, then main on it

# 50 epochs, not 5: over the seeded encoder's embeddings (mean pairwise
# cosine 0.970) the VAE sits in posterior collapse for its first ~20
# epochs (its latents' mean cosine 0.99999 at 5 epochs, where the fold's
# 19-bit keys cannot order them: 0.147 of slots as xla_exact's; 0.9996 at
# 20) and leaves it by 50 (0.601, 1.0 of slots), about 3 s on the card
# (H100 80GB HBM3, 700 W; scripts/torch_training_sweep.py)
TRAIN_AE_EPOCHS = 50
TRAIN_RERANK_PAIRS = 512
STEP_LOSS_RTOL = 1e-5  # one AE step, card vs CPU from the same state
STEP_PARAM_ATOL = 1e-6


def train_overrides(workdir: str, index: str = "index") -> list:
    """The main path's data and encoder with every checkpoint at its
    default name under ``<workdir>/ckpt``."""
    return [
        "data.dataset=synthetic", "data.max_samples=2000",
        "encoder.dtype=bfloat16", "retrieval.store_dtype=bfloat16",
        "retrieval.metric=cosine", "retrieval.top_k=10",
        "retrieval.kernel=auto", f"retrieval.index_path={workdir}/{index}",
        f"paths.data_dir={workdir}/data",
        f"paths.checkpoints_dir={workdir}/ckpt",
        f"paths.logs_dir={workdir}/logs",
        "logging.log_to_file=false", "logging.level=WARNING",
    ]


def timed_training(torch, owner, step_owner, run) -> tuple:
    """Run ``run()`` (a trainer's CLI) with the peak device memory reset;
    returns its record (steps and samples from ``step_owner.train_step``'s
    calls, rates over the ``owner.fit`` call's seconds, the devices every
    batch lay on) and the fit call (trainer, data, result)."""
    fits, steps = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted_calls(owner, "fit", fits), \
            counted_calls(step_owner, "train_step", steps):
        t0 = time.perf_counter()
        rc = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fit = fits[0]
    history = fit.out.history
    rows = [next(iter(c.args[1].values())).shape[0] for c in steps]
    devices = sorted({v.device.type for c in steps
                      for v in c.args[1].values()})
    return {"rc": rc, "wall_s": wall, "fit_s": fit.s, "fits": len(fits),
            "epochs": len(history), "steps": len(steps),
            "samples": sum(rows), "history": history,
            "steps_per_s": len(steps) / fit.s,
            "samples_per_s": sum(rows) / fit.s,
            "epoch_s": fit.s / max(len(history), 1),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "batch_devices": devices}, fit


def ae_step_check(torch, trainer, data) -> dict:
    """One train step of ``trainer`` (on the card, after its fit) against
    the same step on the CPU from copies of its model and optimizer
    state, on the first 128 training rows, the VAE with one eps drawn on
    the host for both; fp32, TF32 off."""
    import copy

    from latentrag_torch.training.trainer import Trainer

    batch = {k: torch.from_numpy(v[:128]) for k, v in data.items()}
    twin = Trainer(copy.deepcopy(trainer.model).cpu(), trainer.ae_type,
                   trainer.cfg, device="cpu")
    # a deep copy: the step count is a host tensor the two would share
    twin.optimizer.load_state_dict(copy.deepcopy(
        trainer.optimizer.state_dict()))
    eps = None
    if trainer.ae_type == "vae":
        eps = torch.randn((128, trainer.model.latent_dim),
                          generator=torch.Generator().manual_seed(17))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        loss = trainer.train_step({k: v.cuda() for k, v in batch.items()},
                                  eps=None if eps is None else eps.cuda())
        loss = loss.item()
        card_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    t0 = time.perf_counter()
    want = twin.train_step(batch, eps=eps).item()
    cpu_s = time.perf_counter() - t0
    got_sd, want_sd = trainer.model.state_dict(), twin.model.state_dict()
    err = max((got_sd[k].cpu() - want_sd[k]).abs().max().item()
              for k in want_sd)
    rec = {"ae_type": trainer.ae_type, "rows": 128, "loss": loss,
           "cpu_loss": want, "loss_rel_err": abs(loss - want) / abs(want),
           "param_max_abs_err": err, "card_step_s": card_s,
           "cpu_step_s": cpu_s, "steps_per_s": 1.0 / card_s,
           "samples_per_s": 128 / card_s,
           "step_count": int(trainer.optimizer.state_dict()["state"][0][
               "step"])}
    rec["ok"] = (rec["loss_rel_err"] <= STEP_LOSS_RTOL
                 and err <= STEP_PARAM_ATOL)
    return rec


def trained_main(torch, workdir: str, ae: str, kernel: str = "auto",
                 extra=(), tag: str = "") -> tuple:
    """``main --ae_type ae`` on the card over ``train_overrides`` (its
    store at its own index_path), the kernels' counts at 0 before it;
    returns the result and the counts it left."""
    from latentrag_torch import main as cli
    from latentrag_torch.ops import fused_topk as ft

    results: list = []
    ft.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["--ae_type", ae, "--device", "cuda", "--tag",
                   f"smoke_trained_{ae}_{kernel}{tag}", "--set",
                   *train_overrides(workdir,
                                    f"index_trained_{ae}_{kernel}{tag}"),
                   f"retrieval.kernel={kernel}", *extra], results=results)
    torch.cuda.synchronize()
    if rc != 0 or len(results) != 1:
        fail(f"main --ae_type {ae} over the trained checkpoints returned "
             f"{rc} with {len(results)} results")
    res = results[0]
    res["wall_s"] = time.perf_counter() - t0
    return res, {k: v for k, v in ft.launches.items() if v}


def mean_cosine(torch, rows) -> float:
    """The mean pairwise cosine of up to 1024 rows (1 = collinear)."""
    x = rows[:1024].float()
    x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    n = x.shape[0]
    return ((x @ x.T).sum().item() - n) / (n * (n - 1))


def check_train_ae(torch, failures: list, workdir: str) -> dict:
    """Phase 3u; returns the fold launches of each trained AE's ``main``."""
    from latentrag_torch.training import train as cli
    from latentrag_torch.training import trainer as tt

    t_phase = time.perf_counter()
    out, launches = {}, {}
    for ae in ("vae", "dae", "cae"):
        run, fit = timed_training(
            torch, tt.Trainer, tt.Trainer, lambda ae=ae: cli.main(
                ["--ae_type", ae, "--epochs", str(TRAIN_AE_EPOCHS),
                 "--device", "cuda", "--set", *train_overrides(workdir)]))
        trainer, hist = fit.args[0], run["history"]
        run.update(
            ae_type=ae, card=card_line(),
            stopped_early=fit.out.stopped_early,
            weights_on_card=all(p.is_cuda for p in trainer.model.parameters()),
            val_first=hist[0][2], val_last=hist[-1][2],
            checkpoint=os.path.exists(f"{workdir}/ckpt/{ae}.pth"))
        # every epoch ran, or the early stop ended the run
        run["ok"] = (run["rc"] == 0 and run["fits"] == 1
                     and run["epochs"] == fit.out.epochs_ran
                     and (run["epochs"] == TRAIN_AE_EPOCHS
                          or run["stopped_early"])
                     and run["weights_on_card"]
                     and run["batch_devices"] == ["cuda"]
                     and run["val_last"] < run["val_first"]
                     and run["checkpoint"])
        record("train_ae", **run)
        if not run["ok"]:
            failures.append(f"training the {ae}: {run}")
        if ae == "vae":
            step = ae_step_check(torch, trainer, fit.args[1])
            step["card"] = card_line()
            record("train_step_check", **step)
            if not step["ok"]:
                failures.append(f"the VAE train step, card vs CPU: {step}")
        out[ae] = run
        del trainer, fit
    # resume: a 2-epoch DAE run, then the same run to 4 with --resume
    resume_ov = train_overrides(workdir) + [
        f"paths.checkpoints_dir={workdir}/ckpt_resume"]
    state = f"{workdir}/ckpt_resume/dae.train.pt"
    first, _ = timed_training(torch, tt.Trainer, tt.Trainer, lambda: (
        cli.main(["--ae_type", "dae", "--epochs", "2", "--device", "cuda",
                  "--set", *resume_ov])))
    saved = torch.load(state, weights_only=True)
    again, _ = timed_training(torch, tt.Trainer, tt.Trainer, lambda: (
        cli.main(["--ae_type", "dae", "--epochs", "4", "--resume",
                  "--device", "cuda", "--set", *resume_ov])))
    final = torch.load(state, weights_only=True)
    per_epoch = first["steps"] // 2
    rec = {"steps_per_epoch": per_epoch, "saved_epoch": saved["epoch"],
           "saved_step": int(saved["optimizer"]["state"][0]["step"]),
           "resumed_epochs": [h[0] for h in again["history"]],
           "resumed_steps": again["steps"], "final_epoch": final["epoch"],
           "final_step": int(final["optimizer"]["state"][0]["step"])}
    rec["ok"] = (saved["epoch"] == 1 and rec["saved_step"] == 2 * per_epoch
                 and rec["resumed_epochs"] == [2, 3]
                 and rec["final_step"] == (final["epoch"] + 1) * per_epoch)
    record("train_resume", **rec)
    if not rec["ok"]:
        failures.append(f"the resumed DAE run: {rec}")
    # main over each trained checkpoint by its default name
    for ae in ("vae", "dae", "cae"):
        with search_calls() as calls:
            res, counts = trained_main(torch, workdir, ae)
        rec = {"ae_type": ae, "launches": counts, "wall_s": res["wall_s"],
               "timings_s": res["timings"], "dim_out": res["dim_out"],
               "metrics": {m: v["mean"] for m, v in
                           res["retrieval_metrics"].items()},
               "latent_mean_cosine": mean_cosine(torch,
                                                 calls[0].retriever._corpus)}
        ok = (res["dim_out"] == 64 and counts.get("fold", 0) >= 2
              and "exact" not in counts)
        if ae == "vae":
            oracle, _ = trained_main(torch, workdir, ae, "xla_exact")
            rec["doc_id_agreement"] = slot_agreement(
                res["retrieved_doc_ids"], oracle["retrieved_doc_ids"])
            rec["oracle_metrics"] = {m: v["mean"] for m, v in
                                     oracle["retrieval_metrics"].items()}
            ok = ok and rec["doc_id_agreement"] >= MAIN_DOC_AGREE
        rec["ok"] = ok
        record("trained_main", **rec)
        if not ok:
            failures.append(f"main over the trained {ae}: {rec}")
        launches[f"trained_main_{ae}"] = counts.get("fold", 0)
        del calls
    torch.cuda.empty_cache()
    record("phase_3u", seconds=time.perf_counter() - t_phase)
    return launches


def check_train_encoders(torch, failures: list, workdir: str) -> dict:
    """Phase 3v; returns the fold launches of the encoder's ``main`` and of
    DPR's in the harness."""
    from latentrag_torch import main as cli
    from latentrag_torch.models.convert import minilm_state_dict_from_jax
    from latentrag_torch.models.encoder.msgpack_io import load_msgpack
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.retrieval.dpr import DPRRetriever
    from latentrag_torch.training import train_dpr as td
    from latentrag_torch.training import train_encoder as te

    t_phase = time.perf_counter()
    ov = train_overrides(workdir)
    launches = {}
    run, fit = timed_training(torch, te.EncoderTrainer, te.PairTrainer,
                              lambda: te.main(["--epochs", "1", "--device",
                                               "cuda", "--set", *ov]))
    trainer = fit.args[0]
    path = f"{workdir}/ckpt/encoder.msgpack"
    run.update(card=card_line(), checkpoint=os.path.exists(path),
               weights_on_card=all(p.is_cuda for p in trainer.params),
               dtype=str(trainer.module.dtype))
    with logged("latentrag_torch.main") as lines, search_calls() as calls:
        res, counts = trained_main(torch, workdir, "none")
    run.update(main_launches=counts, main_wall_s=res["wall_s"],
               embedding_mean_cosine=mean_cosine(
                   torch, calls[0].retriever._corpus),
               main_metrics={m: v["mean"] for m, v in
                             res["retrieval_metrics"].items()},
               loaded=f"loaded encoder weights: {path}" in lines)
    run["ok"] = (run["rc"] == 0 and run["steps"] > 0 and run["checkpoint"]
                 and run["weights_on_card"] and run["batch_devices"]
                 == ["cuda"] and run["loaded"]
                 and counts.get("fold", 0) >= 2 and "exact" not in counts)
    record("train_encoder", **run)
    if not run["ok"]:
        failures.append(f"training the encoder: {run}")
    launches["trained_encoder_main"] = counts.get("fold", 0)
    del trainer, fit, calls
    # DPR: its towers, then the harness's dpr system over them
    run, _ = timed_training(torch, td.DualEncoderTrainer, te.PairTrainer,
                            lambda: td.main(["--epochs", "1", "--device",
                                             "cuda", "--set", *ov]))
    dpr, results = [], []
    with counted_calls(DPRRetriever, "search", dpr):
        ft.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["--ae_type", "none", "--device", "cuda",
                       "--benchmark", "dpr", "--set", *ov,
                       "retrieval.index_path="], results=results)
        torch.cuda.synchronize()
        bench_s = time.perf_counter() - t0
        counts = {k: v for k, v in ft.launches.items() if v}
    if rc != 0 or len(results) != 1:
        fail(f"main --benchmark dpr returned {rc} with {len(results)} "
             "results")
    r, queries = dpr[0].args[0], dpr[0].args[1]
    same = {}
    for name, enc in (("dpr_question", r.q_encoder),
                      ("dpr_context", r.c_encoder)):
        want = minilm_state_dict_from_jax(load_msgpack(
            f"{workdir}/ckpt/{name}.msgpack"))
        got = enc.module.state_dict()
        same[name] = all(torch.equal(got[k].cpu(), want[k]) for k in want)
    fold = dpr_fold_check(torch, r, r.q_encoder.encode_batch(list(queries)))
    out = results[0].get("dpr", {})
    run.update(card=card_line(), bench_rc=rc, bench_s=bench_s,
               bench_launches=counts, towers_from_msgpacks=same,
               error=out.get("error"), dpr_fold=fold,
               metrics={m: v["mean"] for m, v in out.get("metrics",
                                                         {}).items()})
    run["ok"] = (run["rc"] == 0 and run["steps"] > 0
                 and run["batch_devices"] == ["cuda"] and all(same.values())
                 and "error" not in out and fold["ok"]
                 and counts.get("fold", 0) >= 2 and "exact" not in counts)
    record("train_dpr", **run)
    if not run["ok"]:
        failures.append(f"training DPR: {run}")
    launches["trained_dpr_benchmark"] = counts.get("fold", 0)
    del r, dpr
    torch.cuda.empty_cache()
    record("phase_3v", seconds=time.perf_counter() - t_phase)
    return {"launches": launches, "dpr_max_abs_err": fold["max_abs_err"]}


def check_train_reranker(torch, failures: list, workdir: str) -> dict:
    """Phase 3w; returns the reranked ``main``'s fold launches."""
    from latentrag_torch.models.convert import (
        cross_encoder_state_dict_from_jax,
    )
    from latentrag_torch.models.encoder.msgpack_io import load_msgpack
    from latentrag_torch.pipeline import aggregate_docs
    from latentrag_torch.training import train_encoder as te
    from latentrag_torch.training import train_reranker as trr

    t_phase = time.perf_counter()
    run, _ = timed_training(
        torch, trr.RerankerTrainer, te.PairTrainer, lambda: trr.main(
            ["--epochs", "1", "--device", "cuda", "--set",
             *train_overrides(workdir),
             f"data.max_samples={TRAIN_RERANK_PAIRS}"]))
    path = f"{workdir}/ckpt/reranker.msgpack"
    with rescore_calls() as calls:
        res, counts = trained_main(torch, workdir, "none",
                                   extra=("retrieval.rerank=cross",),
                                   tag="_rerank")
    call = calls[0]
    scorer = call.reranker.scorer
    want = cross_encoder_state_dict_from_jax(load_msgpack(path))
    got = scorer.module.state_dict()
    own_scores, own_docs = aggregate_docs(
        call.out, call.idx, range(len(call.texts)), res["top_k"],
        scorer.device)
    live = call.idx >= 0
    rerank_s = res["timings"]["rerank_s"]
    run.update(
        card=card_line(), pairs_trained=TRAIN_RERANK_PAIRS,
        sidecar=os.path.exists(path + ".meta.json"),
        trained_weights=all(torch.equal(got[k].cpu(), want[k]) for k in want),
        on_card=all(p.is_cuda for p in scorer.module.parameters()),
        pair_length=scorer.cfg.max_length, candidate_k=res["candidate_k"],
        pairs=int(live.sum()), rerank_s=rerank_s,
        pairs_per_s=int(live.sum()) / rerank_s, main_wall_s=res["wall_s"],
        main_launches=counts,
        docs_bit_for_bit_maxsim_of_own_logits=(
            own_docs == res["retrieved_doc_ids"]
            and bool((own_scores == res["doc_scores"]).all())),
        logit_std=float(call.out[live].std()),
        metrics={m: v["mean"] for m, v in res["retrieval_metrics"].items()})
    run["ok"] = (run["rc"] == 0 and run["steps"] > 0
                 and run["batch_devices"] == ["cuda"] and run["sidecar"]
                 and run["trained_weights"] and run["on_card"]
                 and run["candidate_k"] == 40
                 and run["docs_bit_for_bit_maxsim_of_own_logits"]
                 and counts.get("fold", 0) >= 2 and "exact" not in counts)
    record("train_reranker", **run)
    if not run["ok"]:
        failures.append(f"training the reranker: {run}")
    del call, calls, scorer
    torch.cuda.empty_cache()
    record("phase_3w", seconds=time.perf_counter() - t_phase)
    return {"trained_rerank_main": counts.get("fold", 0)}


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


# ------------------- phases 3x-3z: outside inputs and the operator's tools

HF_SEED = 1818  # the seeded MiniLM-L6 written as an HF checkpoint (3x)
HF_CROSS_SEED = 1819  # the seeded cross-encoder written as one (3y)
HF_VOCAB_WORDS = 4000  # the pseudo-words of the 3x data and its vocab.txt
MSMARCO_DATA_QUERIES = 2000  # the main path's queries, over ~10x its corpus
MSMARCO_DATA_PASSAGES = 10  # each query's passages, one selected
MSMARCO_DATA_WORDS = (40, 80)  # a passage's words, both ends included
MSMARCO_SNIPPET = (12, 3)  # a query: 12 words of its passage, 3 dropped
CLOZE_DOCS = 2000
CLOZE_RERANK_QUERIES = 500  # the reranked cloze run: 20,000 pairs
CROSS_PAIRS = 64  # 3y's pairs scored by the converted and the built model
VIZ_PAIRS = 1000  # 3z's (query, positive) pairs on the card and the CPU
# HF BERT module names of the port's TransformerLayer children
HF_LAYER_NAMES = {
    "q": "attention.self.query", "k": "attention.self.key",
    "v": "attention.self.value", "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm", "mlp_in": "intermediate.dense",
    "mlp_out": "output.dense", "mlp_ln": "output.LayerNorm",
}


def pseudo_words(n: int, seed: int) -> list:
    """``n`` distinct lowercase ASCII words of 2-4 consonant-vowel
    syllables, each one WordPiece token of the vocab written with them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cons, vows = "bcdfghjklmnprstvwz", "aeiou"
    words, seen = [], set()
    while len(words) < n:
        w = "".join(cons[rng.integers(len(cons))] + vows[rng.integers(5)]
                    for _ in range(int(rng.integers(2, 5))))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def write_safetensors(path: str, tensors: dict) -> None:
    """``tensors`` as a safetensors file (F32, little-endian): an 8-byte
    header length, the JSON header, then the buffers in order."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().to("cpu").float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)


def hf_trunk_tensors(sd: dict, token_types, prefix: str) -> dict:
    """The port's trunk state dict under HF BERT names (``prefix`` "bert."
    for a sequence classifier)."""
    out = {
        f"{prefix}embeddings.word_embeddings.weight":
            sd["word_embeddings.weight"],
        f"{prefix}embeddings.position_embeddings.weight":
            sd["position_embeddings.weight"],
        f"{prefix}embeddings.token_type_embeddings.weight": token_types,
        f"{prefix}embeddings.LayerNorm.weight": sd["embed_ln.weight"],
        f"{prefix}embeddings.LayerNorm.bias": sd["embed_ln.bias"],
    }
    for key, t in sd.items():
        if key.startswith("layers."):
            _, i, name, leaf = key.split(".")
            out[f"{prefix}encoder.layer.{i}.{HF_LAYER_NAMES[name]}.{leaf}"] = t
    return out


def write_hf_dir(path: str, tensors: dict, ecfg, vocab: list,
                 architecture: str) -> None:
    """An HF BERT checkpoint directory: config.json, model.safetensors
    and vocab.txt."""
    os.makedirs(path, exist_ok=True)
    config = {
        "architectures": [architecture], "model_type": "bert",
        "vocab_size": ecfg.vocab_size, "hidden_size": ecfg.hidden_dim,
        "num_hidden_layers": ecfg.num_layers,
        "num_attention_heads": ecfg.num_heads,
        "intermediate_size": ecfg.mlp_dim, "hidden_act": "gelu",
        "max_position_embeddings": ecfg.max_position_embeddings,
        "type_vocab_size": 2, "layer_norm_eps": 1e-12,
        "torch_dtype": "float32",
    }
    if architecture == "BertForSequenceClassification":
        config["id2label"] = {"0": "LABEL_0"}
        config["label2id"] = {"LABEL_0": 0}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")


def write_hf_bert(torch, path: str, vocab: list) -> dict:
    """The seeded MiniLM-L6 (the config's full width, the self-init
    encoder's draws from ``HF_SEED``) as an HF ``BertModel`` checkpoint;
    returns the port's state dict of it (fp32, on the CPU)."""
    from latentrag_torch.models.encoder.minilm import MiniLMEncoder, seeded_init
    from latentrag_torch.utils import load_config

    ecfg = load_config(None).encoder
    module = MiniLMEncoder(
        vocab_size=ecfg.vocab_size, hidden_dim=ecfg.hidden_dim,
        num_layers=ecfg.num_layers, num_heads=ecfg.num_heads,
        mlp_dim=ecfg.mlp_dim,
        max_position_embeddings=ecfg.max_position_embeddings)
    g = torch.Generator().manual_seed(HF_SEED)
    seeded_init(module, g)
    sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
    h = ecfg.hidden_dim
    # the segment table's row 1 and the pooler, which the bi-encoder drops
    token_types = torch.stack([sd["token_type_embedding"],
                               0.02 * torch.randn(h, generator=g)])
    tensors = hf_trunk_tensors(sd, token_types, "")
    tensors["pooler.dense.weight"] = 0.02 * torch.randn((h, h), generator=g)
    tensors["pooler.dense.bias"] = torch.zeros(h)
    write_hf_dir(path, tensors, ecfg, vocab, "BertModel")
    return sd


def write_msmarco_data(path: str, words: list, seed: int) -> None:
    """MS MARCO-shaped records: MSMARCO_DATA_QUERIES queries, each with
    MSMARCO_DATA_PASSAGES seeded passages of pseudo-words, one selected,
    the query a snippet of it with a few words dropped."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = np.asarray(words)
    n_words, n_drop = MSMARCO_SNIPPET
    with open(path, "w") as f:
        for _ in range(MSMARCO_DATA_QUERIES):
            lens = rng.integers(MSMARCO_DATA_WORDS[0],
                                MSMARCO_DATA_WORDS[1] + 1,
                                MSMARCO_DATA_PASSAGES)
            texts = [vocab[rng.integers(0, len(vocab), n)] for n in lens]
            sel = int(rng.integers(MSMARCO_DATA_PASSAGES))
            start = int(rng.integers(0, len(texts[sel]) - n_words))
            keep = np.ones(n_words, bool)
            keep[rng.choice(n_words, n_drop, replace=False)] = False
            query = " ".join(texts[sel][start:start + n_words][keep])
            f.write(json.dumps({"query": query, "passages": {
                "passage_text": [" ".join(t) + "." for t in texts],
                "is_selected": [int(j == sel) for j in range(len(texts))],
            }}) + "\n")


def run_cli(torch, argv: list) -> dict:
    """One ``latentrag_torch.main`` run on the card; the result, its wall
    seconds, the launches it made (the counts at 0 just before it) and
    its pipeline log lines."""
    from latentrag_torch import main as cli
    from latentrag_torch.ops import fused_topk as ft

    results: list = []
    ft.reset_launches()
    t0 = time.perf_counter()
    with logged("latentrag_torch.main") as lines:
        rc = cli.main(argv, results=results)
    torch.cuda.synchronize()
    if rc != 0 or len(results) != 1:
        fail(f"main {argv[:6]} returned {rc} with {len(results)} results")
    res = results[0]
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = {k: v for k, v in ft.launches.items() if v}
    res["c_kernel"] = ft.last_kernel
    res["log"] = lines
    return res


def outside_overrides(wd: str, dataset: str, index: str) -> list:
    """A run over the 3x checkpoint and data directories: the HF
    directory as ``encoder.name``, ``dataset``, its own index_path."""
    return [f"data.dataset={dataset}", f"encoder.name={wd}/hf_bert",
            f"paths.data_dir={wd}/data", f"paths.checkpoints_dir={wd}/ckpt",
            f"paths.logs_dir={wd}/logs",
            f"retrieval.index_path={wd}/{index}",
            "logging.log_to_file=false", "logging.level=WARNING"]


def run_msmarco_data(torch, wd: str, index: str) -> dict:
    """``main --config configs/msmarco_v5e8.yaml --ae_type dae`` over the
    written MS MARCO data with the HF directory as its encoder."""
    root = os.path.dirname(os.path.abspath(__file__))
    return run_cli(torch, [
        "--config", os.path.join(root, MSMARCO_CONFIG), "--ae_type", "dae",
        "--device", "cuda", "--tag", f"smoke_outside_{index}", "--set",
        *msmarco_overrides(wd, index),
        *outside_overrides(wd, f"msmarco:{wd}/msmarco.jsonl", index)])


def run_cloze(torch, wd: str, index: str, extra=()) -> dict:
    """``main --set data.dataset=cloze:<txt>`` on the default config
    (``--ae_type none``: the 384-d embeddings in a bf16 store), over the
    converted encoder."""
    return run_cli(torch, [
        "--device", "cuda", "--tag", f"smoke_outside_{index}", "--set",
        f"data.max_samples={CLOZE_DOCS}",
        *outside_overrides(wd, f"cloze:{wd}/cloze.txt", index), *extra])


def check_outside_inputs(torch, failures: list, wd: str) -> dict:
    """Phase 3x: a local HF checkpoint and MS MARCO-shaped data through
    ``main`` on the card. Writes the seeded MiniLM-L6 as an HF BERT
    directory (config.json, model.safetensors, vocab.txt) and 2000
    MS MARCO queries of 10 passages, then runs the msmarco config with
    ``encoder.name`` that directory in a fresh checkpoints_dir: the
    conversion must write ``encoder.msgpack`` with the written tensors bit
    for bit and copy vocab.txt; the corpus is the loader's, distractors
    included; the int8 fold serves search and self-check and the exact
    kernel nothing; the same run on the kernels' plain versions gives the
    same doc ids (by set at ties) and metrics; a warm run loads the
    msgpack, converts nothing and returns the same ids. Then ``main --set
    data.dataset=cloze:<txt>`` over the converted encoder: its docs on >=
    98 % of slots ``xla_exact``'s. Returns the drives' fold launches."""
    import numpy as np

    from latentrag_torch.data.msmarco import load_msmarco_eval
    from latentrag_torch.models.convert import minilm_state_dict_from_jax
    from latentrag_torch.models.encoder.msgpack_io import load_msgpack
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops import quantization as tq

    t_phase = time.perf_counter()
    words = pseudo_words(HF_VOCAB_WORDS, HF_SEED)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."] + words
    t0 = time.perf_counter()
    written = write_hf_bert(torch, f"{wd}/hf_bert", vocab)
    write_msmarco_data(f"{wd}/msmarco.jsonl", words, HF_SEED)
    write_dae(torch, f"{wd}/dae.pth")
    queries, corpus, relevant = load_msmarco_eval(
        MSMARCO_DATA_QUERIES, f"{wd}/msmarco.jsonl")
    with open(f"{wd}/cloze.txt", "w") as f:
        f.write("\n".join(corpus[r] for r in relevant[:CLOZE_DOCS]) + "\n")
    write_s = time.perf_counter() - t0

    res = run_msmarco_data(torch, wd, "index")
    converted = load_msgpack(f"{wd}/ckpt/encoder.msgpack")
    got = minilm_state_dict_from_jax(converted)
    bits = sorted(got) == sorted(written) and all(
        torch.equal(got[k], written[k]) for k in written)
    with open(f"{wd}/hf_bert/vocab.txt", "rb") as a, \
            open(f"{wd}/data/vocab.txt", "rb") as b:
        vocab_copied = a.read() == b.read()
    warm = run_msmarco_data(torch, wd, "index")
    with plain_quantized(ft):
        plain = run_msmarco_data(torch, wd, "index_plain")
    same = float(tq.same_ids_at_ties(
        res["doc_scores"], res["retrieved_doc_ids"], plain["doc_scores"],
        plain["retrieved_doc_ids"]).mean())
    ds = np.asarray(res["doc_scores"])
    metrics = {m: v["mean"] for m, v in res["retrieval_metrics"].items()}
    rec = {
        "card": card_line(), "write_s": write_s,
        "hf_dir_bytes": store_bytes(f"{wd}/hf_bert"),
        "n_queries": res["n_queries"], "n_corpus": res["n_corpus"],
        "loader_queries": len(queries), "loader_corpus": len(corpus),
        "converted_bit_for_bit": bits, "vocab_copied": vocab_copied,
        "converted_logged": any("converted HF checkpoint" in x
                                for x in res["log"]),
        "launches": res["launches"], "c_kernel": res["c_kernel"],
        "plain_launches": plain["launches"],
        "rows_same_by_set_at_ties": same, "metrics": metrics,
        "plain_metrics": {m: v["mean"] for m, v in
                          plain["retrieval_metrics"].items()},
        "timings_s": res["timings"], "wall_s": res["wall_s"],
        "warm": {"loaded_msgpack": any("loaded encoder weights" in x
                                       for x in warm["log"]),
                 "converted": any("converted" in x for x in warm["log"]),
                 "same_doc_ids": warm["retrieved_doc_ids"]
                 == res["retrieved_doc_ids"],
                 "wall_s": warm["wall_s"], "launches": warm["launches"]},
    }
    ok = (bits and vocab_copied and rec["converted_logged"]
          and res["n_corpus"] == len(corpus) == plain["n_corpus"]
          and res["n_queries"] == len(queries)
          and res["launches"].get("int8_fold", 0) >= 2
          and "int8_exact" not in res["launches"]
          and res["c_kernel"].split("+")[0] == "fold_mma_kernel<i8>"
          and not plain["launches"] and same == 1.0
          and metrics == rec["plain_metrics"]
          and rec["warm"]["loaded_msgpack"] and not rec["warm"]["converted"]
          and rec["warm"]["same_doc_ids"]
          and ds.shape == (res["n_queries"], 10)
          and bool(np.isfinite(ds).all()))
    rec["ok"] = ok
    record("msmarco_data_main_path", **rec)
    if not ok:
        failures.append(f"the msmarco data main path: {rec}")

    cloze = run_cloze(torch, wd, "index_cloze")
    oracle = run_cloze(torch, wd, "index_cloze_exact",
                       ["retrieval.kernel=xla_exact"])
    agree = slot_agreement(cloze["retrieved_doc_ids"],
                           oracle["retrieved_doc_ids"])
    crec = {
        "n_queries": cloze["n_queries"], "n_corpus": cloze["n_corpus"],
        "dim_out": cloze["dim_out"], "launches": cloze["launches"],
        "oracle_launches": oracle["launches"], "doc_agreement": agree,
        "metrics": {m: v["mean"]
                    for m, v in cloze["retrieval_metrics"].items()},
        "oracle_metrics": {m: v["mean"]
                           for m, v in oracle["retrieval_metrics"].items()},
        "timings_s": cloze["timings"], "wall_s": cloze["wall_s"],
        "loaded_msgpack": any("loaded encoder weights" in x
                              for x in cloze["log"]),
    }
    cok = (cloze["n_queries"] == cloze["n_corpus"] == CLOZE_DOCS
           and crec["loaded_msgpack"]
           and cloze["launches"].get("fold", 0) >= 2
           and "exact" not in cloze["launches"]
           and agree >= MAIN_DOC_AGREE)
    crec["ok"] = cok
    crec["phase_s"] = time.perf_counter() - t_phase
    record("cloze_main_path", **crec)
    if not cok:
        failures.append(f"the cloze main path: {crec}")
    return {"msmarco_data_int8_fold": res["launches"].get("int8_fold", 0),
            "cloze_fold": cloze["launches"].get("fold", 0),
            "n_corpus": res["n_corpus"]}


def check_outside_reranker(torch, failures: list, wd: str) -> int:
    """Phase 3y: a seeded cross-encoder at the MiniLM-L6 geometry written
    as an HF ``BertForSequenceClassification`` directory ("bert."
    prefix, 1 label), converted by ``convert_hf_cross_encoder_to_params``
    into ``reranker.msgpack``: the reranker built from it scores
    CROSS_PAIRS pairs as a ``CrossEncoderModel`` built from the written
    state dict does, bit for bit; then the reranked ``main`` over the
    cloze data (CLOZE_RERANK_QUERIES queries, candidate_k 40). Returns
    the reranked run's fold launches."""
    import numpy as np

    from latentrag_torch.data import (
        cloze_examples,
        load_evaluation_data,
        load_text_corpus,
    )
    from latentrag_torch.data.tokenizer import resolve_tokenizer
    from latentrag_torch.models.encoder.convert import (
        convert_hf_cross_encoder_to_params,
        save_params,
    )
    from latentrag_torch.models.encoder.cross import CrossEncoderScorer
    from latentrag_torch.retrieval.reranker import (
        build_reranker,
        reranker_checkpoint_path,
    )
    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    cfg = apply_overrides(load_config(None), outside_overrides(
        wd, f"cloze:{wd}/cloze.txt", "index_cloze_rerank"))
    tok = resolve_tokenizer(cfg.paths.data_dir, cfg.encoder.vocab_size)
    seeded = CrossEncoderScorer(tok, cfg.encoder, seed=HF_CROSS_SEED,
                                device="cpu")
    sd = {k: v.detach().clone() for k, v in seeded.module.state_dict().items()}
    tensors = hf_trunk_tensors(sd, sd["token_type_embeddings.weight"], "bert.")
    tensors.update({"bert.pooler.dense.weight": sd["pooler.weight"],
                    "bert.pooler.dense.bias": sd["pooler.bias"],
                    "classifier.weight": sd["classifier.weight"],
                    "classifier.bias": sd["classifier.bias"]})
    with open(f"{wd}/hf_bert/vocab.txt") as f:
        vocab = f.read().split("\n")[:-1]
    write_hf_dir(f"{wd}/hf_cross", tensors, cfg.encoder, vocab,
                 "BertForSequenceClassification")
    t0 = time.perf_counter()
    params, vocab_file = convert_hf_cross_encoder_to_params(f"{wd}/hf_cross")
    save_params(params, reranker_checkpoint_path(cfg))
    convert_s = time.perf_counter() - t0
    built = build_reranker(cfg, tok, device="cuda").scorer
    twin = CrossEncoderScorer(tok, cfg.encoder, state_dict=sd,
                              query_max=built.query_max, device="cuda")
    queries, corpus, _ = load_evaluation_data(cloze_examples(
        load_text_corpus(f"{wd}/cloze.txt"), CLOZE_DOCS))
    rng = np.random.default_rng(HF_CROSS_SEED)
    qi = rng.integers(0, len(queries), CROSS_PAIRS)
    di = rng.integers(0, len(corpus), CROSS_PAIRS)
    pq, pd = [queries[i] for i in qi], [corpus[i] for i in di]
    got, want = built.score_pairs(pq, pd), twin.score_pairs(pq, pd)
    del twin
    res = run_cloze(torch, wd, "index_cloze_rerank", [
        "retrieval.rerank=cross", f"data.max_samples={CLOZE_RERANK_QUERIES}"])
    rec = {
        "card": card_line(), "convert_s": convert_s,
        "vocab_file": vocab_file is not None,
        "hf_dir_bytes": store_bytes(f"{wd}/hf_cross"),
        "pairs": CROSS_PAIRS, "logits_bit_for_bit": bool(
            np.array_equal(got, want)),
        "logit_range": [float(got.min()), float(got.max())],
        "on_card": all(p.is_cuda for p in built.module.parameters()),
        "n_queries": res["n_queries"], "candidate_k": res["candidate_k"],
        "launches": res["launches"], "timings_s": res["timings"],
        "wall_s": res["wall_s"],
        "metrics": {m: v["mean"] for m, v in res["retrieval_metrics"].items()},
    }
    ok = (rec["logits_bit_for_bit"] and rec["on_card"]
          and bool(np.isfinite(got).all())
          and res["n_queries"] == CLOZE_RERANK_QUERIES
          and res["candidate_k"] == 40
          and res["launches"].get("fold", 0) >= 2
          and "exact" not in res["launches"]
          and bool(np.isfinite(np.asarray(res["doc_scores"])).all()))
    rec["ok"] = ok
    rec["phase_s"] = time.perf_counter() - t_phase
    record("hf_cross_encoder", **rec)
    if not ok:
        failures.append(f"the converted cross-encoder: {rec}")
    del built
    torch.cuda.empty_cache()
    return res["launches"].get("fold", 0)


def run_doctor(args: list) -> subprocess.Popen:
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "latentrag_torch.doctor", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)


def doctor_report(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    lines = [x for x in out.splitlines() if x.strip()]
    try:
        rep = json.loads(lines[0])["doctor"] if len(lines) == 1 else None
    except (ValueError, KeyError):
        rep = None
    return {"rc": proc.returncode, "stdout_lines": len(lines), "report": rep,
            "stderr_tail": err[-800:]}


def check_operator_tools(torch, failures: list, wd: str,
                         n_corpus: int) -> None:
    """Phase 3z: ``python -m latentrag_torch.doctor`` over 3x's store and
    checkpoints (exit 0, one JSON line, platform and kernels pass) and
    over a copy of the store with a corrupted sidecar (exit 1, that
    store's FAIL), both at once; then ``visualize_compressed_vs_original
    (make_plots=False)`` over VIZ_PAIRS of 3x's (query, positive)
    embeddings and DAE latents on the card, equal in recall to the same
    call on the CPU; ``reconstruction_mse`` and ``summarise_sizes`` over
    the 3x store."""
    import numpy as np

    from latentrag_torch.data.msmarco import load_msmarco_eval
    from latentrag_torch.evaluation import (
        reconstruction_mse,
        summarise_sizes,
        visualize_compressed_vs_original,
    )
    from latentrag_torch.models import encode_latents
    from latentrag_torch.pipeline import default_encoder, load_autoencoder
    from latentrag_torch.utils import apply_overrides, load_config

    t_phase = time.perf_counter()
    bad = f"{wd}/index_corrupt"
    shutil.copytree(f"{wd}/index", bad)
    with open(f"{bad}/texts_doc_ids.npy", "wb") as f:
        f.write(b"\x93NUMPY corrupted")
    t0 = time.perf_counter()
    procs = [run_doctor(["--index", f"{wd}/index", "--checkpoints",
                         f"{wd}/ckpt"]),
             run_doctor(["--index", bad, "--checkpoints", f"{wd}/ckpt"])]
    good, broken = (doctor_report(p) for p in procs)
    doctor_s = time.perf_counter() - t0
    checks = (good["report"] or {}).get("checks", {})
    bchecks = (broken["report"] or {}).get("checks", {})
    drec = {"good": good, "corrupt": broken, "wall_s": doctor_s}
    dok = (good["rc"] == 0 and good["stdout_lines"] == 1
           and checks.get("platform", {}).get("status") == "pass"
           and checks.get("kernels", {}).get("status") == "pass"
           and checks.get("store:dense", {}).get("status") == "pass"
           and broken["rc"] == 1 and broken["stdout_lines"] == 1
           and bchecks.get("store:dense", {}).get("status") == "fail"
           and bchecks.get("kernels", {}).get("status") == "pass")
    drec["ok"] = dok
    record("doctor", **drec)
    if not dok:
        failures.append(f"the doctor: {drec}")

    cfg = apply_overrides(load_config(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), MSMARCO_CONFIG)),
        [*msmarco_overrides(wd, "index"),
         *outside_overrides(wd, f"msmarco:{wd}/msmarco.jsonl", "index")])
    queries, corpus, relevant = load_msmarco_eval(
        VIZ_PAIRS, f"{wd}/msmarco.jsonl")
    t0 = time.perf_counter()
    enc = default_encoder(cfg, corpus, device="cuda")
    dae = load_autoencoder(cfg, "dae", device="cuda")
    q = enc.encode_batch(queries)
    d = enc.encode_batch([corpus[r] for r in relevant])
    q_lat, d_lat = encode_latents(dae, q), encode_latents(dae, d)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = visualize_compressed_vs_original(q, d, q_lat, d_lat,
                                            make_plots=False)
    torch.cuda.synchronize()
    viz_s = time.perf_counter() - t0
    host = visualize_compressed_vs_original(
        q.cpu(), d.cpu(), q_lat.cpu(), d_lat.cpu(), make_plots=False)
    mse = reconstruction_mse(dae, d)
    sizes = summarise_sizes(f"{wd}/index", n_corpus, 384, 64)
    vrec = {"pairs": len(queries), "card": card, "cpu": host,
            "encode_s": encode_s, "viz_s": viz_s,
            "reconstruction_mse": mse, "sizes": sizes}
    vok = (card["recall_original"] == host["recall_original"]
           and card["recall_compressed"] == host["recall_compressed"]
           and q.is_cuda and q_lat.is_cuda and np.isfinite(mse) and mse >= 0
           and sizes["index_bytes"] > 0 and sizes["compression_ratio"] == 6.0)
    vrec["ok"] = vok
    vrec["phase_s"] = time.perf_counter() - t_phase
    record("latent_diagnostics", **vrec)
    if not vok:
        failures.append(f"the latent diagnostics: {vrec}")
    del enc, dae, q, d, q_lat, d_lat
    torch.cuda.empty_cache()


# ------------------------------------------- phases 5a-5d: the sharded corpus

SHARDS = 4  # the virtual mesh: four shards on cuda:0
SHARD_ROWS = 1_000_003  # not a multiple of 4: pad rows on the last shard
SHARD_QUERIES = 1024
SHARD_D = 64
SHARD_MASK = 0.1  # the filtered cases' allowed share
RING_ROWS = 200_000  # the ring k-NN's corpus, in SHARDS shards
RING_K = 16
MP_ROWS = 100_003  # phase 5d's rows (two processes of 2 shards each)
MP_QUERIES = 256


def shard_mesh():
    from latentrag_torch.parallel import make_mesh

    return make_mesh(devices=["cuda:0"] * SHARDS)


def shard_kernel_check(torch, ft, case: dict, q, shard, k: int, mask):
    """One shard's kernel call, as its route makes it at ``k``, against
    the kernel's plain version on the same inputs, with phase 2's limits
    (2b's for the binary kernels, 2d's for the int8 ones). Not counted:
    the caller reads the launches before it."""
    from latentrag_torch.ops.quantization import score_factor, sq8_quantize

    store, rt = case["store"], case["rt"]
    n = shard.shape[0]
    k_eff = min(k, n)
    fold = k_eff <= ft.FOLD_MAX_K and case["backend"] != "exact"
    rec = {"rows": n, "k": k_eff, "fold": fold}
    if store == "int8":
        qc, qs = sq8_quantize(q.float())
        fac = score_factor(qs, case["scale"])
        if fold:
            block_n, cand = ft.fold_plan(n, k_eff, rt)
            kw = dict(k=cand, mode="fold", block_n=block_n, mask=mask)
        else:
            kw = dict(k=k_eff, mode="exact", mask=mask)
        s_k, i_k = ft.sq8_fused_topk_raw(qc, shard, fac, **kw)
        s_p, i_p = ft.quantized_fused_topk_raw_reference(
            qc, shard, fac, d=shard.shape[1], op=ft._OP_I8, **kw)
        same = i_k == i_p
        rec["id_match"] = same.float().mean().item()
        rec["max_abs_err"] = (s_k - s_p).abs()[same].max().item()
        rec["ok"] = rec["id_match"] >= (FOLD_ID_MATCH if fold else 1.0) \
            and rec["max_abs_err"] == 0.0
        return rec
    if store == "binary":
        from latentrag_torch.ops.binary import binary_topk

        if fold:
            block_n, cand = ft.fold_plan(n, k_eff, rt)
            s_k, i_k = ft.binary_fused_topk_raw(
                q, shard, d=SHARD_D, k=cand, block_n=block_n, mask=mask)
            s_p, i_p = ft.binary_fused_topk_raw_reference(
                q, shard, d=SHARD_D, k=cand, block_n=block_n, mask=mask)
            tol = 2.0 ** -10 * s_p.abs() + 1e-6  # one 19-bit key step
        else:
            s_k, i_k = ft.binary_exact_topk_raw(q, shard, d=SHARD_D,
                                                k=k_eff, mask=mask)
            s_p, i_p = binary_topk(q, shard, SHARD_D, k_eff, mask=mask)
            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
        same = i_k == i_p.to(i_k.dtype)
        rec["id_match"] = same.float().mean().item()
        rec["max_abs_err"] = (s_k - s_p).abs()[same].max().item()
        rec["ok"] = rec["id_match"] >= (BIN_ID_MATCH if fold
                                        else EXACT_ID_MATCH) and bool(
            ((s_k - s_p).abs() <= tol)[same].all())
        return rec
    metric = case["metric"]
    if fold:
        block_n, cand = ft.fold_plan(n, k_eff, rt)
        kw = dict(k=cand, metric=metric, mode="fold", block_n=block_n,
                  mask=mask)
    else:
        kw = dict(k=k_eff, metric=metric, mode="exact", mask=mask)
    s_k, i_k = ft.fused_topk_raw(q, shard, **kw)
    s_p, i_p = ft.fused_topk_raw_reference(q, shard, **kw)
    same = i_k == i_p
    rec["id_match"] = same.float().mean().item()
    if fold:  # exact rescored scores at equal ids
        s_k, i_k = ft.rescore_candidates(q, shard, i_k, metric)
        s_p, i_p = ft.rescore_candidates(q, shard, i_p, metric)
        same = i_k == i_p
        err = (s_k - s_p).abs()[same]
        rec["max_abs_err"] = err.max().item() if err.numel() else 0.0
        rec["ok"] = rec["id_match"] >= FOLD_ID_MATCH
        return rec
    tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s_p.abs()
    slot_err = (s_k - s_p).abs()
    rec["max_abs_err"] = slot_err[same].max().item() if same.any() else 0.0
    if k_eff > ft.EXACT_MAX_K:
        # ranks near 3000 of 250k scores lie ~1e-5 apart: sets and every
        # slot's score, as phase 2 holds the select at 1M
        rec["set_match"] = set_match(torch, i_k, i_p)
        rec["slot_max_abs_err"] = slot_err.max().item()
        rec["ok"] = rec["set_match"] >= EXACT_ID_MATCH and bool(
            (slot_err <= tol).all())
    else:
        rec["ok"] = rec["id_match"] >= EXACT_ID_MATCH and bool(
            (slot_err <= tol)[same].all())
    return rec


def sharded_cases(torch) -> list:
    """Phase 5a's searches: (store, metric, backend, k, masked), each with
    the kernel it runs on every shard, its launch counter and the name of
    that kernel's entry in the kernels line."""
    cases = []
    for store, metric in (("bfloat16", "cosine"), ("bfloat16", "euclidean"),
                          ("float32", "cosine")):
        tag = "_fp32" if store == "float32" else ""
        cases += [
            dict(store=store, metric=metric, backend="approx", k=10,
                 counter="fold", entry=f"fused_topk_fold{tag}"),
            dict(store=store, metric=metric, backend="exact", k=160,
                 counter="exact", entry=f"fused_topk_exact{tag}"),
            dict(store=store, metric=metric, backend="exact", k=3000,
                 counter="exact", entry=f"fused_topk_exact_select{tag}"),
        ]
    cases += [
        dict(store="bfloat16", metric="cosine", backend="approx", k=10,
             masked=True, counter="fold", entry="fused_topk_fold_masked"),
        dict(store="bfloat16", metric="cosine", backend="exact", k=160,
             masked=True, counter="exact", entry="fused_topk_exact_masked"),
        dict(store="int8", metric="cosine", backend="sq8", k=10,
             counter="int8_fold", entry="sq8_fused_topk_fold"),
        dict(store="int8", metric="cosine", backend="sq8", k=160,
             counter="int8_exact", entry="sq8_fused_topk_exact"),
        dict(store="int8", metric="cosine", backend="sq8", k=10, masked=True,
             counter="int8_fold", entry="sq8_fused_topk_fold_masked"),
        dict(store="binary", metric="cosine", backend="binary", k=10,
             counter="binary_fold", entry="binary_fused_topk_fold"),
        dict(store="binary", metric="cosine", backend="binary", k=160,
             counter="binary_exact", entry="binary_exact_topk"),
    ]
    for c in cases:
        c.setdefault("masked", False)
        c["rt"] = 0.99
    return cases


def check_sharded_topk(torch, failures: list) -> dict:
    """Phase 5a: ``make_sharded_topk`` on a 4-shard mesh of cuda:0 over
    SHARD_ROWS seeded rows (d=64), Q=1024: bf16 (cosine, euclidean: the
    pad-row case) and fp32 stores at k=10 (the fold), 160 (the exact
    kernel) and 3000 (the exact select), the int8 and binary stores at 10
    and 160, a 10 % row mask at 10 and 160. Each search is read with the
    counts at 0 (4 launches of its kernel, one a shard); each shard's
    kernel call is then held to its plain version; the exact routes to
    the unsharded exact route (ids by set where scores tie, scores within
    phase 2's exact limits), the fold routes by candidate recall against
    it; no pad row's or masked row's id. The sharded and unsharded searches
    are timed. Returns the launches by kernel entry."""
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.binary import binary_quantize
    from latentrag_torch.ops.quantization import score_factor, sq8_quantize
    from latentrag_torch.ops.store_search import store_topk
    from latentrag_torch.ops.topk import pack_row_mask
    from latentrag_torch.parallel import make_sharded_topk, shard_rows

    t_phase = time.perf_counter()
    mesh = shard_mesh()
    g = torch.Generator(device="cuda").manual_seed(505)
    raw = torch.randn((SHARD_ROWS, SHARD_D), generator=g, device="cuda")
    qraw = torch.randn((SHARD_QUERIES, SHARD_D), generator=g, device="cuda")
    unit = torch.nn.functional.normalize(raw, dim=1)
    qunit = torch.nn.functional.normalize(qraw, dim=1)
    allowed = torch.rand(SHARD_ROWS, generator=g, device="cuda") < SHARD_MASK
    mask_sh = shard_rows(allowed, mesh)
    mask_sh.shards = [pack_row_mask(m) for m in mask_sh.shards]
    whole_mask = pack_row_mask(allowed)
    codes, cscale = sq8_quantize(unit)
    words = binary_quantize(unit)
    stores = {}
    out: dict = {}
    for case in sharded_cases(torch):
        store, metric = case["store"], case["metric"]
        key = (store, metric)
        if key not in stores:
            if store == "int8":
                c, q = codes, qunit
            elif store == "binary":
                c, q = words, qunit
            else:
                dt = getattr(torch, store)
                src, qs = (raw, qraw) if metric == "euclidean" else (
                    unit, qunit)
                c, q = src.to(dt).contiguous(), qs.to(dt).contiguous()
            stores[key] = (c, q, shard_rows(c, mesh))
        c, q, sh = stores[key]
        case["scale"] = float(cscale)
        k, masked = case["k"], case["masked"]
        fn = make_sharded_topk(mesh, k=k, metric=metric,
                               backend=case["backend"], d=SHARD_D,
                               filtered=masked)
        args = (q, sh, SHARD_ROWS, float(cscale) if store == "int8"
                else None)
        kw = {"mask_shard": mask_sh} if masked else {}
        ft.reset_launches()
        s, i = fn(*args, **kw)
        torch.cuda.synchronize()
        launches = dict(ft.launches)
        local_k = k + SHARDS - 1
        checks = [shard_kernel_check(
            torch, ft, case, q, sh.shards[j], local_k,
            mask_sh.shards[j] if masked else None) for j in range(SHARDS)]
        # the unsharded route of the same store, whole corpus
        route_store = {"bfloat16": "float", "float32": "float"}.get(
            store, store)
        route = {"approx": "xla", "exact": "exact"}.get(case["backend"])
        whole = functools.partial(
            store_topk, q, c, k, store=route_store, backend=route,
            metric=metric, recall_target=case["rt"],
            mask=whole_mask if masked else None,
            scale=float(cscale) if store == "int8" else None, d=SHARD_D)
        wm = whole_mask if masked else None
        if store == "int8":  # the exact int8 kernel over the whole store
            qc, qs = sq8_quantize(q.float())
            s0, i0 = ft.sq8_fused_topk_raw(
                qc, c, score_factor(qs, float(cscale)), k=k, mode="exact",
                mask=wm)
        elif store == "binary":
            s0, i0 = ft.binary_exact_topk_raw(q, c, d=SHARD_D, k=k, mask=wm)
        else:
            s0, i0 = store_topk(q, c, k, store="float", backend="exact",
                                metric=metric, mask=wm)
        torch.cuda.synchronize()
        i_cpu = i.cpu()
        live = i_cpu >= 0
        rec = {**{f: case[f] for f in ("store", "metric", "backend", "k",
                                       "masked", "counter", "entry")},
               "launches": launches[case["counter"]],
               "masked_launches": launches["masked"],
               "shard_checks": checks,
               "pad_ids": int((i_cpu >= SHARD_ROWS).sum()),
               "empty_slots": int((~live).sum())}
        if masked:
            ok_rows = allowed.cpu()[i_cpu.clamp_min(0)]
            rec["masked_ids"] = int((live & ~ok_rows).sum())
        sharded_exact = case["backend"] == "exact" or k > ft.FOLD_MAX_K
        if sharded_exact:
            rec["set_match"] = set_match(torch, i, i0.long())
            tol = EXACT_SCORE_ATOL + EXACT_SCORE_RTOL * s0.abs()
            rec["slot_max_abs_err"] = (s - s0).abs().max().item()
            score_ok = bool(((s - s0).abs() <= tol).all())
            rec["ok_vs_unsharded"] = (rec["set_match"] >= EXACT_ID_MATCH
                                      and score_ok)
        else:
            rec["recall_vs_exact"] = set_match(torch, i, i0.long())
            rec["ok_vs_unsharded"] = rec["recall_vs_exact"] >= FOLD_RECALL
        rec["sharded_ms"] = time_ms(torch, lambda: fn(*args, **kw), reps=10,
                                    warmup=2)
        rec["unsharded_ms"] = time_ms(torch, whole, reps=10, warmup=2)
        rec["ok"] = (rec["launches"] == SHARDS
                     and (not masked or rec["masked_launches"] == SHARDS)
                     and all(x["ok"] for x in checks)
                     and rec["pad_ids"] == 0
                     and rec.get("masked_ids", 0) == 0
                     and rec["ok_vs_unsharded"])
        record("sharded_topk", **rec)
        if not rec["ok"]:
            failures.append(f"sharded top-k {rec}")
        out.setdefault(case["entry"], {})[
            f"{store}_{metric}_k{k}"] = rec["launches"]
    del stores, raw, unit, codes, words
    torch.cuda.empty_cache()
    record("sharded_topk_phase", phase_s=time.perf_counter() - t_phase)
    return out


def sharded_main_overrides(wd: str, store: str, top_k: int,
                           kernel: str = "auto") -> list:
    return main_overrides(wd, kernel, store, top_k) + [
        "retrieval.shard_corpus=true",
        f"retrieval.index_path={wd}/sharded_{kernel}_{store}_{top_k}"]


def plain_sharded_cascade(torch, r, queries, k: int, p: int):
    """The binary store ``r`` (unsharded) searched over ``p`` shards built
    here, apart from the port's ``parallel/``: its words split into row
    ranges of ceil(n / p) rows, zero words padding the last; each range
    searched by the plain version of the kernel that a shard's stage 1
    launches, at that shard's plan (k + p - 1 of its rows: the fold's plain
    version up to 128 candidates, the exact search's past them); its ids
    offset by its start, pad rows dropped; the ranges' candidates ranked by
    score, ties to the lower shard-major position (a stable sort); then
    the store's stage 2. Host numpy (scores, ids)."""
    import numpy as np

    from latentrag_torch.ops import binary as tb
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.distances import prepare_for_metric
    from latentrag_torch.retrieval.rescore import exact_rescore_topk

    q = prepare_for_metric(torch.as_tensor(queries).float().cuda(),
                           r.metric, r._whitener)
    n, d = r._corpus_n, r._dim
    ok = min(r.binary_oversample * k, n)
    rt = r._effective_recall_target(k)
    rows = -(-n // p)
    words = torch.zeros((rows * p, r._corpus.shape[1]), dtype=torch.int32,
                        device="cuda")
    words[:n] = r._corpus[:n]
    parts_s, parts_i = [], []
    for j in range(p):
        w = words[j * rows:(j + 1) * rows].contiguous()
        kk = min(ok + p - 1, rows)
        if kk > ft.FOLD_MAX_K:
            s1, idx = tb.binary_topk(q, w, d, kk)
        else:
            block_n, cand = ft.fold_plan(rows, kk, rt)
            _, idx = ft.binary_fused_topk_raw_reference(
                q, w, d=d, k=cand, block_n=block_n)
            s1, idx = ft.rescore_binary_candidates(q, w, idx, d)
            s1, idx = s1[:, :kk], idx[:, :kk]
        gi = idx.long().cpu().numpy() + j * rows
        parts_s.append(np.where(gi < n, s1.float().cpu().numpy(), -np.inf))
        parts_i.append(gi)
    cat_s, cat_i = np.concatenate(parts_s, 1), np.concatenate(parts_i, 1)
    order = np.argsort(-cat_s, axis=1, kind="stable")[:, :ok]
    cand = np.take_along_axis(cat_i, order, 1)
    cand = np.where(np.take_along_axis(cat_s, order, 1) > -np.inf, cand, -1)
    return exact_rescore_topk(
        q.cpu().numpy(), lambda i: r._rescore_host[i], cand, k,
        metric="dot", scale=r._corpus_scale)


def check_sharded_main(torch, failures: list) -> dict:
    """Phase 5b: the main path at full width (MiniLM-L6 bf16, 384 -> VAE
    64, 1997 contexts, 2000 queries) through ``PipelineRunner(cfg,
    ae_type="vae", mesh=<4 shards of cuda:0>).process`` under
    ``retrieval.shard_corpus``: the bf16 store at top_k 10 and 150 held to
    the ``xla_exact`` oracle over one unsharded store of the same latents
    (MAIN_DOC_AGREE of the slots, metrics within MAIN_METRIC_TOL), the
    binary store at top_k 10 and 20 to ``plain_sharded_cascade`` over the
    unsharded binary store's words (BIN_DOC_AGREE of the slots: the same
    plans, so the same ties) and to the unsharded binary store (metrics
    within BIN_METRIC_TOL; at 20, where stage 1 is exact, BIN_DOC_AGREE of
    the slots; at 10 the two fold plans keep different rows among equal
    sign-dots, its slot agreement recorded); the 4-shard encode against the
    unsharded one (the encoder's bf16 band); the bf16 store saved as
    sharded/, warm-booted by a second run ("skipping rebuild", the same
    docs), mutated (an added row top-1 on itself, a removed id never
    back) and checked by ``python -m latentrag_torch.doctor``; then
    ``main --set retrieval.shard_corpus=true`` on the one card (a 1-device
    mesh, dropped: the unsharded run bit for bit). Returns the launches of
    each run, read with the counts at 0 before it."""
    import numpy as np

    from latentrag_torch.data import get_examples, load_evaluation_data
    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.pipeline import PipelineRunner
    from latentrag_torch.retrieval import load_retriever
    from latentrag_torch.utils import Config, apply_overrides

    t_phase = time.perf_counter()
    mesh = shard_mesh()
    launches: dict = {}
    wd = tempfile.mkdtemp(prefix="lr_sharded_")
    atexit.register(shutil.rmtree, wd, True)
    write_vae(torch, f"{wd}/vae.pth")
    base = apply_overrides(Config(), sharded_main_overrides(wd, "bfloat16",
                                                            10))
    queries, corpus, relevant = load_evaluation_data(get_examples(base))

    def run(store, top_k, kernel="auto", sharded=True):
        """One run on the 4-shard encode; ``sharded``: the store too (the
        reference runs search one unsharded store of the same latents)."""
        ov = sharded_main_overrides(wd, store, top_k, kernel)
        if not sharded:
            ov = [o for o in ov if "shard_corpus" not in o] + [
                f"retrieval.index_path={wd}/plain_{kernel}_{store}_{top_k}"]
        cfg = apply_overrides(Config(), ov)
        ft.reset_launches()
        t0 = time.perf_counter()
        with logged("latentrag_torch.retrieval") as lines:
            res = PipelineRunner(cfg, ae_type="vae", device="cuda",
                                 mesh=mesh).process(
                queries, corpus, relevant)
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = dict(ft.launches)
        res["retrieval_log"] = lines
        return res, cfg

    rows = lambda ids: [list(r) for r in ids]  # noqa: E731
    results = {}
    # the queries' latents of the main runs, by the 4-shard encode
    sharded_enc = PipelineRunner(base, ae_type="vae", device="cuda",
                                 mesh=mesh)._ensure_compressor(corpus)
    q_emb = sharded_enc.encode_text(list(queries))
    # the binary store at top_k=10: stage 1 is the fold, whose plan differs
    # between 500-row shards (128-row tiles, 4 a lane) and the 1997-row
    # store (16 a lane); these seeded latents' sign words repeat by the
    # hundred (recorded), so the two folds keep different rows among
    # equal sign-dots: against the unsharded store it is held on the
    # metrics, its slot agreement recorded, and on its slots against
    # plain_sharded_cascade, whose plans break the ties as the shards do.
    # At top_k=20 stage 1 is exact, ties to the lower row, on both sides
    for store, top_k, ref_kernel, agree_min, tol in (
            ("bfloat16", 10, "xla_exact", MAIN_DOC_AGREE, MAIN_METRIC_TOL),
            ("bfloat16", 150, "xla_exact", MAIN_DOC_AGREE, MAIN_METRIC_TOL),
            ("binary", 10, "auto", 0.0, BIN_METRIC_TOL),
            ("binary", 20, "auto", BIN_DOC_AGREE, BIN_METRIC_TOL)):
        res, cfg = run(store, top_k)
        ref, _ = run(store, top_k, ref_kernel, sharded=False)
        agree = slot_agreement(rows(res["retrieved_doc_ids"]),
                               rows(ref["retrieved_doc_ids"]))
        deltas = {m: abs(res["retrieval_metrics"][m]["mean"]
                         - ref["retrieval_metrics"][m]["mean"])
                  for m in res["retrieval_metrics"]}
        ds = np.asarray(res["doc_scores"])
        want = {("bfloat16", 10): {"fold": 2 * SHARDS},
                ("bfloat16", 150): {"exact": SHARDS, "fold": SHARDS},
                ("binary", 10): {"binary_fold": 2 * SHARDS},
                ("binary", 20): {"binary_exact": SHARDS,
                                 "binary_fold": SHARDS}}[(store, top_k)]
        got = {c: res["launches"][c] for c in want}
        persisted = any(x.startswith("index persisted to")
                        for x in res["retrieval_log"])
        rec = {"store": store, "top_k": top_k, "reference": ref_kernel,
               "doc_agreement": agree, "metric_deltas": deltas,
               "metrics": {m: v["mean"] for m, v in
                           res["retrieval_metrics"].items()},
               "timings_s": res["timings"], "wall_s": res["wall_s"],
               "reference_wall_s": ref["wall_s"], "launches": got,
               "persisted": persisted, "agreement_held": agree_min > 0,
               "finite": bool(np.isfinite(ds).all()),
               "shape_ok": ds.shape == (res["n_queries"], top_k)}
        rec["ok"] = (agree >= agree_min and max(deltas.values()) <= tol
                     and got == want and rec["finite"] and rec["shape_ok"]
                     and persisted and res["dim_out"] == 64)
        rec["self_check_failed"] = {
            name: "post-build self-check failed; rebuilding once" in x[
                "retrieval_log"] for name, x in (("sharded", res),
                                                 ("reference", ref))}
        if store == "binary":
            # the unsharded store of the same latents, split into shards
            # here: the main run's docs on BIN_DOC_AGREE of the slots
            plain_cfg = apply_overrides(Config(), main_overrides(
                wd, "auto", store, top_k) + [
                f"retrieval.index_path={wd}/plain_auto_{store}_{top_k}"])
            u = load_retriever(plain_cfg.retrieval, device="cuda")
            _, ids = plain_sharded_cascade(torch, u, q_emb, top_k, SHARDS)
            split_docs = [[u.doc_ids[int(j)] for j in row if j >= 0]
                          for row in ids]
            rec["plain_sharded_doc_agreement"] = slot_agreement(
                rows(res["retrieved_doc_ids"]), split_docs)
            rec["distinct_sign_rows"] = int(torch.unique(
                u._rows(), dim=0).shape[0])
            rec["ok"] = rec["ok"] and (rec["plain_sharded_doc_agreement"]
                                       >= BIN_DOC_AGREE)
        record("sharded_main_path", **rec)
        if not rec["ok"]:
            failures.append(f"sharded main path {rec}")
        launches[f"{store}_top_k_{top_k}"] = got
        results[(store, top_k)] = (res, cfg)

    # the 4-shard encode against the unsharded one, bf16 MiniLM-L6
    res, cfg = results[("bfloat16", 10)]
    plain_enc = PipelineRunner(cfg, ae_type="vae",
                               device="cuda")._ensure_compressor(corpus)
    texts = list(corpus[:512])
    e_sh = sharded_enc.encoder.encode_batch(texts)
    e_pl = plain_enc.encoder.encode_batch(texts)
    enc_err = (e_sh - e_pl).abs().max().item()
    enc = {"rows": len(texts), "max_abs_err": enc_err,
           "bit_for_bit": torch.equal(e_sh, e_pl),
           "ok": enc_err <= 5e-3}
    record("sharded_encode", **enc)
    if not enc["ok"]:
        failures.append(f"the 4-shard encode {enc}")

    # the sharded store: on disk, the doctor, a warm boot, mutation
    path = cfg.retrieval.index_path
    files = sorted(os.listdir(path))
    # the doctor reads a copy: the mutations below rewrite the store
    shutil.copytree(path, f"{wd}/doctor_copy")
    doctor_proc = run_doctor(["--index", f"{wd}/doctor_copy",
                              "--checkpoints", f"{wd}/ckpt"])
    again, _ = run("bfloat16", 10)
    warm = {"files": files,
            "skipped": "index compatible; skipping rebuild"
                       in again["retrieval_log"],
            "same_docs": again["retrieved_doc_ids"]
            == res["retrieved_doc_ids"],
            "search_launches": again["launches"]["fold"]}
    r = load_retriever(cfg.retrieval, device="cuda", mesh=mesh)
    comp = sharded_enc
    new_text = "a sharded store takes a new document about comets"
    new_emb = comp.encode_text([new_text])
    ft.reset_launches()
    r.add(new_emb, [new_text], doc_ids=[10 ** 6])
    removed = r.remove([0, 1])
    _, ids = r.search(comp.encode_text([new_text, corpus[0]]), 10)
    mutation_launches = dict(ft.launches)
    warm["added_top1"] = r.doc_ids[int(ids[0, 0])] == 10 ** 6
    warm["removed_back"] = any(r.doc_ids[int(j)] in (0, 1)
                               for j in ids.ravel() if j >= 0)
    warm["removed"] = removed
    r2 = load_retriever(cfg.retrieval, device="cuda", mesh=mesh)
    warm["reloaded_n"] = r2._corpus_n if r2 is not None else None
    d_out, d_err = doctor_proc.communicate(timeout=600)
    try:
        report = json.loads(d_out.strip().splitlines()[-1])["doctor"]
    except (ValueError, KeyError, IndexError):
        report = {}
    store_check = report.get("checks", {}).get("store:dense", {})
    note = [x for x in d_err.splitlines() if "sharded/ store present" in x]
    warm["doctor"] = {"rc": doctor_proc.returncode, "store": store_check,
                      "note": note}
    warm["ok"] = ("sharded" in files and "corpus.npy" not in files
                  and warm["skipped"] and warm["same_docs"]
                  and warm["added_top1"] and not warm["removed_back"]
                  and removed == 2 and warm["reloaded_n"] == len(corpus) - 1
                  and doctor_proc.returncode == 0
                  and store_check.get("status") == "pass" and bool(note))
    record("sharded_store", **warm)
    if not warm["ok"]:
        failures.append(f"the sharded store {warm}")
    launches["warm_boot"] = {"fold": warm["search_launches"]}
    launches["mutation"] = {"fold": mutation_launches["fold"]}

    # main on the one card with shard_corpus: a 1-device mesh, dropped
    from latentrag_torch import main as cli

    outs = []
    for sharded_flag in (True, False):
        ov = main_overrides(wd, "auto", "bfloat16") + [
            f"retrieval.index_path={wd}/one_card_{sharded_flag}"]
        if sharded_flag:
            ov.append("retrieval.shard_corpus=true")
        got: list = []
        with logged("latentrag_torch.main") as lines:
            rc = cli.main(["--ae_type", "vae", "--device", "cuda", "--set",
                           *ov], results=got)
        outs.append((rc, got, lines))
    (rc1, r1, l1), (rc2, r2_, _) = outs
    one = {"logged": "sharding corpus over 1 devices" in l1,
           "rc": [rc1, rc2],
           "same_docs": bool(r1 and r2_ and r1[0]["retrieved_doc_ids"]
                             == r2_[0]["retrieved_doc_ids"]),
           "same_scores": bool(r1 and r2_ and np.array_equal(
               r1[0]["doc_scores"], r2_[0]["doc_scores"]))}
    one["ok"] = rc1 == rc2 == 0 and all(
        one[f] for f in ("logged", "same_docs", "same_scores"))
    record("shard_corpus_one_card", **one)
    if not one["ok"]:
        failures.append(f"main with shard_corpus on one card {one}")
    record("sharded_main_phase", phase_s=time.perf_counter() - t_phase)
    return launches


def check_ring_knn(torch, failures: list) -> dict:
    """Phase 5c: ``sharded_knn_graph`` over RING_ROWS x 64 fp32 unit rows
    in 4 shards of cuda:0, k=RING_K: the approximate ring (the fp32 fold,
    one launch a shard a step) at recall >= KNN_RECALL of ``knn_graph``'s
    exact lists, the exact ring equal to them by set. Returns the
    approximate ring's launches."""
    import numpy as np

    from latentrag_torch.ops import fused_topk as ft
    from latentrag_torch.ops.knn import knn_graph
    from latentrag_torch.parallel import sharded_knn_graph

    t_phase = time.perf_counter()
    mesh = shard_mesh()
    g = torch.Generator(device="cuda").manual_seed(707)
    c = torch.nn.functional.normalize(
        torch.randn((RING_ROWS, ANN_D), generator=g, device="cuda"), dim=1)
    t0 = time.perf_counter()
    want = knn_graph(c, RING_K, exact=True)
    exact_single_s = time.perf_counter() - t0
    ft.reset_launches()
    t0 = time.perf_counter()
    approx = sharded_knn_graph(c, RING_K, mesh)
    approx_s = time.perf_counter() - t0
    launches = dict(ft.launches)
    t0 = time.perf_counter()
    exact = sharded_knn_graph(c, RING_K, mesh, exact=True)
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = knn_graph(c, RING_K)
    single_s = time.perf_counter() - t0

    def recall(got):
        hits = sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(got, want))
        return hits / want.size

    rec = {"rows": RING_ROWS, "k": RING_K, "shards": SHARDS,
           "fold_launches": launches["fold"],
           "approx_recall": recall(approx), "exact_recall": recall(exact),
           "exact_same_order": bool(np.array_equal(exact, want)),
           "single_device_approx_recall": recall(single),
           "approx_s": approx_s, "exact_s": exact_s,
           "single_device_approx_s": single_s,
           "single_device_exact_s": exact_single_s}
    rec["ok"] = (rec["approx_recall"] >= KNN_RECALL
                 and rec["exact_recall"] == 1.0
                 and launches["fold"] == SHARDS * SHARDS)
    rec["phase_s"] = time.perf_counter() - t_phase
    record("ring_knn", **rec)
    if not rec["ok"]:
        failures.append(f"the ring k-NN {rec}")
    del c
    torch.cuda.empty_cache()
    return {"ring_approx": launches["fold"]}


def check_two_processes(torch, failures: list) -> None:
    """Phase 5d: two processes on gloo (``scripts/torch_multiproc_worker.py
    --device cuda:0 --local_devices 2 --dtype bfloat16``), a 4-shard global
    mesh on the one card: their sharded exact bf16 and SQ8 searches equal
    bit for bit to this process's 4-shard search of the same rows; the
    sharded store both saved, loaded here on a 4-shard mesh and with no
    mesh, searches as they did. A worker's failure fails the phase."""
    import socket

    import numpy as np

    from latentrag_torch.parallel import (
        load_sharded_index,
        make_sharded_topk,
        shard_rows,
    )
    from latentrag_torch.retrieval import DenseRetriever

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "scripts"))
    from torch_multiproc_worker import data

    t_phase = time.perf_counter()
    wd = tempfile.mkdtemp(prefix="lr_mp_")
    atexit.register(shutil.rmtree, wd, True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "scripts",
                                      "torch_multiproc_worker.py"),
         "--process_id", str(r), "--num_processes", "2",
         "--coordinator", f"localhost:{port}", "--local_devices", "2",
         "--device", "cuda:0", "--dtype", "bfloat16", "--n", str(MP_ROWS),
         "--d", "64", "--queries", str(MP_QUERIES), "--out", f"{wd}/res",
         "--checkpoint_dir", f"{wd}/ckpt"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    workers_s = time.perf_counter() - t_phase
    rec = {"workers_rc": [rc for rc, _ in outs], "workers_s": workers_s}
    if any(rc != 0 or "TORCH_MULTIPROC_OK" not in out for rc, out in outs):
        rec["tails"] = [out[-1500:] for _, out in outs]
        record("two_processes", **rec)
        failures.append(f"a phase 5d worker failed: {rec}")
        return
    res = [dict(np.load(f"{wd}/res.{r}.npz")) for r in range(2)]
    corpus, queries, _ = data(MP_ROWS, 64, MP_QUERIES)
    mesh = shard_mesh()
    q = torch.tensor(queries, device="cuda")
    c = torch.tensor(corpus, device="cuda").to(torch.bfloat16)
    sh = shard_rows(c, mesh)
    s, i = make_sharded_topk(mesh, k=10, backend="exact")(q, sh, MP_ROWS)
    codes = torch.tensor(res[0]["codes"], device="cuda")
    s8, i8 = make_sharded_topk(mesh, k=10, backend="sq8")(
        q, shard_rows(codes, mesh), MP_ROWS, float(res[0]["scale"]))
    same = lambda a, b: bool(np.array_equal(a, b))  # noqa: E731
    rec["ranks_agree"] = all(same(res[0][x], res[1][x]) for x in res[0])
    rec["exact_bit_for_bit"] = same(res[0]["exact_i"], i.cpu().numpy()) \
        and same(res[0]["exact_s"], s.cpu().numpy())
    rec["sq8_bit_for_bit"] = same(res[0]["sq8_i"], i8.cpu().numpy()) \
        and same(res[0]["sq8_s"], s8.cpu().numpy())
    loaded, meta = load_sharded_index(f"{wd}/ckpt/sharded", mesh)
    s2, i2 = make_sharded_topk(mesh, k=10, backend="exact")(q, loaded,
                                                           MP_ROWS)
    rec["checkpoint_mesh_bit_for_bit"] = same(i2.cpu().numpy(),
                                              res[0]["exact_i"]) and same(
        s2.cpu().numpy(), res[0]["exact_s"])
    whole, _ = load_sharded_index(f"{wd}/ckpt/sharded", device="cuda")
    rec["checkpoint_rows_bit_for_bit"] = torch.equal(whole[:MP_ROWS], c)
    dense = {}
    for label, m in (("mesh", mesh), ("no_mesh", None)):
        r = DenseRetriever(backend="xla_exact", store_dtype="bfloat16",
                           mesh=m, device="cuda",
                           index_path=f"{wd}/ckpt/dense")
        sd, idd = r.search(queries, 10)
        dense[label] = r.is_built and same(idd, res[0]["dense_i"]) and same(
            sd, res[0]["dense_s"])
    rec["dense_store_bit_for_bit"] = dense
    rec["ok"] = (rec["ranks_agree"] and rec["exact_bit_for_bit"]
                 and rec["sq8_bit_for_bit"]
                 and rec["checkpoint_mesh_bit_for_bit"]
                 and rec["checkpoint_rows_bit_for_bit"]
                 and all(dense.values()))
    rec["phase_s"] = time.perf_counter() - t_phase
    record("two_processes", **rec)
    if not rec["ok"]:
        failures.append(f"phase 5d {rec}")


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
    worst["fold_fp32_knn"] = check_knn_fold(torch, failures)  # phase 2f
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
    launches32, oracle32, launches32_150, filtered32 = check_main_path(
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
    knn_time = time_knn_fold(torch)
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
    # phases 3m and 3n: the ANN tiers at 1M, then through main and serve;
    # each drive's fold launches read with the counts set to 0 before it
    knn_launches = check_ann_tiers(torch, failures)
    if failures:
        fail("; ".join(failures))
    knn_main_launches = check_ann_main(torch, failures, main_wd, oracle32)
    if failures:
        fail("; ".join(failures))
    # phases 3o-3q: the second stage and chunked documents through main
    # and serve; each drive's fold launches read with the counts at 0
    slice_launches = {"rerank_main": check_rerank_main(torch, failures,
                                                       main_wd)}
    if failures:
        fail("; ".join(failures))
    slice_launches.update(check_chunked_main(torch, failures, main_wd))
    if failures:
        fail("; ".join(failures))
    slice_launches.update(check_rerank_serving(torch, failures, main_wd))
    if failures:
        fail("; ".join(failures))
    # phases 3r-3t: generation, the benchmark harness (DPR: the fold at
    # metric dot) and served generation; each drive's fold launches read
    # with the counts at 0
    generated = check_generate_main(torch, failures, main_wd)
    if failures:
        fail("; ".join(failures))
    gen_launches = {"generate_main": generated["launches"]}
    bench = check_benchmark(torch, failures, main_wd,
                            generated["vae_doc_ids"])
    if failures:
        fail("; ".join(failures))
    gen_launches.update(bench["launches"])
    worst["fold"] = max(worst["fold"], bench["dpr_max_abs_err"])
    gen_launches.update(check_generate_serving(torch, failures, main_wd))
    if failures:
        fail("; ".join(failures))
    # phases 3u-3w: the trainers on the card, then main over what they
    # wrote; each main's fold launches read with the counts at 0
    train_wd = tempfile.mkdtemp(prefix="lr_train_")
    atexit.register(shutil.rmtree, train_wd, True)
    train_launches = check_train_ae(torch, failures, train_wd)
    if failures:
        fail("; ".join(failures))
    trained_encoders = check_train_encoders(torch, failures, train_wd)
    if failures:
        fail("; ".join(failures))
    train_launches.update(trained_encoders["launches"])
    worst["fold"] = max(worst["fold"], trained_encoders["dpr_max_abs_err"])
    train_launches.update(check_train_reranker(torch, failures, train_wd))
    if failures:
        fail("; ".join(failures))
    # phases 3x-3z: an HF checkpoint, MS MARCO and cloze data through main,
    # the converted cross-encoder, the doctor and the latent diagnostics;
    # each main's launches read with the counts at 0 just before it
    outside_wd = tempfile.mkdtemp(prefix="lr_outside_")
    atexit.register(shutil.rmtree, outside_wd, True)
    t_outside = time.perf_counter()
    outside = check_outside_inputs(torch, failures, outside_wd)
    if failures:
        fail("; ".join(failures))
    outside["cloze_rerank_fold"] = check_outside_reranker(torch, failures,
                                                         outside_wd)
    if failures:
        fail("; ".join(failures))
    check_operator_tools(torch, failures, outside_wd, outside.pop("n_corpus"))
    if failures:
        fail("; ".join(failures))
    record("outside_inputs_phases", seconds=time.perf_counter() - t_outside)
    # phases 5a-5d: the sharded corpus on a mesh of four shards of the one
    # card; each search and run read with the counts at 0 just before it
    t_sharded = time.perf_counter()
    sharded = check_sharded_topk(torch, failures)
    if failures:
        fail("; ".join(failures[:5]))
    counter_entry = {"fold": "fused_topk_fold", "exact": "fused_topk_exact",
                     "binary_fold": "binary_fused_topk_fold",
                     "binary_exact": "binary_exact_topk"}
    for label, counts in check_sharded_main(torch, failures).items():
        for counter, n in counts.items():
            sharded.setdefault(counter_entry[counter], {})[
                f"main_{label}"] = n
    if failures:
        fail("; ".join(failures))
    sharded["fused_topk_fold_fp32_knn"] = check_ring_knn(torch, failures)
    if failures:
        fail("; ".join(failures))
    check_two_processes(torch, failures)
    if failures:
        fail("; ".join(failures))
    record("sharded_phases", seconds=time.perf_counter() - t_sharded)

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
    # at 0: the bf16 fold serves them all, as it serves stage 1 of the
    # reranked and chunked runs (phases 3o-3q)
    kernels[0]["serve_launches"] = serve_launches
    kernels[0]["rerank_chunk_launches"] = slice_launches
    # and stage 1 of the generated main path, of each dense system of the
    # benchmark harness, DPR's (metric dot) included, and of the
    # generating server (phases 3r-3t)
    kernels[0]["generate_benchmark_launches"] = gen_launches
    # and stage 1 of main over the trained AEs, encoder, DPR towers and
    # reranker (phases 3u-3w)
    kernels[0]["trained_launches"] = train_launches
    # and stage 1 of main over the cloze data, plain and reranked, on the
    # converted HF encoder (phases 3x-3y)
    kernels[0]["outside_inputs_launches"] = {
        "cloze_main": outside["cloze_fold"],
        "cloze_rerank_main": outside["cloze_rerank_fold"]}
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
                if key == "int8_fold":
                    # the msmarco config over MS MARCO-shaped data (3x)
                    kernels[-1]["msmarco_data_launches"] = outside[
                        "msmarco_data_int8_fold"]
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
    # the fp32 fold's list-of-128 instance as the HNSW build runs it
    # (phase 2f at 4096 x 1M and at the main path's 1997 rows; launches:
    # the 1M build of 3m and the cold main run of 3n). The JAX package's
    # k-NN stage is no Pallas kernel: XLA's approx_max_k (ops/topk.py),
    # which the port runs on this fold kernel
    t = knn_time
    kernels.append({
        "name": "fused_topk_fold_fp32_knn",
        "route": "cuda",
        "source": "latentrag_torch/csrc/fold_mma.cuh",
        "replaces": "latentrag_tpu/ops/topk.py:209",
        "launches": knn_launches,
        "main_launches": knn_main_launches,
        "max_abs_err": worst["fold_fp32_knn"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": f"Q={t['Q']} N={t['N']} d={ANN_D} k={t['k']} "
                 f"block_n={t['block_n']} fp32 cosine (knn_graph's block)",
        "resources": t["resources"],
    })
    # the slice's drives (5a-5c): each kernel's launches there, by run
    for entry in kernels:
        entry["sharded_launches"] = sharded.get(entry["name"], {})
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
