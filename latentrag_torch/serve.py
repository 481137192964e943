"""The port's query server (stdin/stdout JSONL, or HTTP): the JAX package's
``serve.py`` on PyTorch.

Loads the configured encoder + AE + index once, then serves searches:
one JSON object per line in, one per line out. With ``--http PORT`` the
same request handler serves over a threaded stdlib HTTP server instead:

  POST /search   body = the query object below ({"query"|"queries", ...})
  POST /add      body = the "add" payload      ({"texts": [...], ...})
  POST /remove   body = the "remove" payload   ({"doc_ids": [...]})
  GET|POST /stats[?reset=1]                    -> serving stats
  GET /healthz                                 -> liveness + index info

Device work and mutations serialize behind one lock; HTTP threads overlap
only on parse and I/O. The kernels' launch counters and ``last_kernel``
(``ops/fused_topk.py``) stay coherent because every search runs under
that lock, and every response is host data (``DenseRetriever.search``
returns numpy) before the lock drops. With ``--batch-window-ms N``
concurrent searches of one (k, filter) group coalesce into a single
encode and one fold or exact launch (``latentrag_torch.serving``).

Protocol:

  {"query": "...", "k": 5}                  -> retrieval
  {"query": "...", "generate": true}        -> retrieval + an answer
                                               (server started with
                                               --generate)
  {"queries": ["...", "..."], "k": 5}       -> one batched device call
  {"query": "...", "filter": {...}}         -> predicate-filtered search
                                               (doc_ids / exclude_doc_ids
                                               / where: retrieval.filtering)
  {"add": {"texts": ["..."], "doc_ids": [..],
           "metadata": [{...}, ...]}}       -> incremental index growth
  {"remove": {"doc_ids": [..]}}             -> drop docs (dense tiers;
                                               survivors' scores unchanged)
  {"query": "...", "nprobe": 64}            -> the device IVF's probe
                                               budget for this search
                                               (retrieval.ivf_nlist > 0)
  {"stats": true[, "reset": true]}          -> serving stats + index info
                                               (+ ivf_recall_estimate)

``retrieval.rerank=cross`` adds the second stage (``retrieval/
reranker.py``): boot loads the cross-encoder and fails without its
checkpoint; each search fetches ``max(k, rerank_candidates or 4 k)``
candidates, rescores them on the device and keeps the best k, whose
scores are then cross-encoder logits. The micro-batcher's padding rows
(copies of a burst's last query) are encoded and searched at their bucket
but not rescored: the JAX server rescores them for its fixed jit shapes,
which the port does not have.

``--generate`` answers requests that carry ``"generate": true``: each
result gets an ``"answer"`` from its own hits' texts through the
configured generator (``generation.provider=extractive`` answers offline;
a multi-query request's answers run through ``generate_batch_async``).
Generation runs on the host after the lock is released, on the direct
and the micro-batched path alike, so a slow LLM call never holds up other
requests' device work. Without ``--generate`` the flag is ignored, as the
JAX server ignores it.

``retrieval.backend=hnsw|ivfpq`` serves the C++ ANN tiers (their
searches, filters and adds on the host; ``"nprobe"`` and ``remove`` are
refused there with the JAX server's texts).

Boot modes: when ``retrieval.index_path`` holds a loadable persisted
index (written by the port or by the JAX package), the server WARM-boots
from it: texts and vectors come off disk and the corpus is never
re-encoded. ``--cold-boot`` forces the dataset load + encode + build; it
also runs when no store exists, when the store's provenance contradicts
the serving config, or when its width differs from the encoder's output.

``--device`` defaults to ``cuda`` and never falls back to the CPU on its
own; ``--device cpu`` runs the plain PyTorch path.

Usage:
  echo '{"query": "what do telescopes observe?"}' | \\
      python -m latentrag_torch.serve --device cuda --ae_type vae \\
          --set models.vae.checkpoint=/path/vae.pth
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import inspect
import json
import sys
import threading
import time

import numpy as np
import torch

from .data import get_examples, load_evaluation_data
from .models.encoder.minilm import _bucket_batch
from .pipeline import PipelineRunner
from .retrieval import build_retriever, load_retriever
from .retrieval.filtering import canonical_filter_key
from .serving import MicroBatcher
from .utils import apply_overrides, canonical_ae_type, init_logger, load_config


def boot(cfg, args, loggers):
    """Returns (runner, compressor, retriever, mode), mode "warm" or
    "cold". ``args`` carries ``ae_type``, ``generate``, ``cold_boot`` and
    ``device``."""
    mesh = None
    if cfg.retrieval.shard_corpus and torch.device(
            args.device).type == "cuda" and torch.cuda.device_count() > 1:
        from .parallel import make_mesh

        # one card serves the corpus unsharded, as the JAX server does
        mesh = make_mesh()
        loggers.main.info("serving sharded over %d devices", mesh.size)
    runner = PipelineRunner(
        cfg, ae_type=canonical_ae_type(args.ae_type),
        generate=args.generate, device=args.device, mesh=mesh,
    )
    ae = runner.ae_type if runner.ae_type != "none" else None
    retriever = None
    if not args.cold_boot:
        retriever = load_retriever(
            cfg.retrieval, device=runner.device, mesh=mesh,
            expect={"embedding_model": cfg.encoder.name, "ae_type": ae},
        )
    if retriever is not None:
        # the encoder and AE still load (queries need encoding), but the
        # corpus text feeding the tokenizer fallback comes from the store
        compressor = runner._ensure_compressor(retriever.texts)
        if retriever.dim and retriever.dim != compressor.output_dim:
            loggers.main.warning(
                "persisted index dim %d != encoder output %d; cold boot",
                retriever.dim, compressor.output_dim,
            )
            retriever = None
            # the compressor above may carry a tokenizer trained on the
            # STALE store's texts: the cold path rebuilds from the
            # configured corpus, exactly as a plain --cold-boot run would
            runner._compressor = None
    if retriever is not None:
        return runner, compressor, retriever, "warm"

    _, corpus, _ = load_evaluation_data(get_examples(cfg))
    compressor = runner._ensure_compressor(corpus)
    retriever = build_retriever(
        compressor.encode_text(corpus), corpus, None, cfg.retrieval,
        device=runner.device, mesh=mesh,
        embedding_model=cfg.encoder.name,
        ae_type=ae,
        latent_dim=compressor.output_dim,
    )
    return runner, compressor, retriever, "cold"


def make_handle(cfg, args, runner, compressor, retriever, mode):
    """One request dict -> one response dict (raises on protocol errors).

    Shared by the JSONL loop and the HTTP front-end. Device work (encode +
    search) and mutations serialize behind one lock: interleaved mutations
    would corrupt the texts/doc_ids/index alignment, and the kernels'
    launch accounting assumes one search at a time.
    """
    lock = threading.Lock()

    def _validate_search(req: dict):
        """Shared request validation -> (queries, k, filter, nprobe)."""
        queries = req.get("queries")
        if queries is None:
            queries = [req["query"]]
        elif not isinstance(queries, list):
            # a bare string would be encoded character by character
            raise ValueError('"queries" must be a list of strings')
        k = int(req.get("k", cfg.retrieval.top_k))
        flt = req.get("filter")
        if flt is not None and "filter" not in inspect.signature(
            retriever.search
        ).parameters:
            raise ValueError(
                f"{type(retriever).__name__} does not support filtered "
                'search; use backend "dense", "hnsw" or "ivfpq"'
            )
        nprobe = req.get("nprobe")
        if nprobe is not None:
            # the per-request device-IVF probe budget: a strict int (a
            # float would truncate, a bool would pass as 0 or 1), and only
            # where an IVF is configured
            if isinstance(nprobe, bool) or not isinstance(nprobe, int) \
                    or nprobe <= 0:
                raise ValueError('"nprobe" must be a positive integer')
            if "nprobe" not in inspect.signature(
                retriever.search
            ).parameters or not getattr(retriever, "ivf_nlist", 0):
                raise ValueError(
                    '"nprobe" requires the dense backend with '
                    "retrieval.ivf_nlist > 0 (the device IVF tier)"
                )
        return queries, k, flt, nprobe

    # the second stage (retrieval.rerank=cross): boot fails here when its
    # checkpoint is missing
    reranker = runner._ensure_reranker()

    def _hits_for(queries, k, flt, nprobe=None, live=None):
        """Encode + search (+ rerank) + assemble per-query hit lists, for
        the first ``live`` queries (default all; the rest are padding that
        is encoded and searched, never rescored). Must run under the lock:
        hit assembly reads texts/doc_ids, which mutations rewrite. The
        search and the rescore return host numpy, so the device work has
        finished when the lock drops."""
        n = len(queries) if live is None else live
        fetch_k = k
        if reranker is not None:
            fetch_k = max(k, cfg.retrieval.rerank_candidates or 4 * k)
        q_emb = compressor.encode_text(queries)
        kw = {"filter": flt} if flt is not None else {}
        if nprobe is not None:
            kw["nprobe"] = nprobe
        scores, idx = retriever.search(q_emb, fetch_k, **kw)
        scores, idx = scores[:n], np.asarray(idx)[:n]
        if reranker is not None:
            rescored = reranker.rescore_candidates(queries[:n], idx,
                                                   retriever.texts)
            order = np.argsort(-rescored, axis=1)[:, :k]
            scores = np.take_along_axis(rescored, order, axis=1)
            idx = np.take_along_axis(idx, order, axis=1)
            idx = np.where(scores > -1e37, idx, -1)
        return [
            [
                {
                    "text": retriever.texts[j],
                    "score": float(scores[qi][rank]),
                    "doc_id": retriever.doc_ids[j],
                }
                for rank, j in enumerate(idx[qi])
                if j >= 0
            ]
            for qi in range(n)
        ]

    # dynamic micro-batching (HTTP mode ONLY: a single-stream JSONL caller
    # would pay the window as pure latency with nothing to coalesce):
    # concurrent search requests of one (k, filter) group coalesce into
    # one encode and one search
    batcher = None
    window_ms = float(getattr(args, "batch_window_ms", 0) or 0)
    if window_ms > 0 and getattr(args, "http", None) is not None:
        def _score_batch(queries, k, flt, nprobe=None):
            # burst sizes are arbitrary; pad the query list to the
            # encoder's power-of-two batch buckets, so the search sees
            # only those sizes too. The batcher pads with copies of the
            # burst's last query: past the first of that trailing run,
            # rows take its hits and are not rescored
            n = len(queries)
            live = n
            while live > 1 and queries[live - 2] == queries[n - 1]:
                live -= 1
            padded = list(queries) + [queries[0]] * (_bucket_batch(n) - n)
            with lock:
                hits = _hits_for(padded, k, flt, nprobe, live=live)
            return hits + [hits[-1]] * (n - live)

        batcher = MicroBatcher(
            _score_batch, window_ms=window_ms,
            max_batch=int(getattr(args, "max_batch", 64) or 64),
        )

    def handle(req: dict) -> dict:
        if batcher is None or (
            req.get("stats") or "add" in req or "remove" in req
        ):
            with lock:
                out = _handle_locked(req)
        else:
            queries, k, flt, nprobe = _validate_search(req)
            fkey = canonical_filter_key(flt) if flt is not None else None
            t0 = time.perf_counter()
            hits = batcher.submit(queries, k, flt, fkey, nprobe)
            out = {
                "results": [
                    {"query": q, "hits": h} for q, h in zip(queries, hits)
                ],
                "latency_ms": round((time.perf_counter() - t0) * 1000, 3),
            }
        if (req.get("generate") and getattr(args, "generate", False)
                and "results" in out):
            # outside the lock: the hits are host data already
            _answer(out["results"])
        return out

    def _answer(results: list) -> None:
        """An ``"answer"`` on each result, from its own hits' texts."""
        gen = runner._ensure_generator()
        queries = [r["query"] for r in results]
        docs = [[h["text"] for h in r["hits"]] for r in results]
        if len(results) > 1:  # overlap in-flight completions
            answers = asyncio.run(gen.generate_batch_async(
                queries, docs,
                concurrency=max(1, cfg.generation.concurrency)))
        else:
            answers = [gen.generate(queries[0], docs[0])]
        for r, a in zip(results, answers):
            r["answer"] = a

    def _handle_locked(req: dict) -> dict:
        if req.get("stats"):
            out_stats = {
                "stats": retriever.get_stats(reset=bool(req.get("reset"))),
                "n_docs": len(retriever.texts),
                "boot": mode,
                "ae_type": runner.ae_type,
                "dim": compressor.output_dim,
                "rerank": cfg.retrieval.rerank,
                "micro_batch_window_ms": window_ms if batcher else 0,
            }
            ivf_r = getattr(retriever, "_ivf_recall_estimate", None)
            if ivf_r is not None:
                out_stats["ivf_recall_estimate"] = round(float(ivf_r), 4)
            return out_stats
        if "add" in req:
            spec = req["add"]
            texts = spec.get("texts")
            if not isinstance(texts, list) or not texts:
                raise ValueError(
                    '"add.texts" must be a non-empty list of strings'
                )
            t0 = time.perf_counter()
            emb = compressor.encode_text(texts)
            retriever.add(emb, texts, spec.get("doc_ids"),
                          metadata=spec.get("metadata"))
            return {
                "added": len(texts),
                "n_total": len(retriever.texts),
                "latency_ms": round((time.perf_counter() - t0) * 1000, 3),
            }
        if "remove" in req:
            spec = req["remove"]
            ids = spec.get("doc_ids") if isinstance(spec, dict) else spec
            if not isinstance(ids, list) or not ids:
                raise ValueError('"remove.doc_ids" must be a non-empty list')
            if not hasattr(retriever, "remove"):
                raise ValueError(
                    f"{type(retriever).__name__} does not support remove; "
                    "rebuild the index without those docs"
                )
            t0 = time.perf_counter()
            removed = retriever.remove(ids)
            return {
                "removed": removed,
                "n_total": len(retriever.texts),
                "latency_ms": round((time.perf_counter() - t0) * 1000, 3),
            }
        queries, k, flt, nprobe = _validate_search(req)
        t0 = time.perf_counter()
        hits = _hits_for(queries, k, flt, nprobe)
        return {
            "results": [
                {"query": q, "hits": h} for q, h in zip(queries, hits)
            ],
            "latency_ms": round((time.perf_counter() - t0) * 1000, 3),
        }

    handle.close = batcher.close if batcher is not None else (lambda: None)
    return handle


def serve_http(handle, retriever, mode, host, port, loggers):
    """Threaded stdlib HTTP front-end over the shared request handler.
    Returns the bound server (the caller runs ``serve_forever``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs

    class Handler(BaseHTTPRequestHandler):
        def _respond(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self, req: dict) -> None:
            try:
                self._respond(200, handle(req))
            except KeyError as e:
                self._respond(400, {"error": f"missing field {e}"})
            except Exception as e:  # noqa: BLE001 - a request's error
                self._respond(400, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):  # noqa: N802 (stdlib naming)
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
            except Exception as e:  # noqa: BLE001 - a malformed body
                self._respond(400, {"error": f"{type(e).__name__}: {e}"})
                return
            path = self.path.split("?")[0].rstrip("/")
            if path == "/search":
                self._dispatch(body)
            elif path == "/add":
                self._dispatch({"add": body})
            elif path == "/remove":
                self._dispatch({"remove": body})
            elif path == "/stats":
                self._dispatch({"stats": True, **body})
            else:
                self._respond(404, {"error": f"unknown path {self.path!r}"})

        def do_GET(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            path = path.rstrip("/")
            if path == "/healthz":
                self._respond(200, {
                    "ok": True, "n_docs": len(retriever.texts),
                    "boot": mode,
                })
            elif path == "/stats":
                reset = parse_qs(query).get("reset", ["0"])[-1]
                self._dispatch(
                    {"stats": True,
                     "reset": reset.lower() in ("1", "true", "yes")}
                )
            else:
                self._respond(404, {"error": f"unknown path {self.path!r}"})

        def log_message(self, fmt, *a):  # route access logs off stdout
            loggers.main.debug("http: " + fmt, *a)

    class Server(ThreadingHTTPServer):
        # the listen backlog: the stdlib's 5 drops the connections of a
        # burst of concurrent clients, which retry only a second later
        request_queue_size = 128

    server = Server((host, port), Handler)
    loggers.main.info("http serving on %s:%d", *server.server_address[:2])
    return server


@contextlib.contextmanager
def running_http(handle, retriever, mode, host, port, loggers):
    """``serve_http`` serving on a thread of its own; yields the bound
    server (``server.server_address[1]`` is the port when ``port`` is 0).
    On exit it stops the server, closes its socket, then closes
    ``handle`` (failing what its batcher still holds) and joins the
    thread."""
    server = serve_http(handle, retriever, mode, host, port, loggers)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        handle.close()
        thread.join(timeout=30)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="latentrag_torch query server")
    p.add_argument("--config", default=None)
    p.add_argument("--ae_type", default="none")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--generate", action="store_true",
                   help='answer requests that carry "generate": true')
    p.add_argument(
        "--cold-boot", action="store_true",
        help="force dataset load + corpus re-encode even when a persisted "
             "index is loadable",
    )
    p.add_argument(
        "--http", type=int, default=None, metavar="PORT",
        help="serve HTTP on this port instead of stdin/stdout JSONL",
    )
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --http (default loopback)")
    p.add_argument(
        "--batch-window-ms", type=float, default=0.0, metavar="MS",
        help="dynamic micro-batching window for concurrent --http "
             "searches: the first request of a (k, filter) group waits "
             "this long for others to coalesce into ONE device call "
             "(0 = off)",
    )
    p.add_argument(
        "--max-batch", type=int, default=64,
        help="micro-batching: flush a group at this many queries even "
             "inside the window",
    )
    p.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.set)
    # stdout is the JSONL response channel: log lines go to stderr
    loggers = init_logger(cfg.logging, stream=sys.stderr)

    t_boot = time.perf_counter()
    runner, compressor, retriever, mode = boot(cfg, args, loggers)
    loggers.main.info(
        "%s boot in %.1fs: corpus=%d dim=%d ae=%s device=%s", mode,
        time.perf_counter() - t_boot, len(retriever.texts),
        compressor.output_dim, runner.ae_type, runner.device,
    )

    handle = make_handle(cfg, args, runner, compressor, retriever, mode)

    # warm the live request path before accepting traffic: the first
    # search otherwise pays the kernels' build and load (and the
    # tokenizer's) on a live request; routing it through handle() keeps
    # it on the very path real traffic takes
    if retriever.texts:
        t0 = time.perf_counter()
        handle({"query": str(retriever.texts[0])[:256],
                "k": cfg.retrieval.top_k})
        retriever.get_stats(reset=True)  # exclude warmup from serving stats
        loggers.main.info(
            "query path warmed in %.1fs; serving", time.perf_counter() - t0
        )
    if args.http is not None:
        server = serve_http(
            handle, retriever, mode, args.host, args.http, loggers
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            handle.close()
        return 0
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                out = handle(json.loads(line))
            except Exception as e:  # noqa: BLE001 - one error line a request
                out = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps(out), flush=True)
    finally:
        handle.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
