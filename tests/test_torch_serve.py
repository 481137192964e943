"""The port's query server (``latentrag_torch.serve``) against the JAX
package's ``serve.py``, on the CPU at small widths: the same JSONL stream
over copies of one warm-booted store, line for line; HTTP micro-batching;
the boot modes; and the two repairs it needed (``shard_corpus`` on one
device, ``DenseRetriever.dim``)."""

import io
import json
import logging
import os
import shutil
import socket
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace
from unittest.mock import patch

import numpy as np
import pytest
import torch

import serve as jax_serve
from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_torch import serve
from latentrag_torch.models import VariationalAutoencoder
from latentrag_torch.retrieval import DenseRetriever, EmbeddingCompressor
from latentrag_torch.retrieval import factory
from latentrag_torch.utils import (
    Config,
    apply_overrides,
    init_logger,
    load_config,
)

N_EXAMPLES = 48


def _overrides(base, index, latent=8, vae="vae.pth"):
    return [
        f"paths.data_dir={base}/data",
        f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs",
        f"retrieval.index_path={index}",
        "logging.log_to_file=false",
        "data.dataset=synthetic", f"data.max_samples={N_EXAMPLES}",
        "encoder.vocab_size=800", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", f"models.vae.latent_dim={latent}",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={base}/{vae}",
    ]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One tokenizer (data_dir), one JAX encoder saved as
    ``<checkpoints_dir>/encoder.msgpack`` and one VAE ``.pth``: both
    packages read all three."""
    base = str(tmp_path_factory.mktemp("serve"))
    queries, corpus, _ = load_evaluation_data(
        synthetic_examples(N_EXAMPLES))
    tok = resolve_tokenizer(f"{base}/data", 800, corpus)
    cfg = jax_overrides(JaxConfig(), _overrides(base, ""))
    params = JaxEncoder(tok, cfg.encoder, seed=11).params
    save_params(params, f"{base}/ckpt/encoder.msgpack")
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    torch.manual_seed(6)
    torch.save(VariationalAutoencoder(32, 4, 16).state_dict(),
               f"{base}/vae4.pth")
    return SimpleNamespace(base=base, queries=queries, corpus=corpus)


def _run(main_fn, argv, payload, capsys):
    """One server run over ``payload`` lines; its stdout as JSON lines."""
    capsys.readouterr()
    with patch.object(sys, "stdin", io.StringIO(
            "".join(line + "\n" for line in payload))):
        assert main_fn(argv) == 0
    return [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()
            if line.strip()]


def _port(env, index, payload, capsys, extra=(), flags=()):
    return _run(serve.main,
                ["--ae_type", "vae", "--device", "cpu", *flags, "--set",
                 *_overrides(env.base, index), *extra], payload, capsys)


def _cold_store(env, capsys, store, kernel):
    """The port cold-boots once and persists its store; returns it."""
    index = f"{env.base}/cold_{store}"
    if not os.path.exists(f"{index}/meta.json"):
        _port(env, index, [], capsys,
              extra=[f"retrieval.store_dtype={store}",
                     f"retrieval.kernel={kernel}"])
    return index


def _stream(env):
    q0, q1, q2 = env.queries[:3]
    live = "zzqx unique quasar document"
    other = "another freshly added note about glaciers"
    return [
        json.dumps({"query": q0, "k": 3}),
        json.dumps({"queries": [q1, q2], "k": 2}),
        # fewer allowed rows than k: the empty slot is dropped
        json.dumps({"query": q0, "k": 4, "filter": {"doc_ids": [0, 3, 5]}}),
        json.dumps({"query": q1, "k": 3,
                    "filter": {"exclude_doc_ids": [0, 1, 2]}}),
        json.dumps({"add": {"texts": [live, other], "doc_ids": [900, 901],
                            "metadata": [{"src": "live"},
                                         {"src": "other"}]}}),
        json.dumps({"query": live, "k": 3,
                    "filter": {"where": {"src": "live"}}}),
        json.dumps({"query": other, "k": 3}),
        json.dumps({"remove": {"doc_ids": [900]}}),
        json.dumps({"query": live, "k": 3}),
        json.dumps({"stats": True}),
        json.dumps({"query": q0, "generate": True, "k": 2}),
        json.dumps({"query": q0, "nprobe": 4}),
        json.dumps({"queries": "a bare string"}),
        json.dumps({"add": {"texts": []}}),
        json.dumps({"remove": {"doc_ids": []}}),
        json.dumps({"k": 3}),
        "not json",
    ]


@pytest.mark.parametrize("store,kernel", [("float32", "xla_exact"),
                                          ("binary", "xla")])
def test_jsonl_stream_matches_jax(env, capsys, store, kernel):
    """The JAX server and the port's, each warm-booted from a copy of the
    store the port persisted, answer the same stream line for line."""
    cold = _cold_store(env, capsys, store, kernel)
    copies = {}
    for side in ("jax", "port"):
        copies[side] = f"{env.base}/{store}_{side}"
        shutil.rmtree(copies[side], ignore_errors=True)
        shutil.copytree(cold, copies[side])
    extra = [f"retrieval.store_dtype={store}", f"retrieval.kernel={kernel}"]
    payload = _stream(env)
    want = _run(jax_serve.main,
                ["--ae_type", "vae", "--set",
                 *_overrides(env.base, copies["jax"]), *extra],
                payload, capsys)
    got = _port(env, copies["port"], payload, capsys, extra=extra)
    assert len(got) == len(want) == len(payload)
    for line, g, w in zip(payload, got, want):
        if "error" in w:
            assert "error" in g, (line, g)
            if "nprobe" in line:  # the JAX server's own text
                assert g["error"] == w["error"], (line, g, w)
            continue
        assert "error" not in g, (line, g)
        if "results" in w:
            assert [r["query"] for r in g["results"]] == [
                r["query"] for r in w["results"]]
            for rg, rw in zip(g["results"], w["results"]):
                assert [h["doc_id"] for h in rg["hits"]] == [
                    h["doc_id"] for h in rw["hits"]], line
                assert [h["text"] for h in rg["hits"]] == [
                    h["text"] for h in rw["hits"]]
                if store != "binary":
                    np.testing.assert_allclose(
                        [h["score"] for h in rg["hits"]],
                        [h["score"] for h in rw["hits"]], atol=1e-5)
        elif "stats" in w:
            for key in ("n_docs", "boot", "ae_type", "dim", "rerank",
                        "micro_batch_window_ms"):
                assert g[key] == w[key], key
            assert g["boot"] == "warm"
            assert g["stats"]["search_calls"] == w["stats"]["search_calls"]
        else:
            for key in ("added", "removed", "n_total"):
                assert g.get(key) == w.get(key), (line, key)
    # the filter's empty slot, the add and the remove took effect
    assert len(got[2]["results"][0]["hits"]) == 3
    assert got[5]["results"][0]["hits"][0]["doc_id"] == 900
    assert all(h["doc_id"] != 900 for h in got[8]["results"][0]["hits"])
    assert got[7]["removed"] == 1 and got[4]["added"] == 2


def _with_ivf_sidecar(path, nlist=4, cap=8, estimate=0.912345):
    """Give a persisted store IVF sidecars and their meta.json entries, as
    a save of an IVF store writes them (the rows' lists all 0)."""
    from latentrag_torch.retrieval.dense import _stored_digest

    with open(f"{path}/meta.json") as f:
        meta = json.load(f)
    cent = np.zeros((nlist, 8), np.float32)
    assign = np.zeros(meta["n"], np.int32)
    np.save(f"{path}/ivf_centroids.npy", cent)
    np.save(f"{path}/ivf_assign.npy", assign)
    meta["stored_digests"]["ivf_centroids.npy"] = _stored_digest(cent)
    meta["stored_digests"]["ivf_assign.npy"] = _stored_digest(assign)
    meta.update(ivf_cap=cap, ivf_nlist=nlist, ivf_recall_estimate=estimate)
    with open(f"{path}/meta.json", "w") as f:
        json.dump(meta, f)


def test_nprobe_requests_and_ivf_stats_match_jax(env, capsys):
    """A request's "nprobe" is validated with the JAX server's texts, with
    and without ``retrieval.ivf_nlist``, and ``stats`` carries the store's
    ``ivf_recall_estimate`` as the JAX server rounds it."""
    cold = _cold_store(env, capsys, "float32", "xla_exact")
    q0 = env.queries[0]
    payload = [
        json.dumps({"query": q0, "k": 3, "nprobe": 4}),
        json.dumps({"query": q0, "nprobe": 0}),
        json.dumps({"query": q0, "nprobe": -3}),
        json.dumps({"query": q0, "nprobe": 2.5}),
        json.dumps({"query": q0, "nprobe": True}),
        json.dumps({"query": q0, "nprobe": "8"}),
        json.dumps({"stats": True}),
    ]
    for ivf in (True, False):
        extra = ["retrieval.store_dtype=float32", "retrieval.kernel=xla"]
        if ivf:
            extra += ["retrieval.ivf_nlist=4", "retrieval.ivf_cap=8"]
        out = {}
        for side in ("jax", "port"):
            path = f"{env.base}/ivf_{side}"
            shutil.rmtree(path, ignore_errors=True)
            shutil.copytree(cold, path)
            _with_ivf_sidecar(path)
            if side == "jax":
                out[side] = _run(jax_serve.main,
                                 ["--ae_type", "vae", "--set",
                                  *_overrides(env.base, path), *extra],
                                 payload, capsys)
            else:
                out[side] = _port(env, path, payload, capsys, extra=extra)
        got, want = out["port"], out["jax"]
        assert len(got) == len(want) == len(payload)
        for line, g, w in zip(payload[1:6], got[1:6], want[1:6]):
            assert g == w and "error" in g, (line, g, w)
        assert ("error" in got[0]) == ("error" in want[0]) == (not ivf)
        if ivf:
            assert [h["doc_id"] for h in got[0]["results"][0]["hits"]] == [
                h["doc_id"] for h in want[0]["results"][0]["hits"]]
            assert got[6]["ivf_recall_estimate"] == want[6][
                "ivf_recall_estimate"] == 0.9123
        else:
            assert got[0] == want[0]
            assert "ivf_recall_estimate" not in got[6]
            assert "ivf_recall_estimate" not in want[6]


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_micro_batching_end_to_end(env, capsys):
    """Concurrent HTTP searches coalesce into fewer ``retriever.search``
    calls of the encoder's batch buckets, while each response carries its
    own query's hits."""
    index = _cold_store(env, capsys, "float32", "xla_exact")
    cfg = apply_overrides(load_config(None), _overrides(env.base, index))
    loggers = init_logger(cfg.logging, stream=sys.stderr)
    args = SimpleNamespace(
        ae_type="vae", generate=False, cold_boot=False, device="cpu",
        batch_window_ms=40.0, max_batch=64, http=0,
    )
    runner, compressor, retriever, mode = serve.boot(cfg, args, loggers)
    assert mode == "warm"
    search_calls = []
    orig_search = retriever.search

    def spy(q_emb, k, **kw):
        search_calls.append(int(q_emb.shape[0]))
        return orig_search(q_emb, k, **kw)

    retriever.search = spy
    handle = serve.make_handle(cfg, args, runner, compressor, retriever,
                               mode)
    out = [None] * 6

    def post(i):
        out[i] = _post(port, "/search", {"query": f"experiment {i}", "k": 2})

    with serve.running_http(handle, retriever, mode, "127.0.0.1", 0,
                            loggers) as server:
        port = server.server_address[1]
        post(0)  # the first search, alone
        search_calls.clear()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        coalesced = list(search_calls)
        direct = serve.make_handle(cfg, SimpleNamespace(), runner,
                                   compressor, retriever, mode)
        for i, o in enumerate(out):
            assert o["results"][0]["query"] == f"experiment {i}"
            assert len(o["results"][0]["hits"]) == 2
            # the hits a lone search gives the same query
            alone = direct({"query": f"experiment {i}", "k": 2})
            assert [h["doc_id"] for h in o["results"][0]["hits"]] == [
                h["doc_id"] for h in alone["results"][0]["hits"]]
        assert len(coalesced) < 6  # coalescing happened
        assert all(c in (8, 16, 32, 64) for c in coalesced), coalesced
        status, health = _get(port, "/healthz")
        assert status == 200 and health == {
            "ok": True, "n_docs": len(env.corpus), "boot": "warm"}
        status, stats = _get(port, "/stats?reset=1")
        assert status == 200 and stats["micro_batch_window_ms"] == 40.0
        assert stats["stats"]["search_calls"] > 0
        assert _get(port, "/stats")[1]["stats"]["search_calls"] == 0
        status, missing = _get(port, "/nowhere")
        assert status == 404 and "unknown path" in missing["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/search", {"query": "x", "nprobe": 8})
        assert e.value.code == 400
        assert json.loads(e.value.read())["error"] == (
            'ValueError: "nprobe" requires the dense backend with '
            "retrieval.ivf_nlist > 0 (the device IVF tier)")
    # leaving the block stops the server and closes the handle's batcher
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=5)
    with pytest.raises(RuntimeError, match="MicroBatcher is closed"):
        handle({"query": "x", "k": 2})


def test_warm_boot_skips_the_corpus_encode(env, capsys, monkeypatch):
    index = _cold_store(env, capsys, "float32", "xla_exact")
    encoded = []
    orig = EmbeddingCompressor.encode_text

    def spy(self, texts):
        texts = list(texts)
        encoded.append(len(texts))
        return orig(self, texts)

    monkeypatch.setattr(EmbeddingCompressor, "encode_text", spy)
    lines = _port(env, index, [json.dumps({"query": "galaxies", "k": 3}),
                               json.dumps({"stats": True})], capsys)
    # the warm-up probe and the query: the corpus never re-encodes
    assert encoded == [1, 1]
    assert lines[1]["boot"] == "warm"
    assert all(h["text"] for h in lines[0]["results"][0]["hits"])
    encoded.clear()
    lines = _port(env, index, [json.dumps({"stats": True})], capsys,
                  flags=["--cold-boot"])
    assert lines[0]["boot"] == "cold" and len(env.corpus) in encoded


class _Lines(logging.Handler):
    """The messages of one logger (the server resets the root's
    handlers, so pytest's caplog does not see them)."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logging.getLogger(name)

    def emit(self, rec):
        self.lines.append(rec.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def test_store_of_another_dim_boots_cold(env, capsys):
    """A store whose width differs from the encoder's output (8 against a
    4-d VAE of the same provenance) is not served: the boot goes cold."""
    index = f"{env.base}/dim_store"
    shutil.rmtree(index, ignore_errors=True)
    shutil.copytree(_cold_store(env, capsys, "float32", "xla_exact"),
                    index)
    with _Lines("latentrag_torch.main") as log:
        lines = _run(serve.main,
                     ["--ae_type", "vae", "--device", "cpu", "--set",
                      *_overrides(env.base, index, latent=4,
                                  vae="vae4.pth"),
                      "retrieval.kernel=xla_exact"],
                     [json.dumps({"query": "galaxies", "k": 2}),
                      json.dumps({"stats": True})], capsys)
    assert "persisted index dim 8 != encoder output 4; cold boot" in (
        log.lines)
    assert lines[1]["boot"] == "cold" and lines[1]["dim"] == 4
    assert len(lines[0]["results"][0]["hits"]) == 2


def test_shard_corpus_serves_unsharded_on_one_device(env, capsys):
    index = _cold_store(env, capsys, "float32", "xla_exact")
    payload = [json.dumps({"queries": env.queries[:4], "k": 5})]
    plain = _port(env, index, payload, capsys,
                  extra=["retrieval.kernel=xla_exact"])
    sharded = _port(env, index, payload, capsys,
                    extra=["retrieval.kernel=xla_exact",
                           "retrieval.shard_corpus=true"])
    assert sharded[0]["results"] == plain[0]["results"]


def test_shard_corpus_refuses_more_than_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = apply_overrides(Config(), ["retrieval.shard_corpus=true"])
    with pytest.raises(NotImplementedError, match="item 23"):
        factory._make_dense(cfg.retrieval, "cuda")
    # on the CPU the flag is served unsharded, whatever cards there are
    r = factory._make_dense(cfg.retrieval, "cpu")
    assert isinstance(r, DenseRetriever) and not r.is_built


@pytest.mark.parametrize("store", ["bfloat16", "float32", "binary"])
def test_dim_matches_jax(rng, tmp_path, store):
    emb = rng.standard_normal((300, 64)).astype(np.float32)
    texts = [f"t{i}" for i in range(300)]
    backend = "xla" if store == "binary" else "xla_exact"
    j = JaxDense(backend=backend, store_dtype=store)
    t = DenseRetriever(store_dtype=store, device="cpu",
                       index_path=str(tmp_path / "idx"))
    assert t.dim == 0
    j.build(emb.copy(), texts)
    t.build(emb.copy(), texts)
    assert t.dim == j.dim == 64
    j2 = JaxDense(backend=backend, store_dtype=store,
                  index_path=str(tmp_path / "idx"))
    t2 = DenseRetriever(store_dtype=store, device="cpu",
                        index_path=str(tmp_path / "idx"))
    assert t2.is_built and t2.dim == j2.dim == 64
