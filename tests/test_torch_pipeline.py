"""The port's retriever and pipeline against the JAX package's, end to end
on the CPU, plus the port's import and device rules."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.pipeline import PipelineRunner as JaxRunner
from latentrag_tpu.retrieval.ann import HNSWIndex as JaxHNSW
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_torch import main as torch_main
from latentrag_torch import serve as torch_serve
from latentrag_torch.models import VariationalAutoencoder
from latentrag_torch.models.convert import minilm_state_dict_from_jax
from latentrag_torch.pipeline import PipelineRunner
from latentrag_torch.retrieval import (
    DenseRetriever,
    HNSWIndex,
    build_retriever,
    load_retriever,
)
from latentrag_torch.utils import Config, apply_overrides, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "latentrag_torch")


def _overrides(base):
    return [
        f"paths.data_dir={base}/data",
        f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs",
        f"retrieval.index_path={base}/index",
        f"logging.log_file={base}/logs/run.log",
        "data.dataset=synthetic", "data.max_samples=60",
        "encoder.vocab_size=800", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16",
        f"models.vae.checkpoint={base}/vae.pth",
        "retrieval.store_dtype=float32",
    ]


def test_pipeline_end_to_end_matches_jax(tmp_path):
    """Same synthetic data, same VAE .pth, same encoder weights carried
    across, fp32 store: the JAX pipeline (xla_exact) and the port on the
    CPU retrieve the same docs and score the same metrics."""
    base = str(tmp_path)
    ov = _overrides(base)
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))

    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg_j = jax_overrides(JaxConfig(), ov + ["retrieval.kernel=xla_exact"])
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    params = JaxEncoder(tok, cfg_j.encoder, seed=11).params
    save_params(params, f"{base}/ckpt/encoder.msgpack")
    torch.save(minilm_state_dict_from_jax(params), f"{base}/ckpt/encoder.pt")

    want = JaxRunner(cfg_j, ae_type="vae").process(queries, corpus, relevant)

    results = []
    rc = torch_main.main(
        ["--ae_type", "vae", "--device", "cpu", "--set", *ov,
         f"encoder.weights_path={base}/ckpt/encoder.pt"],
        results=results,
    )
    assert rc == 0 and len(results) == 1
    got = results[0]
    assert got["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    for name, stats in want["retrieval_metrics"].items():
        assert got["retrieval_metrics"][name]["mean"] == pytest.approx(
            stats["mean"], abs=1e-6)
        assert got["retrieval_metrics"][name]["std"] == pytest.approx(
            stats["std"], abs=1e-6)
    np.testing.assert_allclose(got["doc_scores"], want["doc_scores"],
                               atol=1e-5)
    assert (got["dim_in"], got["dim_out"]) == (32, 8)
    assert os.path.exists(f"{base}/logs/benchmarks/experiments.csv")


@pytest.mark.parametrize("backend", ["hnsw", "ivfpq"])
def test_ann_pipeline_matches_jax_and_warm_boots(tmp_path, capsys, backend,
                                                 monkeypatch):
    """``retrieval.backend=hnsw|ivfpq`` through ``main`` on the CPU (the
    beam and host builds): the JAX pipeline's doc ids; a second run on the
    same store loads it instead of building. Both packages' beam builds
    run on one thread: on several, either package links rows in a racy
    order (``tests/test_torch_ann.py``), so two builds of the same rows
    can strand different rows."""
    for cls in (JaxHNSW, HNSWIndex):
        monkeypatch.setattr(
            cls, "add", lambda self, v, nthreads=0, _add=cls.add:
            _add(self, v, nthreads=1))
    base = str(tmp_path)
    ov = _overrides(base) + [f"retrieval.backend={backend}"]
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg_j = jax_overrides(JaxConfig(), ov + [
        f"retrieval.index_path={base}/jax_index"])
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    save_params(JaxEncoder(tok, cfg_j.encoder, seed=11).params,
                f"{base}/ckpt/encoder.msgpack")
    want = JaxRunner(cfg_j, ae_type="vae").process(queries, corpus, relevant)
    runs = []
    for _ in range(2):
        results = []
        capsys.readouterr()
        assert torch_main.main(["--ae_type", "vae", "--device", "cpu",
                                "--set", *ov], results=results) == 0
        logged = capsys.readouterr()  # main logs to stdout
        runs.append((results[0], logged.out + logged.err))
    (cold, cold_log), (warm, warm_log) = runs
    assert cold["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    assert f"{backend} index loaded from" not in cold_log
    assert f"{backend} index loaded from" in warm_log
    assert warm["retrieved_doc_ids"] == cold["retrieved_doc_ids"]
    assert os.path.exists(f"{base}/index.{backend}.meta.json")


# the second stage and chunking: a chunk window that cuts each synthetic
# document (~35 tokens) into several chunks
CHUNKING = ["chunking.max_tokens=16", "chunking.stride=8",
            "chunking.min_tokens=6"]
SLICE_R_CASES = {
    "rerank": ["retrieval.rerank=cross"],
    "sliding": ["chunking.enabled=true", "chunking.mode=sliding"],
    "semantic": ["chunking.enabled=true", "chunking.mode=semantic"],
    "semantic_rerank": ["chunking.enabled=true", "chunking.mode=semantic",
                        "retrieval.rerank=cross"],
}


def _slice_r_env(base, ov):
    """The encoder (JAX params carried across as a .pt), a VAE .pth and a
    JAX-saved fp32 reranker with its sidecar, in ``base``."""
    from latentrag_tpu.models.encoder.cross import CrossEncoderScorer
    from latentrag_tpu.retrieval.reranker import (
        reranker_checkpoint_path,
        save_reranker_meta,
    )

    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg_j = jax_overrides(JaxConfig(), ov)
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    params = JaxEncoder(tok, cfg_j.encoder, seed=11).params
    save_params(params, f"{base}/ckpt/encoder.msgpack")
    torch.save(minilm_state_dict_from_jax(params), f"{base}/ckpt/encoder.pt")
    save_params(CrossEncoderScorer(tok, cfg_j.encoder, seed=12).params,
                reranker_checkpoint_path(cfg_j))
    save_reranker_meta(cfg_j, tok, max_length=48, query_max=16)
    return queries, corpus, relevant


@pytest.mark.parametrize("case", list(SLICE_R_CASES))
def test_rerank_and_chunking_match_jax(tmp_path, case):
    """``retrieval.rerank=cross`` and ``chunking.enabled`` (sliding,
    semantic, semantic with the reranker) through ``main`` on the CPU
    against the JAX pipeline on the same weights (fp32 encoder, store and
    cross-encoder): the same chunks, candidate_k, docs and metrics."""
    base = str(tmp_path)
    ov = _overrides(base) + CHUNKING + SLICE_R_CASES[case]
    queries, corpus, relevant = _slice_r_env(base, ov)
    cfg_j = jax_overrides(JaxConfig(), ov + [
        "retrieval.kernel=xla_exact", f"retrieval.index_path={base}/jax"])
    want = JaxRunner(cfg_j, ae_type="vae").process(queries, corpus, relevant)
    results = []
    assert torch_main.main(
        ["--ae_type", "vae", "--device", "cpu", "--set", *ov,
         f"encoder.weights_path={base}/ckpt/encoder.pt"],
        results=results) == 0
    got = results[0]
    chunked = "chunking.enabled=true" in ov
    reranked = "retrieval.rerank=cross" in ov
    assert got["n_chunks"] == want["n_chunks"]
    assert (got["n_chunks"] > 2 * len(corpus)) == chunked
    assert got["candidate_k"] == want["candidate_k"] == (40 if reranked
                                                         else 30)
    assert ("chunking_s" in got["timings"]) == chunked
    assert ("rerank_s" in got["timings"]) == reranked
    assert got["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    for row in got["retrieved_doc_ids"]:  # docs, each once
        assert len(row) == len(set(row)) == 10
        assert all(0 <= d < len(corpus) for d in row)
    for name, stats in want["retrieval_metrics"].items():
        for key in ("mean", "std"):
            assert got["retrieval_metrics"][name][key] == pytest.approx(
                stats[key], abs=1e-6)
    np.testing.assert_allclose(got["doc_scores"], want["doc_scores"],
                               rtol=1e-5, atol=1e-5)


def test_chunked_and_unchunked_stores_never_share(tmp_path, capsys):
    """A store persisted by an unchunked run is rebuilt by a chunked run
    at the same ``index_path``, and the reverse (the provenance records
    the chunking), while a repeat of either run warm-boots."""
    import json

    base = str(tmp_path)
    ov = _overrides(base) + CHUNKING
    _slice_r_env(base, ov)
    sliding = SLICE_R_CASES["sliding"]
    runs = []
    for extra in ([], sliding, sliding, []):
        capsys.readouterr()
        results = []
        assert torch_main.main(
            ["--ae_type", "vae", "--device", "cpu", "--set", *ov, *extra,
             f"encoder.weights_path={base}/ckpt/encoder.pt"],
            results=results) == 0
        logged = capsys.readouterr()  # main logs to stdout
        with open(f"{base}/index/meta.json") as f:
            chunking = json.load(f)["fingerprint"]["chunking"]
        runs.append((results[0],
                     "skipping rebuild" in logged.out + logged.err,
                     chunking))
    (plain, skip0, fp0), (chunked, skip1, fp1), (again, skip2, fp2), \
        (plain2, skip3, fp3) = runs
    assert (skip0, skip1, skip2, skip3) == (False, False, True, False)
    assert fp0 == fp3 and fp0["enabled"] is False
    assert fp1 == fp2 == {"enabled": True, "mode": "sliding",
                          "max_tokens": 16, "stride": 8, "min_tokens": 6}
    assert chunked["n_chunks"] == again["n_chunks"] > plain["n_chunks"]
    assert again["retrieved_doc_ids"] == chunked["retrieved_doc_ids"]
    assert plain2["retrieved_doc_ids"] == plain["retrieved_doc_ids"]


def test_injected_reranker_reorders_candidates(tmp_path):
    """An injected reranker wins over the config's checkpoint (none
    exists here): candidate_k widens to ``rerank_candidates`` and each
    query's docs follow the injected scores (longer text first)."""
    from latentrag_torch.retrieval.reranker import CrossEncoderReranker

    class LongestWins:
        def score_pairs(self, queries, docs):
            return np.asarray([float(len(d)) for d in docs], np.float32)

    base = str(tmp_path)
    ov = _overrides(base) + ["retrieval.rerank=cross",
                             "retrieval.rerank_candidates=25",
                             "retrieval.top_k=3", "models.vae.checkpoint="]
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    runner = PipelineRunner(apply_overrides(Config(), ov), device="cpu",
                            reranker=CrossEncoderReranker(LongestWins()))
    out = runner.process(queries, corpus, relevant)
    assert out["candidate_k"] == 25 and "rerank_s" in out["timings"]
    for row in out["retrieved_doc_ids"]:
        lens = [len(corpus[d]) for d in row]
        assert lens == sorted(lens, reverse=True) and len(row) == 3
    with pytest.raises(FileNotFoundError, match="reranker"):
        PipelineRunner(apply_overrides(Config(), ov), device="cpu").process(
            queries, corpus, relevant)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "mahalanobis"])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_dense_retriever_matches_jax(rng, metric, store):
    emb = rng.standard_normal((400, 12)).astype(np.float32)
    emb[:, 1] *= 4.0
    q = rng.standard_normal((9, 12)).astype(np.float32)
    texts = [f"t{i}" for i in range(400)]
    j = JaxDense(metric=metric, backend="xla_exact", store_dtype=store)
    j.build(emb, texts)
    t = DenseRetriever(metric=metric, store_dtype=store, device="cpu")
    t.build(emb, texts)
    s_j, i_j = j.search(q, 6)
    s_t, i_t = t.search(q, 6)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-4)
    assert t.get_stats()["search_calls"] == 1
    texts_out, scores_out, ids_out = t.retrieve(q[0], top_k=3)
    assert texts_out == [texts[i] for i in i_t[0, :3]] and len(ids_out) == 3


@pytest.mark.parametrize("backend", ["xla", "xla_exact", "pallas",
                                     "pallas_exact"])
def test_every_backend_runs_on_cpu(rng, backend):
    emb = rng.standard_normal((300, 8)).astype(np.float32)
    r = DenseRetriever(backend=backend, store_dtype="float32", device="cpu")
    r.build(emb, [str(i) for i in range(300)])
    s, i = r.search(emb[:4], 5)
    assert s.shape == (4, 5) and (i[:, 0] == np.arange(4)).all()


def test_unported_options_raise(rng):
    with pytest.raises(ValueError):
        DenseRetriever(backend="faiss", device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        PipelineRunner(apply_overrides(Config(), ["retrieval.rerank=bogus"]),
                       device="cpu")._ensure_reranker()


def test_bm25_backend_matches_jax(rng, tmp_path):
    """``retrieval.backend=bm25`` in the factory is a dense store on kernel
    ``auto``, as the JAX factory maps it (BM25 itself runs only in the
    benchmark harness): the same searches as the JAX package's, built and
    warm-booted from its index_path."""
    from latentrag_tpu.retrieval import build_retriever as jax_build
    from latentrag_tpu.retrieval import load_retriever as jax_load

    emb = rng.standard_normal((300, 12)).astype(np.float32)
    q = rng.standard_normal((7, 12)).astype(np.float32)
    texts = [f"t{i}" for i in range(300)]
    ov = ["retrieval.backend=bm25", "retrieval.store_dtype=float32",
          "retrieval.kernel=pallas", f"retrieval.index_path={tmp_path}/i"]
    want = jax_build(emb, texts, None, jax_overrides(
        JaxConfig(), ov[:-1] + ["retrieval.index_path="]).retrieval)
    got = build_retriever(emb, texts, None,
                          apply_overrides(Config(), ov).retrieval,
                          device="cpu")
    assert isinstance(got, DenseRetriever) and got.backend == "auto"
    assert want.backend == "auto"
    (s_t, i_t), (s_j, i_j) = got.search(q, 6), want.search(q, 6)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=1e-5, atol=1e-5)
    warm = load_retriever(apply_overrides(Config(), ov).retrieval,
                          device="cpu")
    np.testing.assert_array_equal(warm.search(q, 6)[1], i_t)
    jwarm = jax_load(jax_overrides(JaxConfig(), ov).retrieval)
    np.testing.assert_array_equal(np.asarray(jwarm.search(q, 6)[1]), i_t)


GENERATION = ["generation.provider=extractive",
              "evaluation.generation_metrics=[ROUGE-L,METEOR,BLEU]",
              "evaluation.min_pairs_for_bootstrap=20",
              "evaluation.bootstrap_samples=300"]


class EchoGenerator:
    """A duck-typed generator with ``generate`` only: the top context."""

    def generate(self, query, docs):
        return docs[0] if docs else ""


@pytest.mark.parametrize("case", ["extractive", "echo", "chunked"])
def test_generation_matches_jax(tmp_path, case):
    """``PipelineRunner(generate=True)``: the same answers (the extractive
    provider through ``generate_batch_async``; a duck-typed generator one
    query at a time; chunked documents, several chunks a doc) and the same
    bootstrap generation metrics as the JAX runner."""
    base = str(tmp_path)
    ov = _overrides(base) + GENERATION
    if case == "chunked":
        ov += CHUNKING + ["chunking.enabled=true",
                          "retrieval.max_chunks_per_doc=2"]
    queries, corpus, relevant, gold = load_evaluation_data(
        synthetic_examples(60), with_answers=True)
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg_j = jax_overrides(JaxConfig(), ov + [
        f"retrieval.index_path={base}/jax", "retrieval.kernel=xla_exact"])
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    save_params(JaxEncoder(tok, cfg_j.encoder, seed=11).params,
                f"{base}/ckpt/encoder.msgpack")
    gen = EchoGenerator() if case == "echo" else None
    want = JaxRunner(cfg_j, ae_type="vae", generate=True,
                     generator=gen).process(queries, corpus, relevant,
                                            gold_answers=gold)
    got = PipelineRunner(apply_overrides(Config(), ov), ae_type="vae",
                         generate=True, generator=gen, device="cpu").process(
        queries, corpus, relevant, gold_answers=gold)
    assert got["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    assert len(got["answers"]) == len(queries)
    assert got["answers"] == want["answers"]
    assert got["generation_metrics"] == want["generation_metrics"]
    assert set(got["generation_metrics"]) == {"ROUGE-L", "METEOR", "BLEU"}
    assert {"generate_s", "generation_eval_s"} <= set(got["timings"])
    # without gold answers, or below the bootstrap floor: answers only
    few = PipelineRunner(apply_overrides(Config(), ov), ae_type="vae",
                         generate=True, generator=gen, device="cpu")
    out = few.process(queries[:10], corpus, relevant[:10],
                      gold_answers=gold[:10])
    assert out["answers"] == got["answers"][:10]
    assert "generation_metrics" not in out
    assert "generation_metrics" not in few.process(queries, corpus, relevant)


def test_main_generate_and_profile_on_cpu(tmp_path):
    """``main --generate`` writes the generation columns to the CSV row;
    ``--profile DIR`` writes a trace file there."""
    import csv

    base = str(tmp_path)
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    ov = _overrides(base) + GENERATION
    results = []
    assert torch_main.main(["--ae_type", "vae", "--device", "cpu",
                            "--generate", "--set", *ov],
                           results=results) == 0
    assert len(results[0]["answers"]) == 60
    assert set(results[0]["generation_metrics"]) == {"ROUGE-L", "METEOR",
                                                     "BLEU"}
    with open(f"{base}/logs/benchmarks/experiments.csv") as f:
        row = list(csv.DictReader(f))[-1]
    assert float(row["meteor"]) == pytest.approx(
        results[0]["generation_metrics"]["METEOR"]["mean"], abs=1e-3)
    assert torch_main.main(["--ae_type", "vae", "--device", "cpu",
                            "--profile", f"{base}/trace", "--set", *ov],
                           results=results) == 0
    traces = [f for f in os.listdir(f"{base}/trace")
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(f"{base}/trace/{traces[0]}") as f:
        assert "traceEvents" in f.read(200_000)
    assert "answers" not in results[1]


def test_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    """Without CUDA the defaults raise; nothing moves to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseRetriever()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PipelineRunner(Config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main.main(["--set", "data.dataset=synthetic",
                         "data.max_samples=10",
                         f"paths.data_dir={tmp_path}/d",
                         "logging.log_to_file=false"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_serve.main(["--set", "data.dataset=synthetic",
                          "data.max_samples=10",
                          f"paths.data_dir={tmp_path}/d",
                          f"retrieval.index_path={tmp_path}/i",
                          "logging.log_to_file=false"])
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_without_jax():
    """Every module imports with jax, flax, optax and orbax blocked, and
    none of them pulls in the JAX package."""
    code = f"""
import pkgutil, sys, importlib
for name in ("jax", "flax", "optax", "orbax", "latentrag_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
import latentrag_torch
mods = [m.name for m in pkgutil.walk_packages(latentrag_torch.__path__,
                                              "latentrag_torch.")]
for m in mods:
    importlib.import_module(m)
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_no_port_file_names_the_jax_package():
    hits = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    if "latentrag_tpu" in fh.read():
                        hits.append(path)
    assert hits == []


def test_config_trees_have_the_same_fields():
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())
