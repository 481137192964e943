"""The port's benchmark harness (``evaluation/benchmark.py``) against the
JAX package's: systems bm25, sbert, vae, dpr and rerank with extractive
generation, over the same data and weights (the encoder, the VAE, the
reranker and the DPR towers carried across), in fp32 stores on the
exact oracle."""

import os

import jax
import numpy as np
import pytest
import torch

from latentrag_torch import main as torch_main
from latentrag_torch.evaluation import run_benchmark
from latentrag_torch.models import autoencoder_state_dict_from_jax
from latentrag_torch.utils import Config, apply_overrides
from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.evaluation import run_benchmark as jax_run_benchmark
from latentrag_tpu.models import build_autoencoder, init_autoencoder
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.models.encoder.cross import CrossEncoderScorer
from latentrag_tpu.retrieval.reranker import (
    reranker_checkpoint_path,
    save_reranker_meta,
)
from latentrag_tpu.training import save_checkpoint
from latentrag_tpu.training.train_dpr import build_dpr_encoders
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides

SYSTEMS = ("bm25", "sbert", "vae", "dpr", "rerank")


def _overrides(base):
    return [
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", f"logging.log_file={base}/logs/r.log",
        "data.dataset=synthetic", "data.max_samples=40",
        "encoder.vocab_size=800", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", "retrieval.index_path=",
        "retrieval.store_dtype=float32", "retrieval.kernel=xla_exact",
        "generation.provider=extractive",
        "evaluation.generation_metrics=[ROUGE-L,METEOR,BLEU]",
        "evaluation.min_pairs_for_bootstrap=20",
        "evaluation.bootstrap_samples=500",
    ]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Both packages' configs and the weights they share: the encoder
    (encoder.msgpack), the VAE (the JAX package's Orbax checkpoint and its
    params as a reference-keyed .pth), the cross-encoder (reranker.msgpack
    with its sidecar) and the DPR towers (dpr_*.msgpack)."""
    base = str(tmp_path_factory.mktemp("bench"))
    ov = _overrides(base)
    queries, corpus, relevant, gold = load_evaluation_data(
        synthetic_examples(40), with_answers=True)
    cfg_j = jax_overrides(JaxConfig(), ov)
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    save_params(JaxEncoder(tok, cfg_j.encoder, seed=11).params,
                f"{base}/ckpt/encoder.msgpack")
    vae = build_autoencoder("vae", cfg_j.models.vae)
    params = jax.tree.map(np.asarray,
                          init_autoencoder(vae, jax.random.PRNGKey(4), 32))
    save_checkpoint(os.path.join(cfg_j.paths.checkpoints_dir, "vae"), {
        "params": params, "opt_state": None, "epoch": 0, "best_val": 0.0})
    torch.save(autoencoder_state_dict_from_jax(params, "vae"),
               f"{base}/vae.pth")
    save_params(CrossEncoderScorer(tok, cfg_j.encoder, seed=12).params,
                reranker_checkpoint_path(cfg_j))
    save_reranker_meta(cfg_j, tok, max_length=48, query_max=16)
    for enc, name in zip(build_dpr_encoders(cfg_j, corpus),
                         ("dpr_question", "dpr_context")):
        save_params(enc.params, f"{base}/ckpt/{name}.msgpack")
    cfg_t = apply_overrides(Config(), ov + [
        f"models.vae.checkpoint={base}/vae.pth"])
    return cfg_j, cfg_t, (queries, corpus, relevant, gold), base


def test_benchmark_matches_jax(env):
    cfg_j, cfg_t, (queries, corpus, relevant, gold), base = env
    want = jax_run_benchmark(cfg_j, queries, corpus, relevant,
                             systems=SYSTEMS, generate=True,
                             gold_answers=gold)
    got = run_benchmark(cfg_t, queries, corpus, relevant, systems=SYSTEMS,
                        generate=True, gold_answers=gold, device="cpu",
                        csv_path=f"{base}/bench.csv")
    assert set(got) == set(want)
    errors = {s for s in SYSTEMS if "error" in got[s]}
    assert errors == {s for s in SYSTEMS if "error" in want[s]} == set()
    for system in SYSTEMS:
        for name, stats in want[system]["metrics"].items():
            for key in ("mean", "std"):
                assert got[system]["metrics"][name][key] == pytest.approx(
                    stats[key], abs=1e-6), (system, name, key)
        assert ("generation_metrics" in got[system]) == (
            "generation_metrics" in want[system])
        for name, stats in want[system].get("generation_metrics",
                                            {}).items():
            for key in ("mean", "ci_low", "ci_high"):
                assert got[system]["generation_metrics"][name][key] == \
                    pytest.approx(stats[key], abs=1e-6), (system, name, key)
    # the dense systems and rerank answered; bm25 and dpr do not generate
    assert {s for s in SYSTEMS if "generation_metrics" in got[s]} == {
        "sbert", "vae", "rerank"}
    for metric, pairs in want["_deltas"].items():
        assert set(got["_deltas"][metric]) == set(pairs)
        for pair, entry in pairs.items():
            g = got["_deltas"][metric][pair]
            assert g["delta"] == pytest.approx(entry["delta"], abs=1e-6)
            assert (g["p_value"], g["significant_05"]) == (
                entry["p_value"], entry["significant_05"]), (metric, pair)
    assert len(got["_deltas"]["Recall@10"]) == 10  # every pair of 5
    assert got["_generation_deltas"] == want["_generation_deltas"]
    assert set(got["_generation_deltas"]["ROUGE-L"]) == {
        "sbert-vae", "sbert-rerank", "vae-rerank"}
    with open(f"{base}/bench.csv") as f:
        assert sum(1 for _ in f) == 1 + len(SYSTEMS)


def test_benchmark_errors_match_jax(env):
    """An unknown system, and a rerank without its checkpoint, are
    reported per system, as the JAX harness reports them, and the other
    systems still run."""
    cfg_j, cfg_t, (queries, corpus, relevant, _), base = env
    import dataclasses

    paths = dict(checkpoints_dir=f"{base}/nowhere")
    cfg_j = dataclasses.replace(cfg_j, paths=dataclasses.replace(
        cfg_j.paths, **paths))
    cfg_t = dataclasses.replace(cfg_t, paths=dataclasses.replace(
        cfg_t.paths, **paths))
    systems = ("nope", "bm25", "rerank")
    want = jax_run_benchmark(cfg_j, queries[:12], corpus, relevant[:12],
                             systems=systems)
    got = run_benchmark(cfg_t, queries[:12], corpus, relevant[:12],
                        systems=systems, device="cpu")
    assert [s for s in systems if "error" in got[s]] == [
        s for s in systems if "error" in want[s]] == ["nope", "rerank"]
    assert got["nope"]["error"] == want["nope"]["error"]
    assert got["bm25"]["metrics"] == want["bm25"]["metrics"]


def test_main_benchmark_defaults_to_bm25_and_sbert(env, tmp_path):
    _, _, _, base = env
    ov = _overrides(base) + [f"paths.logs_dir={tmp_path}/logs",
                             f"logging.log_file={tmp_path}/logs/r.log"]
    results = []
    assert torch_main.main(["--device", "cpu", "--benchmark", "--set", *ov],
                           results=results) == 0
    assert set(results[0]) == {"bm25", "sbert", "_deltas"}
    assert all("metrics" in results[0][s] for s in ("bm25", "sbert"))
    assert results[0]["bm25"]["metrics"]["Recall@10"]["mean"] > 0.9
