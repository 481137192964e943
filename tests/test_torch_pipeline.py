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
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_torch import main as torch_main
from latentrag_torch import serve as torch_serve
from latentrag_torch.models import VariationalAutoencoder
from latentrag_torch.models.convert import minilm_state_dict_from_jax
from latentrag_torch.pipeline import PipelineRunner
from latentrag_torch.retrieval import DenseRetriever, build_retriever
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
    with pytest.raises(NotImplementedError, match="item 18"):
        build_retriever(np.zeros((2, 4), np.float32), ["a", "b"], None,
                        apply_overrides(Config(), ["retrieval.backend=ivfpq"])
                        .retrieval, device="cpu")
    with pytest.raises(ValueError):
        DenseRetriever(backend="faiss", device="cpu")
    cfg = apply_overrides(Config(), ["retrieval.backend=hnsw"])
    with pytest.raises(NotImplementedError):
        build_retriever(np.zeros((2, 4), np.float32), ["a", "b"], None,
                        cfg.retrieval, device="cpu")
    with pytest.raises(NotImplementedError):
        PipelineRunner(apply_overrides(Config(), ["chunking.enabled=true"]),
                       device="cpu")
    with pytest.raises(NotImplementedError):
        PipelineRunner(Config(), generate=True, device="cpu")


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
