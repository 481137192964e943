"""The port's operator tools against the JAX package's, on the CPU: the
doctor (the eight cases of ``tests/test_doctor.py``, over the port's
stores), the visualization's ranks and recall, ``viz_cli`` end to end,
the autoencoder metrics, ``load_dotenv``, the stopwatches, ``to_dict``
and the parquet chunk index, which each package reads from the other.

Tolerances: ranks, recall, sizes, env and records equal; the
reconstruction MSE within 1e-7 (the same fp32 weights through two
libraries' matmuls, the mean in fp64)."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.data.chunking import ChunkRecord as JaxChunkRecord
from latentrag_tpu.data.chunking import load_chunk_index as jax_load_chunks
from latentrag_tpu.data.chunking import save_chunk_index as jax_save_chunks
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.evaluation import autoencoder_metrics as jam
from latentrag_tpu.evaluation import visualization as jviz
from latentrag_tpu.models import build_autoencoder as jax_build
from latentrag_tpu.models.autoencoders import init_autoencoder as jax_init
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_tpu.utils import config as jconfig
from latentrag_tpu.utils.dotenv import load_dotenv as jax_load_dotenv
from latentrag_tpu.utils.config import AutoencoderConfig as JaxAECfg
from latentrag_torch import doctor, viz_cli
from latentrag_torch.data.chunking import (
    ChunkRecord,
    load_chunk_index,
    save_chunk_index,
)
from latentrag_torch.evaluation import autoencoder_metrics as tam
from latentrag_torch.evaluation import visualization as tviz
from latentrag_torch.models import autoencoder_state_dict_from_jax
from latentrag_torch.models import build_autoencoder
from latentrag_torch.retrieval.ann_retriever import ANNRetriever
from latentrag_torch.retrieval.dense import DenseRetriever
from latentrag_torch.retrieval.textstore import atomic_save, save_texts
from latentrag_torch.utils import (
    Config,
    Stopwatch,
    device_stopwatch,
    load_dotenv,
    stopwatch,
    to_dict,
)
from latentrag_torch.utils.config import AutoencoderConfig, RetrievalConfig


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _run(capsys, argv):
    rc = doctor.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1  # stdout purity: exactly one JSON line
    return rc, json.loads(out[0])["doctor"]


def _dense(path, **kw):
    return DenseRetriever(backend="xla_exact", store_dtype="float32",
                          index_path=path, device="cpu", **kw)


def _ann(path):
    return ANNRetriever(RetrievalConfig(index_path=path, backend="hnsw"),
                        "hnsw", device="cpu")


def test_doctor_healthy_store(rng, tmp_path, capsys):
    path = str(tmp_path / "idx")
    _dense(path, fingerprint={"embedding_model": "m", "ae": "none"}).build(
        _normed(rng, 12, 8), [f"doc {i}" for i in range(12)])
    rc, rep = _run(capsys, ["--index", path,
                            "--checkpoints", str(tmp_path / "ckpt")])
    assert rc == 0 and rep["ok"]
    assert rep["checks"]["store:dense"]["status"] == "pass"
    assert "n=12" in rep["checks"]["store:dense"]["detail"]


def test_doctor_flags_mixed_generation_store(rng, tmp_path, capsys):
    path = str(tmp_path / "idx")
    texts = [f"doc {i}" for i in range(12)]
    _dense(path).build(_normed(rng, 12, 8), texts)
    # shrink the text store under the index (crash between saves)
    save_texts(os.path.join(path, "texts"), texts[:5], list(range(5)))
    rc, rep = _run(capsys, ["--index", path,
                            "--checkpoints", str(tmp_path / "ckpt")])
    assert rc == 1 and not rep["ok"]
    assert rep["checks"]["store:dense"]["status"] == "fail"
    assert "mixed-generation" in rep["checks"]["store:dense"]["detail"]


def test_doctor_flags_stale_binary_sidecar(rng, tmp_path, capsys):
    path = str(tmp_path / "idx")
    _dense(path).build(_normed(rng, 10, 8), [f"doc {i}" for i in range(10)])
    with open(os.path.join(path, "binary_packed.npy"), "wb") as f:
        np.save(f, np.zeros((7, 1), dtype=np.uint32))
    rc, rep = _run(capsys, ["--index", path,
                            "--checkpoints", str(tmp_path / "ckpt")])
    assert rc == 1
    assert "stale sidecar" in rep["checks"]["store:dense"]["detail"]


def test_doctor_checks_ann_store(rng, tmp_path, capsys):
    apath = str(tmp_path / "ann")
    _ann(apath).build(_normed(rng, 15, 8), [f"doc {i}" for i in range(15)])
    rc, rep = _run(capsys, ["--index", apath,
                            "--checkpoints", str(tmp_path / "ckpt")])
    assert rc == 0
    assert rep["checks"]["store:hnsw"]["status"] == "pass"
    assert "15 texts" in rep["checks"]["store:hnsw"]["detail"]


def test_doctor_survives_corrupt_sidecar(rng, tmp_path, capsys):
    path = str(tmp_path / "idx")
    _dense(path).build(_normed(rng, 8, 8), [f"doc {i}" for i in range(8)])
    with open(os.path.join(path, "corpus.npy"), "wb") as f:
        f.write(b"\x93NUMPY garbage")
    rc, rep = _run(capsys, ["--index", path,
                            "--checkpoints", str(tmp_path / "ckpt")])
    assert rc == 1
    assert rep["checks"]["store:dense"]["status"] == "fail"


def test_doctor_flags_same_n_corpus_swap(rng, tmp_path, capsys):
    path = str(tmp_path / "idx")
    _dense(path).build(_normed(rng, 10, 8), [f"doc {i}" for i in range(10)])
    atomic_save(os.path.join(path, "corpus.npy"), _normed(rng, 10, 8))
    rc, rep = _run(capsys, ["--index", path,
                            "--checkpoints", str(tmp_path / "ckpt")])
    assert rc == 1
    assert "contradicts" in rep["checks"]["store:dense"]["detail"]


def test_doctor_flags_ann_missing_doc_ids(rng, tmp_path, capsys):
    apath = str(tmp_path / "ann")
    _ann(apath).build(_normed(rng, 10, 8), [f"doc {i}" for i in range(10)])
    os.remove(apath + ".hnsw.texts_doc_ids.npy")
    rc, rep = _run(capsys, ["--index", apath,
                            "--checkpoints", str(tmp_path / "ckpt")])
    assert rc == 1
    assert rep["checks"]["store:hnsw"]["status"] == "fail"
    assert "doc_ids" in rep["checks"]["store:hnsw"]["detail"]


def test_doctor_baseline_environment(tmp_path, capsys, monkeypatch):
    """Here every environment check passes under --device cpu, the kernels
    are skipped (a warning) and absent stores warn; asking for the card
    where there is none fails the platform check and exits 1."""
    rc, rep = _run(capsys, ["--index", str(tmp_path / "none"),
                            "--checkpoints", str(tmp_path / "none")])
    assert rc == 0
    for name in ("imports", "platform", "native", "tokenizer"):
        assert rep["checks"][name]["status"] == "pass", name
    assert rep["checks"]["kernels"]["status"] == "warn"
    assert rep["checks"]["store"]["status"] == "warn"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = doctor.main(["--index", str(tmp_path / "none"),
                      "--checkpoints", str(tmp_path / "none")])
    rep = json.loads(capsys.readouterr().out)["doctor"]
    assert rc == 1
    assert rep["checks"]["platform"]["status"] == "fail"
    assert rep["checks"]["kernels"]["status"] == "fail"


# ----------------------------------------------------------- visualization


@pytest.mark.parametrize("n, d, collinear", [(40, 16, False), (25, 8, True)])
def test_positive_ranks_and_recall_match_jax(n, d, collinear):
    rng = np.random.default_rng(n)
    q = rng.standard_normal((n, d)).astype(np.float32)
    docs = q + 0.8 * rng.standard_normal((n, d)).astype(np.float32)
    if collinear:  # a positive tied with another doc keeps its rank
        docs[3] = docs[4]
    got = tviz.positive_ranks(q, docs)
    want = jviz.positive_ranks(q, docs)
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (1, 3, 10):
        assert tviz.recall_at_k(got, k) == jviz.recall_at_k(want, k)
    res = tviz.visualize_compressed_vs_original(
        q, docs, q[:, :4], docs[:, :4], make_plots=False)
    assert res == jviz.visualize_compressed_vs_original(
        q, docs, q[:, :4], docs[:, :4], make_plots=False)


def _small_cli_overrides(wd):
    return [
        "data.dataset=synthetic", "data.max_samples=40",
        "encoder.vocab_size=300", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={wd}/vae.pth",
        f"paths.data_dir={wd}/data", f"paths.checkpoints_dir={wd}/ckpt",
        f"paths.logs_dir={wd}/logs", "logging.log_to_file=false",
    ]


def _printed(capsys):
    """The CLI's own lines (the loggers share stdout, as in the JAX
    package)."""
    return [line for line in capsys.readouterr().out.splitlines()
            if line.startswith(("recall@", "wrote "))]


def test_viz_cli_writes_the_figures(tmp_path, capsys):
    """``python -m latentrag_torch.viz_cli --checkpoint <vae.pth>`` on the
    CPU: the AE type from the path, the JAX CLI's recall line over the
    same encoder and AE weights, and its three figures."""
    from latentrag_tpu import viz_cli as jax_viz_cli

    wd = str(tmp_path)
    torch.manual_seed(4)
    torch.save(build_autoencoder("vae", AutoencoderConfig(32, 8, 16))
               .state_dict(), f"{wd}/vae.pth")
    ov = _small_cli_overrides(wd)
    # one encoder for both packages: the JAX seeded init, as encoder.msgpack
    jcfg = jax_overrides(jconfig.Config(), ov)
    corpus = load_evaluation_data(synthetic_examples(40))[1]
    tok = resolve_tokenizer(jcfg.paths.data_dir, 300, corpus)
    save_params(JaxEncoder(tok, jcfg.encoder, seed=3).params,
                f"{wd}/ckpt/encoder.msgpack")
    assert jax_viz_cli.main(["--checkpoint", f"{wd}/vae.pth", "--n_samples",
                             "30", "--out_dir", f"{wd}/jfig",
                             "--set", *ov]) == 0
    want = _printed(capsys)
    assert viz_cli.main(["--checkpoint", f"{wd}/vae.pth", "--n_samples",
                         "30", "--out_dir", f"{wd}/fig", "--device", "cpu",
                         "--set", *ov]) == 0
    out = _printed(capsys)
    assert out[0].startswith("recall@10: original=")
    assert out[0] == want[0]
    names = [line.split()[-1] for line in out[1:]]
    assert [os.path.basename(p) for p in names] == [
        "vae_8d_30s_10k_pca_pairs.png", "vae_8d_30s_10k_pair_dist.png",
        "vae_8d_30s_10k_pos_neg.png"]
    assert [os.path.basename(p.split()[-1]) for p in want[1:]] == [
        os.path.basename(p) for p in names]
    assert all(os.path.getsize(p) > 0 for p in names)
    assert viz_cli.infer_ae_type_from_path("/x/contrastive_best/") == "cae"
    with pytest.raises(ValueError, match="cannot infer"):
        viz_cli.infer_ae_type_from_path("/x/model.pth")


def test_positive_vs_negative_plot(tmp_path):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((20, 8)).astype(np.float32)
    path = tviz.plot_positive_vs_negative_distances(
        torch.from_numpy(q), q + 0.1, out_dir=str(tmp_path), prefix="p")
    assert path == str(tmp_path / "p_pos_neg.png") and os.path.exists(path)


# -------------------------------------------------------- autoencoder metrics


@pytest.mark.parametrize("ae_type", ["vae", "dae", "cae"])
def test_reconstruction_mse_matches_jax(ae_type):
    jmodel = jax_build(ae_type, JaxAECfg(input_dim=32, latent_dim=8,
                                         hidden_dim=16))
    params = jax.tree.map(np.asarray,
                          jax_init(jmodel, jax.random.PRNGKey(5), 32))
    model = build_autoencoder(ae_type, AutoencoderConfig(32, 8, 16))
    model.load_state_dict(autoencoder_state_dict_from_jax(params, ae_type))
    x = np.random.default_rng(8).standard_normal((24, 32)).astype(np.float32)
    got = tam.reconstruction_mse(model.eval(), x)
    want = jam.reconstruction_mse(jmodel, params, jnp.asarray(x))
    assert got == pytest.approx(want, abs=1e-7)


def test_summarise_sizes_matches_jax(rng, tmp_path):
    path = str(tmp_path / "idx")
    _dense(path).build(_normed(rng, 12, 8), [f"doc {i}" for i in range(12)])
    for p in (path, os.path.join(path, "corpus.npy"), str(tmp_path / "no"),
              None):
        assert tam.summarise_sizes(p, 12, 384, 64) == \
            jam.summarise_sizes(p, 12, 384, 64)
    with pytest.raises(ValueError, match="positive"):
        tam.compression_ratio(384, 0)


# ------------------------------------------------------------------ utils


def test_load_dotenv_matches_jax(tmp_path, monkeypatch):
    env = tmp_path / ".env"
    env.write_text("# keys\nLR_A=1\nLR_B = 'two'\nnot a pair\n\nLR_C=\"x=y\"\n")
    results = []
    for load in (load_dotenv, jax_load_dotenv):
        for key in ("LR_A", "LR_B", "LR_C"):
            monkeypatch.delenv(key, raising=False)
        monkeypatch.setenv("LR_A", "kept")
        loaded = load(str(env))
        results.append((loaded, {k: os.environ[k]
                                 for k in ("LR_A", "LR_B", "LR_C")},
                        load(str(env), override=True), os.environ["LR_A"]))
    assert results[0] == results[1]
    assert results[0][1]["LR_A"] == "kept" and results[0][3] == "1"
    assert load_dotenv(str(tmp_path / "absent")) == {}


def test_stopwatches():
    sw = Stopwatch()
    for _ in range(3):
        with sw.span("a"):
            time.sleep(0.001)
    assert sw.counts["a"] == 3 and sw.totals["a"] >= 0.003
    store = {}
    with stopwatch(store, "s"):
        pass
    with stopwatch(store, "s"):
        time.sleep(0.001)
    assert store["s"] >= 0.001
    outputs = []
    with device_stopwatch(store, "d", outputs):
        outputs.append(torch.ones(4) * 2)
    assert store["d"] > 0 and set(store) == {"s", "d"}


def test_to_dict_matches_jax():
    assert to_dict(Config()) == jconfig.to_dict(jconfig.Config())


def test_chunk_index_reads_across_packages(tmp_path):
    fields = dict(chunk_id=0, text="t", tok_start=0, tok_end=3,
                  char_start=0, char_end=5)
    recs = [ChunkRecord(doc_id=i, **{**fields, "chunk_id": i,
                                     "text": f"chunk {i}"},
                        contains_answer=bool(i % 2)) for i in range(5)]
    save_chunk_index(recs, str(tmp_path / "t.parquet"))
    jrecs = jax_load_chunks(str(tmp_path / "t.parquet"))
    assert [r.__dict__ for r in jrecs] == [r.__dict__ for r in recs]
    jax_save_chunks([JaxChunkRecord(**r.__dict__) for r in recs],
                    str(tmp_path / "j.parquet"))
    assert load_chunk_index(str(tmp_path / "j.parquet")) == recs
