"""The port's dense retriever, encoder and pipeline on an 8-entry ``cpu``
mesh against the JAX package's on pytest's 8 virtual CPU devices: the
sharded stores (float, int8, int4, binary; filters; add / remove) return
the JAX package's ids bit for bit and its scores within 1e-5 (fp32 sum
order); the port's ``sharded/`` layout saves and loads on meshes of any
size and on one device, refuses a mixed generation and the JAX package's
Orbax layout, which ``scripts/orbax_sharded_to_npy.py`` rewrites; the
doctor checks it; the data-parallel encode and ``PipelineRunner`` with a
mesh match the JAX package's within the main path's tolerances."""

import importlib.util
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.parallel import make_mesh as jax_make_mesh
from latentrag_tpu.pipeline import PipelineRunner as JaxRunner
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_tpu.utils.config import EncoderConfig
from latentrag_torch import doctor
from latentrag_torch import main as torch_main
from latentrag_torch.data.tokenizer import WordPieceTokenizer
from latentrag_torch.models import VariationalAutoencoder
from latentrag_torch.models.convert import minilm_state_dict_from_jax
from latentrag_torch.models.encoder.minilm import SentenceEncoder
from latentrag_torch.parallel import (
    ShardedRows,
    load_sharded_index,
    make_mesh,
    save_sharded_index,
    shard_rows,
)
from latentrag_torch.pipeline import PipelineRunner
from latentrag_torch.retrieval import DenseRetriever, factory
from latentrag_torch.utils import Config, apply_overrides

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "orbax_sharded_to_npy.py")
SCORE_TOL = 1e-5


def _mesh(p=8):
    return make_mesh(devices=["cpu"] * p)


def _corpus(rng, n=333, d=32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _texts(n):
    return [f"doc {i}" for i in range(n)]


def _meta(n):
    return [{"tag": i % 4} for i in range(n)]


def _pair(store, metric, path=None):
    backend = "xla" if store in ("int8", "int4", "binary") else "xla_exact"
    t = DenseRetriever(metric=metric, backend=backend, store_dtype=store,
                       mesh=_mesh(), device="cpu",
                       index_path=None if path is None else f"{path}/t")
    j = JaxDense(metric=metric, backend=backend, store_dtype=store,
                 mesh=jax_make_mesh(8),
                 index_path=None if path is None else f"{path}/j")
    return t, j


def _same(a, b):
    (sa, ia), (sb, ib) = a, b
    np.testing.assert_array_equal(ia, ib)
    live = ia >= 0
    np.testing.assert_allclose(sa[live], sb[live], atol=SCORE_TOL,
                               rtol=SCORE_TOL)


STORES = [("float32", "cosine"), ("float32", "euclidean"),
          ("float32", "dot"), ("bfloat16", "cosine"), ("int8", "cosine"),
          ("int8", "dot"), ("int4", "cosine"), ("binary", "cosine"),
          ("binary", "dot")]


@pytest.mark.parametrize("store,metric", STORES)
def test_sharded_store_matches_jax(rng, eight_devices, store, metric):
    """Unfiltered, a doc-id filter and a where filter, at k inside a shard
    and past it (333 rows make 42-row shards: shard starts fall inside
    32-row mask words; pad rows on the last shard)."""
    c = _corpus(rng)
    q = _corpus(rng, 6)
    t, j = _pair(store, metric)
    t.build(c, _texts(333), metadata=_meta(333))
    j.build(c, _texts(333), metadata=_meta(333))
    allowed = [i for i in range(333) if i % 3]
    for k in (5, 50):
        for flt in (None, {"doc_ids": allowed}, {"where": {"tag": 1}}):
            _same(t.search(q, k, filter=flt), j.search(q, k, filter=flt))


@pytest.mark.parametrize("store", ["bfloat16", "int8", "binary"])
def test_sharded_add_remove_matches_jax(rng, eight_devices, store):
    metric = "cosine"
    c = _corpus(rng, 203)
    q = _corpus(rng, 5)
    t, j = _pair(store, metric)
    for r in (t, j):
        r.build(c, _texts(203))
        r.add(c[:3] * 0.5 + 0.1, ["a", "b", "c"], doc_ids=[900, 901, 902])
        assert r.remove([5, 6, 900]) == 3
    assert t.doc_ids == j.doc_ids and t._corpus_n == 203
    _same(t.search(q, 10), j.search(q, 10))
    # a removed id never returns; an added row is top-1 on itself
    _, ids = t.search(c[[5, 6]], 5)
    assert not {t.doc_ids[i] for i in ids.ravel()} & {5, 6}
    _, ids = t.search(c[1:3] * 0.5 + 0.1, 1)
    assert [t.doc_ids[i] for i in ids[:, 0]] == [901, 902]


def test_sharded_self_check_and_dropped_one_device_mesh(rng):
    c = _corpus(rng, 100, 16)
    r = DenseRetriever(backend="xla_exact", store_dtype="float32",
                       mesh=_mesh(1), device="cpu")
    assert r.mesh is None  # as the JAX package drops a 1-device mesh
    r2 = DenseRetriever(backend="xla_exact", store_dtype="float32",
                        mesh=_mesh(4), device="cpu")
    r2.build(c, _texts(100))
    assert isinstance(r2._corpus, ShardedRows)
    assert r2._corpus.shape == (100, 16) and len(r2._corpus.shards) == 4
    assert r2._self_check()


def test_mesh_with_ivf_raises_naming_the_roadmap_item(rng):
    """The refusal this test held is gone with the sharded IVF: a mesh with
    ``ivf_nlist > 0`` builds and searches through it (its parity with the
    JAX package: tests/test_torch_sharded_ivf.py)."""
    from latentrag_torch.parallel.ivf import ShardedIVF

    r = DenseRetriever(backend="xla", mesh=_mesh(2), device="cpu",
                       ivf_nlist=16, ivf_nprobe=10**6)
    c = _corpus(rng, 9000, 16)
    r.build(c, [str(i) for i in range(9000)], sanity_check=False)
    _, i = r.search(c[:3], 1)
    assert isinstance(r._ivf_index, ShardedIVF)
    assert (i[:, 0] == np.arange(3)).all()


@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8", "int4",
                                   "binary"])
def test_sharded_persistence_round_trip(rng, tmp_path, store):
    """Float and int8 stores persist as sharded/ (the int8 codes and the
    bf16 rows bit for bit), cascades as their usual files; a warm boot on
    a 3-entry mesh and on one device searches as the original."""
    c = _corpus(rng, 150, 16)
    q = _corpus(rng, 4, 16)
    path = str(tmp_path / "idx")
    backend = "xla" if store in ("int8", "int4", "binary") else "xla_exact"
    kw = dict(backend=backend, store_dtype=store, device="cpu",
              index_path=path)
    r = DenseRetriever(mesh=_mesh(), **kw)
    r.build(c, _texts(150), metadata=_meta(150))
    want = r.search(q, 7, filter={"where": {"tag": 2}})
    files = set(os.listdir(path))
    if store in ("int4", "binary"):
        assert "corpus.npy" in files and "sharded" not in files
    else:
        assert "sharded" in files and "corpus.npy" not in files
        with open(os.path.join(path, "meta.json")) as f:
            gen = json.load(f)["sharded_generation"]
        with open(os.path.join(path, "sharded", "meta.json")) as f:
            smeta = json.load(f)
        assert smeta["generation"] == gen and smeta["n"] == 150
        assert (smeta["p"], smeta["rows_per_shard"]) == (8, 19)
    for mesh in (_mesh(3), None):
        r2 = DenseRetriever(mesh=mesh, **kw)
        assert r2.is_built and r2._corpus_n == 150
        got = r2.search(q, 7, filter={"where": {"tag": 2}})
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        if store in ("int8", "bfloat16"):
            assert torch.equal(r._rows(), r2._rows())
    # a second build of the same corpus skips the rebuild
    r3 = DenseRetriever(mesh=_mesh(), **kw)
    r3.build(c, _texts(150), metadata=_meta(150))
    np.testing.assert_array_equal(r3.search(q, 7)[1], r.search(q, 7)[1])


@pytest.mark.parametrize("saved,loaded", [
    ("float32", "bfloat16"), ("int8", "float32"), ("float32", "int8"),
    ("float32", "binary")])
def test_sharded_store_loads_into_another_tier(rng, tmp_path, saved,
                                               loaded):
    """A sharded/ store read by a retriever of another tier: on a mesh of
    another size and on one device, float rows are cast and int8 codes
    dequantized shard by shard, float rows become int8 codes over all of
    them at once (``sq8_quantize``), and a cascade takes the same host rows
    as from the same rows' corpus.npy."""
    from latentrag_torch.ops.quantization import sq8_quantize

    c = _corpus(rng, 150, 16)
    q = _corpus(rng, 4, 16)
    backend = {"int8": "xla", "binary": "xla"}
    src = DenseRetriever(backend=backend.get(saved, "xla_exact"),
                         store_dtype=saved, mesh=_mesh(), device="cpu",
                         index_path=str(tmp_path / "sharded"))
    src.build(c, _texts(150))
    rows = src._rows()
    if saved == "int8":
        rows = rows.float() * src._corpus_scale
    kw = dict(backend=backend.get(loaded, "xla_exact"), store_dtype=loaded,
              device="cpu", index_path=str(tmp_path / "sharded"))
    for mesh in (_mesh(3), None):
        r = DenseRetriever(mesh=mesh, **kw)
        assert r.is_built and r._corpus_n == 150 and r.dim == 16
        if loaded == "int8":
            codes, scale = sq8_quantize(rows)
            assert torch.equal(r._rows(), codes)
            assert r._corpus_scale == float(scale)
        elif loaded == "binary":
            # the same corpus as an unsharded store: its corpus.npy
            plain = DenseRetriever(backend="xla_exact", store_dtype="float32",
                                   device="cpu",
                                   index_path=str(tmp_path / "plain"))
            plain.build(c, _texts(150))
            assert torch.equal(plain._rows(), rows)
            want = DenseRetriever(**dict(kw, index_path=plain.index_path))
            assert torch.equal(r._rows(), want._rows())
            np.testing.assert_array_equal(r._rescore_host,
                                          want._rescore_host)
            _same(r.search(q, 5), want.search(q, 5))
        else:
            assert torch.equal(r._rows(), rows.to(r._rows().dtype))


def test_sharded_quantized_search_quantizes_queries_once(rng, monkeypatch):
    """The int8 and int4 stores' sharded search quantizes the queries once
    for all eight shards, not once a shard, and returns what the
    unsharded store returns."""
    from latentrag_torch.ops import quantization

    calls = []
    real = quantization.sq8_quantize
    monkeypatch.setattr(quantization, "sq8_quantize",
                        lambda x: calls.append(x.shape) or real(x))
    c = _corpus(rng, 300, 16)
    q = _corpus(rng, 5, 16)
    for store in ("int8", "int4"):
        r = DenseRetriever(backend="xla", store_dtype=store, mesh=_mesh(),
                           device="cpu")
        r.build(c, _texts(300))
        calls.clear()
        r.search(q, 6)
        assert calls == [(5, 16)], store


def test_sharded_generation_mismatch_starts_clean(rng, tmp_path, caplog):
    path = str(tmp_path / "idx")
    r = DenseRetriever(backend="xla_exact", store_dtype="float32",
                       mesh=_mesh(), device="cpu", index_path=path)
    r.build(_corpus(rng, 64, 16), _texts(64))
    meta_p = os.path.join(path, "sharded", "meta.json")
    with open(meta_p) as f:
        smeta = json.load(f)
    smeta["generation"] = "stale"
    with open(meta_p, "w") as f:
        json.dump(smeta, f)
    with caplog.at_level(logging.WARNING, "latentrag_torch.retrieval"):
        r2 = DenseRetriever(backend="xla_exact", store_dtype="float32",
                            mesh=_mesh(), device="cpu", index_path=path)
    assert not r2.is_built
    assert any("mixed-generation" in m for m in caplog.messages)
    status, why, _ = doctor._dense_store(path)
    assert status == doctor.FAIL and "generation" in why


def test_doctor_passes_a_sharded_store(rng, tmp_path):
    path = str(tmp_path / "idx")
    r = DenseRetriever(backend="xla", store_dtype="int8", mesh=_mesh(),
                       device="cpu", index_path=path)
    r.build(_corpus(rng, 90, 16), _texts(90))
    status, _, notes = doctor._dense_store(path)
    assert status == doctor.PASS
    assert any("sharded/ store present" in n and "8 shards" in n
               for n in notes)
    os.remove(os.path.join(path, "sharded", "shard_00003.npy"))
    status, why, _ = doctor._dense_store(path)
    assert status == doctor.FAIL and "shard_00003.npy" in why


def test_checkpoint_api_round_trip(rng, tmp_path):
    """save_sharded_index / load_sharded_index, as the JAX module's test
    drives them: the same rows back on the same mesh, on another mesh
    size, and (padded, as stored) on one device."""
    mesh = _mesh()
    c = torch.tensor(_corpus(rng, 128, 16)).to(torch.bfloat16)
    path = str(tmp_path / "sharded_idx")
    save_sharded_index(path, shard_rows(c, mesh), {"n": 128,
                                                   "metric": "cosine"})
    restored, meta = load_sharded_index(path, mesh)
    assert meta["n"] == 128 and meta["metric"] == "cosine"
    assert len(restored.shards) == 8 and restored.dtype == torch.bfloat16
    for a, b in zip(restored.shards, shard_rows(c, mesh).shards):
        assert torch.equal(a, b)
    other, _ = load_sharded_index(path, _mesh(5))
    assert other.shape == (130, 16)
    assert torch.equal(torch.cat(other.shards)[:128], c)
    whole, _ = load_sharded_index(path, device="cpu")
    assert torch.equal(whole, c)


def _load_script():
    spec = importlib.util.spec_from_file_location("orbax_sharded_to_npy",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("store", ["float32", "int8"])
def test_orbax_store_refused_then_converted(rng, eight_devices, tmp_path,
                                            caplog, store):
    """The JAX package's Orbax sharded/ store starts clean in the port,
    naming the script; after ``scripts/orbax_sharded_to_npy.py`` the port
    loads it on a mesh and searches as the JAX package does."""
    c = _corpus(rng, 101, 16)
    q = _corpus(rng, 5, 16)
    path = str(tmp_path / "idx")
    backend = "xla" if store == "int8" else "xla_exact"
    j = JaxDense(backend=backend, store_dtype=store, mesh=jax_make_mesh(8),
                 index_path=path)
    j.build(c, _texts(101))
    want = j.search(q, 6)
    kw = dict(backend=backend, store_dtype=store, device="cpu",
              index_path=path)
    with caplog.at_level(logging.WARNING, "latentrag_torch.retrieval"):
        assert not DenseRetriever(mesh=_mesh(), **kw).is_built
    assert any("orbax_sharded_to_npy.py" in m for m in caplog.messages)
    status, why, _ = doctor._dense_store(path)
    assert status == doctor.FAIL and "orbax_sharded_to_npy.py" in why
    assert _load_script().main(["--index", path]) == 0
    t = DenseRetriever(mesh=_mesh(), **kw)
    assert t.is_built and t._corpus_n == 101
    _same(t.search(q, 6), want)
    assert doctor._dense_store(path)[0] == doctor.PASS


def test_factory_takes_the_mesh_only_under_shard_corpus(monkeypatch):
    """The factory no longer refuses more than one card: under
    ``shard_corpus`` it shards over the mesh it is given, the device IVF's
    settings passed through (the sharded IVF)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = apply_overrides(Config(), ["retrieval.shard_corpus=true",
                                     "retrieval.index_path="])
    r = factory._make_dense(cfg.retrieval, "cpu", _mesh(2))
    assert r.mesh is not None and r.mesh.size == 2
    plain = apply_overrides(Config(), ["retrieval.index_path="])
    assert factory._make_dense(plain.retrieval, "cpu", _mesh(2)).mesh is None
    ivf = apply_overrides(cfg, ["retrieval.ivf_nlist=16",
                                "retrieval.ivf_nprobe=8"])
    r = factory._make_dense(ivf.retrieval, "cpu", _mesh(2))
    assert r.mesh.size == 2 and (r.ivf_nlist, r.ivf_nprobe) == (16, 8)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_data_parallel_encode_matches_jax(eight_devices):
    """The 8-shard encode (odd row count: the rows pad to a multiple of
    8) against the JAX package's 8-device encode and the port's own
    unsharded one; the chunk is batch_size x 8 rows."""
    texts = [f"the quick brown fox number {i} jumps over the lazy dog"
             for i in range(37)]
    tok_j = JaxTokenizer.train_from_corpus(texts, vocab_size=300, min_freq=1)
    tok_t = WordPieceTokenizer(dict(tok_j.vocab))
    cfg = EncoderConfig(vocab_size=300, hidden_dim=32, num_layers=2,
                        num_heads=4, mlp_dim=64, dtype="float32",
                        max_length=32, batch_size=4)
    enc_j = JaxEncoder(tok_j, cfg, mesh=jax_make_mesh(8))
    sd = minilm_state_dict_from_jax(_np_tree(enc_j.params))
    enc_t = SentenceEncoder(tok_t, cfg, state_dict=sd, device="cpu",
                            mesh=_mesh())
    single = SentenceEncoder(tok_t, cfg, state_dict=sd, device="cpu")
    calls = []
    orig = enc_t._encode_chunk
    enc_t._encode_chunk = lambda t: (calls.append(len(t)), orig(t))[1]
    got = enc_t.encode_batch(texts)
    assert calls == [32, 5]
    np.testing.assert_allclose(got.numpy(), enc_j.encode_batch(texts),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), single.encode_batch(texts)
                               .numpy(), atol=1e-6)


def _overrides(base):
    return [
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", f"retrieval.index_path={base}/index",
        f"logging.log_file={base}/logs/run.log",
        "data.dataset=synthetic", "data.max_samples=60",
        "encoder.vocab_size=800", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={base}/vae.pth",
        "retrieval.store_dtype=float32", "retrieval.kernel=xla_exact",
        "retrieval.shard_corpus=true",
    ]


def test_pipeline_with_mesh_matches_jax(tmp_path, eight_devices):
    """``PipelineRunner(mesh=)`` on 8 cpu shards (the data-parallel encode
    and the sharded store) against the JAX package's
    ``PipelineRunner(mesh=make_mesh(8))``: the same docs, the metrics
    within 1e-6 and the doc scores within 1e-5, the main path's parity
    tolerances; the store persists as sharded/."""
    base = str(tmp_path)
    ov = _overrides(base)
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg_j = jax_overrides(JaxConfig(), ov + [
        f"retrieval.index_path={base}/jax_index"])
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    save_params(JaxEncoder(tok, cfg_j.encoder, seed=11).params,
                f"{base}/ckpt/encoder.msgpack")
    want = JaxRunner(cfg_j, ae_type="vae", mesh=jax_make_mesh(8)).process(
        queries, corpus, relevant)
    cfg = apply_overrides(Config(), ov)
    got = PipelineRunner(cfg, ae_type="vae", device="cpu",
                         mesh=_mesh()).process(queries, corpus, relevant)
    assert got["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    for name, stats in want["retrieval_metrics"].items():
        assert got["retrieval_metrics"][name]["mean"] == pytest.approx(
            stats["mean"], abs=1e-6)
    np.testing.assert_allclose(got["doc_scores"], want["doc_scores"],
                               atol=1e-5)
    assert os.path.isdir(f"{base}/index/sharded")


def test_main_shard_corpus_on_one_device_serves_unsharded(tmp_path, capsys):
    """``main --set retrieval.shard_corpus=true`` on one device logs the
    1-device mesh, which is dropped: the unsharded run's docs exactly."""
    base = str(tmp_path)
    ov = [o for o in _overrides(base) if "vae" not in o]
    results = []
    assert torch_main.main(["--ae_type", "none", "--device", "cpu",
                            "--set", *ov], results=results) == 0
    assert "sharding corpus over 1 devices" in capsys.readouterr().out
    assert not os.path.isdir(f"{base}/index/sharded")
    plain = [o for o in ov if "shard_corpus" not in o] + [
        f"retrieval.index_path={base}/index2"]
    assert torch_main.main(["--ae_type", "none", "--device", "cpu",
                            "--set", *plain], results=results) == 0
    assert results[0]["retrieved_doc_ids"] == results[1]["retrieved_doc_ids"]
    np.testing.assert_array_equal(results[0]["doc_scores"],
                                  results[1]["doc_scores"])
