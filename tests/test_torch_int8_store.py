"""The port's int8 store and int4 cascade store (``DenseRetriever(
store_dtype="int8" | "int4")``) against the JAX package's, on the CPU:
build, search, filtered search, ``add``, ``remove``, the self-check, save
and load across the two packages both ways, and the pipeline on
``configs/msmarco_v5e8.yaml`` cut to a small encoder.

Tolerances. With ``metric="dot"`` over rows normalized here, both stores
quantize the same fp32 rows, so codes, scales and nibbles are held
bit-identical and so are the scores (int32 dots times one fp32 factor; the
int4 store's stage 2 is the host SQ8 rescore both packages share); ids are
held equal by set within each group of tied scores
(``quantization.same_ids_at_ties``).
With ``metric="cosine"`` each package normalizes the rows itself, and the
two fp32 row norms differ in the last bit for about a third of the values
(JAX and PyTorch sum the squares in other orders), so a code or the scale
may land one step apart: there the codes agree on >= 99.9 % of values, the
scale within 1e-6 relative, ids on >= 99 % of slots and scores at equal
ids within 1e-2 (an int8 step of both operands)."""

import os

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
from latentrag_tpu.utils import load_config as jax_load_config
from latentrag_torch import main as torch_main
from latentrag_torch.models import DenoisingAutoencoder
from latentrag_torch.models.convert import minilm_state_dict_from_jax
from latentrag_torch.ops.quantization import same_ids_at_ties
from latentrag_torch.ops.topk import NEG_INF
from latentrag_torch.retrieval import DenseRetriever, build_retriever
from latentrag_torch.retrieval.factory import load_retriever
from latentrag_torch.utils import apply_overrides, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSMARCO = os.path.join(ROOT, "configs", "msmarco_v5e8.yaml")
N = 2500


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _texts(n=N):
    return [f"t{i}" for i in range(n)]


def _meta(n=N):
    return [{"shard": i % 5} for i in range(n)]


def _pair(rng, store, d=64, metric="dot", n=N, **kw):
    """A JAX store and a port store built from copies of one corpus (the
    port's ``torch.as_tensor`` would share the caller's buffer)."""
    emb = _unit(rng, n, d)
    j = JaxDense(store_dtype=store, backend="xla", metric=metric, **kw)
    j.build(emb.copy(), _texts(n), metadata=_meta(n))
    t = DenseRetriever(store_dtype=store, metric=metric, device="cpu", **kw)
    t.build(emb.copy(), _texts(n), metadata=_meta(n))
    return emb, j, t


def _assert_same_stores(t, j, store):
    np.testing.assert_array_equal(t._corpus.numpy(), np.asarray(j._corpus_dev))
    assert t._corpus_scale == float(j._corpus_scale)
    assert t.dim == j.dim and t._corpus_n == j._corpus_n
    if store == "int4":
        assert t._corpus.dtype == torch.uint8
        assert t._sq4_scale == float(j._sq4_scale)
        np.testing.assert_array_equal(t._rescore_host, j._rescore_host)
    else:
        assert t._corpus.dtype == torch.int8 and t._rescore_host is None


def _assert_same_search(t, j, q, k, filter=None):
    s_j, i_j = j.search(q.copy(), k, filter=filter)
    s_t, i_t = t.search(q.copy(), k, filter=filter)
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    assert same_ids_at_ties(s_t, i_t, s_t, np.asarray(i_j)).all()
    return s_t, i_t


@pytest.mark.parametrize("k", [1, 10, 20, 160])
@pytest.mark.parametrize("d", [64, 33])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_store_matches_jax(rng, store, d, k):
    """The device operand (int8 codes, or nibbles beside host SQ8 codes)
    and its scales are the JAX store's bit for bit, and so are the
    searches: at k=20 the int4 stage 1 takes 160 candidates, past the
    fold's 128 on the card, and at k=160 the int8 search is past them too
    (``exact_i8_wgmma_kernel`` on the card; the int4 stage 1 takes 1280)."""
    _, j, t = _pair(rng, store, d)
    _assert_same_stores(t, j, store)
    q = rng.standard_normal((13, d)).astype(np.float32)
    _assert_same_search(t, j, q, k)


@pytest.mark.parametrize("spec", [{"where": {"shard": 2}},
                                  {"doc_ids": [3, 5, 7]},
                                  {"exclude_doc_ids": list(range(0, N, 2))}])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_filtered_search_matches_jax(rng, store, spec):
    """A filter restricts both stores alike; slots no allowed row fills
    are (NEG_INF, -1) in both (k=10 over 3 allowed rows)."""
    _, j, t = _pair(rng, store)
    q = rng.standard_normal((9, 64)).astype(np.float32)
    s, i = _assert_same_search(t, j, q, 10, spec)
    allowed = {
        "where": lambda r: r % 5 == 2,
        "doc_ids": lambda r: r in (3, 5, 7),
        "exclude_doc_ids": lambda r: r % 2 == 1,
    }[next(iter(spec))]
    assert all(allowed(int(r)) for r in i.ravel() if r >= 0)
    if "doc_ids" in spec:
        assert (i[:, 3:] == -1).all() and (s[:, 3:] <= NEG_INF * 0.5).all()


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_add_remove_match_jax(rng, store):
    """``add`` quantizes new rows at the build's scales (int4: the nibbles'
    and the SQ8 codes'), ``remove`` gathers the survivors: the stores stay
    bit-identical to the JAX package's, a survivor's score does not change
    and a removed row never returns."""
    _, j, t = _pair(rng, store, d=33)
    q = rng.standard_normal((11, 33)).astype(np.float32)
    s0, i0 = t.search(q.copy(), 10)
    new = rng.standard_normal((40, 33)).astype(np.float32) * 3.0
    for r in (j, t):
        r.add(new.copy(), [f"n{i}" for i in range(40)],
              doc_ids=list(range(10**6, 10**6 + 40)),
              metadata=[{"shard": 9}] * 40)
    _assert_same_stores(t, j, store)
    _assert_same_search(t, j, q, 10)
    _assert_same_search(t, j, new[:5] / 3.0, 1, {"where": {"shard": 9}})
    drop = [int(x) for x in i0[:, 0]] + list(range(10**6, 10**6 + 40, 2))
    assert j.remove(drop) == t.remove(drop)
    _assert_same_stores(t, j, store)
    s1, i1 = _assert_same_search(t, j, q, 10)
    ids = np.asarray(t.doc_ids)[i1]
    assert not set(ids.ravel().tolist()) & set(drop)
    before = {(qi, int(d)): v for qi in range(11)
              for d, v in zip(i0[qi], s0[qi])}
    for qi in range(11):  # survivors keep their scores bit for bit
        for d, v in zip(ids[qi], s1[qi]):
            if (qi, int(d)) in before:
                assert before[(qi, int(d))] == v


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_self_check_and_dequantized_row(rng, store, caplog):
    """The self-check probes the dequantized row 0 through the store's own
    search, as the JAX package's does; a duplicate of row 0 ties with it,
    and ties go to the lower row, so row 0 still comes back top-1."""
    emb = _unit(rng, 300, 48)
    emb[200] = emb[0]  # a tie at the probe
    j = JaxDense(store_dtype=store, backend="xla", metric="dot")
    j.build(emb.copy(), _texts(300))
    t = DenseRetriever(store_dtype=store, metric="dot", device="cpu")
    t.build(emb.copy(), _texts(300))
    assert "self-check failed" not in caplog.text
    assert t._self_check() and j._self_check()
    np.testing.assert_array_equal(t._corpus_row(0).numpy(),
                                  np.asarray(j._corpus_row(0)))
    s, i = t.search(t._corpus_row(0).numpy()[None], 3)
    assert i[0, 0] == 0 and i[0, 1] == 200 and s[0, 0] == s[0, 1]


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_cosine_store_close_to_jax(rng, store):
    """Cosine: each package normalizes the rows itself (module docstring's
    tolerances)."""
    emb = rng.standard_normal((N, 64)).astype(np.float32)
    j = JaxDense(store_dtype=store, backend="xla")
    j.build(emb.copy(), _texts())
    t = DenseRetriever(store_dtype=store, device="cpu")
    t.build(emb.copy(), _texts())
    host = t._corpus.numpy() if store == "int8" else t._rescore_host
    want = np.asarray(j._corpus_dev) if store == "int8" else j._rescore_host
    assert np.mean(host == want) >= 0.999
    assert t._corpus_scale == pytest.approx(float(j._corpus_scale), rel=1e-6)
    q = rng.standard_normal((16, 64)).astype(np.float32)
    s_j, i_j = j.search(q.copy(), 10)
    s_t, i_t = t.search(q.copy(), 10)
    same = i_t == np.asarray(i_j)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(s_t[same], np.asarray(s_j)[same], atol=1e-2)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("store", ["int8", "int4"])
def test_store_cross_loads(rng, tmp_path, store, writer):
    """A store saved by either package loads in the other as the store it
    is (int8: the dequantized rows re-quantized; int4: its nibbles and
    both scales from the sidecars), with the same files and the same
    searches, filtered ones too; the port's reload searches as the built
    store did."""
    path = str(tmp_path / "idx")
    emb = _unit(rng, N, 64)
    W = JaxDense if writer == "jax" else DenseRetriever
    kw = {"backend": "xla"} if writer == "jax" else {"device": "cpu"}
    built = W(store_dtype=store, metric="dot", index_path=path, **kw)
    built.build(emb, _texts(), metadata=_meta())
    files = set(os.listdir(path))
    assert ({"sq4_packed.npy", "sq4_scale.npy", "sq8_scale.npy"} <= files) \
        == (store == "int4")
    assert "sq8_scale.npy" not in files or store == "int4"
    j = JaxDense(store_dtype=store, backend="xla", index_path=path)
    t = DenseRetriever(store_dtype=store, index_path=path, device="cpu")
    assert j.is_built and t.is_built and t.metric == "dot"
    _assert_same_stores(t, j, store)
    q = rng.standard_normal((12, 64)).astype(np.float32)
    s_t, i_t = _assert_same_search(t, j, q, 10)
    _assert_same_search(t, j, q, 10, {"where": {"shard": 1}})
    s_b, i_b = built.search(q.copy(), 10)
    np.testing.assert_array_equal(s_t, np.asarray(s_b))
    np.testing.assert_array_equal(i_t, np.asarray(i_b))
    if writer == "torch":  # the port's own reload saves the same files
        t._save(str(tmp_path / "again"))
        for name in ("corpus.npy", "sq4_packed.npy", "sq8_scale.npy"):
            if os.path.exists(os.path.join(path, name)):
                np.testing.assert_array_equal(
                    np.load(os.path.join(path, name)),
                    np.load(str(tmp_path / "again" / name)))


@pytest.mark.parametrize("written", ["float32", "int8", "binary"])
def test_int4_loads_other_tiers_as_jax_does(rng, tmp_path, caplog, written):
    """A store without the sq4 sidecars loads as int4 by packing its rows
    on the host at a re-derived scale, with the JAX package's warning; the
    nibbles and scales are the JAX load's bit for bit (the legacy path is
    held only to the JAX package: its scale comes from the stored rows,
    not the original floats)."""
    path = str(tmp_path / "idx")
    JaxDense(backend="xla", store_dtype=written, metric="dot",
             index_path=path).build(_unit(rng, N, 33), _texts())
    j = JaxDense(store_dtype="int4", backend="xla", index_path=path)
    t = DenseRetriever(store_dtype="int4", index_path=path, device="cpu")
    assert "lacks sq4 sidecars" in caplog.text
    _assert_same_stores(t, j, "int4")
    _assert_same_search(t, j, rng.standard_normal((8, 33)).astype(
        np.float32), 10)


@pytest.mark.parametrize("loaded", ["bfloat16", "float32", "binary"])
@pytest.mark.parametrize("written", ["int8", "int4"])
def test_quantized_store_loads_at_other_tiers(rng, tmp_path, written,
                                              loaded):
    """The port's int8 and int4 stores load at another tier as the JAX
    package loads them (their corpus.npy holds the dequantized rows)."""
    path = str(tmp_path / "idx")
    DenseRetriever(store_dtype=written, metric="dot", index_path=path,
                   device="cpu").build(_unit(rng, N, 64), _texts())
    j = JaxDense(store_dtype=loaded, backend="xla", index_path=path)
    t = DenseRetriever(store_dtype=loaded, index_path=path, device="cpu")
    assert j.is_built and t.is_built
    if loaded == "binary":
        np.testing.assert_array_equal(t._corpus.numpy().view(np.uint32),
                                      np.asarray(j._corpus_dev))
    else:
        np.testing.assert_array_equal(
            t._corpus.float().numpy(),
            np.asarray(j._corpus_dev, dtype=np.float32))


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_refused_combinations(store):
    """As the JAX ``__post_init__`` and ``build``: quantized stores refuse
    the exact oracle; int4 takes cosine or dot only at construction, int8
    at build."""
    for backend in ("xla_exact", "pallas_exact"):
        with pytest.raises(ValueError, match="exact oracle"):
            DenseRetriever(store_dtype=store, backend=backend, device="cpu")
    if store == "int4":
        with pytest.raises(ValueError, match="int4 store supports cosine"):
            DenseRetriever(store_dtype=store, metric="euclidean",
                           device="cpu")
    else:
        r = DenseRetriever(store_dtype=store, metric="euclidean",
                           device="cpu")
        with pytest.raises(ValueError, match="int8 store supports cosine"):
            r.build(np.eye(4, 8, dtype=np.float32), list("abcd"))


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_factory_builds_and_warm_boots(rng, tmp_path, store):
    """The config path to the store refuses neither dtype: the factory
    builds it (with the msmarco config's recall target and block size)
    and ``load_retriever`` warm-boots it."""
    cfg = apply_overrides(load_config(MSMARCO), [
        f"retrieval.store_dtype={store}",
        f"retrieval.index_path={tmp_path}/idx"])
    assert cfg.retrieval.recall_target == 0.95
    emb = rng.standard_normal((200, 16)).astype(np.float32)
    r = build_retriever(emb, [str(i) for i in range(200)], None,
                        cfg.retrieval, device="cpu")
    assert r.store_dtype == store and r.block_size == 1048576
    w = load_retriever(cfg.retrieval, device="cpu")
    assert w is not None and w.store_dtype == store
    s1, i1 = r.search(emb[:5], 3)
    s2, i2 = w.search(emb[:5], 3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
    assert (i1[:, 0] == np.arange(5)).all()


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_msmarco_pipeline_matches_jax(tmp_path, store):
    """``configs/msmarco_v5e8.yaml`` (int8 store, recall_target 0.95,
    block_size 1048576, shard_corpus served unsharded on one device) with
    ``--ae_type dae``, cut to a small encoder and DAE (384->512->64 to
    32->16->8) and 60 synthetic examples, the DAE a seeded .pth: the port
    on the CPU retrieves the JAX pipeline's docs and scores its metrics;
    int4 the same config with its store swapped."""
    base = str(tmp_path)
    ov = [
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", f"retrieval.index_path={base}/index",
        f"logging.log_file={base}/logs/run.log", "data.max_samples=60",
        "encoder.vocab_size=800", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.dae.input_dim=32", "models.dae.latent_dim=8",
        "models.dae.hidden_dim=16", f"models.dae.checkpoint={base}/dae.pth",
        f"retrieval.store_dtype={store}",
    ]
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    torch.manual_seed(6)
    torch.save(DenoisingAutoencoder(32, 8, 16).state_dict(), f"{base}/dae.pth")
    cfg_j = jax_overrides(jax_load_config(MSMARCO), ov)
    assert cfg_j.retrieval.shard_corpus and cfg_j.retrieval.kernel == "xla"
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    params = JaxEncoder(tok, cfg_j.encoder, seed=11).params
    save_params(params, f"{base}/ckpt/encoder.msgpack")
    torch.save(minilm_state_dict_from_jax(params), f"{base}/ckpt/encoder.pt")

    want = JaxRunner(cfg_j, ae_type="dae").process(queries, corpus, relevant)
    results = []
    rc = torch_main.main(
        ["--config", MSMARCO, "--ae_type", "dae", "--device", "cpu",
         "--set", *ov, f"encoder.weights_path={base}/ckpt/encoder.pt"],
        results=results,
    )
    assert rc == 0 and len(results) == 1
    got = results[0]
    assert got["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    for name, stats in want["retrieval_metrics"].items():
        assert got["retrieval_metrics"][name]["mean"] == pytest.approx(
            stats["mean"], abs=1e-6)
    np.testing.assert_allclose(got["doc_scores"], want["doc_scores"],
                               atol=1e-5)
