"""The binary (1-bit) cascade store of the port against the JAX package's,
on the CPU: packing, SQ8 codes, the host rescore, the plain sign-dot
searches, the binary fold kernel's plain version (held to
``pallas_binary_topk`` in interpret mode, as
``tests/test_binary_transposed.py`` runs it), the retriever and the
pipeline. The CUDA kernel itself is held to its plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Sign-dot scores tie whenever two rows share their sign bits, so the plain
searches compare score multisets; the fold and the store compare ids on
>= 99 % of slots and scores at equal ids."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.ops import binary as jb
from latentrag_tpu.ops.pallas_topk import pallas_binary_topk as jax_pbt
from latentrag_tpu.ops.quantization import sq8_quantize as jax_sq8
from latentrag_tpu.pipeline import PipelineRunner as JaxRunner
from latentrag_tpu.retrieval.dense import DenseRetriever as JaxDense
from latentrag_tpu.retrieval.rescore import exact_rescore_topk as jax_rescore
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_torch import main as torch_main
from latentrag_torch.models import VariationalAutoencoder
from latentrag_torch.models.convert import minilm_state_dict_from_jax
from latentrag_torch.ops import binary as tb
from latentrag_torch.ops import cuda_build
from latentrag_torch.ops import fused_topk as ft
from latentrag_torch.ops.quantization import sq8_quantize
from latentrag_torch.retrieval import DenseRetriever, build_retriever
from latentrag_torch.retrieval.rescore import exact_rescore_topk
from latentrag_torch.utils import Config, apply_overrides


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _words(t: torch.Tensor) -> np.ndarray:
    """The port's int32 words as the JAX package's uint32."""
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------ packing


@pytest.mark.parametrize("d", [64, 48, 384])
@pytest.mark.parametrize("fn", ["quantize", "unpack", "quantize_t",
                                "unpack_t"])
def test_packing_is_bit_identical(rng, fn, d):
    x = rng.standard_normal((37, d)).astype(np.float32)
    x[0, :5] = 0.0  # x >= 0 sets the bit, as in the JAX package
    x[1, :5] = -0.0
    xt = torch.from_numpy(x)
    if fn == "quantize":
        got, want = _words(tb.binary_quantize(xt)), jb.binary_quantize(x)
    elif fn == "quantize_t":
        got, want = _words(tb.binary_quantize_t(xt)), jb.binary_quantize_t(x)
    elif fn == "unpack":
        got = tb.binary_unpack(tb.binary_quantize(xt), d).numpy()
        want = jb.binary_unpack(jb.binary_quantize(x), d)
    else:
        got = tb.binary_unpack_t(tb.binary_quantize_t(xt), d).numpy()
        want = jb.binary_unpack_t(jb.binary_quantize_t(x), d)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if fn == "quantize":
        assert got.shape == (37, -(-d // 32))
    if fn == "unpack":  # the round trip gives the signs back
        np.testing.assert_array_equal(got, np.where(x >= 0, 1, -1))


# ---------------------------------------------------------------- SQ8


@pytest.mark.parametrize("case", ["random", "half_boundaries"])
def test_sq8_codes_identical(rng, case):
    if case == "random":
        x = rng.standard_normal((50, 24)).astype(np.float32)
    else:  # max|x| = 127 -> scale 1: every x/scale is a .5 tie
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                      [3.5, -3.5, 4.5, 0.0, 64.5, -64.5, 100.5, -126.5]],
                     np.float32)
    codes_t, scale_t = sq8_quantize(torch.from_numpy(x))
    codes_j, scale_j = jax_sq8(jnp.asarray(x))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    assert float(scale_t) == float(scale_j)
    assert codes_t.dtype == torch.int8
    if case == "half_boundaries":  # half to even
        assert codes_t[0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]


# ------------------------------------------------------------- rescore


@pytest.mark.parametrize("metric", ["dot", "euclidean"])
@pytest.mark.parametrize("k", [3, 9])
def test_rescore_identical(rng, metric, k):
    """-1 sentinels in the candidates and, at k=9 > K1=6, padding."""
    codes = rng.integers(-127, 128, (40, 8)).astype(np.int8)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    cand = rng.integers(0, 40, (5, 6))
    cand[0, 2] = cand[3, :4] = -1
    cand[4, :] = -1
    args = (q, lambda idx: codes[idx], cand, k)
    s_t, i_t = exact_rescore_topk(*args, metric=metric, scale=0.02)
    s_j, i_j = jax_rescore(*args, metric=metric, scale=0.02)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(s_t, s_j)
    assert i_t.shape == (5, k) and (i_t[4] == -1).all()
    assert np.isneginf(s_t[4]).all()


# ------------------------------------------------- plain sign-dot top-k


@pytest.mark.parametrize("d", [64, 48])
@pytest.mark.parametrize("layout", ["rows", "transposed"])
def test_plain_binary_topk_matches_jax(rng, layout, d):
    x, q = _unit(rng, 4999, d), rng.standard_normal((16, d)).astype(np.float32)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    if layout == "rows":
        s_j, _ = jb.binary_topk(q, jb.binary_quantize(x), d=d, k=10,
                                recall_target=1.0)
        s_t, i_t = tb.binary_topk(qt, tb.binary_quantize(xt), d, 10,
                                  block_size=1024)
    else:
        s_j, _ = jb.binary_topk_t(q, jb.binary_quantize_t(x), d=d, k=10,
                                  recall_target=1.0)
        s_t, i_t = tb.binary_topk_t(qt, tb.binary_quantize_t(xt), d, 10,
                                    block_size=1024)
    np.testing.assert_allclose(np.sort(s_t.numpy()), np.sort(np.asarray(s_j)),
                               atol=1e-5)
    # the ids carry the scores they claim
    pm1 = torch.from_numpy(np.where(x >= 0, 1.0, -1.0).astype(np.float32))
    exact = (qt.bfloat16().float() @ pm1.T).gather(1, i_t)
    np.testing.assert_allclose(s_t.numpy(), exact.numpy(), atol=1e-5)


def test_plain_binary_topk_clips_k(rng):
    x = _unit(rng, 5, 64)
    s, i = tb.binary_topk(torch.from_numpy(x), tb.binary_quantize(
        torch.from_numpy(x)), 64, 9)
    assert s.shape == (5, 5) and (i[:, 0] == torch.arange(5)).all()


# ------------------------------------------ the binary kernel's plain version


def _kernel_case(rng, d, n=2100, nq=16):
    """N=2100 is not a multiple of block_n=512."""
    x, q = _unit(rng, n, d), rng.standard_normal((nq, d)).astype(np.float32)
    s_j, i_j = jax_pbt(jnp.asarray(q), jb.binary_quantize_t(x), d=d, k=10,
                       block_n=512, interpret=True)
    return x, q, np.asarray(s_j), np.asarray(i_j)


@pytest.mark.parametrize("d", [64, 48])
def test_binary_fused_topk_matches_pallas_interpret(rng, d):
    x, q, s_j, i_j = _kernel_case(rng, d)
    packed = tb.binary_quantize(torch.from_numpy(x))
    s_t, i_t = ft.binary_fused_topk(torch.from_numpy(q), packed, d=d, k=10,
                                    block_n=512)
    same = i_t.numpy() == i_j
    assert same.mean() >= 0.99
    np.testing.assert_allclose(s_t.numpy()[same], s_j[same], atol=1e-5)
    # the transposed-layout name gives the same answer
    s_p, i_p = ft.pallas_binary_topk(torch.from_numpy(q),
                                     tb.binary_quantize_t(torch.from_numpy(x)),
                                     d=d, k=10, block_n=512)
    np.testing.assert_array_equal(i_p.numpy(), i_t.numpy())
    np.testing.assert_array_equal(s_p.numpy(), s_t.numpy())


@pytest.mark.parametrize("d", [64, 48])
def test_binary_raw_reference_matches_pallas_interpret(rng, d):
    """The raw fold: the same candidate sets as the JAX kernel, and its
    19-bit-quantized scores within one key step of the exact sign-dots."""
    x, q, s_j, i_j = _kernel_case(rng, d)
    packed = tb.binary_quantize(torch.from_numpy(x))
    s_r, i_r = ft.binary_fused_topk_raw_reference(
        torch.from_numpy(q), packed, d=d, k=10, block_n=512)
    hits = np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(i_r.numpy().tolist(), i_j.tolist())])
    assert hits >= 0.99
    exact = torch.sum(  # the exact sign-dots of the fold's own ids
        torch.from_numpy(q).bfloat16().float()[:, None, :]
        * tb.binary_unpack(packed[i_r.long().reshape(-1)], d).float()
        .reshape(16, 10, d), dim=2)
    step = 2.0 ** -10 * exact.abs() + 1e-6  # 13 mantissa bits cut
    assert bool(((s_r - exact).abs() <= step).all())
    # the wrapper on a CPU tensor is this plain version
    s_w, i_w = ft.binary_fused_topk_raw(torch.from_numpy(q), packed, d=d,
                                        k=10, block_n=512)
    assert torch.equal(i_w, i_r) and torch.equal(s_w, s_r)


def test_approx_binary_route_recall(rng):
    """The route the store takes on the card, run here through the plain
    fold: candidates from ``fold_plan``, rescored to exact sign-dots."""
    x, q = _unit(rng, 5000, 64), rng.standard_normal((16, 64)).astype(
        np.float32)
    packed = tb.binary_quantize(torch.from_numpy(x))
    qt = torch.from_numpy(q)
    s0, _ = tb.binary_topk(qt, packed, 64, 80)
    s1, i1 = ft.approx_binary_fused_topk(qt, packed, d=64, k=80,
                                         recall_target=0.99)
    assert i1.shape == (16, 80) and bool((s1[:, :-1] >= s1[:, 1:]).all())
    # score multisets: the route finds the exact top-80 scores
    match = np.mean(np.sort(s1.numpy(), 1) == np.sort(s0.numpy(), 1))
    assert match >= 0.99
    # above the fold's 128 candidates the route is the exact search, and
    # past the exact kernel's 2048 its blocked route: the same answer
    for k in (129, 2049):
        s2, i2 = ft.approx_binary_fused_topk(qt, packed, d=64, k=k)
        s3, i3 = tb.binary_topk(qt, packed, 64, k)
        assert i2.dtype == torch.int32 and torch.equal(i2, i3.to(torch.int32))
        assert torch.equal(s2, s3)


@pytest.mark.parametrize("k", [160, 300])
@pytest.mark.parametrize("d", [64, 48])
def test_approx_binary_route_above_128_matches_jax(rng, d, k):
    """The binary store's stage 1 at ok = binary_oversample x k > 128 (k=20
    at 8x): the route gives the plain exact search's ids and scores, which
    are the JAX package's exact sign-dot top-k (``binary_topk`` at
    recall_target=1.0; the store calls it at dense.py:1172)."""
    x, q = _unit(rng, 3000, d), rng.standard_normal((16, d)).astype(np.float32)
    packed = tb.binary_quantize(torch.from_numpy(x))
    qt = torch.from_numpy(q)
    s_r, i_r = ft.approx_binary_fused_topk(qt, packed, d=d, k=k)
    s_p, i_p = tb.binary_topk(qt, packed, d, k)
    np.testing.assert_array_equal(i_r.numpy(), i_p.numpy())
    np.testing.assert_array_equal(s_r.numpy(), s_p.numpy())
    s_j, i_j = jb.binary_topk(q, jb.binary_quantize(x), d=d, k=k,
                              recall_target=1.0)
    # sign-dots tie where rows share their bits: ids on >= 99 % of slots,
    # scores as multisets
    assert np.mean(i_r.numpy() == np.asarray(i_j)) >= 0.99
    np.testing.assert_allclose(np.sort(s_r.numpy(), 1),
                               np.sort(np.asarray(s_j), 1), atol=1e-5)
    assert bool((s_r[:, :-1] >= s_r[:, 1:]).all())


def test_binary_exact_raw_plain_version(rng):
    """On a CPU tensor the exact binary entry is ``binary_topk`` with int32
    ids; k clips to N, and past the kernel's 2048 it answers (on the card
    the entry raises there)."""
    x = _unit(rng, 40, 48)
    packed = tb.binary_quantize(torch.from_numpy(x))
    q = torch.from_numpy(x[:3])
    s, i = ft.binary_exact_topk_raw(q, packed, d=48, k=50)
    assert s.shape == (3, 40) and i.dtype == torch.int32
    assert (i[:, 0] == torch.arange(3, dtype=torch.int32)).all()
    s, i = ft.binary_exact_topk_raw(
        q, torch.zeros((3000, 2), dtype=torch.int32), d=48, k=2049)
    # every row scores alike: ties go to the lower row
    assert s.shape == (3, 2049) and i.dtype == torch.int32
    assert (i == torch.arange(2049, dtype=torch.int32)).all()


def _stage_unpack_mirror(words: np.ndarray, d: int) -> np.ndarray:
    """numpy mirror of the binary fold's stage (csrc/fold_mma.cuh:
    fm_load_words, fm_unpack, fm_pm1x2): per 64-dim stage, row r's two
    words (0 past the row's last word), chunk ch of 8 dims = byte ch & 3 of
    word ch >> 2, each pair of bits one word of two bf16 (bit 0 in the low
    half; set -> 0x3F80, clear -> 0xBF80). Returns the bf16 bits
    [N, stages x 64] as uint16."""
    n, w = words.shape
    n_dch = -(-d // 64)
    out = np.empty((n, 64 * n_dch), np.uint16)
    for dci in range(n_dch):
        for ch in range(8):
            wi = 2 * dci + (ch >> 2)
            word = words[:, wi] if wi < w else np.zeros(n, np.uint32)
            b = (word >> np.uint32(8 * (ch & 3))) & np.uint32(0xFF)
            for p in range(4):
                t = b >> np.uint32(2 * p)
                pair = (np.uint32(0xBF80BF80)
                        ^ ((t & np.uint32(1)) << np.uint32(15))
                        ^ ((t & np.uint32(2)) << np.uint32(30)))
                col = 64 * dci + 8 * ch + 2 * p
                out[:, col] = (pair & np.uint32(0xFFFF)).astype(np.uint16)
                out[:, col + 1] = (pair >> np.uint32(16)).astype(np.uint16)
    return out


@pytest.mark.parametrize("d", [64, 48, 384])
def test_stage_unpack_mirror_matches_binary_unpack(rng, d):
    """The kernel's unpack gives +-1.0 bf16 equal to ``binary_unpack`` on
    dims < d; dims past d (pad bits, absent words) are finite (-1.0), and
    meet zero query dims, so the stage's sign-dots are the exact ones."""
    x = rng.standard_normal((130, d)).astype(np.float32)
    packed = tb.binary_quantize(torch.from_numpy(x))
    bits = _stage_unpack_mirror(_words(packed), d)
    assert set(np.unique(bits).tolist()) <= {0x3F80, 0xBF80}
    vals = (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)
    np.testing.assert_array_equal(vals[:, :d],
                                  tb.binary_unpack(packed, d).numpy())
    np.testing.assert_array_equal(vals[:, d:], -1.0)
    q = rng.standard_normal((5, d)).astype(np.float32)
    qb = torch.from_numpy(q).bfloat16().float().numpy()
    q_pad = np.zeros((5, vals.shape[1]), np.float32)  # the query tile
    q_pad[:, :d] = qb
    want = qb @ np.where(x >= 0, 1.0, -1.0).astype(np.float32).T
    np.testing.assert_allclose(q_pad @ vals.T, want, rtol=1e-6, atol=1e-6)
    # the 1024 chunks of a stage land on distinct 16-byte slots of the
    # swizzled [128][64] bf16 stage (fm_swz)
    slots = {r * 128 + ((ch ^ (r & 7)) << 4)
             for r in range(128) for ch in range(8)}
    assert len(slots) == 1024 and max(slots) == 128 * 128 - 16


def test_binary_wrapper_validates():
    q = torch.zeros(2, 64)
    packed = torch.zeros(300, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="k <= 128"):
        ft.binary_fused_topk_raw(q, packed, d=64, k=129)
    with pytest.raises(ValueError, match="int32 sign words"):
        ft.binary_fused_topk_raw(q, packed.long(), d=64, k=3)
    with pytest.raises(ValueError, match="int32 sign words"):
        ft.binary_fused_topk_raw(torch.zeros(2, 96), packed, d=96, k=3)
    with pytest.raises(ValueError, match="dim"):
        ft.binary_fused_topk_raw(torch.zeros(2, 48), packed, d=64, k=3)
    with pytest.raises(ValueError, match="multiple of"):
        ft.binary_fused_topk_raw(q, packed, d=64, k=3, block_n=200)


# --------------------------------------------------------------- store


def _stores(rng, n=3000, d=64, oversample=8):
    """Each store builds from its own copy: ``torch.as_tensor`` shares the
    caller's numpy buffer, and the JAX store must not see the port's."""
    emb = rng.standard_normal((n, d)).astype(np.float32)
    texts = [f"t{i}" for i in range(n)]
    j = JaxDense(store_dtype="binary", backend="xla",
                 binary_oversample=oversample)
    j.build(emb.copy(), texts)
    t = DenseRetriever(store_dtype="binary", binary_oversample=oversample,
                       device="cpu")
    t.build(emb.copy(), texts)
    return emb, j, t


@pytest.mark.parametrize("k", [1, 10, 20])
def test_binary_store_matches_jax(rng, k):
    emb, j, t = _stores(rng)
    # the stores first: only the packed words live on the device, the
    # SQ8 codes and their scale on the host, all bit-identical
    assert t._corpus.dtype == torch.int32 and t._corpus.shape == (3000, 2)
    np.testing.assert_array_equal(_words(t._corpus),
                                  np.asarray(j._corpus_dev))
    np.testing.assert_array_equal(t._rescore_host, j._rescore_host)
    assert t._corpus_scale == float(j._corpus_scale)
    q = rng.standard_normal((13, 64)).astype(np.float32)
    s_j, i_j = j.search(q.copy(), k)
    s_t, i_t = t.search(q.copy(), k)
    same = i_t == i_j
    assert same.mean() >= 0.99
    np.testing.assert_allclose(s_t[same], s_j[same], atol=1e-5)


def test_binary_store_self_check_and_clamps(rng, caplog):
    emb, j, t = _stores(rng, n=7, d=48)
    assert t._self_check() and j._self_check()
    assert "self-check failed" not in caplog.text
    # k > N: ok clamps to N, and the tail slots are (-inf, -1)
    s_t, i_t = t.search(emb[:3], 9)
    s_j, i_j = j.search(emb[:3], 9)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, atol=1e-5)
    assert (i_t[:, 7:] == -1).all() and np.isneginf(s_t[:, 7:]).all()
    assert (i_t[:, 0] == np.arange(3)).all()
    texts, scores, ids = t.retrieve(emb[2], top_k=9)
    assert len(texts) == 7 and ids[0] == 2


def test_binary_store_refused_combinations():
    with pytest.raises(ValueError, match="cosine/dot"):
        DenseRetriever(store_dtype="binary", metric="euclidean", device="cpu")
    for backend in ("xla_exact", "pallas_exact"):
        with pytest.raises(ValueError, match="exact oracle"):
            DenseRetriever(store_dtype="binary", backend=backend,
                           device="cpu")
    for store in ("int8", "int4"):
        with pytest.raises(NotImplementedError, match="item 15"):
            DenseRetriever(store_dtype=store, device="cpu")
    r = DenseRetriever(store_dtype="binary", metric="dot", device="cpu")
    r.build(np.eye(4, 8, dtype=np.float32), list("abcd"))
    with pytest.raises(NotImplementedError, match="item 12"):
        r.search(np.eye(1, 8, dtype=np.float32), 2, filter={"doc_ids": [0]})


def test_factory_passes_binary_oversample(rng):
    cfg = apply_overrides(Config(), ["retrieval.store_dtype=binary",
                                     "retrieval.binary_oversample=3"])
    emb = rng.standard_normal((20, 16)).astype(np.float32)
    r = build_retriever(emb, [str(i) for i in range(20)], None,
                        cfg.retrieval, device="cpu")
    assert r.binary_oversample == 3 and r.store_dtype == "binary"


# ------------------------------------------------------------ pipeline


def test_binary_pipeline_matches_jax(tmp_path):
    """The pipeline with ``retrieval.store_dtype=binary`` on the same
    synthetic data, VAE .pth and encoder weights: the port on the CPU and
    the JAX package retrieve the same docs and score the same metrics."""
    base = str(tmp_path)
    ov = [
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", f"retrieval.index_path={base}/index",
        f"logging.log_file={base}/logs/run.log",
        "data.dataset=synthetic", "data.max_samples=60",
        "encoder.vocab_size=800", "encoder.dtype=float32",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={base}/vae.pth",
        "retrieval.store_dtype=binary",
    ]
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg_j = jax_overrides(JaxConfig(), ov)
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
    np.testing.assert_allclose(got["doc_scores"], want["doc_scores"],
                               atol=1e-5)


# ----------------------------------------------------------- the build


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ must change the library's name, or a
    stale library would load."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n#include <stdint.h>\n')
    (tmp_path / "k.cuh").write_text('#include "k2.cuh"\n')
    (tmp_path / "k2.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    assert cuda_build.sources("k") == ["k.cu", "k.cuh", "k2.cuh"]
    before = cuda_build.library_path("k")
    (tmp_path / "k2.cuh").write_text("// v2\n")
    after = cuda_build.library_path("k")
    assert before != after
    assert os.path.basename(after).startswith("k-")
