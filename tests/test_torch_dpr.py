"""The port's DPR (``retrieval/dpr.py``, ``training/train_dpr.py``'s
``build_dpr_encoders``) against the JAX package's: tower checkpoints saved
by the JAX package load in the port and give the same [CLS] embeddings,
and the dual-encoder store retrieves the same ids."""

import os

import numpy as np
import pytest
import torch

from latentrag_torch.retrieval import DPRRetriever
from latentrag_torch.training import build_dpr_encoders
from latentrag_torch.utils import Config, apply_overrides
from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.models.encoder.convert import save_params
from latentrag_tpu.retrieval.dpr import DPRRetriever as JaxDPR
from latentrag_tpu.training.train_dpr import (
    build_dpr_encoders as jax_build_dpr_encoders,
)
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides

# |port - JAX| of a [CLS] embedding. fp32 mode: within 1e-6 of the value
# (the rows are unnormalized, |x| up to ~3, where two fp32 sum orders
# differ by up to 1.07e-6, 7.1e-7 of the value). bf16 mode: the encoder's
# band (tests/test_torch_models.py), which holds unit rows at the encoder's
# width, so it is held at width 384 on the rows over the JAX row's norm
# (one bf16 rounding of an unnormalized |x| ~ 2 is already ~4e-3)
FP32_TOL = 1e-6
BF16_BAND = 5e-3
# (hidden, layers, heads, mlp) of each mode's towers
GEOMETRY = {"float32": (32, 2, 4, 64), "bfloat16": (384, 2, 12, 1536)}


def _overrides(base, dtype):
    hidden, layers, heads, mlp = GEOMETRY[dtype]
    return [f"paths.data_dir={base}/data",
            f"paths.checkpoints_dir={base}/ckpt",
            "encoder.vocab_size=800", f"encoder.dtype={dtype}",
            f"encoder.hidden_dim={hidden}", f"encoder.num_layers={layers}",
            f"encoder.num_heads={heads}", f"encoder.mlp_dim={mlp}"]


def _towers(tmp_path, dtype, save=True):
    """The JAX towers (their params saved as the JAX package's tower
    checkpoints when ``save``) and the port's from build_dpr_encoders."""
    base = str(tmp_path)
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    ov = _overrides(base, dtype)
    jq, jc = jax_build_dpr_encoders(jax_overrides(JaxConfig(), ov), corpus)
    if save:
        for enc, name in ((jq, "dpr_question"), (jc, "dpr_context")):
            save_params(enc.params, f"{base}/ckpt/{name}.msgpack")
    tq, tc = build_dpr_encoders(apply_overrides(Config(), ov), corpus,
                                device="cpu")
    return (queries, corpus, relevant), (jq, jc), (tq, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_tower_checkpoints_load_in_port(tmp_path, dtype):
    (queries, corpus, _), (jq, jc), (tq, tc) = _towers(tmp_path, dtype)
    for j, t, texts in ((jq, tq, queries), (jc, tc, corpus)):
        assert t.cfg.pooling == "cls" and not t.cfg.normalize
        want = np.asarray(j.encode_batch(texts), np.float32)
        got = t.encode_batch(texts)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        # unnormalized [CLS] rows, not unit vectors
        assert not np.allclose(np.linalg.norm(want, axis=1), 1.0)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL,
                                       rtol=FP32_TOL)
        else:
            scale = np.linalg.norm(want, axis=1, keepdims=True)
            assert (np.abs(got.numpy() - want) / scale).max() <= BF16_BAND
    # the two towers are distinct
    assert not torch.allclose(tq.encode_batch(corpus[:4]),
                              tc.encode_batch(corpus[:4]))


def test_towers_without_checkpoints_take_seeded_init(tmp_path):
    """No tower file: seeded towers (torch.Generator seeds 1 and 2), the
    same on every call and different from each other."""
    (_, corpus, _), _, (tq, tc) = _towers(tmp_path, "float32", save=False)
    assert not os.path.exists(f"{tmp_path}/ckpt/dpr_question.msgpack")
    again = build_dpr_encoders(
        apply_overrides(Config(), _overrides(str(tmp_path), "float32")),
        corpus, device="cpu")
    for a, b in zip((tq, tc), again):
        torch.testing.assert_close(a.encode_batch(corpus[:5]),
                                   b.encode_batch(corpus[:5]),
                                   rtol=0, atol=0)
    assert not torch.allclose(tq.encode_batch(corpus[:5]),
                              tc.encode_batch(corpus[:5]))


@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_dpr_retriever_matches_jax(tmp_path, metric):
    """The float32 store with xla_exact (the differential-parity mode):
    the same ids and scores as the JAX DPRRetriever, filters included."""
    (queries, corpus, relevant), (jq, jc), (tq, tc) = _towers(
        tmp_path, "float32")
    j = JaxDPR(jq, jc, metric=metric, backend="xla_exact",
               store_dtype="float32")
    t = DPRRetriever(tq, tc, metric=metric, backend="xla_exact",
                     store_dtype="float32")
    j.build_index(corpus)
    t.build_index(corpus)
    assert t.dense.metric == metric and t.dense.device.type == "cpu"
    for k, flt in ((10, None), (5, {"doc_ids": list(range(0, 60, 3))})):
        (ts, ti), (js, ji) = t.search(queries, k, filter=flt), j.search(
            queries, k, filter=flt)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-5, atol=1e-5)
    got, want = t.retrieve(queries[0], 3), j.retrieve(queries[0], 3)
    assert [x for x, _ in got] == [x for x, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5, atol=1e-5)
    assert t.get_stats()["search_calls"] == 3


def test_dpr_default_store_is_bf16_dot(tmp_path):
    """The defaults: metric dot over unnormalized rows, backend auto, bf16
    store; ids equal the float32 store's on most slots (bf16 rounding
    moves near-ties only)."""
    (queries, corpus, _), _, (tq, tc) = _towers(tmp_path, "float32")
    r = DPRRetriever(tq, tc)
    assert (r.dense.metric, r.dense.backend, r.dense.store_dtype) == (
        "dot", "auto", "bfloat16")
    r.build_index(corpus)
    exact = DPRRetriever(tq, tc, backend="xla_exact", store_dtype="float32")
    exact.build_index(corpus)
    _, ib = r.search(queries, 10)
    _, ie = exact.search(queries, 10)
    assert (ib == ie).mean() >= 0.9
