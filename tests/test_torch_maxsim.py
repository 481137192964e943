"""MaxSim doc aggregation of the pipeline (``pipeline.aggregate_docs``)
against the JAX package's ``maxsim_aggregate`` as its pipeline calls it:
identical doc ids, doc scores and metrics, with tied chunk scores,
several chunks of one doc among the candidates, and empty slots (-1).
On the CPU the device placement is the CPU; ``tests/test_torch_cuda.py``
holds the card's placement to this one."""

import jax.numpy as jnp
import numpy as np
import pytest

from latentrag_tpu.ops.topk import maxsim_aggregate as jax_maxsim
from latentrag_torch.evaluation import evaluate_retrieval
from latentrag_torch.pipeline import aggregate_docs


def tied_candidates(rng, nq=40, c=30, n_chunks=200, n_docs=25):
    """Search-shaped candidates: scores sorted descending with runs of
    exact ties, chunk ids drawn so docs repeat in a row, a few trailing
    empty slots, and a chunk -> doc map with several chunks a doc."""
    levels = np.round(rng.standard_normal((nq, c)), 1).astype(np.float32)
    scores = -np.sort(-levels, axis=1)
    idx = rng.integers(0, n_chunks, (nq, c)).astype(np.int64)
    idx[:5, -3:] = -1
    scores[:5, -3:] = -np.inf
    doc_ids = list(rng.integers(0, n_docs, n_chunks))
    return scores, idx, doc_ids


def jax_pipeline_aggregate(scores, idx, doc_ids, k):
    """latentrag_tpu/pipeline.py's MaxSim step."""
    chunk_doc = np.asarray([doc_ids[j] if j >= 0 else -1 for j in idx.ravel()],
                           dtype=np.int64).reshape(idx.shape)
    scores = np.where(idx >= 0, scores, -3.4e38).astype(np.float32)
    ds, dt = jax_maxsim(jnp.asarray(scores),
                        jnp.asarray(chunk_doc.astype(np.int32)), k=k)
    ds, dt = np.asarray(ds), np.asarray(dt)
    return ds, [[int(d) for d, s in zip(row, srow) if s > -1e37 and d >= 0]
                for row, srow in zip(dt, ds)]


@pytest.mark.parametrize("k", [5, 10, 30])
def test_aggregate_docs_matches_jax(rng, k):
    scores, idx, doc_ids = tied_candidates(rng)
    assert (scores[:, 1:] == scores[:, :-1]).any()  # ties
    ds, ids = aggregate_docs(scores, idx, doc_ids, k, "cpu")
    ds_j, ids_j = jax_pipeline_aggregate(scores, idx, doc_ids, k)
    assert ids == ids_j
    np.testing.assert_array_equal(ds, ds_j)
    relevant = [int(r) for r in rng.integers(0, 25, len(ids))]
    assert (evaluate_retrieval(ids, relevant)
            == evaluate_retrieval(ids_j, relevant))
    # the case repeats docs among a query's candidates
    cand_docs = np.asarray(doc_ids)[np.maximum(idx, 0)]
    assert any(len(set(row)) < len(row) for row in cand_docs)
