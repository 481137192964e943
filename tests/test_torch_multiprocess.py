"""The port's sharded paths across a real process boundary: two worker
processes (``scripts/torch_multiproc_worker.py``, importing only the
port) on gloo, 4 ``cpu`` shards each, one 8-shard global mesh. Their
results are held against each other and against the JAX package's
8-device results on the same seeded inputs (ids bit for bit, scores
within 1e-5); the sharded checkpoint and the sharded store they saved
together load in this one process, on an 8-shard mesh and without one,
and search as they did."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.ops.knn import knn_graph as jax_knn_graph
from latentrag_tpu.parallel import make_mesh as jax_make_mesh
from latentrag_tpu.parallel import make_sharded_topk as jax_sharded_topk
from latentrag_tpu.parallel import shard_rows as jax_shard_rows
from latentrag_torch.parallel import (
    initialize_distributed,
    load_sharded_index,
    make_mesh,
    make_sharded_topk,
)
from latentrag_torch.retrieval import DenseRetriever

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_multiproc_worker.py")
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_multiproc_worker import data  # noqa: E402

N, D, NQ, K = 1001, 32, 16, 10
SCORE_TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    base = tmp_path_factory.mktemp("mp")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--process_id", str(r),
         "--num_processes", "2", "--coordinator", f"localhost:{port}",
         "--local_devices", "4", "--out", str(base / "res"),
         "--checkpoint_dir", str(base / "ckpt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"worker {rank} failed (rc={rc}):\n{out}"
        assert f"TORCH_MULTIPROC_OK process={rank}/2 shards=8" in out, out
        assert "sharded checkpoint round-trip ok" in out, out
    res = [dict(np.load(base / f"res.{r}.npz")) for r in range(2)]
    return base, res


def test_both_processes_agree(workers):
    _, (a, b) = workers
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _jax_search(q, c, backend="exact", scale=None, d=None, mask=None, k=K):
    jm = jax_make_mesh(8)
    fn = jax_sharded_topk(jm, k=k, backend=backend, d=d,
                          filtered=mask is not None)
    s, i = fn(jnp.asarray(q), jax_shard_rows(jnp.asarray(c), jm),
              jnp.int32(N), None if scale is None else jnp.float32(scale),
              mask_shard=None if mask is None
              else jax_shard_rows(jnp.asarray(mask), jm))
    return np.asarray(s), np.asarray(i)


def _same(got_s, got_i, want_s, want_i):
    np.testing.assert_array_equal(got_i, want_i)
    live = got_i >= 0
    np.testing.assert_allclose(got_s[live], want_s[live], atol=SCORE_TOL,
                               rtol=SCORE_TOL)


def test_sharded_searches_match_jax(workers, eight_devices):
    _, (res, _) = workers
    corpus, queries, mask = data(N, D, NQ)
    _same(res["exact_s"], res["exact_i"], *_jax_search(queries, corpus))
    _same(res["filtered_s"], res["filtered_i"],
          *_jax_search(queries, corpus, mask=mask))
    _same(res["sq8_s"], res["sq8_i"],
          *_jax_search(queries, res["codes"], "sq8", res["scale"]))
    from latentrag_torch.ops.binary import binary_quantize

    words = binary_quantize(torch.tensor(corpus)).numpy().view(np.uint32)
    _same(res["binary_s"], res["binary_i"],
          *_jax_search(queries, words, "binary", d=D, k=4 * K))


def test_ring_knn_across_processes_matches_jax(workers):
    _, (res, _) = workers
    corpus, _, _ = data(N, D, NQ)
    want = jax_knn_graph(jnp.asarray(corpus[:203]), 8, exact=True)
    np.testing.assert_array_equal(res["knn"], np.asarray(want))


def test_two_process_checkpoint_loads_in_one_process(workers):
    """The shards both processes wrote, on an 8-shard mesh in this
    process and on one device: the workers' search bit for bit."""
    base, (res, _) = workers
    corpus, queries, _ = data(N, D, NQ)
    path = str(base / "ckpt" / "sharded")
    mesh = make_mesh(devices=["cpu"] * 8)
    c_sh, meta = load_sharded_index(path, mesh)
    assert meta["p"] == 8 and meta["n"] == N
    s, i = make_sharded_topk(mesh, k=K, backend="exact")(
        torch.tensor(queries), c_sh, N)
    np.testing.assert_array_equal(i.numpy(), res["exact_i"])
    np.testing.assert_array_equal(s.numpy(), res["exact_s"])
    whole, _ = load_sharded_index(path, device="cpu")
    np.testing.assert_array_equal(whole[:N].numpy(), corpus)


@pytest.mark.parametrize("p", [8, None])
def test_two_process_dense_store_loads_in_one_process(workers, p):
    base, (res, _) = workers
    _, queries, _ = data(N, D, NQ)
    r = DenseRetriever(backend="xla_exact", store_dtype="float32",
                       device="cpu",
                       mesh=None if p is None else make_mesh(
                           devices=["cpu"] * p),
                       index_path=str(base / "ckpt" / "dense"))
    assert r.is_built and r._corpus_n == N
    s, i = r.search(queries, K)
    np.testing.assert_array_equal(i, res["dense_i"])
    np.testing.assert_array_equal(s, res["dense_s"])


def test_sharded_ivf_across_processes(workers):
    """The workers' sharded IVF (each process its 4 shards, the padded
    block count agreed between them) rebuilt in this process on an
    8-shard mesh from the centroids and assignments they gathered: the
    same block count and search, bit for bit; and the IVF store they saved
    warm-boots here from its ``ivf_mesh_p`` sidecar and searches as they
    did."""
    from latentrag_torch.parallel import shard_rows
    from latentrag_torch.parallel.ivf import (
        build_sharded_ivf_from_assign,
        make_sharded_ivf_topk,
    )

    base, (res, _) = workers
    corpus, queries, _ = data(N, D, NQ)
    mesh = make_mesh(devices=["cpu"] * 8)
    sivf = build_sharded_ivf_from_assign(
        shard_rows(torch.tensor(corpus), mesh), mesh, res["ivf_cent"],
        res["ivf_assign"], 16)
    assert sivf.nblocks == int(res["ivf_nblocks"])
    assert sivf.max_list_blocks == int(res["ivf_mlb"])
    s, i = make_sharded_ivf_topk(mesh, k=K, nprobe=8)(
        torch.tensor(queries), sivf, N)
    np.testing.assert_array_equal(i.numpy(), res["ivf_i"])
    np.testing.assert_array_equal(s.numpy(), res["ivf_s"])
    r = DenseRetriever(backend="xla", store_dtype="float32", device="cpu",
                       mesh=mesh, ivf_nlist=32, ivf_cap=16, ivf_nprobe=8,
                       index_path=str(base / "ckpt" / "dense_ivf"))
    r.IVF_MIN_ROWS = 512
    assert r._ivf_sidecar is not None
    s, i = r.search(queries, K)
    assert r._ivf_build_info["restored"] is True
    np.testing.assert_array_equal(i, res["dense_ivf_i"])
    np.testing.assert_array_equal(s, res["dense_ivf_s"])


def test_initialize_distributed_noop_and_failure(monkeypatch):
    """No coordinator: a no-op returning False. An init that was asked
    for and fails raises (the JAX function only warns)."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False
    # rank 1 of 2 finds no rendezvous on a closed port within 2 s
    with pytest.raises(RuntimeError, match="init_process_group"):
        initialize_distributed(f"localhost:{_free_port()}", 2, 1,
                               backend="gloo", timeout=2)
