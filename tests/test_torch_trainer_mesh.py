"""The port's data-parallel AE trainer (``Trainer(..., mesh=)``) on an
8-entry ``cpu`` mesh against the port on one device and against the JAX
package's ``Trainer(mesh=make_mesh(8))`` on pytest's 8 virtual CPU devices,
from the same init (the JAX params carried across) and seeded data.

* the DAE's latents after 3 epochs: the mesh against one device and
  against JAX's mesh within rtol 2e-3 / atol 2e-4, the JAX test's own
  limits (tests/test_trainer.py);
* the CAE with ``mine_hard_negatives``: the mesh's first-step loss and
  gradients equal one device's within 1e-6 (its negatives are mined over
  the global batch), and its fit within the DAE's limits;
* the VAE from one seed: one global noise draw split over the shards, so
  its fit's losses match one device's within 1e-5 relative and its latents
  within the DAE's limits;
* the batch rounded to a multiple of the mesh, a ragged batch's loss the
  whole batch's;
* the first step at the configs' AE widths and batch (the worker's
  ``config`` shape, 384 -> 512 -> 64, batch 128) on 4 shards: loss and
  gradients (``Trainer.step_grads``) equal one device's within 1e-6;
* two gloo processes of 4 shards each (``scripts/torch_trainer_worker.py``,
  a 120 s rendezvous limit) against this process on one device, within
  the DAE's limits, their first step's global loss and gradients (summed
  over the processes) within 1e-6 of one device's, and their resume from
  the files rank 0 wrote.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from latentrag_tpu.models import build_autoencoder as jax_build
from latentrag_tpu.models import encode_latents
from latentrag_tpu.models.autoencoders import init_autoencoder as jax_init
from latentrag_tpu.parallel import make_mesh as jax_make_mesh
from latentrag_tpu.training import trainer as jt
from latentrag_torch.models import autoencoder_state_dict_from_jax
from latentrag_torch.models import build_autoencoder
from latentrag_torch.parallel import make_mesh
from latentrag_torch.training import trainer as tt
from latentrag_torch.utils.config import AutoencoderConfig, TrainingConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_trainer_worker.py")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_trainer_worker as worker  # noqa: E402

ACFG = AutoencoderConfig(input_dim=32, latent_dim=8, hidden_dim=16)
RTOL, ATOL = 2e-3, 2e-4  # the JAX test's data-parallel limits
STEP_TOL = 1e-6


def _data(seed, n, ae_type):
    rng = np.random.default_rng(seed)
    if ae_type == "cae":
        return {k: rng.standard_normal((n, 32)).astype(np.float32)
                for k in ("q", "p")}
    y = rng.standard_normal((n, 32)).astype(np.float32)
    return {"x": y + 0.05 * rng.standard_normal(y.shape).astype(np.float32),
            "y": y}


def _probe():
    return np.random.default_rng(11).standard_normal((4, 32)).astype(
        np.float32)


def _latents(trainer):
    with torch.no_grad():
        z = trainer.model.encode(torch.from_numpy(_probe()))
    return (z[0] if isinstance(z, tuple) else z).numpy()


def _init(ae_type, seed=0):
    p0 = jax.tree.map(np.asarray, jax_init(jax_build(ae_type, ACFG),
                                           jax.random.PRNGKey(seed), 32))
    return p0, autoencoder_state_dict_from_jax(p0, ae_type)


def _fit(ae_type, cfg, mesh=None, init=None, data=None):
    trainer = tt.Trainer(build_autoencoder(ae_type, ACFG), ae_type, cfg,
                         device="cpu", mesh=mesh)
    train, val = data or (_data(2, 128, ae_type), _data(3, 40, ae_type))
    res = trainer.fit(train, val, init_state=init)
    return trainer, res


@pytest.fixture(scope="module")
def mesh(eight_devices):
    return make_mesh(devices=["cpu"] * 8)


DP = {
    "dae": TrainingConfig(batch_size=32, epochs=3, learning_rate=1e-2,
                          early_stop_patience=100, seed=7),
    "cae": TrainingConfig(batch_size=32, epochs=3, learning_rate=1e-2,
                          weight_decay=1e-4, grad_clip_norm=1.0,
                          mine_hard_negatives=True, early_stop_patience=100,
                          seed=7),
}


@pytest.mark.parametrize("ae_type", ["dae", "cae"])
def test_mesh_matches_one_device_and_jax_mesh(mesh, ae_type):
    cfg = DP[ae_type]
    p0, sd0 = _init(ae_type)
    t1, r1 = _fit(ae_type, cfg, init=sd0)
    tm, rm = _fit(ae_type, cfg, mesh, init=sd0)
    z1, zm = _latents(t1), _latents(tm)
    np.testing.assert_allclose(zm, z1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.array(rm.history), np.array(r1.history),
                               rtol=1e-4)
    model = jax_build(ae_type, ACFG)
    train, val = _data(2, 128, ae_type), _data(3, 40, ae_type)
    want = jt.Trainer(model, ae_type, cfg, mesh=jax_make_mesh(8)).fit(
        train, val, init_params=p0)
    zj = np.asarray(encode_latents(model, want.params, _probe()))
    np.testing.assert_allclose(zm, zj, rtol=RTOL, atol=ATOL)
    assert rm.epochs_ran == want.epochs_ran
    # the replicas hold the trained parameters (one device here: none)
    assert tm.replicas == {}


def test_cae_first_step_mines_over_the_global_batch(mesh):
    cfg = DP["cae"]
    _, sd0 = _init("cae", seed=1)
    batch = _data(5, 32, "cae")
    t1 = tt.Trainer(build_autoencoder("cae", ACFG), "cae", cfg, device="cpu")
    tm = tt.Trainer(build_autoencoder("cae", ACFG), "cae", cfg, device="cpu",
                    mesh=mesh)
    grads = []
    for t in (t1, tm):
        t.model.load_state_dict(sd0)
        b = t._device_batch(batch)
        assert isinstance(b, tt.ShardedBatch) == (t is tm)
        loss = t.loss(b)
        grads.append((loss.item(), tt.grads_of(loss, t.params)))
    (l1, g1), (lm, gm) = grads
    assert abs(lm - l1) <= STEP_TOL
    for a, b in zip(g1, gm):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=STEP_TOL)
    # mined per shard (4 rows each) the loss would differ
    per_shard = np.mean([
        t1.loss({k: torch.from_numpy(v[i:i + 4]) for k, v in batch.items()}
                ).item() for i in range(0, 32, 4)])
    assert abs(per_shard - l1) > 1e-3


@pytest.mark.parametrize("ae_type", ["dae", "cae"])
def test_first_step_at_config_widths(ae_type):
    shape = worker.SHAPES["config"]
    mesh4 = make_mesh(devices=["cpu"] * 4)
    l1, g1 = worker.first_step(ae_type, "cpu", shape=shape)
    lm, gm = worker.first_step(ae_type, "cpu", mesh4, shape)
    assert g1[0].shape == (shape.hidden_dim, shape.input_dim)
    assert abs(lm - l1) <= STEP_TOL
    for a, b in zip(g1, gm):
        np.testing.assert_allclose(b, a, atol=STEP_TOL)


def test_vae_same_seed_trains_alike(mesh):
    cfg = TrainingConfig(batch_size=32, epochs=2, learning_rate=1e-2,
                         early_stop_patience=100, seed=3)
    _, sd0 = _init("vae", seed=2)
    t1, r1 = _fit("vae", cfg, init=sd0)
    tm, rm = _fit("vae", cfg, mesh, init=sd0)
    np.testing.assert_allclose(np.array(rm.history), np.array(r1.history),
                               rtol=1e-5)
    np.testing.assert_allclose(_latents(tm), _latents(t1), rtol=RTOL,
                               atol=ATOL)


def test_batch_rounding_and_ragged_batch(mesh):
    cfg = TrainingConfig(batch_size=30, epochs=1, learning_rate=1e-2)
    tm = tt.Trainer(build_autoencoder("dae", ACFG), "dae", cfg, device="cpu",
                    mesh=mesh)
    data = _data(4, 60, "dae")
    train = list(tm._batches(data, 30, np.random.default_rng(0)))
    # 30 rounds down to 24: two sharded batches, the 12-row tail dropped
    assert [b.rows for b in train] == [24, 24]
    assert all(isinstance(b, tt.ShardedBatch) and len(b.parts) == 8
               and b.parts[0]["x"].shape[0] == 3 for b in train)
    val = list(tm._batches(data, 30, drop_last=False))
    assert [type(b).__name__ for b in val] == ["ShardedBatch",
                                              "ShardedBatch", "dict"]
    tail = val[2]
    assert tail["x"].shape[0] == 12  # ragged: the whole batch, unsharded
    t1 = tt.Trainer(build_autoencoder("dae", ACFG), "dae", cfg, device="cpu")
    t1.model.load_state_dict(tm.model.state_dict())
    assert tm.eval_step(tail).item() == t1.eval_step(tail).item()
    # a batch size below the mesh rounds up to one row a shard
    assert [b.rows for b in tm._batches(data, 5)] == [8] * 7
    # a dataset smaller than the batch: one batch of every row (ragged)
    small = _data(4, 13, "dae")
    (only,) = list(tm._batches(small, 32, np.random.default_rng(0)))
    assert isinstance(only, dict) and only["x"].shape[0] == 13
    tm.train_step(only)  # a whole-batch step on the first device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    base = tmp_path_factory.mktemp("trainer_mp")
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
        assert f"TORCH_TRAINER_OK process={rank}/2 shards=8" in out, out
    return base, [dict(np.load(base / f"res.{r}.npz")) for r in range(2)]


def test_two_processes_agree_and_match_one_device(two_processes):
    base, (a, b) = two_processes
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for ae_type in ("dae", "cae"):
        t1, r1 = worker.train(ae_type, 3, "cpu")
        np.testing.assert_allclose(a[f"{ae_type}_latents"],
                                   worker.probe_latents(t1), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(a[f"{ae_type}_history"],
                                   np.array(r1.history), rtol=1e-4)
    # rank 0 alone wrote the files; both resumed from them at epoch 3
    assert os.path.isfile(base / "ckpt" / "dae.pth")
    assert os.path.isfile(base / "ckpt" / "dae.train.pt")
    np.testing.assert_array_equal(a["dae_resumed_epochs"], [3])


def test_replica_on_a_second_device(eight_devices):
    """Shards on two distinct devices (``cpu`` and ``cpu:0``): the second
    holds a replica, whose gradients join the first device's, and which
    takes every update."""
    mesh2 = make_mesh(devices=["cpu", "cpu:0"] * 4)
    cfg = DP["dae"]
    _, sd0 = _init("dae")
    t1, r1 = _fit("dae", cfg, init=sd0)
    tm, rm = _fit("dae", cfg, mesh2, init=sd0)
    assert list(tm.replicas) == [torch.device("cpu:0")]
    np.testing.assert_allclose(_latents(tm), _latents(t1), rtol=RTOL,
                               atol=ATOL)
    rep = tm.replicas[torch.device("cpu:0")]
    for p_r, p in zip(rep.parameters(), tm.params):
        assert torch.equal(p_r, p)


@pytest.mark.parametrize("ae_type", ["dae", "cae"])
def test_two_processes_first_step_gradients(two_processes, ae_type):
    """The first step's global loss and gradient, summed over the shards
    and the two processes, against one device's ``grads_of``: a gradient
    off by a constant factor (the loss not divided by the world size, a
    gather's backward summed twice) fails here, where Adam and the CAE's
    clipping would hide it from the latents."""
    _, (a, _) = two_processes
    t1, _ = worker.train(ae_type, 0, "cpu")
    batch = t1._device_batch(worker.data(ae_type, worker.SMALL.batch, 5))
    loss = t1.loss(batch)
    want = tt.grads_of(loss, t1.params)
    assert abs(float(a[f"{ae_type}_step_loss"]) - loss.item()) <= STEP_TOL
    for i, g in enumerate(want):
        np.testing.assert_allclose(a[f"{ae_type}_step_grad_{i}"],
                                   g.numpy(), atol=STEP_TOL)
