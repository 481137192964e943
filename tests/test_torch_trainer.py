"""The port's AE trainer (``latentrag_torch/training/trainer.py``, the
VAE's training forward, ``train.py`` and ``pipeline.load_autoencoder``
over its checkpoints) against the JAX package's on the CPU.

* the optimizer: 5 steps from identical grads against
  ``_make_optimizer``'s optax chain (Adam, AdamW, the clip active and
  not, ``_scale_lr`` between steps): params within 1e-6 relative;
* ``fit`` for the DAE and the CAE from the JAX init carried across, fp32:
  every epoch's train and val loss within 1e-4 relative, the same
  ``epochs_ran`` / ``stopped_early`` (patience 1 included), and the
  params after the fit held in two parts, since Adam's first steps turn
  any gradient into +-lr: >= 99.9 % of elements within 1e-5 and every
  element within 2 * lr * steps;
* the VAE step with the JAX side's own normal draw as the port's eps;
* resume, in both packages from their own files;
* the ``.pth`` through ``load_autoencoder`` and the JAX reference reader;
* ``python -m latentrag_torch.training.train`` then ``main`` on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latentrag_tpu.models import build_autoencoder as jax_build
from latentrag_tpu.models import encode_latents
from latentrag_tpu.models.autoencoders import init_autoencoder as jax_init
from latentrag_tpu.models.convert_torch import load_reference_checkpoint
from latentrag_tpu.training import trainer as jt
from latentrag_tpu.training.losses import vae_loss as jax_vae_loss
from latentrag_torch import main as port_main
from latentrag_torch.models import autoencoder_state_dict_from_jax
from latentrag_torch.models import build_autoencoder
from latentrag_torch.pipeline import autoencoder_checkpoint_path
from latentrag_torch.pipeline import load_autoencoder
from latentrag_torch.training import train as port_train
from latentrag_torch.training import trainer as tt
from latentrag_torch.utils import Config, apply_overrides
from latentrag_torch.utils.config import AutoencoderConfig, TrainingConfig

ACFG = AutoencoderConfig(input_dim=32, latent_dim=8, hidden_dim=16)
LOSS_RTOL = 1e-4
PARAM_CLOSE, PARAM_SHARE = 1e-5, 0.999


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _data(seed, n, ae_type):
    rng = np.random.default_rng(seed)
    if ae_type == "cae":
        return {k: rng.standard_normal((n, 32)).astype(np.float32)
                for k in ("q", "p", "n")}
    x = rng.standard_normal((n, 32)).astype(np.float32)
    return {"x": x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
            "y": x}


def _jax_params(ae_type, seed=0):
    return _np_tree(jax_init(jax_build(ae_type, ACFG),
                             jax.random.PRNGKey(seed), 32))


def _assert_params(got_sd, want_tree, ae_type, lr, steps):
    want = autoencoder_state_dict_from_jax(want_tree, ae_type)
    diffs = np.concatenate([
        (got_sd[k].detach().cpu() - want[k]).abs().flatten().numpy()
        for k in want])
    assert (diffs <= PARAM_CLOSE).mean() >= PARAM_SHARE, diffs.max()
    assert diffs.max() <= 2 * lr * steps


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("wd,clip,scale", [
    (0.0, 0.0, 1.0),     # plain Adam
    (1e-2, 0.0, 1.0),    # AdamW
    (0.0, 1.0, 10.0),    # the clip active (norms ~10x over)
    (1e-4, 100.0, 1.0),  # the clip set, inactive
])
def test_optimizer_matches_optax(wd, clip, scale):
    cfg = TrainingConfig(learning_rate=1e-2, weight_decay=wd,
                         grad_clip_norm=clip)
    rng = np.random.default_rng(1)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = jt._make_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    ps = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in shapes]
    opt = tt.make_optimizer(ps, cfg.learning_rate, cfg.weight_decay)
    for i, g in enumerate(grads):
        if i == 2:  # the plateau schedule between steps
            state = jt._scale_lr(state, 0.5)
            tt.scale_lr(opt, 0.5)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        tt.apply_gradients(opt, [torch.from_numpy(g[k]) for k in shapes],
                           cfg.grad_clip_norm)
        for k, p in zip(shapes, ps):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7)
    assert opt.param_groups[0]["lr"] == pytest.approx(5e-3)


def test_clip_matches_optax_form():
    g = [torch.full((3,), 2.0), torch.full((2,), -1.0)]
    norm = float(np.sqrt(3 * 4 + 2))
    out = tt.clip_by_global_norm(g, 1.0)
    want = optax.clip_by_global_norm(1.0).update(
        [jnp.full((3,), 2.0), jnp.full((2,), -1.0)], None)[0]
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-7)
    assert torch.allclose(out[0], g[0] / norm)
    # at or below max_norm the grads pass unscaled
    assert all(torch.equal(o, x) for o, x in zip(
        tt.clip_by_global_norm(g, norm + 1.0), g))


# ---------------------------------------------------------------------- fit


FITS = {
    "dae": TrainingConfig(batch_size=16, epochs=3, learning_rate=1e-3,
                          early_stop_patience=1),
    # train.py's CAE extras: AdamW, the clip, the plateau, relative stop
    "cae": TrainingConfig(batch_size=16, epochs=3, learning_rate=1e-3,
                          weight_decay=1e-4, grad_clip_norm=1.0,
                          lr_plateau_factor=0.5, lr_plateau_patience=1,
                          early_stop_relative=True, early_stop_min_delta=0.003,
                          early_stop_patience=1, mine_hard_negatives=True),
    # no improvement after the first epoch: the early stop at patience 1
    "dae_stop": TrainingConfig(batch_size=16, epochs=5, learning_rate=0.0,
                               early_stop_patience=1),
}


@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_matches_jax(case):
    ae_type = case.split("_")[0]
    cfg = FITS[case]
    train, val = _data(2, 64, ae_type), _data(3, 24, ae_type)
    if ae_type == "cae":
        train = {k: v for k, v in train.items() if k != "n"}
        val = {k: v for k, v in val.items() if k != "n"}
    p0 = _jax_params(ae_type)
    want = jt.Trainer(jax_build(ae_type, ACFG), ae_type, cfg).fit(
        train, val, init_params=p0)
    trainer = tt.Trainer(build_autoencoder(ae_type, ACFG), ae_type, cfg,
                         device="cpu")
    got = trainer.fit(train, val,
                      init_state=autoencoder_state_dict_from_jax(p0, ae_type))
    assert (got.epochs_ran, got.stopped_early) == (want.epochs_ran,
                                                   want.stopped_early)
    assert [h[0] for h in got.history] == [h[0] for h in want.history]
    np.testing.assert_allclose(np.array(got.history)[:, 1:],
                               np.array(want.history)[:, 1:], rtol=LOSS_RTOL)
    assert got.best_val_loss == pytest.approx(want.best_val_loss,
                                              rel=LOSS_RTOL)
    steps = got.epochs_ran * (64 // cfg.batch_size)
    _assert_params(got.params, _np_tree(want.params), ae_type,
                   cfg.learning_rate, steps)
    # the model holds the best state at the end
    assert all(torch.equal(v, got.params[k])
               for k, v in trainer.model.state_dict().items())
    if case == "dae_stop":
        assert got.stopped_early and got.epochs_ran == 2


def _vae_eps(model, params, x, key):
    """The normal draw the JAX VAE's reparameterisation takes from
    ``key``: its first ``make_rng("reparam")`` at the module's root."""
    return np.array(model.apply(
        {"params": params}, x, rngs={"reparam": key},
        method=lambda m, x: jax.random.normal(
            m.make_rng("reparam"), (x.shape[0], ACFG.latent_dim))))


def test_vae_step_with_the_same_eps_matches_jax():
    cfg = TrainingConfig(batch_size=16, learning_rate=1e-3)
    batch = {k: v[:16] for k, v in _data(4, 16, "vae").items()}
    model = jax_build("vae", ACFG)
    p0 = _jax_params("vae", seed=3)
    key = jax.random.split(jax.random.split(jax.random.PRNGKey(7))[1])[1]
    eps = _vae_eps(model, p0, batch["x"], key)
    jtr = jt.Trainer(model, "vae", cfg)
    params, _, jloss = jtr._train_step(p0, jtr.tx.init(p0), batch, key)
    # the draw is the one the step used: its loss recomputed from eps
    mu, logvar = model.apply({"params": p0}, batch["x"], method="encode")
    recon = model.apply({"params": p0}, mu + eps * jnp.exp(0.5 * logvar),
                        method="decode")
    assert float(jax_vae_loss(recon, batch["y"], mu, logvar)[0]) == \
        pytest.approx(float(jloss), rel=1e-6)
    trainer = tt.Trainer(build_autoencoder("vae", ACFG), "vae", cfg,
                         device="cpu")
    trainer.model.load_state_dict(autoencoder_state_dict_from_jax(p0, "vae"))
    loss = trainer.train_step({k: torch.from_numpy(v) for k, v in
                               batch.items()}, eps=torch.from_numpy(eps))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _assert_params(trainer.model.state_dict(), _np_tree(params), "vae",
                   cfg.learning_rate, 1)
    # the sampled path needs a draw
    with pytest.raises(ValueError, match="generator or eps"):
        trainer.model(torch.zeros(2, 32), train=True)


def test_vae_fit_samples_and_validates_deterministically(tmp_path):
    """The VAE's fit on the port's generator: finite, and the same seed
    gives the same curve (validation re-seeds its sampler)."""
    cfg = TrainingConfig(batch_size=16, epochs=2, learning_rate=1e-3)
    train, val = _data(5, 48, "vae"), _data(6, 16, "vae")
    runs = [tt.Trainer(build_autoencoder("vae", ACFG), "vae", cfg,
                       device="cpu").fit(train, val) for _ in range(2)]
    assert runs[0].history == runs[1].history
    assert np.isfinite(np.array(runs[0].history)).all()


def test_resume_continues_at_the_saved_epoch_as_jax_does(tmp_path):
    """2 epochs with a checkpoint, then 4 with resume: the port continues
    at epoch 2 with Adam's step count restored and its losses are the
    JAX package's resumed run's."""
    cfg = TrainingConfig(batch_size=16, epochs=2, learning_rate=1e-3,
                         early_stop_patience=100)
    train, val = _data(7, 64, "dae"), _data(8, 16, "dae")
    p0 = _jax_params("dae", seed=5)
    steps = 64 // 16
    jdir = str(tmp_path / "jax_dae")
    jt.Trainer(jax_build("dae", ACFG), "dae", cfg).fit(
        train, val, init_params=p0, checkpoint_dir=jdir)
    want = jt.Trainer(jax_build("dae", ACFG), "dae", dataclasses.replace(
        cfg, epochs=4)).fit(train, val, init_params=p0, checkpoint_dir=jdir,
                            resume=True)
    path = str(tmp_path / "ckpt" / "dae.pth")
    sd0 = autoencoder_state_dict_from_jax(p0, "dae")
    first = tt.Trainer(build_autoencoder("dae", ACFG), "dae", cfg,
                       device="cpu").fit(train, val, init_state=sd0,
                                         checkpoint_path=path)
    state = torch.load(tt.training_state_path(path), weights_only=True)
    assert state["epoch"] == 1 and state["best_val"] == first.best_val_loss
    assert int(state["optimizer"]["state"][0]["step"]) == 2 * steps
    got = tt.Trainer(build_autoencoder("dae", ACFG), "dae",
                     dataclasses.replace(cfg, epochs=4), device="cpu").fit(
        train, val, init_state=sd0, checkpoint_path=path, resume=True)
    assert [h[0] for h in got.history] == [h[0] for h in want.history] == [2, 3]
    np.testing.assert_allclose(np.array(got.history)[:, 1:],
                               np.array(want.history)[:, 1:], rtol=LOSS_RTOL)
    state = torch.load(tt.training_state_path(path), weights_only=True)
    assert int(state["optimizer"]["state"][0]["step"]) == \
        (state["epoch"] + 1) * steps
    _assert_params(got.params, _np_tree(want.params), "dae", 1e-3, 4 * steps)


# ------------------------------------------------------------ checkpoints


def _cfg(tmp_path, *extra):
    return apply_overrides(Config(), [
        f"paths.checkpoints_dir={tmp_path}/ckpt",
        *[f"models.{ae}.{f}={v}" for ae in ("vae", "dae", "cae")
          for f, v in (("input_dim", 32), ("latent_dim", 8),
                       ("hidden_dim", 16))], *extra])


@pytest.mark.parametrize("ae_type", ["vae", "dae", "cae"])
def test_pth_loads_in_port_and_jax_reference_reader(tmp_path, ae_type):
    cfg = _cfg(tmp_path)
    train, val = _data(9, 32, ae_type), _data(10, 16, ae_type)
    path = autoencoder_checkpoint_path(cfg, ae_type)
    assert path == f"{tmp_path}/ckpt/{ae_type}.pth"
    # the default name, without .pth, and no file yet: the train command
    with pytest.raises(FileNotFoundError, match="training.train"):
        load_autoencoder(cfg, ae_type, device="cpu")
    tt.Trainer(build_autoencoder(ae_type, ACFG), ae_type,
               TrainingConfig(batch_size=16, epochs=1),
               device="cpu").fit(train, val, checkpoint_path=path)
    model = load_autoencoder(cfg, ae_type, device="cpu")
    x = np.random.default_rng(11).standard_normal((10, 32)).astype(np.float32)
    with torch.no_grad():
        got = model.latent(torch.from_numpy(x)).numpy()
    want = np.asarray(encode_latents(
        jax_build(ae_type, ACFG), load_reference_checkpoint(path, ae_type),
        jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # an explicit .pth name, absolute, loads the same file
    again = load_autoencoder(_cfg(tmp_path, f"models.{ae_type}.checkpoint="
                                  f"{path}"), ae_type, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        again.state_dict().values(), model.state_dict().values()))


def test_train_cli_then_main_on_the_cpu(tmp_path):
    """``python -m latentrag_torch.training.train --ae_type vae`` with the
    default checkpoint name, then ``main --ae_type vae`` over it."""
    wd = str(tmp_path)
    ov = ["data.dataset=synthetic", "data.max_samples=48",
          "encoder.vocab_size=300", "encoder.dtype=float32",
          "encoder.hidden_dim=32", "encoder.num_layers=1",
          "encoder.num_heads=4", "encoder.mlp_dim=64",
          "retrieval.kernel=xla_exact", f"retrieval.index_path={wd}/index",
          f"paths.data_dir={wd}/data", f"paths.checkpoints_dir={wd}/ckpt",
          f"paths.logs_dir={wd}/logs", "logging.log_to_file=false",
          "models.vae.input_dim=32", "models.vae.latent_dim=8",
          "models.vae.hidden_dim=16"]
    assert port_train.main(["--ae_type", "vae", "--epochs", "2",
                            "--batch_size", "16", "--device", "cpu",
                            "--set", *ov]) == 0
    assert sorted(os.listdir(f"{wd}/ckpt")) == ["vae.pth", "vae.train.pt"]
    assert os.path.exists(f"{wd}/data/tokenizer.json")
    assert os.listdir(f"{wd}/data/emb_cache")
    # --resume past the last epoch: nothing to run, the file stays
    before = os.path.getmtime(f"{wd}/ckpt/vae.pth")
    assert port_train.main(["--ae_type", "vae", "--epochs", "2",
                            "--resume", "--device", "cpu", "--set", *ov]) == 0
    assert os.path.getmtime(f"{wd}/ckpt/vae.pth") == before
    results: list = []
    assert port_main.main(["--ae_type", "vae", "--device", "cpu", "--set",
                           *ov], results=results) == 0
    res = results[0]
    assert res["dim_out"] == 8 and res["n_queries"] == 48
    assert np.isfinite(np.asarray(res["doc_scores"])).all()
    with pytest.raises(SystemExit):
        port_train.main(["--ae_type", "none", "--device", "cpu", "--set",
                         *ov])
