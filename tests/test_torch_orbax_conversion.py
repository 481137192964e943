"""AEs trained by the JAX package, served by the port: the JAX trainer's
Orbax checkpoint directory, converted by ``scripts/orbax_ae_to_pth.py``
(run in process here, where orbax is installed), loads through the port's
``load_autoencoder`` and gives the JAX AE's latents.

The AEs are the 384->512->64 geometry cut to 32->16->8, their params the
JAX init, saved with the JAX trainer's ``save_checkpoint`` (params, the
optimizer's state, epoch, best val). Tolerance: latents within 1e-6, the
same fp32 weights through two libraries' matmuls."""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentrag_tpu.models import build_autoencoder as jax_build
from latentrag_tpu.models import encode_latents as jax_encode_latents
from latentrag_tpu.models.autoencoders import init_autoencoder as jax_init
from latentrag_tpu.training import trainer as jt
from latentrag_tpu.utils.config import AutoencoderConfig as JaxAECfg
from latentrag_tpu.utils.config import TrainingConfig as JaxTrainCfg
from latentrag_torch import doctor
from latentrag_torch.models import encode_latents
from latentrag_torch.pipeline import load_autoencoder
from latentrag_torch.utils import Config, apply_overrides

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "orbax_ae_to_pth.py")
ACFG = JaxAECfg(input_dim=32, latent_dim=8, hidden_dim=16)


def _script():
    spec = importlib.util.spec_from_file_location("orbax_ae_to_pth", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(tmp_path):
    return apply_overrides(Config(), [
        f"paths.checkpoints_dir={tmp_path}/ckpt",
        *[f"models.{ae}.{f}={v}" for ae in ("vae", "dae", "cae")
          for f, v in (("input_dim", 32), ("latent_dim", 8),
                       ("hidden_dim", 16))]])


def _save_jax_checkpoint(path, ae_type, seed):
    model = jax_build(ae_type, ACFG)
    params = jax.tree.map(np.asarray,
                          jax_init(model, jax.random.PRNGKey(seed), 32))
    trainer = jt.Trainer(model, ae_type, JaxTrainCfg())
    trainer.save_checkpoint(path, params, trainer.tx.init(params), 3, 0.25)
    return model, params


@pytest.mark.parametrize("ae_type", ["vae", "dae", "cae"])
def test_converted_orbax_checkpoint_serves_the_jax_latents(tmp_path,
                                                           ae_type):
    ckpt_dir = f"{tmp_path}/ckpt"
    orbax_dir = f"{ckpt_dir}/{ae_type}"
    model, params = _save_jax_checkpoint(orbax_dir, ae_type,
                                         seed=len(ae_type) + ord(ae_type[0]))
    cfg = _cfg(tmp_path)
    command = (f"python scripts/orbax_ae_to_pth.py --checkpoint {orbax_dir} "
               f"--ae_type {ae_type}")
    with pytest.raises(NotImplementedError, match=re.escape(command)):
        load_autoencoder(cfg, ae_type, device="cpu")
    status, detail, _ = doctor._checkpoints(ckpt_dir)
    assert status == doctor.WARN and ae_type in detail
    assert "scripts/orbax_ae_to_pth.py --checkpoint" in detail

    assert _script().main(["--checkpoint", orbax_dir,
                           "--ae_type", ae_type]) == 0
    assert os.path.isfile(f"{orbax_dir}.pth")
    status, detail, _ = doctor._checkpoints(ckpt_dir)
    assert status == doctor.PASS and f"{ae_type}.pth" in detail

    port = load_autoencoder(cfg, ae_type, device="cpu")
    x = np.random.default_rng(3).standard_normal((16, 32)).astype(np.float32)
    got = encode_latents(port, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_encode_latents(model, params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_script_writes_the_named_file(tmp_path):
    orbax_dir = f"{tmp_path}/runs/dae_best"
    _save_jax_checkpoint(orbax_dir, "dae", seed=9)
    out = f"{tmp_path}/serve/dae.pth"
    assert _script().main(["--checkpoint", orbax_dir + "/", "--ae_type",
                           "dae", "--out", out]) == 0
    assert not os.path.exists(f"{orbax_dir}.pth")
    cfg = apply_overrides(_cfg(tmp_path), [f"models.dae.checkpoint={out}"])
    assert load_autoencoder(cfg, "dae", device="cpu").latent_dim == 8


def test_missing_checkpoint_names_both_ways_to_make_one(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="latentrag_torch.training.train --ae_type vae"):
        load_autoencoder(_cfg(tmp_path), "vae", device="cpu")
