"""The port's autoencoders and MiniLM encoder against the JAX package's,
through weights carried across (``latentrag_torch.models.convert``).

Bands: AE latents and fp32 MiniLM agree to 1e-5, the band of
``tests/test_reference_parity.py``. bf16 MiniLM agrees to 5e-3 on
unit-norm embeddings: both sides round activations to bf16 (8 mantissa
bits, a relative step of 2^-8 = 3.9e-3) after every product, but XLA and
PyTorch round at different places inside fused ops (the GELU and the
softmax normaliser run in fp32 inside PyTorch's bf16 kernels), so
single-step differences of one bf16 ulp compound over the layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latentrag_tpu.models import build_autoencoder as jax_build_ae
from latentrag_tpu.models import init_autoencoder
from latentrag_tpu.models.convert_torch import load_reference_checkpoint
from latentrag_tpu.models.encoder.minilm import MiniLMEncoder as JaxMiniLM
from latentrag_tpu.models.encoder.minilm import SentenceEncoder as JaxEncoder
from latentrag_tpu.utils.config import AutoencoderConfig, EncoderConfig
from latentrag_torch.data.tokenizer import WordPieceTokenizer
from latentrag_torch.models import (
    autoencoder_state_dict_from_jax,
    build_autoencoder,
    load_autoencoder_pth,
    minilm_state_dict_from_jax,
)
from latentrag_torch.models.encoder.minilm import MiniLMEncoder, SentenceEncoder
from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer

AE_CFG = AutoencoderConfig(input_dim=48, latent_dim=8, hidden_dim=32)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture
def x():
    v = np.random.default_rng(7).standard_normal((16, 48)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("ae_type", ["vae", "dae", "cae"])
def test_autoencoder_matches_through_carried_weights(ae_type, x):
    jm = jax_build_ae(ae_type, AE_CFG)
    params = _np_tree(init_autoencoder(jm, jax.random.PRNGKey(3), 48))
    tm = build_autoencoder(ae_type, AE_CFG).eval()
    tm.load_state_dict(autoencoder_state_dict_from_jax(params, ae_type))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        t_lat = tm.latent(xt).numpy()
        t_out = tm(xt)
    j_lat = np.asarray(jm.apply({"params": params}, x, method="latent"))
    j_out = jm.apply({"params": params}, x, train=False)
    np.testing.assert_allclose(t_lat, j_lat, atol=1e-5)
    t_out = t_out if isinstance(t_out, tuple) else (t_out,)
    j_out = j_out if isinstance(j_out, tuple) else (j_out,)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    if ae_type == "cae":
        np.testing.assert_allclose(np.linalg.norm(t_lat, axis=1), 1.0,
                                   atol=1e-5)


@pytest.mark.parametrize("ae_type", ["vae", "dae", "cae"])
def test_reference_pth_loads_on_both_sides(ae_type, x, tmp_path):
    """A reference-keyed .pth (the port's own state dict keys) loads into
    the port with load_state_dict and into the JAX package through its
    converter; both give the same latents."""
    torch.manual_seed(0)
    tm = build_autoencoder(ae_type, AE_CFG).eval()
    path = str(tmp_path / f"{ae_type}.pth")
    torch.save(tm.state_dict(), path)
    tm2 = build_autoencoder(ae_type, AE_CFG).eval()
    tm2.load_state_dict(load_autoencoder_pth(path, ae_type))
    params = load_reference_checkpoint(path, ae_type)
    jm = jax_build_ae(ae_type, AE_CFG)
    with torch.no_grad():
        t_lat = tm2.latent(torch.from_numpy(x)).numpy()
    j_lat = np.asarray(jm.apply({"params": params}, x, method="latent"))
    np.testing.assert_allclose(t_lat, j_lat, atol=1e-5)


def test_pth_with_wrong_keys_raises(tmp_path):
    torch.manual_seed(0)
    path = str(tmp_path / "vae.pth")
    torch.save(build_autoencoder("vae", AE_CFG).state_dict(), path)
    with pytest.raises(KeyError):
        load_autoencoder_pth(path, "dae")


SMALL = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_position_embeddings=64)


def _ids_mask():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    mask[1, 10:] = 0
    mask[2, 5:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_minilm_matches_through_carried_weights(dtype, tol, pooling):
    ids, mask = _ids_mask()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = JaxMiniLM(**SMALL, pooling=pooling, dtype=jdt)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                              jnp.asarray(mask))["params"])
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    tm = MiniLMEncoder(**SMALL, pooling=pooling, dtype=getattr(torch, dtype))
    tm.load_state_dict(minilm_state_dict_from_jax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=tol)


def test_sentence_encoder_matches_end_to_end():
    """Tokenize + bucket + encode on both sides (fp32 mode) from the same
    vocabulary and carried weights; batches pad to the same buckets."""
    texts = [
        "telescopes observe distant galaxies",
        "the treaty ended a long war between the two empires, at last",
        "Résumé naïve café",
        "",
        "processors execute billions of instructions per second " * 3,
    ]
    tok_j = JaxTokenizer.train_from_corpus(texts, vocab_size=200, min_freq=1)
    tok_t = WordPieceTokenizer(dict(tok_j.vocab))
    cfg = EncoderConfig(vocab_size=200, hidden_dim=32, num_layers=1,
                        num_heads=4, mlp_dim=64, dtype="float32",
                        max_length=24, batch_size=3)
    enc_j = JaxEncoder(tok_j, cfg)
    enc_t = SentenceEncoder(tok_t, cfg,
                            state_dict=minilm_state_dict_from_jax(
                                _np_tree(enc_j.params)),
                            device="cpu")
    want = enc_j.encode_batch(texts)
    got = enc_t.encode_batch(texts)
    assert got.shape == (5, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_self_init_is_seeded():
    tok = WordPieceTokenizer.train_from_corpus(["a b c"], vocab_size=50)
    cfg = EncoderConfig(vocab_size=50, hidden_dim=16, num_layers=1,
                        num_heads=2, mlp_dim=32, dtype="float32")
    a = SentenceEncoder(tok, cfg, seed=3, device="cpu").encode_batch(["a b"])
    b = SentenceEncoder(tok, cfg, seed=3, device="cpu").encode_batch(["a b"])
    c = SentenceEncoder(tok, cfg, seed=4, device="cpu").encode_batch(["a b"])
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)
