"""The JAX package's ``encoder.msgpack`` in the port, on the CPU: the
plain-Python reader decodes what ``flax.serialization`` writes (chunked
arrays and bf16 leaves included) without flax or msgpack; a small trained
encoder saved by the JAX package encodes the same in the port; and the
port's ``main`` reads ``<checkpoints_dir>/encoder.msgpack`` by default and,
run twice on one ``index_path``, warm-boots its store the second time."""

import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from latentrag_tpu.data import load_evaluation_data, synthetic_examples
from latentrag_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from latentrag_tpu.data.tokenizer import resolve_tokenizer
from latentrag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from latentrag_tpu.models.encoder import save_params
from latentrag_tpu.pipeline import PipelineRunner as JaxRunner
from latentrag_tpu.utils import Config as JaxConfig
from latentrag_tpu.utils import apply_overrides as jax_overrides
from latentrag_tpu.utils.config import EncoderConfig
from latentrag_torch import main as torch_main
from latentrag_torch.data.tokenizer import WordPieceTokenizer
from latentrag_torch.models import VariationalAutoencoder
from latentrag_torch.models.convert import minilm_state_dict_from_jax
from latentrag_torch.models.encoder.minilm import SentenceEncoder
from latentrag_torch.models.encoder.msgpack_io import load_msgpack, unpackb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_jax_encoder_msgpack_encodes_the_same(tmp_path):
    """save_params of a small JAX SentenceEncoder, read by the port's
    reader: the encodings agree to 1e-5 in fp32."""
    texts = ["telescopes observe distant galaxies", "the treaty ended a war",
             "Résumé naïve café", "", "processors execute instructions " * 3]
    tok_j = JaxTokenizer.train_from_corpus(texts, vocab_size=200, min_freq=1)
    tok_t = WordPieceTokenizer(dict(tok_j.vocab))
    cfg = EncoderConfig(vocab_size=200, hidden_dim=32, num_layers=2,
                        num_heads=4, mlp_dim=64, dtype="float32",
                        max_length=24, batch_size=3)
    enc_j = JaxEncoder(tok_j, cfg, seed=7)
    path = str(tmp_path / "encoder.msgpack")
    save_params(enc_j.params, path)
    tree = load_msgpack(path)
    enc_t = SentenceEncoder(tok_t, cfg,
                            state_dict=minilm_state_dict_from_jax(tree),
                            device="cpu")
    np.testing.assert_allclose(enc_t.encode_batch(texts).numpy(),
                               enc_j.encode_batch(texts), atol=1e-5)


def test_chunked_and_bf16_leaves_read(monkeypatch):
    """flax's chunked form of an array and a bf16 leaf, as flax writes
    them, read back exactly."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    big = np.arange(30, dtype=np.float32).reshape(5, 6)
    half = jnp.asarray(np.linspace(-2, 2, 12).reshape(3, 4), jnp.bfloat16)
    raw = serialization.msgpack_serialize({
        "w": big, "h": half, "s": np.float32(2.5), "i": np.int64(-3),
        "nest": {"x": 7, "y": None, "z": True, "f": 0.25, "t": "ok"},
    })
    tree = load_msgpack_bytes(raw)
    np.testing.assert_array_equal(tree["w"], big)
    assert tree["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["h"].float().numpy(),
                                  np.asarray(half, dtype=np.float32))
    assert tree["s"] == np.float32(2.5) and tree["i"] == -3
    assert tree["nest"] == {"x": 7, "y": None, "z": True, "f": 0.25,
                            "t": "ok"}
    restored = serialization.msgpack_restore(raw)
    np.testing.assert_array_equal(restored["w"], tree["w"])


def load_msgpack_bytes(raw: bytes):
    from latentrag_torch.models.encoder.msgpack_io import _unchunk

    return _unchunk(unpackb(raw))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
    -32768, -32769, -(2**31) - 1, 1.5, -0.0, "", "a" * 31, "b" * 32,
    "c" * 300, "d" * 70000, b"\x00\x01", b"x" * 300, b"y" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    [None, True, False, {"k": [1.25, "v"]}],
])
def test_every_type_flax_writes_decodes(value):
    """The reader against the msgpack package's encoder, each size class
    of each type (fix, 8, 16, 32 and 64 bits)."""
    raw = msgpack.packb(value, use_bin_type=True)
    assert unpackb(raw) == value
    f32 = struct.pack(">Bf", 0xCA, 1.5)
    assert unpackb(f32) == 1.5


@pytest.mark.parametrize("raw,match", [
    (msgpack.packb(msgpack.ExtType(5, b"abc")), "extension type 5"),
    (b"\xc1", "0xc1"),
    (msgpack.packb([1, 2])[:-1], "ends inside"),
    (msgpack.packb(1) + b"\x00", "trailing"),
])
def test_anything_else_raises(raw, match):
    with pytest.raises(ValueError, match=match):
        unpackb(raw)


def test_reader_needs_neither_flax_nor_msgpack(tmp_path):
    path = str(tmp_path / "p.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes({"a": {"kernel": np.ones((2, 3),
                                                                np.float32)}}))
    code = f"""
import sys
for name in ("flax", "msgpack", "jax", "latentrag_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
from latentrag_torch.models.encoder.msgpack_io import load_msgpack
print(load_msgpack({path!r})["a"]["kernel"].sum())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == 6.0


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
        "retrieval.store_dtype=float32",
    ]


def test_main_reads_msgpack_and_warm_boots(tmp_path):
    """The port's main with the JAX package's encoder.msgpack at its
    default path matches the JAX pipeline; run again on the same
    index_path, it loads the store, skips the rebuild and the self-check,
    and returns the same doc ids and metrics."""
    base = str(tmp_path)
    ov = _overrides(base)
    queries, corpus, relevant = load_evaluation_data(synthetic_examples(60))
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    cfg_j = jax_overrides(JaxConfig(), ov + [
        "retrieval.kernel=xla_exact", f"retrieval.index_path={base}/jax_index"])
    tok = resolve_tokenizer(cfg_j.paths.data_dir, 800, corpus)
    save_params(JaxEncoder(tok, cfg_j.encoder, seed=11).params,
                f"{base}/ckpt/encoder.msgpack")
    want = JaxRunner(cfg_j, ae_type="vae").process(queries, corpus, relevant)

    runs = []
    log_file = f"{base}/logs/run.log"  # main's own log (it resets the root's)
    for _ in range(2):
        results = []
        seen = os.path.getsize(log_file) if os.path.exists(log_file) else 0
        rc = torch_main.main(["--ae_type", "vae", "--device", "cpu",
                              "--set", *ov, "logging.log_to_file=true"],
                             results=results)
        assert rc == 0 and len(results) == 1
        with open(log_file) as f:
            runs.append((results[0], f.read()[seen:]))
    (first, log1), (second, log2) = runs
    assert "loaded encoder weights" in log1 and "encoder.msgpack" in log1
    assert first["retrieved_doc_ids"] == want["retrieved_doc_ids"]
    assert "index persisted to" in log1 and "skipping rebuild" not in log1
    assert "index loaded from" in log2
    assert "index compatible; skipping rebuild" in log2
    assert "index persisted to" not in log2
    assert second["retrieved_doc_ids"] == first["retrieved_doc_ids"]
    assert second["retrieval_metrics"] == first["retrieval_metrics"]
    np.testing.assert_array_equal(second["doc_scores"], first["doc_scores"])
    assert second["retriever_stats"]["build_time_s"] == 0.0
