"""The port's C++ WordPiece path against its Python path and against the
JAX package's tokenizer (which takes its own C++ path on ASCII text):
identical ids, masks and offsets; non-ASCII rows, tiny and large
max_length, an empty batch, a vocab whose ids are not dense; a failed
build or ABI check raises; two processes building at once."""

import ctypes
import multiprocessing
import os

import numpy as np
import pytest

from latentrag_tpu.data import tokenizer as jtok
from latentrag_torch.data import native_tokenizer as tnat
from latentrag_torch.data import tokenizer as ttok
from latentrag_torch.utils import native

ASCII = [
    "", "   ", "plain ascii words here", "hello,world!!and--more...punct",
    "MiXeD CaSe TEXT", "tab\tsep\nnewline\rcr", "x" * 99, "y" * 101,
    "word " * 300, "digits 1234 and 5,678.90 mixed in",
    "[CLS] literal specials [SEP]", "\x00null\x01ctrl chars\x7f",
    "Telescopes observe distant galaxies and nebulae.",
]
MIXED = ["Café naïve résumé", "mixed ascii then café", "東京 tower",
         "plain row between", "ﬁ ligature"]


@pytest.fixture(scope="module")
def toks():
    corpus = ASCII + MIXED + ["telescopes galaxies nebulae words here"] * 3
    t = ttok.WordPieceTokenizer.train_from_corpus(corpus, vocab_size=400)
    py = ttok.WordPieceTokenizer(t.vocab, native=False)
    j = jtok.WordPieceTokenizer.train_from_corpus(corpus, vocab_size=400)
    assert j.vocab == t.vocab and j._native_handle() is not None
    return t, py, j


def _fuzz(n=200):
    rng = np.random.default_rng(7)
    alphabet = list("abcdefgh qu.ick!bro,wn ZQX 01")
    return ["".join(rng.choice(alphabet, size=rng.integers(0, 120)))
            for _ in range(n)]


@pytest.mark.parametrize("max_length", [1, 2, 8, 256])
@pytest.mark.parametrize("texts", ["ascii", "mixed", "fuzz"])
def test_encode_batch_matches_python_and_jax(toks, texts, max_length):
    t, py, j = toks
    batch = {"ascii": ASCII, "mixed": ASCII[:4] + MIXED + ASCII[4:],
             "fuzz": _fuzz()}[texts]
    ttok.reset_rows_served()
    ids, mask = t.encode_batch(batch, max_length=max_length)
    served = dict(ttok.rows_served)
    n_ascii = sum(s.isascii() for s in batch)
    assert served == {"native": n_ascii, "python": len(batch) - n_ascii}
    for other in (py.encode_batch(batch, max_length=max_length),
                  j.encode_batch(batch, max_length=max_length)):
        np.testing.assert_array_equal(ids, other[0])
        np.testing.assert_array_equal(mask, other[1])
    assert ids.dtype == np.int32 and mask.dtype == np.int32
    assert ids.shape[1] == max(int(mask.sum(1).max()), 1)


@pytest.mark.parametrize("max_length", [None, 1, 8, 48])
@pytest.mark.parametrize("specials", [True, False])
def test_encode_offsets_match_python_and_jax(toks, specials, max_length):
    t, py, j = toks
    for text in ASCII + MIXED:
        got = t.encode(text, add_special_tokens=specials,
                       max_length=max_length)
        for ref in (py.encode(text, add_special_tokens=specials,
                              max_length=max_length),
                    j.encode(text, add_special_tokens=specials,
                             max_length=max_length)):
            assert (got.ids, got.tokens, got.offsets) == (
                ref.ids, ref.tokens, ref.offsets), repr(text)


def test_rows_served_by_path(toks):
    t, py, _ = toks
    ttok.reset_rows_served()
    t.encode("ascii row")
    t.encode("café row")
    py.encode("ascii row")
    assert ttok.rows_served == {"native": 1, "python": 2}


def test_empty_batch(toks):
    t, py, j = toks
    for tok in (t, py, j):
        ids, mask = tok.encode_batch([], max_length=16)
        assert ids.shape == (0, 1) and mask.shape == (0, 1)


def test_non_dense_vocab_takes_python_path(toks):
    t, py, _ = toks
    gapped = {tok: i if i < 5 else i + 10 for tok, i in t.vocab.items()}
    g = ttok.WordPieceTokenizer(gapped)
    with pytest.raises(ValueError, match="not dense"):
        tnat.create_handle(g)
    ttok.reset_rows_served()
    ids, _ = g.encode_batch(ASCII, max_length=32)
    assert ttok.rows_served == {"native": 0, "python": len(ASCII)}
    ref = ttok.WordPieceTokenizer(gapped, native=False)
    np.testing.assert_array_equal(ids, ref.encode_batch(ASCII, 32)[0])


def test_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        native.build(str(tmp_path / "build"))
    # a tokenizer whose library cannot be built raises, it does not fall
    # back to the Python path
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    tnat.get_lib.cache_clear()
    tok = ttok.WordPieceTokenizer.train_from_corpus(ASCII, vocab_size=100)
    try:
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            tok.encode_batch(["plain text"], max_length=8)
    finally:
        tnat.get_lib.cache_clear()


def test_abi_mismatch_raises(monkeypatch):
    native.load_library()  # built and cached as it stands
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "ABI_VERSION", native.ABI_VERSION + 1)
    with pytest.raises(RuntimeError, match="ABI 7"):
        native.load_library()


def test_two_processes_build_one_library(tmp_path):
    """Two processes start a build into one empty directory at once: one
    compiles under the lock, the other finds its library; no temporary is
    left and the library loads with the right ABI."""
    ctx = multiprocessing.get_context("spawn")
    build_dir = str(tmp_path / "build")
    procs = [ctx.Process(target=native.build, args=(build_dir,))
             for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert p.exitcode == 0
    path = native.library_path(build_dir)
    assert sorted(os.listdir(build_dir)) == sorted(
        [os.path.basename(path), "latentrag_native.lock"])
    lib = ctypes.CDLL(path)
    lib.latentrag_abi_version.restype = ctypes.c_int
    assert lib.latentrag_abi_version() == native.ABI_VERSION
