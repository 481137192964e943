"""ctypes bindings for the C++ WordPiece fast path.

The port's counterpart of the JAX package's ``data/native_tokenizer.py``:
the ``wp_*`` exports of ``native/latentrag_native.cpp``, built and loaded
by ``utils/native.py``. For pure-ASCII text they give the Python
tokenizer's ids, masks and offsets exactly; rows with any non-ASCII byte
are flagged back to the caller for the Python path. See
``data/tokenizer.py`` for the contract.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The shared library with the wp_* argtypes declared; builds it at the
    first call and raises if the build, the load or the ABI check fails."""
    from ..utils.native import load_library

    lib = load_library()
    llp = ctypes.POINTER(ctypes.c_longlong)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [
        ctypes.c_char_p, llp, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_encode_offsets.restype = ctypes.c_int
    lib.wp_encode_offsets.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ip, ip, ip, ctypes.c_int,
    ]
    lib.wp_encode_batch.restype = None
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, llp, ctypes.c_int, ctypes.c_int,
        ip, ip, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    return lib


def create_handle(tok) -> int:
    """A C++ vocab handle for a ``WordPieceTokenizer``.

    Needs a vocab whose ids are dense (0..n-1, true for every factory
    path) and raises ``ValueError`` otherwise, before the library is
    touched, so the caller takes the Python path; build and load failures
    raise ``RuntimeError``."""
    n = len(tok.vocab)
    tokens_by_id: list[str | None] = [None] * n
    for t, i in tok.vocab.items():
        if not 0 <= i < n or tokens_by_id[i] is not None:
            raise ValueError("vocab ids are not dense")
        tokens_by_id[i] = t
    # n unique in-range ids over n slots fill every slot
    data = [t.encode("utf-8") for t in tokens_by_id]  # type: ignore[union-attr]
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(d) for d in data], out=offs[1:])
    h = get_lib().wp_create(
        b"".join(data), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n, tok.pad_id, tok.unk_id, tok.cls_id, tok.sep_id,
        1 if tok.lowercase else 0, tok.max_word_chars,
    )
    if not h:
        raise RuntimeError("wp_create returned NULL")
    return h


def free_handle(h) -> None:
    get_lib().wp_free(h)


def encode_offsets(h, text: str, add_specials: bool, max_length):
    """(ids, starts, ends) via C++, or None when the text has non-ASCII
    bytes (the caller takes the Python path)."""
    lib = get_lib()
    data = text.encode("utf-8")
    cap = (max_length if max_length else len(data) + 2) + 2
    ip = ctypes.POINTER(ctypes.c_int)
    while True:
        ids = np.empty(cap, dtype=np.int32)
        starts = np.empty(cap, dtype=np.int32)
        ends = np.empty(cap, dtype=np.int32)
        n = lib.wp_encode_offsets(
            h, data, len(data), 1 if add_specials else 0, max_length or 0,
            ids.ctypes.data_as(ip), starts.ctypes.data_as(ip),
            ends.ctypes.data_as(ip), cap,
        )
        if n == -1:
            return None
        if n == -2:  # cap too small (tokens <= chars, so not expected)
            cap *= 2
            continue
        return ids[:n], starts[:n], ends[:n]
