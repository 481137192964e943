"""The JAX package's msgpack parameter files, read and written in plain
Python.

The JAX package saves its trained encoder and reranker with
``flax.serialization.to_bytes(params)`` (``encoder.msgpack``,
``reranker.msgpack``). Neither flax nor the ``msgpack`` package is needed
to read them back or to write one: this module decodes the subset of
msgpack that flax writes, byte by byte, and ``save_msgpack`` encodes a
tree the way ``to_bytes`` does (string-keyed maps in insertion order,
ndarray leaves as ExtType 1, each integer and length in msgpack's
smallest form), so the JAX package's ``load_params`` reads it.

* maps, arrays, str, bin, int, float, bool and nil;
* ExtType 1, an ndarray: a nested msgpack ``(shape, dtype name, bytes)``,
  C order. ``bfloat16`` (which numpy lacks) is read through a uint16 view
  into a ``torch.bfloat16`` tensor; every other dtype is a numpy array;
* ExtType 3, a numpy scalar: the same encoding, shape ``()``;
* flax's chunked form of a very large array, a map with
  ``__msgpack_chunked_array__``, ``shape`` and ``chunks`` (maps of "0",
  "1", ...), joined back into one array.

Anything else (another extension type, a reserved byte) raises
``ValueError``. ``load_msgpack(path)`` returns the nested dicts of the
params tree, ready for ``models.convert.minilm_state_dict_from_jax``.
The writer takes what a params tree holds: string-keyed maps of numpy
arrays and tensors (a ``torch.bfloat16`` leaf is written as flax writes a
bfloat16 array); it refuses a leaf over flax's chunk size (1 GiB), which
flax would split into chunks.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_LEAF_BYTES = 1 << 30  # flax.serialization.MAX_CHUNK_SIZE


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(self.unpack(">B")),
            0xDA: lambda: self.str(self.unpack(">H")),
            0xDB: lambda: self.str(self.unpack(">I")),
            0xDC: lambda: [self.obj() for _ in range(self.unpack(">H"))],
            0xDD: lambda: [self.obj() for _ in range(self.unpack(">I"))],
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }.get(b)
        if fixed is None:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        return fixed()

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            if isinstance(arr, torch.Tensor):
                return arr.reshape(())
            return arr[()]
        raise ValueError(f"msgpack extension type {code} is not supported")


def _ndarray(data: bytes):
    """flax's ndarray encoding: msgpack ``(shape, dtype name, C bytes)``."""
    fields = unpackb(data)
    if not isinstance(fields, list) or len(fields) != 3:
        raise ValueError("malformed ndarray extension")
    shape, name, buf = fields
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays joined back, everywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)])
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_msgpack(path: str) -> Any:
    """The tree ``flax.serialization.to_bytes`` wrote to ``path``: nested
    dicts of numpy arrays (``torch.bfloat16`` tensors for bf16 leaves)."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


# ------------------------------------------------------------------ writer


def _head(out: bytearray, n: int, small: int | None, small_max: int,
          codes: tuple[int, int, int]) -> None:
    """A length header: the fixed form when ``small`` is given and ``n``
    fits, else the 8/16/32-bit form (``codes``; 0 = no 8-bit form)."""
    if small is not None and n <= small_max:
        out.append(small | n)
    elif codes[0] and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, x: int) -> None:
    """A non-negative integer (shapes) in its smallest form."""
    for code, fmt, top in ((None, ">B", 0x7F), (0xCC, ">BB", 0xFF),
                           (0xCD, ">BH", 0xFFFF), (0xCE, ">BI", 0xFFFFFFFF),
                           (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
        if 0 <= x <= top:
            out += struct.pack(fmt, x) if code is None else struct.pack(
                fmt, code, x)
            return
    raise ValueError(f"integer {x} cannot be written")


def _ndarray_bytes(arr) -> bytes:
    """flax's ndarray payload, msgpack ``(shape, dtype name, C bytes)``."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            shape = tuple(arr.shape)
            data = arr.contiguous().view(torch.int16).numpy().tobytes()
            return packb((shape, "bfloat16", data))
        arr = arr.numpy()
    arr = np.asarray(arr)
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be written")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"a leaf of {arr.nbytes} bytes is over flax's "
                         "chunk size; flax would write it in chunks")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, x: Any) -> None:
    if isinstance(x, int) and not isinstance(x, bool):
        _pack_int(out, x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _head(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, bytes):
        _head(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, (0, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, (0, 0xDE, 0xDF))
        for key, value in x.items():
            _pack(out, str(key))
            _pack(out, value)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        data = _ndarray_bytes(x)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
        if fixed is not None:
            out.append(fixed)
        else:
            _head(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += data
    else:
        raise TypeError(f"{type(x).__name__} cannot be written to msgpack")


def packb(obj: Any) -> bytes:
    """``obj`` (dicts, lists, tuples, non-negative ints, str, bytes,
    arrays) as msgpack bytes, arrays as flax's extension records."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def save_msgpack(tree: Any, path: str) -> None:
    """Write ``tree`` (nested dicts of arrays) to ``path`` as
    ``flax.serialization.to_bytes`` would, atomically."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(tree))
    os.replace(tmp, path)
