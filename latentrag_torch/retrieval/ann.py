"""ctypes bindings for the C++ ANN tiers: HNSW and IVF-PQ.

The port of the JAX package's ``retrieval/ann.py``: the same exports of
``native/latentrag_native.cpp`` with the same argument types, built and
loaded by ``utils/native.py`` (ABI 7, into ``latentrag_torch/_build/``; a
failed build or another ABI raises). HNSW (M, efConstruction, efSearch)
and IVF-PQ (nlist x m x nbits, residual encoding, ADC search) run on the
host; the index files are the library's own, so an index saved by either
package loads in the other.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from ..utils.native import load_library


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The shared library with the ANN exports' argtypes declared; builds
    it at the first call."""
    lib = load_library()
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.hnsw_new.restype = ctypes.c_void_p
    lib.hnsw_new.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint]
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_size.restype = ctypes.c_int
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_add_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, f32p, ctypes.c_int
    ]
    lib.hnsw_search_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
        i32p, f32p, ctypes.c_int,
    ]
    lib.hnsw_search_batch_filtered.argtypes = [
        ctypes.c_void_p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
        u8p, i32p, f32p, ctypes.c_int,
    ]
    lib.hnsw_build_knn.restype = ctypes.c_int
    lib.hnsw_build_knn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, f32p, i32p, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    lib.hnsw_load.argtypes = [ctypes.c_char_p]

    lib.kmeans_train.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, f32p,
    ]

    lib.ivfpq_new.restype = ctypes.c_void_p
    lib.ivfpq_new.argtypes = [ctypes.c_int] * 4
    lib.ivfpq_free.argtypes = [ctypes.c_void_p]
    lib.ivfpq_train.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
    ]
    lib.ivfpq_add.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int]
    lib.ivfpq_set_trained.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.ivfpq_add_encoded.restype = ctypes.c_int
    lib.ivfpq_add_encoded.argtypes = [
        ctypes.c_void_p, i32p, u8p, ctypes.c_int,
    ]
    lib.ivfpq_search.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, f32p,
    ]
    lib.ivfpq_search_filtered.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, i32p, f32p,
    ]
    lib.ivfpq_save.restype = ctypes.c_int
    lib.ivfpq_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ivfpq_load.restype = ctypes.c_void_p
    lib.ivfpq_load.argtypes = [ctypes.c_char_p]
    lib.ivfpq_params.argtypes = [ctypes.c_void_p, i32p]
    return lib


def _as_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def _f32p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _u8p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _bits(allowed_bits: np.ndarray, n: int) -> np.ndarray:
    """The packed bitset as contiguous bytes, checked to cover n ids."""
    bits = np.ascontiguousarray(allowed_bits, dtype=np.uint8)
    need = (n + 7) // 8
    if bits.size < need:
        raise ValueError(
            f"allowed_bits holds {bits.size} bytes; index of {n} vectors "
            f"needs >= {need}"
        )
    return bits


def kmeans_train(
    data: np.ndarray, k: int, iters: int = 20, seed: int = 0
) -> np.ndarray:
    """Native k-means; returns [k, d] centroids."""
    lib = get_lib()
    data = _as_f32(data)
    n, d = data.shape
    out = np.zeros((k, d), dtype=np.float32)
    lib.kmeans_train(_f32p(data), n, d, k, iters, seed, _f32p(out))
    return out


class HNSWIndex:
    """Graph ANN over inner-product scores (pre-normalize for cosine)."""

    def __init__(
        self,
        dim: int,
        M: int = 32,
        ef_construction: int = 200,
        ef_search: int = 64,
        seed: int = 42,
        _handle=None,
    ):
        self._lib = get_lib()
        self.dim = dim
        self.ef_search = ef_search
        self._h = _handle or self._lib.hnsw_new(
            dim, M, ef_construction, seed
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hnsw_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.hnsw_size(self._h)

    def add(self, vectors: np.ndarray, nthreads: int = 0) -> None:
        """Append vectors. ``nthreads``: 0 = all hardware threads (levels
        stay deterministic; link sets may vary under concurrency), 1 = a
        deterministic sequential build."""
        v = _as_f32(vectors)
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] vectors")
        self._lib.hnsw_add_batch(self._h, v.shape[0], _f32p(v), nthreads)

    def search(
        self, queries: np.ndarray, k: int, ef_search: int | None = None,
        nthreads: int = 0, allowed_bits: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched beam search: (scores [Q, k] f32, ids [Q, k] i32).
        ``allowed_bits``: packed little-endian bitset over vector ids
        (``filtering.pack_mask``); disallowed nodes steer the beam but
        never enter results; unreachable slots come back (-inf, -1)."""
        q = _as_f32(queries)
        nq = q.shape[0]
        ids = np.zeros((nq, k), dtype=np.int32)
        scores = np.zeros((nq, k), dtype=np.float32)
        ef = ef_search or self.ef_search
        if allowed_bits is None:
            self._lib.hnsw_search_batch(
                self._h, nq, _f32p(q), k, ef,
                _i32p(ids), _f32p(scores), nthreads,
            )
            return scores, ids
        bits = _bits(allowed_bits, len(self))
        self._lib.hnsw_search_batch_filtered(
            self._h, nq, _f32p(q), k, ef, _u8p(bits),
            _i32p(ids), _f32p(scores), nthreads,
        )
        return scores, ids

    @classmethod
    def from_knn(
        cls,
        vectors: np.ndarray,
        knn_ids: np.ndarray,
        M: int = 32,
        ef_construction: int = 200,
        ef_search: int = 64,
        seed: int = 42,
        nthreads: int = 0,
    ) -> "HNSWIndex":
        """A fresh index assembled from k-NN candidate lists
        (``ops.knn.knn_graph``): level-0 links by diversity-pruning each
        row's candidates, the upper levels beam-built over their ~1/M
        nodes."""
        v = _as_f32(vectors)
        ids = np.ascontiguousarray(knn_ids, dtype=np.int32)
        if ids.shape[0] != v.shape[0]:
            raise ValueError("knn_ids rows must match vectors rows")
        ix = cls(v.shape[1], M=M, ef_construction=ef_construction,
                 ef_search=ef_search, seed=seed)
        rc = ix._lib.hnsw_build_knn(
            ix._h, v.shape[0], _f32p(v), _i32p(ids), ids.shape[1], nthreads
        )
        if rc != 0:
            raise RuntimeError("hnsw_build_knn failed (index not empty?)")
        return ix

    def save(self, path: str) -> None:
        if self._lib.hnsw_save(self._h, path.encode()) != 0:
            raise IOError(f"hnsw_save failed for {path}")

    @classmethod
    def load(cls, path: str, ef_search: int = 64) -> "HNSWIndex":
        lib = get_lib()
        h = lib.hnsw_load(path.encode())
        if not h:
            raise IOError(f"hnsw_load failed for {path}")
        ix = cls.__new__(cls)
        ix._lib = lib
        ix._h = h
        ix.ef_search = ef_search
        with open(path, "rb") as f:  # the file's header leads with dim
            ix.dim = struct.unpack("<i", f.read(4))[0]
        return ix


class IVFPQIndex:
    """Inverted-file product-quantization index (residual encoding + ADC)."""

    def __init__(self, dim: int, nlist: int = 64, m: int = 16, nbits: int = 8,
                 _handle=None):
        if dim % m != 0:
            raise ValueError(f"dim {dim} not divisible by m {m}")
        self._lib = get_lib()
        self.dim = dim
        self.nlist = nlist
        self.m = m
        self.ksub = 1 << nbits
        self.dsub = dim // m
        self._h = _handle or self._lib.ivfpq_new(dim, nlist, m, nbits)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ivfpq_free(self._h)
            self._h = None

    def train(self, data: np.ndarray, iters: int = 15, seed: int = 0) -> None:
        d = _as_f32(data)
        self._lib.ivfpq_train(self._h, _f32p(d), d.shape[0], iters, seed)

    def add(self, data: np.ndarray) -> None:
        d = _as_f32(data)
        self._lib.ivfpq_add(self._h, _f32p(d), d.shape[0])

    def set_trained(self, coarse: np.ndarray, codebooks: np.ndarray) -> None:
        """Parameters trained elsewhere (``ops.kmeans.ivfpq_train_device``:
        the same L2 and residual semantics)."""
        c = _as_f32(coarse)
        cb = _as_f32(codebooks)
        if c.shape != (self.nlist, self.dim):
            raise ValueError(f"coarse shape {c.shape} != "
                             f"({self.nlist}, {self.dim})")
        if cb.shape != (self.m, self.ksub, self.dsub):
            raise ValueError(f"codebooks shape {cb.shape} != "
                             f"({self.m}, {self.ksub}, {self.dsub})")
        self._lib.ivfpq_set_trained(self._h, _f32p(c), _f32p(cb))

    def add_encoded(self, assigns: np.ndarray, codes: np.ndarray) -> None:
        """Append encoded vectors: list ids and PQ codes
        (``ops.kmeans.ivfpq_encode_device``); linear host work."""
        a = np.ascontiguousarray(assigns, dtype=np.int32)
        c = np.ascontiguousarray(codes, dtype=np.uint8)
        if c.shape != (a.shape[0], self.m):
            raise ValueError(f"codes shape {c.shape} != ({a.shape[0]}, "
                             f"{self.m})")
        if self._lib.ivfpq_add_encoded(self._h, _i32p(a), _u8p(c),
                                       a.shape[0]) != 0:
            raise ValueError("add_encoded: list id out of range")

    def save(self, path: str) -> None:
        """Parameters, coarse centroids, codebooks and inverted lists."""
        if self._lib.ivfpq_save(self._h, path.encode()) != 0:
            raise OSError(f"ivfpq_save failed for {path!r}")

    @classmethod
    def load(cls, path: str) -> "IVFPQIndex":
        """A saved index; a corrupt or truncated file raises (the library
        checks the header and payload sizes before allocating)."""
        lib = get_lib()
        h = lib.ivfpq_load(path.encode())
        if not h:
            raise OSError(f"ivfpq_load failed for {path!r} (missing or "
                          f"corrupt)")
        params = np.zeros(5, dtype=np.int32)
        lib.ivfpq_params(h, _i32p(params))
        dim, nlist, m, ksub = (int(v) for v in params[:4])
        return cls(dim, nlist=nlist, m=m, nbits=int(ksub).bit_length() - 1,
                   _handle=h)

    def __len__(self) -> int:
        params = np.zeros(5, dtype=np.int32)
        self._lib.ivfpq_params(self._h, _i32p(params))
        return int(params[4])

    def search(
        self, queries: np.ndarray, k: int, nprobe: int = 8,
        allowed_bits: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """ADC search: (scores [Q, k] f32, ids [Q, k] i32). With
        ``allowed_bits`` (see ``HNSWIndex.search``) disallowed ids are
        skipped in the list scan."""
        q = _as_f32(queries)
        nq = q.shape[0]
        ids = np.zeros((nq, k), dtype=np.int32)
        scores = np.zeros((nq, k), dtype=np.float32)
        if allowed_bits is None:
            self._lib.ivfpq_search(
                self._h, _f32p(q), nq, k, nprobe, _i32p(ids), _f32p(scores)
            )
            return scores, ids
        bits = _bits(allowed_bits, len(self))
        self._lib.ivfpq_search_filtered(
            self._h, _f32p(q), nq, k, nprobe, _u8p(bits),
            _i32p(ids), _f32p(scores),
        )
        return scores, ids
