"""Sharded corpus checkpoints: one ``.npy`` a global shard.

The port of the JAX package's ``parallel/checkpoint.py``. The JAX package
writes Orbax (OCDBT, zstd-compressed), which needs tensorstore; the port
writes its own layout under the same directory name:

* ``meta.json``: the caller's meta (``n``, ``store_dtype``, ``generation``
  ...) plus ``p`` (the mesh size), ``rows_per_shard``, ``dtype`` and
  ``row_shape``;
* ``shard_<g>.npy``: global shard g's rows (pad rows included), written
  by the process that holds it (bf16 as its uint16 bits).

Process 0 alone removes and creates the directory; a barrier comes before
the shards are written and another after ``meta.json``, so no process
returns (and reloads) before the meta is there, the race the JAX
function's second barrier closes. ``load_sharded_index`` reads the files
back into a mesh of any size, or into one device without one, as Orbax
restores into any target sharding. A JAX package Orbax store (a
``corpus/`` directory) is refused with the name of the script that
rewrites it (``scripts/orbax_sharded_to_npy.py``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .distributed import barrier
from .mesh import Mesh, ShardedRows

CONVERT_HINT = (
    "a JAX package Orbax sharded store; rewrite it with python "
    "scripts/orbax_sharded_to_npy.py --index <index_path> where the JAX "
    "package runs"
)
# dtypes numpy lacks travel as the integer type of the same bits
_BITS = {torch.bfloat16: torch.uint16}


def shard_file(g: int) -> str:
    return f"shard_{g:05d}.npy"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _save_npy(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def save_sharded_index(path: str, corpus: ShardedRows, meta: dict) -> None:
    """Persist a row-sharded corpus and its JSON meta: every process
    writes its own shards, process 0 the directory and ``meta.json``."""
    import shutil

    mesh = corpus.mesh
    path = os.path.abspath(path)
    if mesh.rank == 0:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
    # no process writes before the old checkpoint is gone
    barrier()
    for j, shard in enumerate(corpus.shards):
        _save_npy(os.path.join(path, shard_file(mesh.global_index(j))),
                  _to_numpy(shard))
    barrier()  # every shard is on disk before meta.json names them
    if mesh.rank == 0:
        full = dict(meta)
        full.update(p=mesh.size, rows_per_shard=corpus.rows_per_shard,
                    dtype=_dtype_name(corpus.dtype),
                    row_shape=list(corpus.shape[1:]))
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(full, f)
        os.replace(tmp, os.path.join(path, "meta.json"))
    # no process returns (and reloads) before process 0 wrote meta.json
    barrier()


def read_sharded_meta(path: str, n: int | None = None,
                      generation: str | None = None) -> dict:
    """``meta.json`` of a sharded store in the port's layout, checked
    against its shard files' headers and, where given, against the row
    count ``n`` and the ``generation`` tag that the store's own meta
    records. A JAX package Orbax store, a missing or misshapen shard file
    or a contradiction raises ValueError (OSError for an unreadable file)."""
    if os.path.isdir(os.path.join(path, "corpus")):
        raise ValueError(f"{path} is {CONVERT_HINT}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    for key in ("p", "rows_per_shard", "dtype", "row_shape"):
        if key not in meta:
            raise ValueError(f"{path}/meta.json lacks {key!r}; {CONVERT_HINT}")
    if n is not None and (int(meta.get("n", -1)) != n or (
            generation is not None and meta.get("generation") != generation)):
        raise ValueError(
            f"sharded store (n={meta.get('n')}, generation="
            f"{meta.get('generation')!r}) contradicts meta.json (n={n}, "
            f"generation={generation!r}); mixed-generation store")
    p, r = int(meta["p"]), int(meta["rows_per_shard"])
    if p * r < int(meta.get("n", 0)):
        raise ValueError(f"{path} holds {p} x {r} rows, fewer than "
                         f"n={meta['n']}")
    want = (r, *meta["row_shape"])
    for g in range(p):
        shape = tuple(np.load(os.path.join(path, shard_file(g)),
                              mmap_mode="r").shape)
        if shape != want:
            raise ValueError(f"{shard_file(g)} holds {shape}, meta.json "
                             f"says {want}; mixed-generation store")
    return meta


class _Rows:
    """The stored global rows [lo, hi), read off the shard files' mmaps."""

    def __init__(self, path: str, meta: dict):
        self.files = [np.load(os.path.join(path, shard_file(g)),
                              mmap_mode="r") for g in range(meta["p"])]
        self.r = int(meta["rows_per_shard"])
        self.dtype = getattr(torch, meta["dtype"])

    def __call__(self, lo: int, hi: int) -> np.ndarray:
        parts = []
        for g in range(lo // self.r if self.r else 0, len(self.files)):
            a, b = max(lo, g * self.r), min(hi, (g + 1) * self.r)
            if a >= b:
                break
            parts.append(self.files[g][a - g * self.r: b - g * self.r])
        if not parts:
            return np.zeros((0,) + self.files[0].shape[1:],
                            self.files[0].dtype)
        return np.concatenate(parts)

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.view(self.dtype) if self.dtype in _BITS else t


def load_sharded_index(path: str, mesh: Mesh | None = None, *,
                       device="cuda", meta: dict | None = None) -> tuple:
    """(corpus, meta): the stored rows row-sharded on ``mesh`` (any size:
    the first ``n`` rows re-padded to it), or, with no mesh, the padded
    array as stored on ``device``. Each process reads only the rows of its
    own shards. ``meta``: the store's meta as ``read_sharded_meta`` checked
    it (read and checked here without it)."""
    path = os.path.abspath(path)
    if meta is None:
        meta = read_sharded_meta(path)
    rows = _Rows(path, meta)
    total = rows.r * int(meta["p"])
    if mesh is None:
        from ..utils.device import resolve_device

        return rows.tensor(rows(0, total)).to(resolve_device(device)), meta
    n = int(meta.get("n", total))
    p = mesh.size
    r = -(-n // p) if n else 0
    shards = []
    for j, dev in enumerate(mesh.devices):
        lo = mesh.global_index(j) * r
        part = rows.tensor(rows(min(lo, n), min(lo + r, n)))
        if part.shape[0] < r:
            pad = torch.zeros((r - part.shape[0],) + tuple(part.shape[1:]),
                              dtype=part.dtype)
            part = torch.cat([part, pad])
        shards.append(part.to(dev).contiguous())
    return ShardedRows(shards, mesh), meta
