"""Lazy on-disk text store for million-scale index sidecars.

The port's own copy of the JAX package's ``retrieval/textstore.py``: the
same files byte for byte, so a store written by either package loads in
the other.

At MS-MARCO scale the corpus texts are gigabytes; a meta.json that inlines
them makes every warm boot parse the whole blob and hold ~N Python strings
in RAM — while serving only ever touches the top-k texts per query. This
store keeps texts as a flat utf-8 blob + an int64 offset table, mmap-opened
on load: boot cost is O(1) and a text decodes only when indexed.

Layout (``prefix`` is caller-chosen — a dir entry for the dense tier, the
index-file stem for the ANN tiers): ``{prefix}.bin.npy`` (concatenated
utf-8), ``{prefix}_offsets.npy`` (int64 — a ``[MAGIC, tag, tag]`` header
followed by the ``[n+1]`` cumulative offsets), and ``{prefix}_doc_ids.npy``
(same header + the ids) when the doc_ids are plain integers (the common
case — otherwise the caller inlines them in its JSON sidecar). Older stores (texts inlined in
meta.json, or headerless offset tables) keep loading — the format is
additive.

Crash safety: every file lands atomically (tmp + rename) and the two
halves of one save share a random 16-byte GENERATION TAG — in the offsets
header and appended after the last text byte of the blob. A crash between
the two renames leaves files from different generations, whose tags
mismatch with probability 1 - 2^-128; load then refuses the store in O(1)
(one 16-byte read off the mmap tail) instead of silently decoding wrong
texts. Headerless legacy tables fall back to a total-size cross-check.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np

log = logging.getLogger("latentrag_torch.retrieval")

# First int64 of a tagged offset table. Legacy (headerless) tables always
# start with 0 (the first cumulative offset), so any nonzero magic is
# unambiguous.
MAGIC = np.int64(0x4C54475354525F31)  # "LTGSTR_1"
_TAG_BYTES = 16


def _paths(prefix: str):
    return (f"{prefix}.bin.npy", f"{prefix}_offsets.npy",
            f"{prefix}_doc_ids.npy")


def atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save to a tmp name then rename — a crash never leaves a
    half-written array under the final name. Shared by every retriever
    persistence sidecar, not just the text store."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


_atomic_save = atomic_save  # internal alias


class LazyTexts(Sequence):
    """Sequence of strings decoded on demand from the mmap'd blob."""

    def __init__(self, prefix: str):
        blob_p, offs_p, _ = _paths(prefix)
        self._blob = np.load(blob_p, mmap_mode="r")
        raw = np.load(offs_p)
        if raw.ndim == 1 and raw.size >= 4 and raw[0] == MAGIC:
            self._tag = raw[1:3].copy()
            self._offs = raw[3:]
        else:  # headerless legacy table
            self._tag = None
            self._offs = raw

    def __len__(self) -> int:
        return len(self._offs) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        lo, hi = int(self._offs[i]), int(self._offs[i + 1])
        return bytes(self._blob[lo:hi]).decode("utf-8")

    def __eq__(self, other):  # tests compare against plain lists
        if isinstance(other, (list, tuple, LazyTexts)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented


def save_texts(prefix: str, texts: Sequence[str], doc_ids: Sequence) -> bool:
    """Write the lazy store; returns True when doc_ids were persisted as
    an int array (else the caller should inline them in its JSON)."""
    blob_p, offs_p, ids_p = _paths(prefix)
    data = [t.encode("utf-8") for t in texts]
    offs = np.zeros(len(data) + 1, dtype=np.int64)
    np.cumsum([len(d) for d in data], out=offs[1:])
    # one fresh generation tag binds this save's offsets + blob together
    tag = np.frombuffer(os.urandom(_TAG_BYTES), dtype=np.int64)
    header = np.concatenate([[MAGIC], tag, offs])
    blob = np.frombuffer(b"".join(data) + tag.tobytes(), dtype=np.uint8)
    # each file lands atomically (tmp + rename); a crash between the two
    # renames leaves mixed generations whose tags mismatch at load
    _atomic_save(offs_p, header)
    ids_ok = all(isinstance(d, (int, np.integer)) for d in doc_ids)
    if ids_ok:
        ids = np.asarray(doc_ids, dtype=np.int64)
        _atomic_save(ids_p, np.concatenate([[MAGIC], tag, ids]))
    elif os.path.exists(ids_p):  # stale int sidecar from a previous save
        os.remove(ids_p)
    _atomic_save(blob_p, blob)
    return ids_ok


def load_texts(prefix: str):
    """(texts, doc_ids) from the lazy store, or (None, None) when the
    store predates it or is unreadable/inconsistent (caller falls back to
    meta.json inlining, whose absence in turn forces a clean cold boot)."""
    blob_p, _, ids_p = _paths(prefix)
    if not os.path.exists(blob_p):
        return None, None
    try:
        texts = LazyTexts(prefix)
        offs, blob, tag = texts._offs, texts._blob, texts._tag
        # cross-check the pair: a mixed-generation store (crash between
        # the offsets and blob renames, or manual file surgery) must not
        # decode garbage silently
        tail = _TAG_BYTES if tag is not None else 0
        if (
            offs.ndim != 1
            or offs.size < 1
            or int(offs[0]) != 0
            or int(offs[-1]) + tail != blob.size
            or (offs.size > 1 and bool(np.any(np.diff(offs) < 0)))
        ):
            raise ValueError("offset table inconsistent with text blob")
        if tag is not None and not np.array_equal(
            np.frombuffer(bytes(blob[-_TAG_BYTES:]), dtype=np.int64), tag
        ):
            raise ValueError(
                "generation tag mismatch between offsets and blob"
            )
        doc_ids = None
        if os.path.exists(ids_p):
            raw_ids = np.load(ids_p)
            n = len(texts)
            if raw_ids.size == n + 3 and raw_ids[0] == MAGIC:
                if tag is None or not np.array_equal(raw_ids[1:3], tag):
                    raise ValueError(
                        "generation tag mismatch between doc_ids and blob"
                    )
                doc_ids = raw_ids[3:].tolist()
            elif raw_ids.size == n:  # headerless legacy sidecar
                doc_ids = raw_ids.tolist()
            else:
                raise ValueError("doc_ids length mismatches text count")
    except (OSError, ValueError) as e:
        log.warning(
            "lazy text store at %s unreadable (%s); ignoring it", prefix, e
        )
        return None, None
    return texts, doc_ids


def save_metadata_sidecar(path: str, metadata) -> str | None:
    """Persist per-document metadata as a JSONL sidecar at ``path``
    (tmp+rename) and return its sha1 digest for the caller's meta record;
    ``metadata=None`` removes any stale sidecar and returns None. Shared
    by the dense and ANN tiers so the crash-window protocol (digest bound
    into the LAST-written meta file) has exactly one implementation."""
    import hashlib
    import json

    if metadata is None:
        if os.path.exists(path):
            os.remove(path)  # stale metadata from a previous build
        return None
    blob = "\n".join(
        json.dumps(md, sort_keys=True) for md in metadata
    ).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return hashlib.sha1(blob).hexdigest()


def load_metadata_sidecar(path: str, want_digest, n: int):
    """Load + verify a metadata sidecar against the digest its meta file
    recorded. Returns the metadata list, or None when the meta never
    recorded one (an unrecorded file on disk is a crash leftover from a
    newer generation — ignored, the caller may warn). Raises ValueError on
    any mixed-generation evidence: missing file, digest mismatch, or row
    count != n."""
    import hashlib
    import json

    if want_digest is None:
        return None
    if not os.path.exists(path):
        raise ValueError(
            f"{os.path.basename(path)} recorded in the meta file but "
            "missing on disk; mixed-generation store"
        )
    with open(path, "rb") as f:
        blob = f.read()
    if hashlib.sha1(blob).hexdigest() != want_digest:
        raise ValueError(
            f"{os.path.basename(path)} contradicts the meta file's "
            "digest; mixed-generation store"
        )
    metadata = [
        json.loads(line) for line in blob.decode("utf-8").split("\n")
        if line
    ]
    if len(metadata) != n:
        raise ValueError(
            f"{os.path.basename(path)} holds {len(metadata)} entries for "
            f"n={n}; mixed-generation store"
        )
    return metadata
