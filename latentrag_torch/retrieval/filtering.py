"""Filter specs -> corpus row masks.

The port's own copy of the JAX package's ``retrieval/filtering.py``. A
*filter spec* is a small JSON-able dict compiled once into a boolean row
mask; the dense retriever packs it (``pack_mask``) and hands the packed
words to the fused top-k kernels, which drop masked-out rows before they
can enter a candidate list (``ops/fused_topk.py``); the plain versions
unpack the words and mask the scores to NEG_INF.

Spec format — all present keys AND together:

  {"doc_ids": [...]}            only these doc_ids are eligible
  {"exclude_doc_ids": [...]}    these doc_ids are dropped
  {"where": {field: value}}     metadata equality; a list value means
                                membership (``field in [v1, v2, ...]``)

``where`` requires per-document metadata (a list of dicts passed to
``build(..., metadata=...)`` / ``add(..., metadata=...)``); docs whose
metadata lacks the field never match. Compilation is O(n) host work per
distinct spec; retrievers cache compiled masks keyed by
``canonical_filter_key`` and invalidate on any index mutation.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np

_ALLOWED_KEYS = frozenset({"doc_ids", "exclude_doc_ids", "where"})

# sentinel distinguishing "field absent" from an explicit None value —
# a where-filter never matches documents that lack the field
_MISSING = object()


def _canonical(value):
    """Normalize a spec value for the cache key: numpy scalars coerce to
    their Python equivalents (np.int64(5) and 5 filter identically, so
    they must share a key), containers recurse, and anything else
    non-JSON raises — ``default=str`` fallbacks would let DISTINCT specs
    collide on one key (np.int64(5) vs the string "5") and serve each
    other's cached masks."""
    if isinstance(value, dict):
        return {str(k): _canonical(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        items = sorted(value, key=repr) if isinstance(
            value, (set, frozenset)
        ) else value
        return [_canonical(v) for v in items]
    if isinstance(value, bool) or value is None or isinstance(value, str):
        return value
    if isinstance(value, (int, np.integer)):
        return int(value)
    if isinstance(value, (float, np.floating)):
        return float(value)
    raise ValueError(
        f"filter values must be JSON scalars or lists of them; got "
        f"{type(value).__name__}"
    )


def canonical_filter_key(spec: dict) -> str:
    """Stable cache key for a filter spec (sorted-key JSON over the
    normalized value tree).

    Raises ValueError for malformed specs so every caller rejects them
    identically, before any mask work happens.
    """
    if not isinstance(spec, dict) or not spec:
        raise ValueError(
            "filter must be a non-empty dict with keys from "
            f"{sorted(_ALLOWED_KEYS)}"
        )
    unknown = set(spec) - _ALLOWED_KEYS
    if unknown:
        raise ValueError(
            f"unknown filter keys {sorted(unknown)}; "
            f"supported: {sorted(_ALLOWED_KEYS)}"
        )
    for key in ("doc_ids", "exclude_doc_ids"):
        if key in spec and not isinstance(spec[key], (list, tuple)):
            raise ValueError(f'filter["{key}"] must be a list')
    if "where" in spec and not isinstance(spec["where"], dict):
        raise ValueError('filter["where"] must be a dict of field: value')
    return json.dumps(_canonical(spec), sort_keys=True)


def _id_member_mask(doc_ids: Sequence, wanted) -> np.ndarray:
    """Bool [n] — row i's doc_id is in ``wanted``. Hash-set membership
    (doc_ids may be heterogeneous Python objects, so np.isin's sort-based
    path is not safe)."""
    want = set(wanted)
    return np.fromiter(
        (d in want for d in doc_ids), dtype=bool, count=len(doc_ids)
    )


def compile_filter_mask(
    spec: dict,
    doc_ids: Sequence,
    metadata: Sequence[dict] | None,
    n: int,
) -> np.ndarray:
    """Compile a validated spec into a bool [n] row mask.

    A mask that matches nothing is legal — the search returns -1/-inf
    sentinel rows, mirroring the "no hits" contract everywhere else.
    """
    canonical_filter_key(spec)  # validate shape/keys first
    if len(doc_ids) != n:
        raise ValueError(f"{len(doc_ids)} doc_ids for {n} corpus rows")
    mask = np.ones(n, dtype=bool)
    if "doc_ids" in spec:
        mask &= _id_member_mask(doc_ids, spec["doc_ids"])
    if "exclude_doc_ids" in spec:
        mask &= ~_id_member_mask(doc_ids, spec["exclude_doc_ids"])
    where = spec.get("where")
    if where:
        if metadata is None:
            raise ValueError(
                'filter["where"] requires per-document metadata; build the '
                "index with metadata=[{...}, ...]"
            )
        if len(metadata) != n:
            raise ValueError(
                f"{len(metadata)} metadata entries for {n} corpus rows"
            )
        for field, value in where.items():
            want = (
                set(value) if isinstance(value, (list, tuple, set))
                else {value}
            )
            # _MISSING default: a doc lacking the field never matches,
            # even when the filter value is an explicit None
            mask &= np.fromiter(
                (
                    (md.get(field, _MISSING) in want)
                    if isinstance(md, dict) else False
                    for md in metadata
                ),
                dtype=bool,
                count=n,
            )
    return mask


def extend_aligned_metadata(
    existing: list | None, base_len: int, new_md, n_new: int
) -> list | None:
    """Row-aligned metadata growth for ``add()`` (shared by every tier):
    whenever EITHER side carries metadata, rows without it get ``{}`` —
    which passes id filters but matches no ``where`` clause."""
    if new_md is not None and len(new_md) != n_new:
        raise ValueError(
            f"{len(new_md)} metadata entries for {n_new} new rows"
        )
    if new_md is None and existing is None:
        return None
    out = list(existing) if existing is not None else [
        {} for _ in range(base_len)
    ]
    out.extend(new_md if new_md is not None else ({} for _ in range(n_new)))
    return out


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """Bool [n] -> packed uint8 [ceil(n/8)] (little-endian bit order —
    bit ``i & 7`` of byte ``i >> 3`` is row i). One byte per 8 rows, so a
    1M-row mask ships 125 KB to the device instead of 1 MB; viewed as
    little-endian int32 words it is the row mask the kernels read (bit
    ``r & 31`` of word ``r >> 5`` is row r)."""
    return np.packbits(np.asarray(mask, dtype=bool), bitorder="little")


class FilterCache:
    """Tiny LRU of compiled masks, keyed by canonical spec. Retrievers
    hold one per index generation and drop it wholesale on build/add/
    remove (row order changes invalidate every mask)."""

    def __init__(self, capacity: int = 32):
        from collections import OrderedDict

        self.capacity = capacity
        self._store: Any = OrderedDict()

    def get(self, key: str):
        v = self._store.get(key)
        if v is not None:
            self._store.move_to_end(key)
        return v

    def put(self, key: str, value) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def clear(self) -> None:
        self._store.clear()
