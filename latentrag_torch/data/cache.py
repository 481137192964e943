"""Content-addressed embedding cache (SHA1-fingerprinted npz files).

The port's copy of the JAX package's ``data/cache.py``: the key hashes the
texts and the encoder's name, so a stale cache is never served after the
data or the model changed. The digest and the file names are the JAX
package's, so a cache written by either package is a hit for the other.
"""

from __future__ import annotations

import hashlib
import logging
import os
import zipfile
from typing import Callable, Sequence

import numpy as np
import torch

log = logging.getLogger("latentrag_torch.data")


def texts_fingerprint(texts: Sequence[str], model_name: str = "") -> str:
    h = hashlib.sha1()
    h.update(model_name.encode())
    h.update(str(len(texts)).encode())
    for t in texts:
        h.update(t.encode("utf-8", "replace"))
        h.update(b"\x00")
    return h.hexdigest()


def ensure_embedding_cache(
    texts: Sequence[str],
    encode_fn: Callable[[Sequence[str]], "np.ndarray | torch.Tensor"],
    cache_dir: str,
    model_name: str = "",
    tag: str = "emb",
) -> np.ndarray:
    """Host fp32 embeddings for ``texts``, encoding only on a cache miss.
    ``encode_fn`` may return a tensor on any device: it is copied to host
    fp32 numpy once, before it is written."""
    os.makedirs(cache_dir, exist_ok=True)
    fp = texts_fingerprint(texts, model_name)
    path = os.path.join(cache_dir, f"{tag}_{fp[:16]}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                if z["fingerprint"].item() == fp:
                    log.info("embedding cache hit: %s", path)
                    return z["embeddings"]
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            log.warning("cache at %s unreadable (%s); re-encoding", path, e)
    emb = encode_fn(list(texts))
    if isinstance(emb, torch.Tensor):
        emb = emb.detach().to("cpu", torch.float32).numpy()
    emb = np.asarray(emb, dtype=np.float32)
    np.savez(path, embeddings=emb, fingerprint=np.array(fp))
    log.info("embedding cache written: %s (%d vectors)", path, len(emb))
    return emb
