"""Rewrite the JAX package's sharded dense store (an Orbax ``sharded/``
directory) into the PyTorch port's ``sharded/`` layout.

The JAX ``DenseRetriever(mesh=...)`` persists its float or int8 rows
through Orbax (``latentrag_tpu.parallel.save_sharded_index``: OCDBT,
zstd-compressed, read through tensorstore), beside a ``meta.json`` with
``n``, ``store_dtype`` and ``generation``. The port writes one ``.npy``
per shard instead (``latentrag_torch.parallel.checkpoint``) and refuses
the Orbax form. Run this where the JAX package and orbax are installed:

  python scripts/orbax_sharded_to_npy.py --index data/index/latent_index

It restores the padded array onto one device, writes it as the port's
layout in one shard (the port re-shards on load to a mesh of any size),
keeps ``n``, ``store_dtype`` and ``generation``, so the store's
``meta.json`` (its ``sharded_generation``) still pairs with it, and
replaces ``<index>/sharded`` in place. The rest of the store is left as
it is. The JAX package does not read the port's layout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="JAX package Orbax sharded/ store -> the port's layout")
    p.add_argument("--index", required=True,
                   help="the dense store's directory (holding sharded/)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np

    from latentrag_torch.parallel.checkpoint import shard_file
    from latentrag_tpu.parallel import load_sharded_index

    src = os.path.join(os.path.abspath(args.index), "sharded")
    if not os.path.isdir(os.path.join(src, "corpus")):
        print(f"{src} holds no Orbax corpus/ directory", file=sys.stderr)
        return 2
    corpus, meta = load_sharded_index(src)
    rows = np.asarray(corpus)
    dtype = str(rows.dtype)
    if dtype == "bfloat16":  # numpy has no bf16: its bits as uint16
        rows = rows.view(np.uint16)
    n = int(meta.get("n", rows.shape[0]))
    r = rows.shape[0]
    tmp = src + ".npy_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.save(os.path.join(tmp, shard_file(0)), np.ascontiguousarray(rows))
    out_meta = dict(meta, n=n, p=1, rows_per_shard=r, dtype=dtype,
                    row_shape=list(rows.shape[1:]))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(out_meta, f)
    shutil.rmtree(src)
    os.replace(tmp, src)
    print(f"wrote {src} (one shard of {r} rows, {dtype}, n={n})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
