"""Convert an autoencoder checkpoint of the JAX package's trainer (an
Orbax directory) into the reference-keyed ``.pth`` that the PyTorch port
reads.

The JAX trainer (``python -m latentrag_tpu.training.train``) saves its AE
as an Orbax ``StandardCheckpointer`` directory: OCDBT, zstd-compressed,
read through tensorstore. The port's ``load_autoencoder`` reads a ``.pth``
(``<checkpoints_dir>/<ae>.pth`` under the default name). Run this where
the JAX package and orbax are installed:

  python scripts/orbax_ae_to_pth.py --checkpoint ckpt/vae --ae_type vae

It restores ``params`` with ``latentrag_tpu.training.trainer.
load_checkpoint``, maps them with ``latentrag_torch.models.convert.
autoencoder_state_dict_from_jax`` and writes them with ``torch.save``, by
default to ``<checkpoint>.pth`` beside the directory (``ckpt/vae.pth``
above), the name the port reads for ``models.vae.checkpoint=vae``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="JAX package Orbax AE checkpoint -> the port's .pth")
    p.add_argument("--checkpoint", required=True,
                   help="the Orbax checkpoint directory (e.g. ckpt/vae)")
    p.add_argument("--ae_type", required=True,
                   choices=("vae", "dae", "cae", "contrastive"))
    p.add_argument("--out", default=None,
                   help="the .pth to write (default: <checkpoint>.pth)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from latentrag_torch.models.convert import (
        autoencoder_state_dict_from_jax,
        load_autoencoder_pth,
    )
    from latentrag_tpu.training.trainer import load_checkpoint

    src = os.path.abspath(args.checkpoint.rstrip("/"))
    out = args.out or src + ".pth"
    state = autoencoder_state_dict_from_jax(
        load_checkpoint(src)["params"], args.ae_type)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = out + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, out)
    load_autoencoder_pth(out, args.ae_type)  # the keys the port expects
    print(f"wrote {out} ({len(state)} tensors, ae_type={args.ae_type})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
