"""Embedding-visualization CLI, the port of the JAX package's
``viz_cli.py``: encode (question, positive document) pairs, infer the AE
variant from the checkpoint path, compress on the fly, and write the
figures ``<out_dir>/<ae>_<dims>d_<n>s_<k>k_*.png``.

Usage:
  python -m latentrag_torch.viz_cli --config configs/default.yaml \
      --ae_type vae --projection pca --n_samples 200 --k 10

``--device`` defaults to ``cuda`` and never falls back to the CPU on its
own; ``--device cpu`` runs the plain PyTorch path. The figures need
matplotlib and scikit-learn.
"""

from __future__ import annotations

import argparse
import os
import sys

from .data import get_examples, load_evaluation_data
from .evaluation.visualization import (
    plot_positive_vs_negative_distances,
    visualize_compressed_vs_original,
)
from .models import encode_latents
from .pipeline import PipelineRunner, load_autoencoder
from .utils import apply_overrides, canonical_ae_type, init_logger, load_config


def infer_ae_type_from_path(path: str) -> str:
    """The AE variant named in a checkpoint's file or directory name."""
    base = os.path.basename(path.rstrip("/")).lower()
    for key in ("vae", "dae", "cae", "contrastive", "coe"):
        if key in base:
            return canonical_ae_type(key)
    raise ValueError(f"cannot infer ae type from {path!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="latent-space visualization")
    p.add_argument("--config", default=None)
    p.add_argument("--ae_type", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="infer ae type from this path if --ae_type omitted")
    p.add_argument("--projection", default="pca", choices=("pca", "tsne"))
    p.add_argument("--n_samples", type=int, default=200)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--out_dir", default="fig")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.set)
    init_logger(cfg.logging)

    ae_type = args.ae_type or (
        infer_ae_type_from_path(args.checkpoint) if args.checkpoint else None
    )
    if ae_type is None:
        raise SystemExit("provide --ae_type or --checkpoint")
    ae_type = canonical_ae_type(ae_type)

    examples = get_examples(cfg)[: args.n_samples]
    queries, corpus, relevant = load_evaluation_data(examples)
    # aligned pairs: (question, its relevant context)
    docs = [corpus[r] for r in relevant]

    runner = PipelineRunner(cfg, ae_type="none", device=args.device)
    compressor = runner._ensure_compressor(corpus)
    q_emb = compressor.encode_text(queries)
    d_emb = compressor.encode_text(docs)

    model = load_autoencoder(cfg, ae_type, device=args.device)
    q_lat = encode_latents(model, q_emb)
    d_lat = encode_latents(model, d_emb)

    # visualize_* appends the projection itself; keep it out of the prefix
    prefix = f"{ae_type}_{q_lat.shape[1]}d_{len(queries)}s_{args.k}k"
    result = visualize_compressed_vs_original(
        q_emb, d_emb, q_lat, d_lat,
        out_dir=args.out_dir, prefix=prefix, k=args.k,
        projection=args.projection,
    )
    result["pos_neg_figure"] = plot_positive_vs_negative_distances(
        q_lat, d_lat, out_dir=args.out_dir, prefix=prefix
    )
    print(
        f"recall@{args.k}: original={result['recall_original']:.4f} "
        f"compressed={result['recall_compressed']:.4f}"
    )
    for f in result.get("figures", []) + [result["pos_neg_figure"]]:
        print("wrote", f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
