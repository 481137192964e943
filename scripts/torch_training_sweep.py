#!/usr/bin/env python3
"""How the port's trainers leave their seeded inits at full width, on the
card: the sweep behind the epochs that ``chip_smoke.py`` phase 3u trains.

    python3 scripts/torch_training_sweep.py          # from the repo root

On the synthetic 2000 examples with MiniLM-L6 at full width it prints one
JSON line for each of:

1. the sentence encoder trained with ``EncoderTrainer`` (batch 64, length
   64) for 8 epochs from its seeded init, in bf16 at lr 3e-4, 1e-3 and
   3e-3 and in fp32 at lr 1e-3: after each epoch the train and val loss,
   the mean pairwise cosine of 1024 corpus embeddings (1 = collinear) and
   the Recall@10 of an exact search over them;
2. ``python -m latentrag_torch.training.train`` for the VAE at 5, 20 and
   50 epochs (lr 1e-3) and 20 and 50 (lr 3e-3), and for the DAE and the
   CAE at 5: the latents' mean pairwise cosine and the share of slots
   where ``main``'s docs (the fold) equal ``xla_exact``'s.

It needs the card and imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def encoder_sweep(torch, out):
    import numpy as np

    from latentrag_torch.data import (
        WordPieceTokenizer,
        load_evaluation_data,
        synthetic_examples,
    )
    from latentrag_torch.models.encoder import SentenceEncoder
    from latentrag_torch.training.train_encoder import EncoderTrainer
    from latentrag_torch.utils import load_config
    from latentrag_torch.utils.config import TrainingConfig

    examples = synthetic_examples(2000)
    queries, corpus, relevant = load_evaluation_data(examples)
    tok = WordPieceTokenizer.train_from_corpus(
        [e["context"] for e in examples], vocab_size=30522)
    cfg = load_config(None)

    def spread(enc):
        with torch.no_grad():
            c = enc.encode_batch(corpus)
            q = enc.encode_batch(queries)
        c = c / c.norm(dim=1, keepdim=True)
        q = q / q.norm(dim=1, keepdim=True)
        n = 1024
        cos = ((c[:n] @ c[:n].T).sum().item() - n) / (n * (n - 1))
        top = (q @ c.T).topk(10, dim=1).indices.cpu().numpy()
        hit = [relevant[i] in top[i] for i in range(len(queries))]
        return {"mean_cos": cos, "recall10": float(np.mean(hit))}

    for dtype, lr in (("bfloat16", 3e-4), ("bfloat16", 1e-3),
                      ("float32", 1e-3), ("bfloat16", 3e-3)):
        enc = SentenceEncoder(tok, dataclasses.replace(cfg.encoder,
                                                       dtype=dtype),
                              device="cuda")
        rec = {"sweep": "encoder", "dtype": dtype, "lr": lr,
               "start": spread(enc), "epochs": []}
        trainer = EncoderTrainer(enc, TrainingConfig(
            batch_size=64, epochs=1, learning_rate=lr), max_length=64)
        t0 = time.perf_counter()
        for epoch in range(8):
            # one epoch a fit, a new shuffle each: the spread after each
            trainer.cfg = dataclasses.replace(trainer.cfg, seed=42 + epoch)
            res = trainer.fit([e["question"] for e in examples],
                              [e["context"] for e in examples])
            torch.cuda.synchronize()
            rec["epochs"].append({"s": time.perf_counter() - t0,
                                  "train_val": res.history[0][1:],
                                  **spread(enc)})
        out(rec)
        del enc, trainer
        torch.cuda.empty_cache()


def autoencoder_sweep(torch, out):
    import chip_smoke as cs
    from latentrag_torch.training import train as cli

    wd = tempfile.mkdtemp(prefix="lr_sweep_")
    try:
        runs = [("vae", 5, 1e-3), ("vae", 20, 1e-3), ("vae", 50, 1e-3),
                ("vae", 20, 3e-3), ("vae", 50, 3e-3), ("dae", 5, 1e-3),
                ("cae", 5, 1e-3)]
        for ae, epochs, lr in runs:
            t0 = time.perf_counter()
            cli.main(["--ae_type", ae, "--epochs", str(epochs),
                      "--learning_rate", str(lr), "--device", "cuda",
                      "--set", *cs.train_overrides(wd)])
            train_s = time.perf_counter() - t0
            tag = f"_{epochs}_{lr}"
            with cs.search_calls() as calls:
                res, counts = cs.trained_main(torch, wd, ae, tag=tag)
            oracle, _ = cs.trained_main(torch, wd, ae, "xla_exact", tag=tag)
            out({"sweep": "autoencoder", "ae_type": ae, "epochs": epochs,
                 "lr": lr, "train_s": train_s,
                 "latent_mean_cos": cs.mean_cosine(
                     torch, calls[0].retriever._corpus),
                 "doc_id_agreement": cs.slot_agreement(
                     res["retrieved_doc_ids"], oracle["retrieved_doc_ids"]),
                 "recall10": res["retrieval_metrics"]["Recall@10"]["mean"],
                 "oracle_recall10":
                     oracle["retrieval_metrics"]["Recall@10"]["mean"],
                 "launches": counts})
            del calls
    finally:
        shutil.rmtree(wd, True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("this sweep needs a card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke as cs
    from latentrag_torch.ops import cuda_build, fused_topk, ivf
    from latentrag_torch.utils import native

    print(cs.card_line(), flush=True)
    cuda_build.load_libraries(fused_topk.LIBRARIES + ivf.LIBRARIES)
    native.load_library()

    def out(rec):
        print(json.dumps(rec), flush=True)

    encoder_sweep(torch, out)
    autoencoder_sweep(torch, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
