"""latentrag_torch: the PyTorch + CUDA port of latentrag-tpu for NVIDIA Hopper.

The same pipeline as the JAX package beside it (which stays the
reference): WordPiece tokenize, MiniLM encode, autoencoder latent, dense
index, one batched fused distance + top-k search, MaxSim doc aggregation,
retrieval metrics. Module names follow the JAX package's, so each part's
counterpart is easy to find.

Layout:
  utils/       config tree, device selection, seeding, timing, CSV sink
  data/        WordPiece tokenizer, SQuAD-format loaders, synthetic corpus
  ops/         distances, exact top-k, MaxSim, the fused top-k kernels
  csrc/        CUDA C++ sources, built with nvcc at first use
  models/      MiniLM encoder, VAE/DAE/CAE, weight conversion
  retrieval/   embedder, dense retriever, factory
  evaluation/  Recall@k / MRR@k / nDCG@k

Entry points take ``device`` (default ``"cuda"``) and raise rather than
fall back to the CPU; ``device="cpu"`` runs every kernel's plain PyTorch
version. The package imports neither JAX nor the JAX package.
"""
