from .cache import ensure_embedding_cache, texts_fingerprint
from .chunking import (
    ChunkRecord,
    build_chunked_corpus,
    build_inference_corpus,
    chunk_context_with_alignment,
    semantic_window_chunker,
    sliding_window_chunker,
)
from .processing import (
    add_noise,
    build_contrastive_triples,
    build_dae_dataset,
    clean_text,
    jaccard_similarity,
)
from .squad import (
    get_examples,
    load_evaluation_data,
    load_jsonl_examples,
    load_local_squad,
    load_training_arrays,
    prepare_training_arrays,
    save_training_arrays,
    split_dataset,
    synthetic_examples,
)
from .tokenizer import WordPieceTokenizer, resolve_tokenizer

__all__ = [
    "ensure_embedding_cache",
    "texts_fingerprint",
    "ChunkRecord",
    "build_chunked_corpus",
    "build_inference_corpus",
    "chunk_context_with_alignment",
    "semantic_window_chunker",
    "sliding_window_chunker",
    "add_noise",
    "build_contrastive_triples",
    "build_dae_dataset",
    "clean_text",
    "jaccard_similarity",
    "get_examples",
    "load_evaluation_data",
    "load_jsonl_examples",
    "load_local_squad",
    "load_training_arrays",
    "prepare_training_arrays",
    "save_training_arrays",
    "split_dataset",
    "synthetic_examples",
    "WordPieceTokenizer",
    "resolve_tokenizer",
]
