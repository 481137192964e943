from .squad import (
    get_examples,
    load_evaluation_data,
    load_jsonl_examples,
    load_local_squad,
    synthetic_examples,
)
from .tokenizer import WordPieceTokenizer, resolve_tokenizer

__all__ = [
    "get_examples",
    "load_evaluation_data",
    "load_jsonl_examples",
    "load_local_squad",
    "synthetic_examples",
    "WordPieceTokenizer",
    "resolve_tokenizer",
]
