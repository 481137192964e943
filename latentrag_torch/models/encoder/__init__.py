from .convert import (
    convert_hf_bert_to_params,
    convert_hf_cross_encoder_to_params,
    load_params,
    save_params,
)
from .minilm import MiniLMEncoder, SentenceEncoder

__all__ = [
    "convert_hf_bert_to_params",
    "convert_hf_cross_encoder_to_params",
    "load_params",
    "save_params",
    "MiniLMEncoder",
    "SentenceEncoder",
]
