from .dense import BACKENDS, DenseRetriever
from .embedder import EmbeddingCompressor
from .factory import DEVICE_BACKENDS, build_retriever, load_retriever

__all__ = [
    "BACKENDS",
    "DenseRetriever",
    "EmbeddingCompressor",
    "DEVICE_BACKENDS",
    "build_retriever",
    "load_retriever",
]
