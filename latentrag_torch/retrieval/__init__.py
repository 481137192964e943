from .ann import HNSWIndex, IVFPQIndex
from .ann_retriever import ANNRetriever
from .dense import BACKENDS, DenseRetriever
from .embedder import EmbeddingCompressor
from .factory import (
    ANN_BACKENDS,
    DEVICE_BACKENDS,
    build_retriever,
    load_retriever,
)

__all__ = [
    "ANN_BACKENDS",
    "ANNRetriever",
    "BACKENDS",
    "DenseRetriever",
    "EmbeddingCompressor",
    "HNSWIndex",
    "IVFPQIndex",
    "DEVICE_BACKENDS",
    "build_retriever",
    "load_retriever",
]
