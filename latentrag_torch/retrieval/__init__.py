from .ann import HNSWIndex, IVFPQIndex
from .ann_retriever import ANNRetriever
from .base import BaseRetriever, DenseSearchAPI
from .bm25 import BM25Retriever, tokenize
from .dense import BACKENDS, DenseRetriever
from .dpr import DPRRetriever
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
    "BM25Retriever",
    "BaseRetriever",
    "DPRRetriever",
    "DenseSearchAPI",
    "DenseRetriever",
    "EmbeddingCompressor",
    "HNSWIndex",
    "IVFPQIndex",
    "DEVICE_BACKENDS",
    "build_retriever",
    "load_retriever",
    "tokenize",
]
