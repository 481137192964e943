"""Cross-encoder relevance scorer (BERT pair classification), the
reranker's model.

The port of the JAX package's ``models/encoder/cross.py``. A bi-encoder
fetches candidates at corpus scale; this model reads each ``[CLS] query
[SEP] document [SEP]`` pair jointly and gives one relevance logit (Nogueira
& Cho 2019, arXiv:1901.04085). It is HF ``BertForSequenceClassification``
with one label: the MiniLM trunk (``minilm.TransformerLayer``, the same
arithmetic in fp32 and bf16 modes), a 2-row token-type embedding telling
the query segment from the document's, a tanh pooler over [CLS] and a
scalar head, both fp32.

``CrossEncoderScorer`` tokenizes pairs on the host (``encode_pairs``:
fixed-split truncation, a forced closing [SEP]) and scores them on its
device in ``cfg.batch_size`` chunks padded to the sentence encoder's
power-of-two length and batch buckets; the chunks' logits come back to
the host in one copy at the end.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...utils.config import EncoderConfig
from .minilm import (
    LN_EPS,
    TransformerLayer,
    _bucket_batch,
    _bucket_length,
    _dense,
    _layer_norm,
    seeded_init,
)


class CrossEncoderModel(nn.Module):
    """Trunk + pair embeddings + pooler + scalar relevance head."""

    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_dim: int = 384,
        num_layers: int = 6,
        num_heads: int = 12,
        mlp_dim: int = 1536,
        max_position_embeddings: int = 512,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(vocab_size, hidden_dim)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_dim)
        # two segments (query 0, document 1)
        self.token_type_embeddings = nn.Embedding(2, hidden_dim)
        self.embed_ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.layers = nn.ModuleList(
            TransformerLayer(hidden_dim, num_heads, mlp_dim)
            for _ in range(num_layers)
        )
        self.pooler = nn.Linear(hidden_dim, hidden_dim)
        self.classifier = nn.Linear(hidden_dim, 1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        pooled = self.pool(input_ids, attention_mask, token_type_ids)
        return _dense(pooled, self.classifier)[:, 0]  # [B] fp32 logits

    def pool(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             token_type_ids: torch.Tensor) -> torch.Tensor:
        """The head's input: the fp32 tanh pooler over [CLS], [B, H]."""
        l = input_ids.shape[1]
        pos = torch.arange(l, device=input_ids.device)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos)[None]
            + self.token_type_embeddings(token_type_ids)
        )
        x = _layer_norm(x, self.embed_ln).to(self.dtype)
        additive = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, -1e9
        ).to(torch.float32)
        for layer in self.layers:
            x = layer(x, additive)
        return torch.tanh(_dense(x[:, 0, :].float(), self.pooler))


def encode_pairs(tokenizer, queries, docs, max_length: int = 256,
                 query_max: int = 64):
    """Tokenize (query, doc) pairs into BERT pair inputs.

    Returns (ids, mask, token_type) int32 [N, max_length]. Queries keep at
    most ``query_max`` tokens ([CLS] and [SEP] included); each document
    fills the rest of ``max_length`` and, when cut, ends on a forced [SEP]
    (fixed-split truncation). Token types are 0 through the query's [SEP],
    1 after. The rows are assembled with array operations, not a loop a
    pair."""
    if len(queries) != len(docs):
        raise ValueError("queries and docs must pair 1:1")
    n = len(queries)
    q_ids, q_mask = tokenizer.encode_batch(list(queries),
                                           max_length=query_max)
    d_ids, d_mask = tokenizer.encode_batch(list(docs), max_length=max_length)
    col = np.arange(max_length)[None, :]
    ql = q_mask.sum(axis=1, dtype=np.int64)[:, None]  # [CLS] q... [SEP]
    budget = max_length - ql
    body = d_mask.sum(axis=1, dtype=np.int64)[:, None] - 1  # no doc [CLS]
    blen = np.minimum(body, budget)
    live = ql + blen
    in_query = col < ql
    in_doc = ~in_query & (col < live)
    q_tok = np.take_along_axis(
        q_ids, np.minimum(col, q_ids.shape[1] - 1).repeat(n, 0), axis=1)
    d_tok = np.take_along_axis(
        d_ids, np.clip(col - ql + 1, 0, d_ids.shape[1] - 1), axis=1)
    ids = np.where(in_query, q_tok,
                   np.where(in_doc, d_tok, tokenizer.pad_id)).astype(np.int32)
    cut = ((body > budget) & (budget > 0))[:, 0]
    ids[cut, live[cut, 0] - 1] = tokenizer.sep_id  # truncation re-seals
    return ids, (col < live).astype(np.int32), in_doc.astype(np.int32)


class CrossEncoderScorer:
    """Tokenizer + ``CrossEncoderModel`` on a device: the (query, doc) ->
    score surface. ``state_dict`` (optional) is a ``CrossEncoderModel``
    state dict, e.g. from ``models.convert.cross_encoder_state_dict_from_
    jax``; without one the weights are a seeded init."""

    def __init__(
        self,
        tokenizer,
        cfg: EncoderConfig | None = None,
        state_dict: dict | None = None,
        seed: int = 0,
        query_max: int = 64,
        device: str | torch.device = "cuda",
    ):
        from ...utils.device import resolve_device

        self.cfg = cfg or EncoderConfig()
        self.tokenizer = tokenizer
        self.query_max = query_max
        self.device = resolve_device(device)
        self.module = CrossEncoderModel(
            vocab_size=max(self.cfg.vocab_size, tokenizer.vocab_size),
            hidden_dim=self.cfg.hidden_dim,
            num_layers=self.cfg.num_layers,
            num_heads=self.cfg.num_heads,
            mlp_dim=self.cfg.mlp_dim,
            max_position_embeddings=self.cfg.max_position_embeddings,
            dtype=(torch.bfloat16 if self.cfg.dtype == "bfloat16"
                   else torch.float32),
        )
        if state_dict is None:
            seeded_init(self.module, torch.Generator().manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.to(self.device).eval()

    @torch.no_grad()
    def score_pairs(self, queries, docs) -> np.ndarray:
        """Relevance logits for N (query, doc) pairs -> fp32 [N] numpy."""
        queries, docs = list(queries), list(docs)
        if not queries:
            return np.zeros((0,), np.float32)
        bs = self.cfg.batch_size
        out = [self._score_chunk(queries[i:i + bs], docs[i:i + bs])
               for i in range(0, len(queries), bs)]
        return torch.cat(out).cpu().numpy()

    def _score_chunk(self, queries, docs) -> torch.Tensor:
        ids, mask, tt = encode_pairs(
            self.tokenizer, queries, docs,
            max_length=self.cfg.max_length, query_max=self.query_max,
        )
        bucket = _bucket_length(int(mask.sum(axis=1).max()),
                                self.cfg.max_length)
        n = ids.shape[0]
        pad = ((0, _bucket_batch(n) - n), (0, 0))
        ids = np.pad(ids[:, :bucket], pad,
                     constant_values=self.tokenizer.pad_id)
        mask = np.pad(mask[:, :bucket], pad)
        tt = np.pad(tt[:, :bucket], pad)
        logits = self.module(
            *(torch.from_numpy(a).to(self.device, torch.long)
              for a in (ids, mask, tt)))
        return logits[:n].float()
