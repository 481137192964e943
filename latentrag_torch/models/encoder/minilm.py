"""MiniLM-class sentence encoder (6-layer BERT, mean-pool + L2 norm).

The port of the JAX package's ``models/encoder/minilm.py``. The math
follows the Flax module step by step so both modes match it:

* one learned token-type vector, the embedding LayerNorm, post-LN layers
  with an additive -1e9 mask on padding; LayerNorms (eps 1e-6, Flax's
  default) and pooling run in fp32;
* fp32 mode: fp32 softmax and erf GELU (exact BERT semantics);
* bf16 mode: bf16 activations, max-subtracted bf16 exp softmax and tanh
  GELU; attention logits accumulate in fp32 as the Flax einsum's
  ``preferred_element_type`` makes them.

Attention is written out as matmuls so the two modes reproduce the JAX
arithmetic; a fused attention kernel is later work. Parameters stay fp32
and are cast to the activation dtype at each product, as Flax's
``nn.Dense(dtype=...)`` does.

``SentenceEncoder`` pads lengths to powers of two from 16 and batches to
powers of two from 8 (the JAX package's shape buckets) and encodes in
``cfg.batch_size`` chunks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.config import EncoderConfig

LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    # product, then bias, each rounded to the activation dtype, as Flax's
    # nn.Dense computes them
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """fp32 LayerNorm of any-dtype input; returns fp32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def seeded_init(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the Flax modules' initializer scales: weights and
    embeddings N(0, 1/fan_in) (an embedding's fan-in is its width), a
    vector N(0, 0.02), zero biases, unit LayerNorms."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "_ln" in name:
                p.fill_(1.0)
            else:
                std = 0.02 if p.ndim == 1 else p.shape[1] ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator) * std)


class TransformerLayer(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(hidden_dim, hidden_dim)
        self.k = nn.Linear(hidden_dim, hidden_dim)
        self.v = nn.Linear(hidden_dim, hidden_dim)
        self.attn_out = nn.Linear(hidden_dim, hidden_dim)
        self.attn_ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.mlp_in = nn.Linear(hidden_dim, mlp_dim)
        self.mlp_out = nn.Linear(mlp_dim, hidden_dim)
        self.mlp_ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # x: [B, L, H] in the compute dtype; mask: [B, 1, 1, L] additive fp32
        dtype = x.dtype
        b, l, h = x.shape
        hd = h // self.num_heads

        def split(t):
            return t.reshape(b, l, self.num_heads, hd).transpose(1, 2)

        qh = split(_dense(x, self.q))
        kh = split(_dense(x, self.k))
        vh = split(_dense(x, self.v))
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        scores = scores / math.sqrt(hd) + mask
        if dtype == torch.bfloat16:
            mx = scores.amax(dim=-1, keepdim=True)
            e = torch.exp((scores - mx).to(dtype))
            probs = e / e.sum(dim=-1, keepdim=True).to(dtype)
        else:
            probs = torch.softmax(scores, dim=-1).to(dtype)
        ctx = torch.matmul(probs, vh).transpose(1, 2).reshape(b, l, h)
        x = _layer_norm(x + _dense(ctx, self.attn_out), self.attn_ln).to(dtype)
        mlp = F.gelu(
            _dense(x, self.mlp_in),
            approximate="tanh" if dtype == torch.bfloat16 else "none",
        )
        x = _layer_norm(x + _dense(mlp, self.mlp_out), self.mlp_ln)
        return x.to(dtype)


class MiniLMEncoder(nn.Module):
    """BERT encoder trunk + pooling (+ optional L2 normalization).

    ``pooling="mean"`` is the SBERT masked mean; ``"cls"`` takes the [CLS]
    state. Returns [B, H] fp32."""

    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_dim: int = 384,
        num_layers: int = 6,
        num_heads: int = 12,
        mlp_dim: int = 1536,
        max_position_embeddings: int = 512,
        normalize: bool = True,
        pooling: str = "mean",
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.normalize = normalize
        self.pooling = pooling
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(vocab_size, hidden_dim)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_dim)
        self.token_type_embedding = nn.Parameter(torch.zeros(hidden_dim))
        self.embed_ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.layers = nn.ModuleList(
            TransformerLayer(hidden_dim, num_heads, mlp_dim)
            for _ in range(num_layers)
        )

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        l = input_ids.shape[1]
        pos = torch.arange(l, device=input_ids.device)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos)[None]
            + self.token_type_embedding[None, None, :]
        )
        x = _layer_norm(x, self.embed_ln).to(self.dtype)
        additive = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, -1e9
        ).to(torch.float32)
        for layer in self.layers:
            x = layer(x, additive)
        if self.pooling == "cls":
            pooled = x[:, 0, :].float()
        else:
            m = attention_mask[:, :, None].float()
            summed = torch.sum(x.float() * m, dim=1)
            counts = torch.clamp(torch.sum(m, dim=1), min=1e-9)
            pooled = summed / counts
        if self.normalize:
            norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
            pooled = pooled / torch.clamp(norm, min=1e-12)
        return pooled


def _bucket_length(n: int, max_length: int) -> int:
    """Pad sequence length to the next power-of-two bucket (min 16)."""
    b = 16
    while b < n and b < max_length:
        b *= 2
    return min(b, max_length)


def _bucket_batch(n: int) -> int:
    """Pad the batch dimension to the next power-of-two bucket (min 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


class SentenceEncoder:
    """Tokenizer + ``MiniLMEncoder`` on a device: the text→embedding surface.

    ``encode_batch(texts) -> torch.Tensor [B, dim]`` fp32 on the encoder's
    device. ``state_dict`` (optional) is a ``MiniLMEncoder`` state dict,
    e.g. from ``models.convert.minilm_state_dict_from_jax``; without one
    the weights are a seeded init.

    ``mesh`` (a ``parallel.Mesh`` with more than one local shard) encodes
    data-parallel over this process's shards, as the JAX package's mesh
    encode does: one replica of the weights on each distinct device, host
    chunks of ``batch_size`` x P rows padded to a multiple of P, each
    shard's equal slice of the rows on its device, and the outputs
    concatenated in order on the mesh's first device. Each row's result is
    its own (no collective), up to the kernels' sum order at the smaller
    batch."""

    def __init__(
        self,
        tokenizer,
        cfg: EncoderConfig | None = None,
        state_dict: dict | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        from ...utils.device import resolve_device

        self.cfg = cfg or EncoderConfig()
        self.tokenizer = tokenizer
        self.mesh = mesh if mesh is not None and mesh.local_size > 1 else None
        if self.mesh is not None:
            device = self.mesh.devices[0]
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        self.module = MiniLMEncoder(
            vocab_size=max(self.cfg.vocab_size, tokenizer.vocab_size),
            hidden_dim=self.cfg.hidden_dim,
            num_layers=self.cfg.num_layers,
            num_heads=self.cfg.num_heads,
            mlp_dim=self.cfg.mlp_dim,
            max_position_embeddings=self.cfg.max_position_embeddings,
            normalize=self.cfg.normalize,
            pooling=getattr(self.cfg, "pooling", "mean"),
            dtype=dtype,
        )
        if state_dict is None:
            # the self-init encoder used when no weights exist
            seeded_init(self.module, torch.Generator().manual_seed(seed))
        else:
            self.module.load_state_dict(state_dict)
        self.module.to(self.device).eval()
        self._replicas = {self.device: self.module}
        if self.mesh is not None:
            import copy

            for dev in self.mesh.distinct_devices():
                if dev not in self._replicas:
                    self._replicas[dev] = copy.deepcopy(self.module).to(dev)

    @property
    def dim(self) -> int:
        return self.cfg.hidden_dim

    @torch.no_grad()
    def encode_batch(self, texts) -> torch.Tensor:
        """Encode any number of texts in ``cfg.batch_size`` chunks."""
        texts = list(texts)
        if not texts:
            return torch.zeros((0, self.dim), dtype=torch.float32,
                               device=self.device)
        # with a mesh each shard keeps the configured batch; the host chunk
        # grows with the shard count
        bs = self.cfg.batch_size * (self.mesh.local_size if self.mesh else 1)
        chunks = [self._encode_chunk(texts[i : i + bs])
                  for i in range(0, len(texts), bs)]
        return chunks[0] if len(chunks) == 1 else torch.cat(chunks)

    def _encode_chunk(self, texts) -> torch.Tensor:
        import numpy as np

        ids, mask = self.tokenizer.encode_batch(
            list(texts), max_length=self.cfg.max_length
        )
        bucket = _bucket_length(ids.shape[1], self.cfg.max_length)
        n = ids.shape[0]
        nb = _bucket_batch(n)
        if self.mesh is not None:  # rows divide evenly across the shards
            p = self.mesh.local_size
            nb = -(-max(nb, p) // p) * p
        ids = np.pad(ids, ((0, nb - n), (0, bucket - ids.shape[1])),
                     constant_values=self.tokenizer.pad_id)
        mask = np.pad(mask, ((0, nb - n), (0, bucket - mask.shape[1])))
        ids = torch.from_numpy(ids).long()
        mask = torch.from_numpy(mask)
        if self.mesh is None:
            out = self.module(ids.to(self.device), mask.to(self.device))
        else:
            step = nb // self.mesh.local_size
            out = torch.cat([
                self._replicas[dev](ids[j * step:(j + 1) * step].to(dev),
                                    mask[j * step:(j + 1) * step].to(dev)
                                    ).to(self.device)
                for j, dev in enumerate(self.mesh.devices)])
        return out[:n].float()
