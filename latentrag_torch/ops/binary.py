"""Binary (1-bit sign) corpus quantization with asymmetric scoring.

The port of the JAX package's ``ops/binary.py``. Each corpus vector keeps
only its sign bits, packed 32 to a word: 8 B a vector at D=64, 1/16 of a
bf16 row. Scoring is asymmetric: the queries stay bf16 and meet the
corpus as +-1, score = dot(bf16(q), sign(c)) in fp32.

The packed words are int32 tensors holding the same 32 bits as the JAX
package's uint32 (``.view(uint32)`` in numpy gives them back); torch's
uint32 has no shifts. Bit j of word w is 1 iff x[:, 32w + j] >= 0, and D
pads to a multiple of 32 with 0 bits, which unpacking drops again.

``binary_topk`` / ``binary_topk_t`` are the plain exact searches (the
JAX functions at ``recall_target=1.0``): the binary store's stage 1 on
the CPU. On the card stage 1 is the fused kernel in ``ops.fused_topk``.
"""

from __future__ import annotations

import torch

from .topk import NEG_INF, as_bool_mask

BITS = 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(BITS, dtype=torch.int32, device=device)


def binary_quantize(x: torch.Tensor) -> torch.Tensor:
    """Pack sign bits: [N, D] floats -> int32 words [N, ceil(D/32)]."""
    n, d = x.shape
    pad = (-d) % BITS
    bits = (x >= 0).to(torch.int64)
    if pad:  # pad bits are 0
        bits = torch.nn.functional.pad(bits, (0, pad))
    words = torch.sum(
        bits.reshape(n, -1, BITS) << _shifts(x.device).to(torch.int64), dim=-1
    )
    # words >= 2**31 wrap to the int32 with the same bits
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).contiguous()


def binary_unpack(packed: torch.Tensor, d: int) -> torch.Tensor:
    """int32 words [N, W] -> +-1 int8 [N, d] (pad columns dropped)."""
    bits = (packed[:, :, None] >> _shifts(packed.device)) & 1
    pm1 = (2 * bits - 1).to(torch.int8).reshape(packed.shape[0], -1)
    return pm1[:, :d]


def binary_quantize_t(x: torch.Tensor) -> torch.Tensor:
    """Pack sign bits transposed: [N, D] floats -> int32 [ceil(D/32), N]
    (word w of column n is word w of row n of ``binary_quantize``)."""
    return binary_quantize(x).T.contiguous()


def binary_unpack_t(packed_t: torch.Tensor, d: int) -> torch.Tensor:
    """int32 words [W, N] -> +-1 int8 [d, N]."""
    w, n = packed_t.shape
    bits = (packed_t[:, None, :] >> _shifts(packed_t.device)[None, :, None]) & 1
    return (2 * bits - 1).to(torch.int8).reshape(w * BITS, n)[:d]


def _sign_dot_topk(queries, n, k, block_size, unpack_block, mask=None):
    """Exact top-k of sign-dot scores, corpus streamed in blocks:
    (scores [Q, k] f32, ids [Q, k] i64). Ties go to the lower row, as
    ``lax.top_k`` breaks them. Rows outside ``mask`` (bool [n]) score
    NEG_INF."""
    q = queries.to(torch.bfloat16).float()
    k = min(k, n)
    run_s = run_i = None
    for base in range(0, n, block_size):
        c = unpack_block(base, min(base + block_size, n)).float()  # [B, d]
        s = q @ c.T
        if mask is not None:
            s = torch.where(mask[None, base : base + c.shape[0]], s,
                            NEG_INF)
        blk_s, sel = torch.sort(s, dim=1, descending=True, stable=True)
        blk_s, blk_i = blk_s[:, :k], sel[:, :k] + base
        if run_s is not None:  # earlier blocks' rows first: ties stay low
            blk_s = torch.cat([run_s, blk_s], dim=1)
            blk_i = torch.cat([run_i, blk_i], dim=1)
            order = torch.sort(blk_s, dim=1, descending=True, stable=True)[1]
            blk_s = torch.gather(blk_s, 1, order[:, :k])
            blk_i = torch.gather(blk_i, 1, order[:, :k])
        run_s, run_i = blk_s, blk_i
    return run_s, run_i


def binary_topk(
    queries: torch.Tensor, packed: torch.Tensor, d: int, k: int,
    block_size: int = 65536, mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact asymmetric top-k over a packed store [N, W]: (scores [Q, k]
    f32, ids [Q, k] i64), score = dot(bf16(q), sign(c)). k clips to N.
    ``mask`` (bool [N], or its packed int32 words) restricts eligibility:
    excluded rows score NEG_INF and their ids are arbitrary, so callers
    sentinel NEG_INF slots before a rescore, as the JAX function's do."""
    return _sign_dot_topk(
        queries, packed.shape[0], k, block_size,
        lambda lo, hi: binary_unpack(packed[lo:hi], d),
        as_bool_mask(mask, packed.shape[0]),
    )


def binary_topk_t(
    queries: torch.Tensor, packed_t: torch.Tensor, d: int, k: int,
    block_size: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``binary_topk`` over the transposed store [W, N]: the same bits,
    scores and order."""
    return _sign_dot_topk(
        queries, packed_t.shape[1], k, block_size,
        lambda lo, hi: binary_unpack_t(packed_t[:, lo:hi], d).T,
    )
