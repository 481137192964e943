"""Lloyd's k-means on the device: the device IVF's coarse quantizer.

The port of the JAX package's ``ops/kmeans.py``: ``kmeans`` and
``assign_clusters`` (the device IVF's), and the IVF-PQ tier's device
assists ``pq_encode``, ``ivfpq_train_device`` and ``ivfpq_encode_device``,
whose parameters and codes the C++ index takes as they are
(``retrieval.ann.IVFPQIndex.set_trained`` / ``add_encoded``).
Plain L2 Lloyd's: a row's list is ``argmax(x . c - |c|^2 / 2)`` (the |x|^2
term does not change the ranking), empty clusters are re-seeded from
random rows, and rows are scored in blocks so that no [N, k] score matrix
exists beyond one block. The big operand keeps its store dtype (int8 codes,
bf16 rows); only a block is cast to fp32.

Departures from the JAX functions, none of which changes what a row is
assigned to on well-separated data:

* random numbers come from a ``torch.Generator`` on the CPU seeded from
  ``seed`` (the same numbers on every device), not from ``jax.random``, so
  the initial centroids differ from the JAX package's for the same seed
  (PQ sub-quantizer s takes ``seed + 1000 + s``, where the JAX package
  folds ``1000 + s`` into its key); ``kmeans_init`` draws them and
  ``lloyd`` iterates from any given start, so a test can start the port
  from the JAX package's own init;
* the update sums each cluster's rows with ``index_add_`` in place of the
  JAX package's one-hot product (at 8.8M rows and 8192 lists a
  [block, k + 1] one-hot is 4.3 GB a block). The sums run in another
  order (on CUDA with atomics, in no fixed order), so centroids agree with
  the JAX package's to fp32 rounding, not bit for bit.

Every product here is full fp32: ``_full_fp32`` turns TF32 off for the
matmuls of these functions on CUDA (PyTorch's default, enforced here) and
restores the caller's setting after.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils.device import as_tensor


@contextlib.contextmanager
def _full_fp32():
    """fp32 matmuls in full fp32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _argmax_l2(xb: torch.Tensor, cent: torch.Tensor,
               c_half: torch.Tensor) -> torch.Tensor:
    """[B] nearest-centroid ids of the fp32 rows ``xb``; ties to the lower
    id, as ``jnp.argmax``."""
    return torch.argmax(xb @ cent.T - c_half[None, :], dim=1)


def kmeans_init(x: torch.Tensor, k: int, *, seed: int = 0) -> torch.Tensor:
    """[k, d] fp32 initial centroids: k distinct random rows (all rows,
    repeated to k, when there are fewer than k)."""
    n = x.shape[0]
    k_eff = min(k, n)
    g = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=g)[:k_eff].to(x.device)
    cent = x[idx].float()
    if k_eff < k:  # degenerate tiny inputs: duplicate rows to keep shape
        cent = cent.repeat(-(-k // k_eff), 1)[:k]
    return cent.contiguous()


def lloyd(
    x: torch.Tensor,
    init_centroids: torch.Tensor,
    iters: int,
    *,
    seed: int = 0,
    block_size: int = 131072,
) -> torch.Tensor:
    """[k, d] fp32 centroids after ``iters`` Lloyd iterations from
    ``init_centroids``. A cluster left empty by an iteration takes a random
    row (drawn each iteration from a generator seeded with ``seed + 1``)."""
    n, d = x.shape
    cent = init_centroids.float().to(x.device).contiguous()
    k = cent.shape[0]
    g = torch.Generator().manual_seed(seed + 1)
    with _full_fp32():
        for _ in range(iters):
            c_half = 0.5 * torch.sum(cent * cent, dim=1)
            sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
            counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
            for base in range(0, n, block_size):
                xb = x[base : base + block_size].float()
                assign = _argmax_l2(xb, cent, c_half)
                sums.index_add_(0, assign, xb)
                counts += torch.bincount(assign, minlength=k).float()
            reseed = x[torch.randint(0, n, (k,), generator=g).to(
                x.device)].float()
            new_cent = sums / torch.clamp(counts, min=1.0)[:, None]
            cent = torch.where((counts < 0.5)[:, None], reseed, new_cent)
    return cent.contiguous()


def kmeans(
    x: torch.Tensor,
    k: int,
    *,
    iters: int = 15,
    seed: int = 0,
    block_size: int = 131072,
) -> torch.Tensor:
    """[k, d] fp32 centroids by Lloyd's iterations under L2 over the rows
    of ``x`` (any dtype; blocks of ``block_size`` rows are cast to fp32)."""
    return lloyd(x, kmeans_init(x, k, seed=seed), iters, seed=seed,
                 block_size=block_size)


def assign_clusters(
    x: torch.Tensor, centroids: torch.Tensor, *, block_size: int = 131072
) -> torch.Tensor:
    """[n] int32 nearest-centroid (L2) ids, blocked as ``kmeans``: each
    block of rows is cast to fp32, the corpus keeps its dtype."""
    c = centroids.float().to(x.device)
    c_half = 0.5 * torch.sum(c * c, dim=1)
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    with _full_fp32():
        for base in range(0, x.shape[0], block_size):
            xb = x[base : base + block_size].float()
            out[base : base + xb.shape[0]] = _argmax_l2(xb, c, c_half).to(
                torch.int32)
    return out


def ivfpq_train_device(
    x,
    nlist: int,
    m: int,
    *,
    ksub: int = 256,
    iters: int = 15,
    seed: int = 0,
    block_size: int = 131072,
) -> tuple[np.ndarray, np.ndarray]:
    """IVF-PQ parameters trained on the device: (coarse [nlist, d],
    codebooks [m, ksub, d / m]) as host float32, for
    ``IVFPQIndex.set_trained``. L2 Lloyd's for the coarse quantizer, then
    L2 Lloyd's in each subspace over the residuals of every row to its
    nearest list, as the C++ trainer does. ``x``: a tensor, trained on
    its device, or numpy, which goes to the card."""
    x = as_tensor(x)
    dsub = x.shape[1] // m
    coarse = kmeans(x, nlist, iters=iters, seed=seed, block_size=block_size)
    assigns = assign_clusters(x, coarse, block_size=block_size)
    resid = x.float() - coarse[assigns.long()]
    books = [
        kmeans(resid[:, s * dsub : (s + 1) * dsub].contiguous(), ksub,
               iters=iters, seed=seed + 1000 + s, block_size=block_size)
        for s in range(m)
    ]
    return coarse.cpu().numpy(), torch.stack(books).cpu().numpy()


def ivfpq_encode_device(x, coarse, codebooks, *,
                        block_size: int = 131072
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Each row's list and PQ codes on the device: (assigns [n] int32,
    codes [n, m] uint8) as host arrays, for ``IVFPQIndex.add_encoded``.
    ``x`` as ``ivfpq_train_device``'s; the parameters (numpy or tensors)
    go to its device."""
    x = as_tensor(x)
    coarse = torch.as_tensor(coarse, device=x.device).float()
    cb = torch.as_tensor(codebooks, device=x.device)
    assigns = assign_clusters(x, coarse, block_size=block_size)
    resid = x.float() - coarse[assigns.long()]
    codes = pq_encode(resid, cb, m=int(cb.shape[0]),
                      block_size=min(block_size, 32768))
    return assigns.cpu().numpy(), codes.cpu().numpy()


def pq_encode(resid: torch.Tensor, codebooks: torch.Tensor, *, m: int,
              block_size: int = 32768) -> torch.Tensor:
    """[n, m] uint8 PQ codes: each subspace's nearest codebook entry (L2).

    ``resid`` is [n, d] residuals (row minus its list's centroid),
    ``codebooks`` [m, ksub, d / m], the C++ index's layout. Rows go in
    blocks: an unblocked [n, m, ksub] score tensor is ~16 GB fp32 at 1M
    rows, 16 subspaces and 256 entries."""
    n, d = resid.shape
    dsub = d // m
    cb = codebooks.float().to(resid.device)
    half_norm = 0.5 * torch.sum(cb * cb, dim=2)  # [m, ksub]
    out = torch.empty((n, m), dtype=torch.uint8, device=resid.device)
    with _full_fp32():
        for base in range(0, n, block_size):
            rb = resid[base : base + block_size].float().reshape(-1, m, dsub)
            scores = torch.einsum("nmd,mkd->nmk", rb, cb) - half_norm[None]
            out[base : base + rb.shape[0]] = torch.argmax(scores, dim=2).to(
                torch.uint8)
    return out
