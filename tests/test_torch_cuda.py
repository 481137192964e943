"""Tests of the port that need the card: the CUDA kernels have no CPU
mode. Each skips here with its reason; on a machine with an NVIDIA GPU and
nvcc run them with

    python -m pytest tests/test_torch_cuda.py -m cuda

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed."""

import numpy as np
import pytest
import torch

from latentrag_torch.ops import binary as tb
from latentrag_torch.ops import fused_topk as ft

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _data(cuda, dtype, nq=37, n=9000, d=64, seed=0):
    """Seeded queries and corpus on the card. d=64 takes the kernels'
    16-byte staged loads; other widths the element-wise loads."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((nq, d), generator=g, device=cuda).to(dtype)
    c = torch.randn((n, d), generator=g, device=cuda).to(dtype)
    return q, c


@pytest.mark.parametrize("d", [64, 50])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("mode", ["exact", "fold"])
def test_kernel_matches_plain(cuda, mode, metric, store, d):
    q, c = _data(cuda, getattr(torch, store), d=d)
    s_k, i_k = ft.fused_topk_raw(q, c, k=16, metric=metric, mode=mode)
    s_p, i_p = ft.fused_topk_raw_reference(q, c, k=16, metric=metric,
                                           mode=mode)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.99
    if mode == "exact":  # fp32 sums in another order
        tol = 1e-4 + 1e-5 * s_p.abs()
        assert bool(((s_k - s_p).abs() <= tol)[same].all())


def test_launch_counts_and_validation(cuda):
    q, c = _data(cuda, torch.float32, n=500)
    ft.reset_launches()
    ft.fused_topk(q, c, k=5, mode="fold")
    ft.fused_topk(q, c, k=5, mode="exact")
    ft.approx_fused_topk(q, c, k=5)
    assert ft.launches == {"fold": 2, "exact": 1, "binary_fold": 0}
    with pytest.raises(ValueError, match="contiguous"):
        ft.fused_topk_raw(q, c.T.contiguous().T, k=5)


def test_approx_route_recall(cuda):
    q, c = _data(cuda, torch.bfloat16, nq=200, n=50_000)
    q = torch.nn.functional.normalize(q.float(), dim=1).bfloat16()
    c = torch.nn.functional.normalize(c.float(), dim=1).bfloat16()
    _, i0 = ft.fused_topk_raw(q, c, k=10, mode="exact")
    _, i1 = ft.approx_fused_topk(q, c, k=10, recall_target=0.99)
    hits = (i1[:, :, None] == i0[:, None, :]).any(-1).float().mean().item()
    assert hits >= 0.99


def test_main_path_on_card(cuda, tmp_path):
    from latentrag_torch import main as torch_main
    from latentrag_torch.models import VariationalAutoencoder

    base = str(tmp_path)
    torch.manual_seed(5)
    torch.save(VariationalAutoencoder(32, 8, 16).state_dict(),
               f"{base}/vae.pth")
    ft.reset_launches()
    results = []
    rc = torch_main.main([
        "--ae_type", "vae", "--set", "data.dataset=synthetic",
        "data.max_samples=60", "encoder.vocab_size=800",
        "encoder.hidden_dim=32", "encoder.num_layers=1",
        "encoder.num_heads=4", "encoder.mlp_dim=64",
        "models.vae.input_dim=32", "models.vae.latent_dim=8",
        "models.vae.hidden_dim=16", f"models.vae.checkpoint={base}/vae.pth",
        f"paths.data_dir={base}/data", f"paths.checkpoints_dir={base}/ckpt",
        f"paths.logs_dir={base}/logs", "logging.log_to_file=false",
    ], results=results)
    assert rc == 0
    assert ft.launches["fold"] >= 1 and ft.launches["exact"] >= 1
    assert np.isfinite(results[0]["doc_scores"]).all()


def _binary_data(cuda, d, nq=37, n=9000, seed=0):
    """Seeded bf16 queries and the packed sign words of a unit corpus."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((nq, d), generator=g, device=cuda).bfloat16()
    c = torch.nn.functional.normalize(
        torch.randn((n, d), generator=g, device=cuda), dim=1)
    return q, tb.binary_quantize(c)


@pytest.mark.parametrize("block_n", [4096, 512])
@pytest.mark.parametrize("d", [64, 48])
def test_binary_kernel_matches_plain(cuda, d, block_n):
    """d=48 pads each row's last word; N=9000 is not a multiple of the
    tile; 37 queries leave a ragged query tile."""
    q, packed = _binary_data(cuda, d)
    s_k, i_k = ft.binary_fused_topk_raw(q, packed, d=d, k=16,
                                        block_n=block_n)
    s_p, i_p = ft.binary_fused_topk_raw_reference(q, packed, d=d, k=16,
                                                  block_n=block_n)
    same = i_k == i_p
    assert same.float().mean().item() >= 0.99
    e_k, j_k = ft.rescore_binary_candidates(q, packed, i_k, d)
    e_p, j_p = ft.rescore_binary_candidates(q, packed, i_p, d)
    eq = j_k == j_p
    tol = 1e-5 + 1e-6 * e_p.abs()
    assert bool(((e_k - e_p).abs() <= tol)[eq].all())


def test_binary_launch_counts_and_store(cuda):
    q, packed = _binary_data(cuda, 64, n=3000)
    ft.reset_launches()
    ft.binary_fused_topk(q, packed, d=64, k=5)
    ft.approx_binary_fused_topk(q, packed, d=64, k=40)
    assert ft.launches == {"fold": 0, "exact": 0, "binary_fold": 2}
    with pytest.raises(ValueError, match="at most 128"):
        ft.approx_binary_fused_topk(q, packed, d=64, k=129)

    from latentrag_torch.retrieval import DenseRetriever

    emb = torch.randn((3000, 64), generator=torch.Generator().manual_seed(1))
    r = DenseRetriever(store_dtype="binary", device="cuda")
    ft.reset_launches()
    r.build(emb.numpy(), [str(i) for i in range(3000)])
    s, i = r.search(emb[:20].numpy(), 10)
    assert ft.launches["binary_fold"] == 2  # self-check and search
    assert (i[:, 0] == np.arange(20)).all() and np.isfinite(s).all()
    assert r._corpus.is_cuda and r._corpus.dtype == torch.int32
