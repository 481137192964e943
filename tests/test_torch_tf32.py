"""The fp32 stores' 3xTF32 contract (``csrc/fused_topk.cu``), held on the CPU.

The CUDA kernels multiply fp32 operands on the tensor cores in 3xTF32:
each operand x splits into hi = tf32_rna(x) and lo = tf32_rna(x - hi), a
product is lo.hi' + hi.lo' + hi.hi', and the sums are fp32. This file
mirrors that product in torch (a test-only emulation, on no path of the
port): tf32_rna by bit arithmetic, one k8 step of 8 dims at a time as the
kernels' mma.sync.m16n8k8 steps run, each step's three products summed
from zero and added to the running sum in fp32; a numpy model of the
tensor cores' truncating accumulation shows why the steps sum apart. With
seeded inputs at the main path's latent width (d = 64) and the encoder's
(d = 384), cosine, euclidean and whitened mahalanobis, it holds that

* the emulated scores are within 2^-20 sum |q_i c_i| of fp64, as the
  plain fp32 version's are;
* exact top-k on the emulated scores gives the plain fp32 version's ids on
  >= 99.9 % of slots at k = 10 and 300, and the fold's on >= 99 % at the
  main path's plan (128-row tiles, 40 candidates);
* both agree with the JAX package's Pallas kernels in interpret mode.

The kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from latentrag_tpu.ops.distances import (
    estimate_covariance,
    prepare_for_metric,
    whitening_factor,
)
from latentrag_tpu.ops.pallas_topk import pallas_topk_raw
from latentrag_torch.ops import fused_topk as ft

NQ, N = 64, 2000
METRICS = ["cosine", "euclidean", "mahalanobis"]


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the
    magnitude's bits and clear them (a carry rounds up into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)  # x - hi is exact in fp32


def _dots_3xtf32(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q.c as the kernels form it: per 8-dim k step, lo.hi' + hi.lo' +
    hi.hi' summed from zero, then added to the running sum, all in fp32."""
    qh, ql = _split(q)
    ch, cl = _split(c)
    acc = torch.zeros((q.shape[0], c.shape[0]), dtype=torch.float32)
    for j in range(0, q.shape[1], 8):
        s = slice(j, j + 8)
        step = ql[:, s] @ ch[:, s].T
        step = step + qh[:, s] @ cl[:, s].T
        step = step + qh[:, s] @ ch[:, s].T
        acc = acc + step
    return acc


def _to_f32_toward_zero(x: np.ndarray) -> np.ndarray:
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _dots_truncating(q: torch.Tensor, c: torch.Tensor,
                     step_sums: bool) -> np.ndarray:
    """A model of the tensor cores' accumulation: each m16n8k8 mma adds
    its 8 exact products to C and truncates the result toward zero. With
    ``step_sums`` each k step's three mma start from zero and the step sum
    joins the running sum by a rounded fp32 add (the kernels' way);
    without, the running sum is the mma's C throughout."""
    (qh, ql), (ch, cl) = _split(q), _split(c)
    qh, ql, ch, cl = (t.double().numpy() for t in (qh, ql, ch, cl))
    acc = np.zeros((q.shape[0], c.shape[0]), np.float32)
    for j in range(0, q.shape[1], 8):
        s = slice(j, j + 8)
        p = np.zeros_like(acc) if step_sums else acc
        for a, b in ((ql, ch), (qh, cl), (qh, ch)):
            p = _to_f32_toward_zero(p.astype(np.float64) + a[:, s] @ b[:, s].T)
        acc = (acc + p).astype(np.float32) if step_sums else p
    return acc


@functools.cache
def _case(metric: str, d: int):
    """Seeded prepared inputs (JAX arrays and torch tensors, fp32), the
    emulated kernel scores, and the rows' norms^2 for euclidean scores."""
    rng = np.random.default_rng(d * 10 + METRICS.index(metric))
    q = rng.standard_normal((NQ, d)).astype(np.float32)
    c = rng.standard_normal((N, d)).astype(np.float32)
    w = None
    if metric == "mahalanobis":
        scale = np.linspace(0.2, 5.0, d, dtype=np.float32)
        q, c = q * scale, c * scale
        w = whitening_factor(estimate_covariance(jnp.asarray(c)))
    qj = prepare_for_metric(jnp.asarray(q), metric, w)
    cj = prepare_for_metric(jnp.asarray(c), metric, w)
    qt = torch.from_numpy(np.array(qj))
    ct = torch.from_numpy(np.array(cj))
    return qj, cj, qt, ct, _dots_3xtf32(qt, ct)


def _emulated_topk(metric, d, k, mode, block_n=4096):
    """The plain top-k loop of ``ops/fused_topk.py`` over the emulated
    kernel scores (euclidean: 2 q.c - |q|^2 - |c|^2 with the kernels'
    |q|^2 order)."""
    _, _, qt, ct, dots = _case(metric, d)
    if ft._metric_kind(metric) == "euclidean":
        scores = (2.0 * dots - ft.row_sq(qt)[:, None]
                  - torch.sum(torch.square(ct), dim=1)[None, :])
    else:
        scores = dots

    def score_tile(base, end):
        tile = torch.zeros((NQ, block_n), dtype=torch.float32)
        tile[:, : end - base] = scores[:, base:end]
        return tile

    return ft._plain_topk(score_tile, NQ, N, min(k, N), mode, block_n,
                          torch.device("cpu"))


def test_tf32_rna_rounds_to_nearest_away():
    """Low 13 bits cleared, the nearest tf32 value, a tie away from zero,
    and x = hi + lo to within 2^-22 |x|."""
    one = 1.0 + 2.0**-10  # the tf32 neighbour of 1
    x = torch.tensor([1.0 + 2.0**-12, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-12,
                      -(1.0 + 2.0**-11), 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, one, one, -one, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(
        100_000).astype(np.float32))
    hi, lo = _split(v)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((v - hi).abs() <= 2.0**-11 * v.abs()).all())
    err = (v.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-22 * v.double().abs()).all())


@pytest.mark.parametrize("d", [64, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_3xtf32_dots_within_bound_of_fp64(metric, d):
    """Emulated q.c within 2^-20 sum |q_i c_i| of fp64, and no further from
    it than a few times the plain fp32 product's largest error."""
    _, _, qt, ct, dots = _case(metric, d)
    exact = qt.double() @ ct.double().T
    scale = qt.double().abs() @ ct.double().abs().T
    err = (dots.double() - exact).abs()
    assert bool((err <= 2.0**-20 * scale).all())
    plain = (qt @ ct.T).double()
    assert bool(((plain - exact).abs() <= 2.0**-20 * scale).all())
    assert float((err / scale).max()) <= 4 * float(
        ((plain - exact).abs() / scale).max()) + 2.0**-22


@pytest.mark.parametrize("d", [64, 384])
def test_step_sums_keep_truncating_mma_in_bound(d):
    """Why each k step's products sum from zero: under truncating
    accumulation a running sum in the mma's C drifts one way by about an
    ulp of itself a step, past 2^-20 sum |q_i c_i| at d = 384 (whitened
    mahalanobis); step sums stay within it, as plain fp32 sums do."""
    _, _, qt, ct, _ = _case("mahalanobis", d)
    exact = (qt.double() @ ct.double().T).numpy()
    bound = 2.0**-20 * (qt.double().abs() @ ct.double().abs().T).numpy()
    err_steps = np.abs(_dots_truncating(qt, ct, True) - exact)
    err_c = np.abs(_dots_truncating(qt, ct, False) - exact)
    assert bool((err_steps <= bound).all())
    assert err_c.max() > 4 * err_steps.max()
    if d == 384:
        assert not bool((err_c <= bound).all())


@pytest.mark.parametrize("k", [10, 300])
@pytest.mark.parametrize("d", [64, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_3xtf32_exact_ids_match_plain(metric, d, k):
    _, _, qt, ct, _ = _case(metric, d)
    _, i_e = _emulated_topk(metric, d, k, "exact")
    _, i_p = ft.fused_topk_raw(qt, ct, k=k, metric=metric, mode="exact")
    assert (i_e == i_p).float().mean().item() >= 0.999


@pytest.mark.parametrize("d", [64, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_3xtf32_fold_ids_match_plain_at_main_plan(metric, d):
    """The fold as the main path plans it (``fold_plan`` at N=2000, k=10:
    128-row tiles, 40 candidates); keys are 19-bit, so a score may cross
    one key step."""
    block_n, cand = ft.fold_plan(N, 10, 0.99)
    assert (block_n, cand) == (128, 40)
    _, _, qt, ct, _ = _case(metric, d)
    _, i_e = _emulated_topk(metric, d, cand, "fold", block_n)
    _, i_p = ft.fused_topk_raw(qt, ct, k=cand, metric=metric, mode="fold",
                               block_n=block_n)
    assert (i_e == i_p).float().mean().item() >= 0.99


@pytest.mark.parametrize("mode", ["exact", "fold"])
@pytest.mark.parametrize("d", [64, 384])
@pytest.mark.parametrize("metric", METRICS)
def test_3xtf32_and_plain_match_pallas_interpret(metric, d, mode):
    """The emulated kernel and the plain version against the JAX package's
    Pallas kernel in interpret mode on the same inputs: exact at k=10, the
    fold at the main path's plan."""
    qj, cj, qt, ct, _ = _case(metric, d)
    k, block_n = (10, 2048) if mode == "exact" else (40, 128)
    s_j, i_j = pallas_topk_raw(qj, cj, k=k, metric=metric, mode=mode,
                               block_q=64, block_n=block_n, interpret=True)
    i_j = np.asarray(i_j)
    s_e, i_e = _emulated_topk(metric, d, k, mode, block_n)
    s_p, i_p = ft.fused_topk_raw(qt, ct, k=k, metric=metric, mode=mode,
                                 block_n=block_n)
    want = 0.999 if mode == "exact" else 0.99
    for s_t, i_t in ((s_e, i_e), (s_p, i_p)):
        same = i_t.numpy() == i_j
        assert same.mean() >= want
        # fp32 sums in another order; fold keys are 19-bit (one key step)
        tol = 1e-4 if mode == "exact" else 2e-3
        np.testing.assert_allclose(s_t.numpy()[same], np.asarray(s_j)[same],
                                   rtol=tol, atol=tol)
