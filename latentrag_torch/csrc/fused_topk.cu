// Fused distance + top-k for Hopper (sm_90a): the CUDA port of the JAX
// package's Pallas kernels in ops/pallas_topk.py. Every kernel runs on the
// tensor cores (mma.sync), one template for each TPU kernel, instantiated
// for three operand kinds (OP: bf16, packed binary, fp32):
//
//   fold_mma_kernel<E, OP>   (fold_mma.cuh) replaces _fold_kernel
//                            (pallas_topk.py:162-179, _fold_body :114-159)
//                            for bf16 (OP_BF16) and fp32 (OP_F32) stores, and
//                            _binary_fold_kernel (:354-401) as OP_BIN;
//                            fold_merge_kernel<E> merges its slabs
//   exact_mma_kernel<KP, OP> (exact_mma.cuh) replaces _exact_kernel
//                            (pallas_topk.py:182-221) for bf16 and fp32
//                            stores, and as OP_BIN the exact sign-dot search
//                            binary_topk (the JAX package's ops/binary.py:129)
//                            where the binary store's stage 1 asks for more
//                            candidates than the fold's 128 lanes hold;
//                            exact_merge_kernel<KP> merges its slabs. The TPU
//                            grid ran the corpus tiles in order and carried
//                            the running top-k in VMEM; here slabs run in
//                            parallel and the merge kernels join their lists.
//   exact_select_kernel<OP, C> (exact_select.cuh) replaces _exact_kernel past
//                            the exact_mma_kernel lists' k = 2048 (the TPU
//                            kernel takes any k <= N) for bf16 and fp32
//                            stores: a threshold from a strided sample's
//                            scores (exact_mma_kernel), one pass that keeps
//                            the keys at or above it in per-query buffers,
//                            a radix select of the k-th key over histogram
//                            passes for the queries it does not serve, and a
//                            per-query sort.
//
// What is computed (the TPU kernels' contract, not their block structure):
//   score(q, c) = q.c                          (cosine / dot: inputs pre-normalized)
//               = 2 q.c - |q|^2 - corpus_sq[c] (euclidean / mahalanobis on whitened
//                                               inputs; |q|^2 from the stored values,
//                                               dim by dim, rounded as row_sq)
//   accumulated in fp32; the [Q, N] score matrix is never written to device
//   memory. binary: score(q, c) = sum_{j<d} bf16(q_j) * (2 bit_j(c) - 1)
//   (pad bits past d never count), from a row-major store of packed sign
//   words [N, ceil(d/32)] (bit j of word w <-> dim 32w + j), unpacked to +-1
//   bf16 a stage at a time in shared memory. Scores become order-preserving
//   int32 keys (_monotone_i32). Rows >= n never win.
//   exact: the top-k of (key desc, row asc) over all rows: ties go to the lower row.
//   fold:  per aligned tile of block_n rows (block_n = 4096 by default), each of
//          the 128 lanes (lane = column mod 128) keeps the max packed value
//          (key with its low 13 bits replaced by the tile column); the result is
//          the top-k of the union of all lanes' winners under
//          (quantized key desc, tile asc, column desc) -- exactly what the TPU's
//          in-order running merge of per-tile top-k lists yields. Because the
//          order is total, the result does not depend on which slab finishes
//          first, and slabs aligned to block_n give the same ids as the plain
//          fold in ops/fused_topk.py.
//
// Products. bf16 x bf16 and bf16 x +-1 products are exact in the m16n8k16
// bf16 mma, so only the order of the fp32 sums differs from the plain
// version. fp32 stores keep fp32 accuracy by 3xTF32 on m16n8k8 tf32 mma:
// each fp32 operand x splits into hi = tf32_rna(x) and lo = tf32_rna(x -
// hi), both rounded to nearest (ties away, as cvt.rna.tf32.f32 rounds), not
// truncated as the tensor cores would read them, and a product is lo.hi' +
// hi.lo' + hi.hi' accumulated in fp32: each k8 step's products sum from
// zero on the tensor cores and join the running sum by a round-to-nearest
// fp32 add, since the tensor cores' own accumulation truncates and would
// build a one-sided error over a long sum. x - hi is exact and the rounding
// of lo leaves at most 2^-22 |x|, so with the dropped lo.lo' term a product
// is within about 3 x 2^-22 of |x x'| -- the size of the fp32 sum-order
// differences the checks already allow (scores within 1e-4 + 1e-5 |s|, ids
// >= 99.9 %). No operand is rounded to 10-bit TF32, and every store path
// rescores its winners in fp32, so returned scores stay exact fp32 of the
// selected rows.
//
// Bound on the H100: at the main path's shapes (d = 64, k = 10) the work is
// 2*Q*N*d operations against N*d bytes of corpus, far above the card's ridge
// point, so the limit is arithmetic: 989 TFLOP/s of bf16 tensor cores, and
// for fp32 stores 495 / 3 = 165 TFLOP/s of fp32-accurate 3xTF32 products
// (2.5x the 67 TFLOP/s of fp32 FMAs). What the designs do about it (each
// header says more): a ring of corpus stages (128 rows x 128 bytes: 64 bf16
// or 32 fp32 dims) arrives by cp.async while the previous one is scored,
// ldmatrix feeds mma.sync from swizzled shared memory, the fold keeps its
// lane maxima in registers and the exact search rejects almost every score
// with one fp32 compare, the lists are kept by batched bitonic networks,
// and the corpus splits into slabs so that a few query tiles still fill the
// 132 SMs.
//
// Launch: one C function per kernel family, plain C interface, loaded with
// ctypes. Each runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

#define TN 128         // corpus rows per sub-tile = the fold's 128 lanes
#define DCH 64         // bf16 feature dims per shared-memory stage (32 fp32)
#define MIN_I32 (-2147483647)  // the TPU kernels' _MIN_I32 = -(2**31) + 1
#define IDX_MASK 0x1FFF        // 13-bit tile column (block_n <= 8192)

// Operand kinds of the tensor-core kernels (the C API's `op`): bf16 queries
// and corpus; bf16 queries and packed sign words; fp32 queries and corpus,
// multiplied in 3xTF32.
enum { OP_BF16 = 0, OP_BIN = 1, OP_F32 = 2 };

extern "C" {

const char* lr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#include "fold_mma.cuh"
#include "exact_mma.cuh"
#include "exact_select.cuh"
