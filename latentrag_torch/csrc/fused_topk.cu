// Fused distance + top-k for Hopper (sm_90a): the CUDA port of the JAX
// package's Pallas kernels in ops/pallas_topk.py.
//
//   fold_mma_kernel<E, false> (fold_mma.cuh) replaces _fold_kernel
//                                  (pallas_topk.py:162-179, _fold_body :114-159)
//                                  for bf16 stores, on the tensor cores;
//   partial_kernel<TQ, FOLD=true>  replaces it for fp32 stores
//   exact_mma_kernel<KP, false> (exact_mma.cuh) replaces _exact_kernel
//                                  (pallas_topk.py:182-221) for bf16 stores,
//                                  on the tensor cores
//   partial_kernel<TQ, FOLD=false> replaces it for fp32 stores
//   fold_mma_kernel<E, true>  (fold_mma.cuh) replaces _binary_fold_kernel
//                                  (pallas_topk.py:354-401), on the tensor cores
//   exact_mma_kernel<KP, true> (exact_mma.cuh) replaces the exact sign-dot
//                                  search binary_topk (the JAX package's
//                                  ops/binary.py:129) where the binary
//                                  store's stage 1 asks for more candidates
//                                  than the fold's 128 lanes hold
//   merge_kernel                   partial_kernel's slab merge, with no TPU
//                                  counterpart: the TPU grid ran the corpus
//                                  tiles in order and carried the running
//                                  top-k in VMEM scratch; here slabs run in
//                                  parallel and this kernel merges their lists.
//
// What is computed (the TPU kernels' contract, not their block structure):
//   score(q, c) = q.c                          (cosine / dot: inputs pre-normalized)
//               = 2 q.c - |q|^2 - corpus_sq[c] (euclidean / mahalanobis on whitened
//                                               inputs; |q|^2 from the stored values,
//                                               dim by dim, rounded as row_sq)
//   accumulated in fp32 from fp32 or bf16 inputs; the [Q, N] score matrix is
//   never written to device memory.
//   binary: score(q, c) = sum_{j<d} bf16(q_j) * (2 bit_j(c) - 1), accumulated
//   in fp32 (pad bits past d never count), from a row-major store of packed
//   sign words [N, ceil(d/32)] (bit j of word w <-> dim 32w + j). Each stage
//   unpacks to +-1 bf16 in shared memory (fold_mma.cuh), so the unpacked
//   [N, d] corpus never exists in device memory either. Scores become
//   order-preserving int32 keys (_monotone_i32). Rows >= n never win.
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
// Bound on the H100: at the main path's shapes (d = 64, k = 10) the work is
// 2*Q*N*d operations against N*d*2 bytes of bf16 corpus, far above the card's
// ridge point, so the limit is arithmetic. partial_kernel scores fp32
// stores with fp32 FMAs (67 TFLOP/s peak, not the 989 TFLOP/s of bf16
// tensor cores), which keeps their scores exact fp32; bf16 and binary
// stores run on mma.sync tiles (fold_mma.cuh, exact_mma.cuh). What the
// design does about the bound it
// has: each block keeps its query tile resident in shared memory and streams
// corpus stages (128 rows x 64 dims) through it, loading the next stage with
// 16-byte loads while the current one is scored, so global latency hides
// behind the FMAs; each thread scores a 4-column x (TQ/8)-query register
// tile, so two 16-byte shared loads feed 16 FMAs; corpus traffic is one read
// per query tile (largely served from the 50 MB L2), and the corpus is split
// into slabs so that a few query tiles still fill the 132 SMs. Candidate
// lists live in shared memory (registers would spill at k = 128), one warp
// keeps one query's list sorted, and a per-list threshold rejects almost
// every candidate with one compare.
//
// Launch: one C function per kernel, plain C interface, loaded with ctypes.
// Each runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

#define NTHREADS 256
#define TN 128         // corpus rows per sub-tile = the fold's 128 lanes
#define DCH 64         // feature dims per shared-memory stage
#define MIN_I32 (-2147483647)  // the TPU kernels' _MIN_I32 = -(2**31) + 1
#define IDX_MASK 0x1FFF        // 13-bit tile column (block_n <= 8192)
#define EMPTY_KEY INT_MIN      // a list slot that holds no row yet
#define EMPTY_IDX INT_MAX

__device__ __forceinline__ int monotone_i32(float s) {
    int b = __float_as_int(s);
    return b >= 0 ? b : (b ^ 0x7FFFFFFF);
}

// The total order both modes rank by (see the header).
__device__ __forceinline__ bool better(int ka, int ia, int kb, int ib,
                                       int fold, int block_n) {
    if (ka != kb) return ka > kb;
    if (fold) {
        int ta = ia / block_n, tb = ib / block_n;
        if (ta != tb) return ta < tb;
        return ia > ib;
    }
    return ia < ib;
}

// Insert (ck, ci) into the sorted list K/I of length k. Warp-cooperative:
// every lane of the warp calls it with the same arguments.
__device__ void warp_insert(int* K, int* I, int k, int ck, int ci,
                            int fold, int block_n, int lane) {
    int cnt = 0;
    for (int i = lane; i < k; i += 32)
        cnt += better(K[i], I[i], ck, ci, fold, block_n) ? 1 : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    const int pos = cnt;
    if (pos >= k) return;
    // shift [pos, k-2] down one slot, top chunk first, so every read of a
    // chunk happens before any write into it
    if (k >= 2) {
        for (int base = ((k - 2) >> 5) << 5; base >= ((pos >> 5) << 5);
             base -= 32) {
            const int i = base + lane;
            const bool mv = (i >= pos) && (i <= k - 2);
            int tk = 0, ti = 0;
            if (mv) { tk = K[i]; ti = I[i]; }
            __syncwarp();
            if (mv) { K[i + 1] = tk; I[i + 1] = ti; }
            __syncwarp();
        }
    }
    if (lane == 0) { K[pos] = ck; I[pos] = ci; }
    __syncwarp();
}

// Offer ncand candidates (keys ck, rows ci) to one query's list.
__device__ void warp_consume(const int* ck, const int* ci, int ncand,
                             int* K, int* I, int k, int fold, int block_n,
                             int lane) {
    int lk = K[k - 1], li = I[k - 1];
    for (int j0 = 0; j0 < ncand; j0 += 32) {
        const int j = j0 + lane;
        int key = EMPTY_KEY, idx = EMPTY_IDX;
        if (j < ncand) { key = ck[j]; idx = ci[j]; }
        const bool pass = key != EMPTY_KEY &&
                          better(key, idx, lk, li, fold, block_n);
        unsigned m = __ballot_sync(0xffffffffu, pass);
        while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const int k2 = __shfl_sync(0xffffffffu, key, src);
            const int i2 = __shfl_sync(0xffffffffu, idx, src);
            if (better(k2, i2, lk, li, fold, block_n)) {
                warp_insert(K, I, k, k2, i2, fold, block_n, lane);
                lk = K[k - 1];
                li = I[k - 1];
            }
        }
    }
}

// A stage is rows [t0, t0 + TN) x dims [d0, d0 + DCH) of the corpus, held
// in shared memory transposed ([DCH][TN], fp32). The 4-column groups are
// swizzled by (dd >> 3) & 7, so the loads' transposed stores and the score
// loop's 16-byte reads both avoid bank conflicts.
__device__ __forceinline__ int cs_index(int dd, int r) {
    return dd * TN + ((((r >> 2) ^ ((dd >> 3) & 7))) << 2) + (r & 3);
}

// 16-byte loads of one fp32 stage into registers, 8 per thread.
// Needs d % DCH == 0 and a 16-byte aligned corpus (the wrapper checks).
__device__ __forceinline__ void stage_fetch(uint4 (&buf)[8], const float* cp,
                                            int n, int d, int t0, int d0,
                                            int tid) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int v = tid + NTHREADS * u, r = v >> 4, j = v & 15;
        const int row = t0 + r;
        buf[u] = row < n ? __ldg(reinterpret_cast<const uint4*>(
                     cp + (size_t)row * d + d0 + 4 * j))
                         : zero;
    }
}

__device__ __forceinline__ void stage_commit(const uint4 (&buf)[8], float* Cs,
                                             int tid) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int v = tid + NTHREADS * u, r = v >> 4, j = v & 15;
        Cs[cs_index(4 * j, r)] = __uint_as_float(buf[u].x);
        Cs[cs_index(4 * j + 1, r)] = __uint_as_float(buf[u].y);
        Cs[cs_index(4 * j + 2, r)] = __uint_as_float(buf[u].z);
        Cs[cs_index(4 * j + 3, r)] = __uint_as_float(buf[u].w);
    }
}

// grid: (query tiles of TQ, corpus slabs of slab_rows rows); fp32 queries
// and corpus. Each block
// writes its queries' top-k of its slab to out[slab, q, :]. slab_rows is a
// multiple of block_n in fold mode, so fold tiles never straddle slabs.
// With vec set, the next stage's loads are in flight while this stage is
// scored; otherwise (d not a multiple of DCH) each stage loads element by
// element.
template <int TQ, bool FOLD>
__global__ void __launch_bounds__(NTHREADS, 2)
partial_kernel(const float* __restrict__ qp, const float* __restrict__ cp,
               const float* __restrict__ csq, int nq, int n, int d, int k,
               int euclid, int block_n, int slab_rows, int vec,
               int* __restrict__ out_k, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* QsT = (float*)smem;                // [d, TQ], query tile transposed
    float* Cs = QsT + TQ * d;                 // [DCH, TN], one stage (swizzled)
    float* qsq = Cs + DCH * TN;               // [TQ]
    int* candK = (int*)(qsq + TQ);            // [TQ, TN]
    int* candI = candK + TQ * TN;             // [TQ, TN]
    int* LK = candI + TQ * TN;                // [TQ, k] running keys
    int* LI = LK + TQ * k;                    // [TQ, k] running rows

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * TQ;
    const int row0 = blockIdx.y * slab_rows;
    const int row1 = min(row0 + slab_rows, n);
    const int fold = FOLD ? 1 : 0;

    for (int e = tid; e < TQ * d; e += NTHREADS) {
        const int qi = e / d, dd = e - qi * d;
        const int q = q0 + qi;
        QsT[dd * TQ + qi] = q < nq ? qp[(size_t)q * d + dd] : 0.f;
    }
    for (int e = tid; e < TQ * k; e += NTHREADS) {
        LK[e] = EMPTY_KEY;
        LI[e] = EMPTY_IDX;
    }
    __syncthreads();
    if (tid < TQ) {
        float s = 0.f;
        for (int dd = 0; dd < d; ++dd)  // rounded as the plain version
            s = __fadd_rn(s, __fmul_rn(QsT[dd * TQ + tid], QsT[dd * TQ + tid]));
        qsq[tid] = s;
    }

    // thread -> CPT adjacent corpus columns x QPT adjacent queries. A warp
    // covers all 128 columns of one query group, so its query loads are
    // broadcasts, and each step of the d loop is two 16-byte shared loads
    // for CPT x QPT FMAs.
    constexpr int CPT = 4;
    constexpr int QPT = TQ / (NTHREADS / 32);
    const int c0 = lane * CPT;
    const int qb = warp * QPT;
    int folded[QPT][CPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) folded[i][j] = MIN_I32;

    const int n_dch = (d + DCH - 1) / DCH;
    const int n_stages = row1 > row0 ? ((row1 - row0 + TN - 1) / TN) * n_dch : 0;
    uint4 buf[8];
    if (vec && n_stages > 0) stage_fetch(buf, cp, n, d, row0, 0, tid);
    float acc[QPT][CPT];

    for (int st = 0; st < n_stages; ++st) {
        const int sub = st / n_dch, dci = st - sub * n_dch;
        const int t0 = row0 + sub * TN, d0 = dci * DCH;
        const int dc = min(DCH, d - d0);
        if (dci == 0) {
#pragma unroll
            for (int i = 0; i < QPT; ++i)
#pragma unroll
                for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
        }
        __syncthreads();  // the previous stage is done with Cs
        if (vec) {
            stage_commit(buf, Cs, tid);
        } else {
            for (int e = tid; e < TN * dc; e += NTHREADS) {
                const int r = e / dc, dd = e - r * dc;
                const int row = t0 + r;
                Cs[cs_index(dd, r)] =
                    row < n ? cp[(size_t)row * d + d0 + dd] : 0.f;
            }
        }
        __syncthreads();
        if (vec && st + 1 < n_stages) {
            const int nsub = (st + 1) / n_dch;
            stage_fetch(buf, cp, n, d, row0 + nsub * TN,
                        (st + 1 - nsub * n_dch) * DCH, tid);
        }
        for (int dd = 0; dd < dc; ++dd) {
            const float4 cv = *reinterpret_cast<const float4*>(
                &Cs[dd * TN + ((lane ^ ((dd >> 3) & 7)) << 2)]);
            const float* qrow = &QsT[(d0 + dd) * TQ + qb];
            float qv[QPT];
            if constexpr (QPT == 4) {
                const float4 t = *reinterpret_cast<const float4*>(qrow);
                qv[0] = t.x; qv[1] = t.y; qv[2] = t.z; qv[3] = t.w;
            } else if constexpr (QPT == 2) {
                const float2 t = *reinterpret_cast<const float2*>(qrow);
                qv[0] = t.x; qv[1] = t.y;
            } else {
                qv[0] = qrow[0];
            }
#pragma unroll
            for (int i = 0; i < QPT; ++i) {
                acc[i][0] = fmaf(qv[i], cv.x, acc[i][0]);
                acc[i][1] = fmaf(qv[i], cv.y, acc[i][1]);
                acc[i][2] = fmaf(qv[i], cv.z, acc[i][2]);
                acc[i][3] = fmaf(qv[i], cv.w, acc[i][3]);
            }
        }
        if (dci != n_dch - 1) continue;  // more dims of this sub-tile to come

        const int col0 = t0 + c0;
        float cs[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j)
            cs[j] = (euclid && col0 + j < n) ? csq[col0 + j] : 0.f;
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
            const int qi = qb + i;
            int keys[CPT];
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const bool valid = col0 + j < n;
                float s = acc[i][j];
                if (euclid) s = 2.0f * s - qsq[qi] - cs[j];
                const int mono = monotone_i32(s);
                if constexpr (FOLD) {
                    const int local = (col0 + j) % block_n;
                    const int packed =
                        valid ? ((mono & ~IDX_MASK) | local) : MIN_I32;
                    folded[i][j] = max(folded[i][j], packed);
                } else {
                    keys[j] = valid ? mono : EMPTY_KEY;
                }
            }
            if constexpr (!FOLD) {
                *reinterpret_cast<int4*>(&candK[qi * TN + c0]) =
                    make_int4(keys[0], keys[1], keys[2], keys[3]);
                *reinterpret_cast<int4*>(&candI[qi * TN + c0]) =
                    make_int4(col0, col0 + 1, col0 + 2, col0 + 3);
            }
        }

        if constexpr (FOLD) {
            const bool flush = ((t0 + TN) % block_n == 0) || (t0 + TN >= row1);
            if (!flush) continue;  // uniform across the block
            const int base = (t0 / block_n) * block_n;
#pragma unroll
            for (int i = 0; i < QPT; ++i) {
                const int qi = qb + i;
                int keys[CPT], rows[CPT];
#pragma unroll
                for (int j = 0; j < CPT; ++j) {
                    const int p = folded[i][j];
                    keys[j] = p == MIN_I32 ? EMPTY_KEY : (p & ~IDX_MASK);
                    rows[j] = base + (p & IDX_MASK);
                    folded[i][j] = MIN_I32;
                }
                *reinterpret_cast<int4*>(&candK[qi * TN + c0]) =
                    make_int4(keys[0], keys[1], keys[2], keys[3]);
                *reinterpret_cast<int4*>(&candI[qi * TN + c0]) =
                    make_int4(rows[0], rows[1], rows[2], rows[3]);
            }
        }
        __syncthreads();
        for (int qi = warp; qi < TQ; qi += NTHREADS / 32)
            warp_consume(candK + qi * TN, candI + qi * TN, TN, LK + qi * k,
                         LI + qi * k, k, fold, block_n, lane);
        __syncthreads();
    }

    for (int qi = warp; qi < TQ; qi += NTHREADS / 32) {
        const int q = q0 + qi;
        if (q >= nq) continue;
        const size_t o = ((size_t)blockIdx.y * nq + q) * k;
        for (int j = lane; j < k; j += 32) {
            out_k[o + j] = LK[qi * k + j];
            out_i[o + j] = LI[qi * k + j];
        }
    }
}

// One warp per query: start from slab 0's sorted list and offer it every
// other slab's list.
#define MERGE_WARPS 4
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_kernel(const int* __restrict__ pk, const int* __restrict__ pi, int S,
             int nq, int k, int fold, int block_n, int* __restrict__ out_k,
             int* __restrict__ out_i) {
    extern __shared__ int msm[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q = blockIdx.x * MERGE_WARPS + warp;
    if (q >= nq) return;  // whole warp leaves together
    int* K = msm + warp * 2 * k;
    int* I = K + k;
    for (int j = lane; j < k; j += 32) {
        K[j] = pk[(size_t)q * k + j];
        I[j] = pi[(size_t)q * k + j];
    }
    __syncwarp();
    for (int s = 1; s < S; ++s) {
        const size_t o = ((size_t)s * nq + q) * k;
        warp_consume(pk + o, pi + o, k, K, I, k, fold, block_n, lane);
    }
    for (int j = lane; j < k; j += 32) {
        out_k[(size_t)q * k + j] = K[j];
        out_i[(size_t)q * k + j] = I[j];
    }
}

template <int TQ, bool FOLD>
static int launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                          const float* q, const float* c, const float* csq,
                          int nq, int n, int d, int k, int euclid,
                          int block_n, int slab_rows, int vec, int* ok,
                          int* oi) {
    cudaError_t e = cudaFuncSetAttribute(
        partial_kernel<TQ, FOLD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    partial_kernel<TQ, FOLD><<<grid, NTHREADS, smem, st>>>(
        q, c, csq, nq, n, d, k, euclid, block_n, slab_rows, vec, ok, oi);
    return (int)cudaGetLastError();
}

extern "C" {

// Shared memory of one partial_kernel block; the wrapper picks TQ with it.
size_t lr_topk_partial_smem(int tq, int d, int k) {
    return (size_t)tq * d * 4 + (size_t)DCH * TN * 4 + (size_t)tq * 4 +
           (size_t)tq * TN * 8 + (size_t)tq * k * 8;
}

// fp32 queries and corpus (the bf16 and binary flavours are the mma
// kernels'). Returns a cudaError_t; -1 for a TQ the library was not built
// for.
int lr_topk_partial(const float* q, const float* c, const float* csq, int nq,
                    int n, int d, int k, int euclid, int fold, int block_n,
                    int slab_rows, int tq, int vec, int* out_k, int* out_i,
                    void* stream) {
    const size_t smem = lr_topk_partial_smem(tq, d, k);
    dim3 grid((nq + tq - 1) / tq, (n + slab_rows - 1) / slab_rows);
    cudaStream_t st = (cudaStream_t)stream;
#define LR_ARGS grid, smem, st, q, c, csq, nq, n, d, k, euclid, block_n, \
                slab_rows, vec, out_k, out_i
#define LR_CASE(T)                                                   \
    if (tq == T)                                                     \
        return fold ? launch_partial<T, true>(LR_ARGS)               \
                    : launch_partial<T, false>(LR_ARGS);
    LR_CASE(32)
    LR_CASE(16)
    LR_CASE(8)
#undef LR_CASE
#undef LR_ARGS
    return -1;
}

int lr_topk_merge(const int* pk, const int* pi, int S, int nq, int k,
                  int fold, int block_n, int* out_k, int* out_i,
                  void* stream) {
    const size_t smem = (size_t)MERGE_WARPS * 2 * k * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((nq + MERGE_WARPS - 1) / MERGE_WARPS);
    merge_kernel<<<grid, MERGE_WARPS * 32, smem, (cudaStream_t)stream>>>(
        pk, pi, S, nq, k, fold, block_n, out_k, out_i);
    return (int)cudaGetLastError();
}

const char* lr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#include "fold_mma.cuh"
#include "exact_mma.cuh"
