// Fused distance + top-k for Hopper (sm_90a): the CUDA port of the JAX
// package's Pallas kernels in ops/pallas_topk.py.
//
//   fold_mma_kernel<E, false> (fold_mma.cuh) replaces _fold_kernel
//                                  (pallas_topk.py:162-179, _fold_body :114-159)
//                                  for bf16 stores, on the tensor cores;
//   partial_kernel<TQ, FOLD=true,  BIN=false> replaces it for fp32 stores
//   partial_kernel<TQ, FOLD=false, BIN=false> replaces _exact_kernel
//                                  (pallas_topk.py:182-221)
//   fold_mma_kernel<E, true>  (fold_mma.cuh) replaces _binary_fold_kernel
//                                  (pallas_topk.py:354-401), on the tensor cores
//   partial_kernel<TQ, FOLD=false, BIN=true>  replaces the exact sign-dot
//                                  search binary_topk (the JAX package's
//                                  ops/binary.py:129) where the binary
//                                  store's stage 1 asks for more candidates
//                                  than the fold's 128 lanes hold
//   merge_kernel                   has no TPU counterpart: the TPU grid ran the
//                                  corpus tiles in order and carried the running
//                                  top-k in VMEM scratch; here slabs run in
//                                  parallel and this kernel merges their lists.
//
// What is computed (the TPU kernels' contract, not their block structure):
//   score(q, c) = q.c                          (cosine / dot: inputs pre-normalized)
//               = 2 q.c - |q|^2 - corpus_sq[c] (euclidean / mahalanobis on whitened
//                                               inputs; |q|^2 from the stored values)
//   accumulated in fp32 from fp32 or bf16 inputs; the [Q, N] score matrix is
//   never written to device memory.
//   binary: score(q, c) = sum_{j<d} bf16(q_j) * (2 bit_j(c) - 1), accumulated
//   in fp32 (pad bits past d never count), from a row-major store of packed
//   sign words [N, ceil(d/32)] (bit j of word w <-> dim 32w + j). Each stage
//   unpacks to +-1 in shared memory (fp32 here, bf16 in fold_mma.cuh), so the
//   unpacked [N, d] corpus never exists in device memory either. Scores become order-preserving int32 keys
//   (_monotone_i32). Rows >= n never win.
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
// ridge point, so the limit is arithmetic. partial_kernel scores with
// fp32 FMAs (67 TFLOP/s peak, not the 989 TFLOP/s of bf16 tensor cores);
// the bf16 and binary folds have moved to mma.sync tiles (fold_mma.cuh), the
// exact flavours are still to follow. What the design does about the bound it
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
// The exact binary flavour moves 1/16 of the bf16 corpus bytes (8 B a row
// at d = 64) through the same scoring loop, so it is arithmetic-bound like
// the rest; it reads the row-major store with 4-byte loads (one word a
// thread a stage), which any W = ceil(d/32) keeps aligned, so no layout
// change is needed to serve d = 48 or d = 384.
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

__device__ __forceinline__ float load_elem(const void* p, size_t i, int bf16) {
    if (bf16) return __bfloat162float(((const __nv_bfloat16*)p)[i]);
    return ((const float*)p)[i];
}

// A stage is rows [t0, t0 + TN) x dims [d0, d0 + DCH) of the corpus, held
// in shared memory transposed ([DCH][TN], fp32). The 4-column groups are
// swizzled by (dd >> 3) & 7, so the loads' transposed stores and the score
// loop's 16-byte reads both avoid bank conflicts.
__device__ __forceinline__ int cs_index(int dd, int r) {
    return dd * TN + ((((r >> 2) ^ ((dd >> 3) & 7))) << 2) + (r & 3);
}

// 16-byte loads of one stage into registers: bf16 4 per thread, fp32 8.
// Needs d % DCH == 0 and a 16-byte aligned corpus (the wrapper checks).
__device__ __forceinline__ void stage_fetch(uint4 (&buf)[8], const void* cp,
                                            int n, int d, int bf16, int t0,
                                            int d0, int tid) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    if (bf16) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int v = tid + NTHREADS * u, r = v >> 3, j = v & 7;
            const int row = t0 + r;
            buf[u] = row < n ? __ldg(reinterpret_cast<const uint4*>(
                         (const __nv_bfloat16*)cp + (size_t)row * d + d0 + 8 * j))
                             : zero;
        }
    } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int v = tid + NTHREADS * u, r = v >> 4, j = v & 15;
            const int row = t0 + r;
            buf[u] = row < n ? __ldg(reinterpret_cast<const uint4*>(
                         (const float*)cp + (size_t)row * d + d0 + 4 * j))
                             : zero;
        }
    }
}

__device__ __forceinline__ void stage_commit(const uint4 (&buf)[8], float* Cs,
                                             int bf16, int tid) {
    if (bf16) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int v = tid + NTHREADS * u, r = v >> 3, j = v & 7;
            const unsigned w[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {  // bf16 is the top half of an fp32
                Cs[cs_index(8 * j + 2 * h, r)] = __uint_as_float(w[h] << 16);
                Cs[cs_index(8 * j + 2 * h + 1, r)] =
                    __uint_as_float(w[h] & 0xFFFF0000u);
            }
        }
    } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int v = tid + NTHREADS * u, r = v >> 4, j = v & 15;
            Cs[cs_index(4 * j, r)] = __uint_as_float(buf[u].x);
            Cs[cs_index(4 * j + 1, r)] = __uint_as_float(buf[u].y);
            Cs[cs_index(4 * j + 2, r)] = __uint_as_float(buf[u].z);
            Cs[cs_index(4 * j + 3, r)] = __uint_as_float(buf[u].w);
        }
    }
}

// Binary stage: rows [t0, t0 + TN) x words [d0/32, d0/32 + 2), one 4-byte
// word per thread (NTHREADS == 2 * TN); words past the row's last are 0
// and only ever fill dims the score loop does not read.
static_assert(NTHREADS == 2 * TN, "one packed word per thread per stage");
static_assert(DCH == 64, "a stage spans two packed words");

__device__ __forceinline__ void bin_fetch(uint4 (&buf)[8], const void* cp,
                                          int n, int words, int t0, int d0,
                                          int tid) {
    const int row = t0 + (tid >> 1), w = (d0 >> 5) + (tid & 1);
    buf[0].x = (row < n && w < words)
                   ? __ldg((const unsigned*)cp + (size_t)row * words + w)
                   : 0u;
}

__device__ __forceinline__ void bin_commit(const uint4 (&buf)[8], float* Cs,
                                           int tid) {
    const int r = tid >> 1, dd0 = (tid & 1) << 5;
    const unsigned w = buf[0].x;
#pragma unroll
    for (int b = 0; b < 32; ++b)
        Cs[cs_index(dd0 + b, r)] = ((w >> b) & 1u) ? 1.0f : -1.0f;
}

// Fetch one stage into registers, from the packed store (BIN) or with
// 16-byte loads.
template <bool BIN>
__device__ __forceinline__ void fetch_stage(uint4 (&buf)[8], const void* cp,
                                            int n, int d, int bf16, int t0,
                                            int d0, int tid) {
    if constexpr (BIN) bin_fetch(buf, cp, n, (d + 31) >> 5, t0, d0, tid);
    else stage_fetch(buf, cp, n, d, bf16, t0, d0, tid);
}

// grid: (query tiles of TQ, corpus slabs of slab_rows rows). Each block
// writes its queries' top-k of its slab to out[slab, q, :]. slab_rows is a
// multiple of block_n in fold mode, so fold tiles never straddle slabs.
// With vec set, the next stage's loads are in flight while this stage is
// scored; otherwise (d not a multiple of DCH) each stage loads element by
// element. BIN stages are always fetched ahead.
template <int TQ, bool FOLD, bool BIN>
__global__ void __launch_bounds__(NTHREADS, 2)
partial_kernel(const void* __restrict__ qp, const void* __restrict__ cp,
               const float* __restrict__ csq, int nq, int n, int d, int k,
               int bf16, int euclid, int block_n, int slab_rows, int vec,
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
        QsT[dd * TQ + qi] = q < nq ? load_elem(qp, (size_t)q * d + dd, bf16) : 0.f;
    }
    for (int e = tid; e < TQ * k; e += NTHREADS) {
        LK[e] = EMPTY_KEY;
        LI[e] = EMPTY_IDX;
    }
    __syncthreads();
    if (tid < TQ) {
        float s = 0.f;
        for (int dd = 0; dd < d; ++dd) s += QsT[dd * TQ + tid] * QsT[dd * TQ + tid];
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
    const bool staged = BIN || vec;
    uint4 buf[8];
    if (staged && n_stages > 0)
        fetch_stage<BIN>(buf, cp, n, d, bf16, row0, 0, tid);
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
        if constexpr (BIN) {
            bin_commit(buf, Cs, tid);
        } else if (vec) {
            stage_commit(buf, Cs, bf16, tid);
        } else {
            for (int e = tid; e < TN * dc; e += NTHREADS) {
                const int r = e / dc, dd = e - r * dc;
                const int row = t0 + r;
                Cs[cs_index(dd, r)] =
                    row < n ? load_elem(cp, (size_t)row * d + d0 + dd, bf16) : 0.f;
            }
        }
        __syncthreads();
        if (staged && st + 1 < n_stages) {
            const int nsub = (st + 1) / n_dch;
            fetch_stage<BIN>(buf, cp, n, d, bf16, row0 + nsub * TN,
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

template <int TQ, bool FOLD, bool BIN>
static int launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                          const void* q, const void* c, const float* csq,
                          int nq, int n, int d, int k, int bf16, int euclid,
                          int block_n, int slab_rows, int vec, int* ok,
                          int* oi) {
    cudaError_t e = cudaFuncSetAttribute(
        partial_kernel<TQ, FOLD, BIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    partial_kernel<TQ, FOLD, BIN><<<grid, NTHREADS, smem, st>>>(
        q, c, csq, nq, n, d, k, bf16, euclid, block_n, slab_rows, vec, ok, oi);
    return (int)cudaGetLastError();
}

extern "C" {

// Shared memory of one partial_kernel block; the wrapper picks TQ with it.
size_t lr_topk_partial_smem(int tq, int d, int k) {
    return (size_t)tq * d * 4 + (size_t)DCH * TN * 4 + (size_t)tq * 4 +
           (size_t)tq * TN * 8 + (size_t)tq * k * 8;
}

// Returns a cudaError_t; -1 for a TQ the library was not built for or a
// binary fold (fold_mma.cuh has it). binary: c is the packed sign words
// [n, ceil(d/32)] and q is bf16.
int lr_topk_partial(const void* q, const void* c, const float* csq, int nq,
                    int n, int d, int k, int bf16, int euclid, int fold,
                    int block_n, int slab_rows, int tq, int vec, int binary,
                    int* out_k, int* out_i, void* stream) {
    if (binary && fold) return -1;
    const size_t smem = lr_topk_partial_smem(tq, d, k);
    dim3 grid((nq + tq - 1) / tq, (n + slab_rows - 1) / slab_rows);
    cudaStream_t st = (cudaStream_t)stream;
#define LR_ARGS grid, smem, st, q, c, csq, nq, n, d, k, bf16, euclid, \
                block_n, slab_rows, vec, out_k, out_i
#define LR_CASE(T)                                                   \
    if (tq == T)                                                     \
        return binary ? launch_partial<T, false, true>(LR_ARGS)      \
               : fold ? launch_partial<T, true, false>(LR_ARGS)      \
                      : launch_partial<T, false, false>(LR_ARGS);
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
