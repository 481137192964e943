// The exact top-k on Hopper's tensor cores (kernel 2, replaces
// _exact_kernel, pallas_topk.py:182-221) for bf16 stores
// (exact_mma_kernel<KP, OP_BF16>) and fp32 stores (<KP, OP_F32>), and for
// the packed binary store (<KP, OP_BIN>: the exact sign-dot search
// binary_topk, the JAX package's ops/binary.py:129, which the binary store
// calls past the fold's 128 candidates). Included by fused_topk.cu after
// fold_mma.cuh, whose stage machinery it reuses unchanged: the 3-stage
// swizzled cp.async ring of 128-byte rows (64 bf16 or 32 fp32 dims), the
// binary word stages unpacked to +-1 bf16 (0x3F80 / 0xBF80), ldmatrix, and
// mma.sync.m16n8k16 bf16 -> fp32 or, for fp32 stores, m16n8k8 tf32 in
// 3xTF32 (fm_split4 / fm_mma3: each fp32 operand split into rounded tf32 hi
// and lo parts, a product lo.hi' + hi.lo' + hi.hi'; fused_topk.cu states
// the contract and its error).
//
//   exact_mma_kernel<KP, OP>   one block = one m16 tile of queries x one
//                              corpus slab; 8 warps, each 16 of the 128
//                              columns of every 128-row sub-tile
//   exact_merge_kernel<KP>     one block per query merges the slabs' lists
//
// Contract. The top k of (score desc, row asc): ties go to the lower row,
// as in the plain versions. bf16 x bf16 and bf16 x +-1 products are exact,
// so only the order of the fp32 sums differs from them; fp32 products in
// 3xTF32 are within ~3 x 2^-22 of exact, the size of that order's
// differences, and the scores the kernel returns are its fp32 sums.
// Euclidean scores are 2 q.c - |q|^2 - corpus_sq[c]; the kernel sums |q|^2
// of the stored values in the one order every kernel and the plain version
// use (fm_row_sq: dim by dim from 0, each product and sum rounded, no FMA),
// since a sum of d squares in another order moves every score of a query
// alike and, at d = 384, by enough to round near-equal scores apart
// differently.
//
// Order key. A candidate is one signed 64-bit value: monotone_i32(score)
// << 32 | (INT_MAX - row), so a larger value is a better score, then a
// lower row; rows are unique, so no two keys tie. An empty slot is
// LLONG_MIN.
//
// Lists. Each query keeps its best keys as one sorted list of KP entries
// (KP = the least power of two >= k, at least 128; entries past k are real
// but unkept) and a buffer of BUF = max(KP, 256) entries, both in shared
// memory, and a threshold: the k-th key, also as an fp32 score. One fp32 compare (score
// >= the threshold's) drops almost every score; only the few that pass it
// build their key for the exact compare against the k-th key. Passers
// are appended to the query's buffer with a shared-memory atomic on its
// count. When a buffer holds more than BUF - 128 entries (the next
// sub-tile could add 128), or at the end of the slab, the block flushes
// every buffer that holds any: a bitonic sort of the buffer (ascending),
// the larger of list entry i and the buffer's i-th of its best KP (a
// bitonic sequence holding the best KP of both), a bitonic merge
// (descending), and the new threshold. A buffer of 256 keeps a list of 128
// from a flush at almost every sub-tile once few rows pass.
// This is FAISS's BlockSelect shape, with the networks run by the whole
// block in shared memory, since a 2048-entry list does not fit a warp's
// registers.
//
// Sizing. Lists and buffers take QB x (KP + BUF) x 8 bytes: 16 queries up
// to KP = 512 (128 KB), and past that the m16 tile carries QB = 8192 / KP
// real queries (8 at 1024, 4 at 2048; the other rows are zero and never
// append), so a block never needs more than 128 KB for them. At k = 160
// (KP = 256) the binary instance takes ~87 KB and the bf16 one ~117 KB
// (fp32: its query tile is twice the bytes, +2 KB at d = 64); at k = 10
// (KP = 128) the bf16 one ~102 KB: two blocks an SM, one for the bf16 and
// fp32 KP = 256 instances. The fp32 query tile at d = 384 (24 KB) still
// fits beside the 128 KB of lists.
//
// Plan (the wrapper's): grid = (ceil(Q / QB), slabs); slabs of whole
// 128-row sub-tiles, as many as fill the card's resident block slots for
// the query tiles at hand while each keeps 8 sub-tiles, at least one. At
// 2000 x 315 that is 125 query tiles of one slab: one wave on 132 SMs, no
// merge; at 1024 x 1M, 64 query tiles of 4 slabs (2 blocks an SM). With
// one slab the kernel writes the fp32 scores and int32 ids itself;
// otherwise each slab writes its sorted key list and exact_merge_kernel
// merges them with bitonic merges and writes scores and ids. No torch work
// follows.
//
// Bound. The products are 2 Q N d operations at the bf16 tensor-core peak
// (0.13 ms at 1024 x 1M, d = 64; fp32: 3 x 2 Q N d at the TF32 peak, 0.8
// ms) and the bytes are the corpus once (128 MB bf16, 256 MB fp32, 8 MB
// binary: 0.04 / 0.08 / 0.003 ms), so the bound is the operations. The
// fp32 flavour also splits each A and B fragment value on the CUDA cores
// (two roundings and a subtraction; each B fragment feeds one warp, so no
// split is shared), adds each k step's sum to the running one, and takes
// two 32-dim stages a sub-tile at d = 64. An
// m16 tile has only 16 queries, so each B fragment feeds one mma, and the
// corpus is read once per query tile (from the 50 MB L2 where it fits);
// what sets the pace at scale is the per-score filter on the CUDA cores
// (one fp32 compare a score), the per-stage block barrier and
// the flushes, whose number grows as k ln(slab rows / k) passers a query.

#define EM_QROWS 16  // rows of the m16 query tile
#define EM_NEG_INF __int_as_float(0xff800000)

__host__ __device__ constexpr int em_qb(int kp) {
    return kp <= 512 ? EM_QROWS : 8192 / kp;
}

// Entries of a query's buffer: KP, and at least 256, so that a buffer
// takes one full sub-tile and more before it must be flushed.
__host__ __device__ constexpr int em_buf(int kp) { return kp < 256 ? 256 : kp; }

// Dynamic shared memory of one exact_mma_kernel block.
__host__ __device__ inline size_t em_smem_bytes(int d, int kp, int op) {
    const bool bin = op == OP_BIN;
    const int n_dch = (d + fm_dch(op) - 1) / fm_dch(op);
    return (size_t)FM_NST * (bin ? FM_WSLOT_BYTES : FM_SLOT_BYTES) +
           (bin ? FM_STAGE_BYTES : 0) + (size_t)n_dch * EM_QROWS * 128 +
           EM_QROWS * 8 + (size_t)em_qb(kp) * (kp + em_buf(kp)) * 8 +
           3 * EM_QROWS * 4;
}

// fp32 score and corpus row of a key.
__device__ __forceinline__ float em_score(i64 key) {
    const int m = (int)(key >> 32);
    return __int_as_float(m >= 0 ? m : (m ^ 0x7FFFFFFF));
}

__device__ __forceinline__ int em_row(i64 key) {
    return INT_MAX - (int)(unsigned)key;
}

// Index of the lower element of compare pair t of a bitonic step of
// distance j (a power of two): t with a 0 bit inserted at j.
__device__ __forceinline__ int em_pair(int t, int j) {
    return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// Merge every buffer that holds entries into its query's list, block-wide
// (see the header); resets those counts and thresholds. Every thread of
// the block calls it. Buffers hold BUF >= KP entries: after the sort the
// best KP are the last KP, ascending.
template <int KP, int BUF, int QB>
__device__ void em_flush(i64* L, i64* B, int* cnt, i64* thr, float* thr_f,
                         int k, int tid) {
    for (int e = tid; e < QB * BUF; e += FM_THREADS) {
        const int r = e / BUF, c = cnt[r];
        if (c > 0 && e - r * BUF >= c) B[e] = EMPTY64;
    }
    __syncthreads();
#pragma unroll 1
    for (int s = 2; s <= BUF; s <<= 1) {  // sort each buffer ascending
#pragma unroll 1
        for (int j = s >> 1; j > 0; j >>= 1) {
            for (int p = tid; p < QB * BUF / 2; p += FM_THREADS) {
                const int r = p / (BUF / 2);
                if (cnt[r] == 0) continue;
                const int i = em_pair(p - r * (BUF / 2), j);
                i64* x = B + r * BUF;
                const i64 a = x[i], b = x[i + j];
                if ((a > b) == ((i & s) == 0)) {
                    x[i] = b;
                    x[i + j] = a;
                }
            }
            __syncthreads();
        }
    }
    // the larger of list entry i and the buffer's i-th of its best KP: a
    // bitonic sequence holding the best KP of both, merged descending
    for (int e = tid; e < QB * KP; e += FM_THREADS) {
        const int r = e / KP;
        if (cnt[r] > 0) {
            i64* x = B + r * BUF + (BUF - KP) + (e - r * KP);
            *x = fm_max(*x, L[e]);
        }
    }
    __syncthreads();
#pragma unroll 1
    for (int j = KP / 2; j > 0; j >>= 1) {
        for (int p = tid; p < QB * KP / 2; p += FM_THREADS) {
            const int r = p / (KP / 2);
            if (cnt[r] == 0) continue;
            const int i = em_pair(p - r * (KP / 2), j);
            i64* x = B + r * BUF + (BUF - KP);
            const i64 a = x[i], b = x[i + j];
            if (a < b) {
                x[i] = b;
                x[i + j] = a;
            }
        }
        __syncthreads();
    }
    for (int e = tid; e < QB * KP; e += FM_THREADS) {
        const int r = e / KP;
        if (cnt[r] > 0) L[e] = B[r * BUF + (BUF - KP) + (e - r * KP)];
    }
    __syncthreads();
    if (tid < QB && cnt[tid] > 0) {
        const i64 t = L[tid * KP + k - 1];
        thr[tid] = t;
        thr_f[tid] = t == EMPTY64 ? EM_NEG_INF : em_score(t);
        cnt[tid] = 0;
    }
    __syncthreads();
}

// grid: (ceil(nq / QB), slabs of slab_rows rows, a multiple of 128).
// final_out (one slab): write out_s / out_i; else part[slab, q, :] keys.
// qp and cp as fold_mma_kernel's: bf16 (OP_BF16), fp32 (OP_F32), or bf16
// queries and packed sign words [n, ceil(d/32)] (OP_BIN; euclid and vec 0).
template <int KP, int OP>
__global__ void __launch_bounds__(FM_THREADS, 2)
exact_mma_kernel(const void* __restrict__ qp,
                 const void* __restrict__ cp, const float* __restrict__ csq,
                 int nq, int n, int d, int k, int euclid, int slab_rows,
                 int vec, int final_out, i64* __restrict__ part,
                 float* __restrict__ out_s, int* __restrict__ out_i) {
    constexpr int QB = em_qb(KP), BUF = em_buf(KP);
    constexpr bool BIN = OP == OP_BIN;
    constexpr int SLOT = BIN ? FM_WSLOT_BYTES : FM_SLOT_BYTES;
    constexpr int CH = fm_dch(OP);
    extern __shared__ __align__(16) unsigned char smem[];
    const int n_dch = (d + CH - 1) / CH;
    unsigned char* ring = smem;                                // FM_NST slots
    unsigned char* U = ring + FM_NST * SLOT;                   // BIN: [128][64] bf16
    unsigned char* Qs = U + (BIN ? FM_STAGE_BYTES : 0);        // [n_dch][16][128 B]
    i64* thr = (i64*)(Qs + n_dch * EM_QROWS * 128);            // [16] k-th keys
    i64* L = thr + EM_QROWS;                                   // [QB][KP] lists
    i64* B = L + QB * KP;                                      // [QB][BUF] buffers
    float* qsq = (float*)(B + QB * BUF);                       // [16]
    float* thr_f = qsq + EM_QROWS;                             // [16]
    int* cnt = (int*)(thr_f + EM_QROWS);                       // [16]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int wc = 16 * warp;  // the warp's 16 columns of each sub-tile
    const int q0 = blockIdx.x * QB;
    const int row0 = blockIdx.y * slab_rows;
    const int row1 = min(row0 + slab_rows, n);
    const int n_sub = (row1 - row0 + TN - 1) / TN;
    const int n_st = n_sub * n_dch;
    // the thread's two query rows, g and g + 8, if they carry a query
    const bool real0 = g < QB && q0 + g < nq;
    const bool real1 = g + 8 < QB && q0 + g + 8 < nq;

#pragma unroll
    for (int s = 0; s < FM_NST - 1; ++s) {
        if (s < n_st)
            fm_stage<OP>(ring + s * SLOT, cp, csq, n, d,
                         row0 + (s / n_dch) * TN, (s % n_dch) * CH, vec,
                         euclid, tid);
        fm_commit();
    }
    for (int v = tid; v < EM_QROWS * n_dch * 8; v += FM_THREADS) {
        const int r = v / (n_dch * 8), cc = v - r * (n_dch * 8);
        const int q = q0 + r;
        *reinterpret_cast<uint4*>(Qs + (cc >> 3) * EM_QROWS * 128 +
                                  fm_swz(r, cc & 7)) =
            (r < QB && q < nq) ? fm_chunk<OP>(qp, q, d, (CH / 8) * cc)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e = tid; e < QB * KP; e += FM_THREADS) L[e] = EMPTY64;
    if (tid < EM_QROWS) {
        thr[tid] = EMPTY64;
        thr_f[tid] = EM_NEG_INF;
        cnt[tid] = 0;
    }
    __syncthreads();
    if (tid < EM_QROWS)  // read after the first stage's barrier
        qsq[tid] = euclid && tid < QB && q0 + tid < nq
                       ? fm_row_sq<OP>(Qs, EM_QROWS, tid, d)
                       : 0.f;
    unsigned afr[4][4];
    if (n_dch == 1) fm_load_a(afr, Qs, 0, lane);

    float acc[2][4];
    for (int st = 0; st < n_st; ++st) {
        fm_wait_ring<FM_NST>();
        __syncthreads();  // stage st is in; stage st - 1's slot (and U) free
        {
            const int s2 = st + FM_NST - 1;
            if (s2 < n_st)
                fm_stage<OP>(ring + (s2 % FM_NST) * SLOT, cp, csq, n, d,
                             row0 + (s2 / n_dch) * TN, (s2 % n_dch) * CH,
                             vec, euclid, tid);
            fm_commit();
        }
        const unsigned char* S = ring + (st % FM_NST) * SLOT;
        if constexpr (BIN) {
            fm_unpack(U, S, tid);
            __syncthreads();
            S = U;
        }
        const int sub = st / n_dch, dci = st - sub * n_dch;
        const int t0 = row0 + sub * TN;
        if (dci == 0) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
        if (n_dch > 1) fm_load_a(afr, Qs + dci * EM_QROWS * 128, 0, lane);
        // four k steps of 16 bf16 dims, or of 8 fp32 dims in 3xTF32
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            unsigned b[4];
            fm_ldsm4(b, fm_smem(S + fm_swz(wc + (lane & 7) + ((lane >> 4) << 3),
                                           2 * s + ((lane >> 3) & 1))));
            if constexpr (OP == OP_F32) {
                unsigned ah[4], al[4];
                fm_split4(afr[s], ah, al);
                fm_mma3_x2(acc[0], acc[1], ah, al, b);
            } else {
                fm_mma(acc[0], afr[s], b[0], b[1]);
                fm_mma(acc[1], afr[s], b[2], b[3]);
            }
        }
        if (dci != n_dch - 1) continue;  // more dims of this sub-tile to come

        // scores of rows g / g + 8 (e >> 1) at columns wc + 8 j + 2 t4 +
        // (e & 1); those that beat the threshold go to the buffers
        const int c0 = t0 + wc + 2 * t4;
        const float* cq = reinterpret_cast<const float*>(
            ring + (st % FM_NST) * SLOT + FM_STAGE_BYTES) + wc + 2 * t4;
        const float tf[2] = {thr_f[g], thr_f[g + 8]};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1, col = c0 + 8 * j + (e & 1);
                float s = acc[j][e];
                if (!BIN && euclid)
                    s = 2.0f * s - qsq[g + 8 * h] - cq[8 * j + (e & 1)];
                if (!(h ? real1 : real0) || col >= n || !(s >= tf[h]))
                    continue;
                const int r = g + 8 * h;
                const int b = __float_as_int(s);
                const int m = b >= 0 ? b : (b ^ 0x7FFFFFFF);
                const i64 key = (i64)(((unsigned long long)(unsigned)m << 32) |
                                      (unsigned)(INT_MAX - col));
                if (key > thr[r]) B[r * BUF + atomicAdd(&cnt[r], 1)] = key;
            }
        }
        __syncthreads();  // the appends are in
        const bool last = sub == n_sub - 1;
        bool need = false;
#pragma unroll
        for (int r = 0; r < QB; ++r) {
            const int c = cnt[r];
            need |= last ? c > 0 : c > BUF - TN;
        }
        if (need) em_flush<KP, BUF, QB>(L, B, cnt, thr, thr_f, k, tid);
    }

    for (int e = tid; e < QB * k; e += FM_THREADS) {
        const int r = e / k, i = e - r * k;
        const int q = q0 + r;
        if (q >= nq) continue;
        const i64 key = L[r * KP + i];
        const size_t o = (size_t)q * k + i;
        if (final_out) {
            out_s[o] = em_score(key);
            out_i[o] = em_row(key);
        } else {
            part[(size_t)blockIdx.y * nq * k + o] = key;
        }
    }
}

// One block per query: start from slab 0's sorted list; take in each other
// slab's list (read reversed, so ascending) by the larger entry, then one
// bitonic merge.
template <int KP>
__global__ void __launch_bounds__(FM_THREADS)
exact_merge_kernel(const i64* __restrict__ part, int S, int nq, int k,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
    __shared__ i64 A[KP];
    const int q = blockIdx.x, tid = threadIdx.x;
    for (int i = tid; i < KP; i += FM_THREADS)
        A[i] = i < k ? part[(size_t)q * k + i] : EMPTY64;
    __syncthreads();
    for (int s = 1; s < S; ++s) {
        const i64* p = part + ((size_t)s * nq + q) * k;
        const bool skip = p[0] <= A[k - 1];  // nothing of this slab enters
        __syncthreads();
        if (skip) continue;  // uniform
        for (int i = tid; i < KP; i += FM_THREADS) {
            const int src = KP - 1 - i;
            if (src < k) A[i] = fm_max(A[i], p[src]);
        }
        __syncthreads();
#pragma unroll 1
        for (int j = KP / 2; j > 0; j >>= 1) {
            for (int t = tid; t < KP / 2; t += FM_THREADS) {
                const int i = em_pair(t, j);
                const i64 a = A[i], b = A[i + j];
                if (a < b) {
                    A[i] = b;
                    A[i + j] = a;
                }
            }
            __syncthreads();
        }
    }
    for (int i = tid; i < k; i += FM_THREADS) {
        const size_t o = (size_t)q * k + i;
        out_s[o] = em_score(A[i]);
        out_i[o] = em_row(A[i]);
    }
}

// Each kernel instance's dynamic shared memory is raised to the card's
// opt-in limit once per device, not on every call.
template <int KP, int OP>
static int em_prepare() {
    static unsigned ready = 0;  // bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32 && (ready >> dev) & 1u) return 0;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(exact_mma_kernel<KP, OP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) ready |= 1u << dev;
    return 0;
}

template <int KP, int OP>
static int em_occupancy(size_t smem) {
    int e = em_prepare<KP, OP>();
    if (e) return -e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, exact_mma_kernel<KP, OP>, FM_THREADS, smem);
    return e ? -e : blocks;
}

template <int KP, int OP>
static int em_launch(const void* q, const void* c, const float* csq,
                     int nq, int n, int d, int k, int euclid,
                     int slab_rows, int vec, long long* part, float* out_s,
                     int* out_i, size_t smem, cudaStream_t st) {
    int e = em_prepare<KP, OP>();
    if (e) return e;
    const int n_slabs = (n + slab_rows - 1) / slab_rows;
    dim3 grid((nq + em_qb(KP) - 1) / em_qb(KP), n_slabs);
    exact_mma_kernel<KP, OP><<<grid, FM_THREADS, smem, st>>>(
        q, c, csq, nq, n, d, k, euclid, slab_rows, vec, n_slabs == 1, part,
        out_s, out_i);
    e = (int)cudaGetLastError();
    if (e || n_slabs == 1) return e;
    exact_merge_kernel<KP><<<nq, FM_THREADS, 0, st>>>(part, n_slabs, nq, k,
                                                      out_s, out_i);
    return (int)cudaGetLastError();
}

static int em_kp(int k) {
    int kp = 128;
    while (kp < k) kp <<= 1;
    return kp;
}

// F<KP, OP>(args) for the list of KP = em_kp(k) entries (k <= 2048) and
// the operand kind op.
#define EM_DISPATCH_OP(F, O, ...)                                             \
    (kp == 128    ? F<128, O>(__VA_ARGS__)                                    \
     : kp == 256  ? F<256, O>(__VA_ARGS__)                                    \
     : kp == 512  ? F<512, O>(__VA_ARGS__)                                    \
     : kp == 1024 ? F<1024, O>(__VA_ARGS__)                                   \
                  : F<2048, O>(__VA_ARGS__))
#define EM_DISPATCH(F, ARGS)                                                  \
    (op == OP_BIN   ? EM_DISPATCH_OP(F, OP_BIN, ARGS)                         \
     : op == OP_F32 ? EM_DISPATCH_OP(F, OP_F32, ARGS)                         \
                    : EM_DISPATCH_OP(F, OP_BF16, ARGS))

extern "C" {

// Queries a block of exact_mma_kernel carries at k (its grid's x unit).
int lr_exact_mma_queries(int k) { return em_qb(em_kp(k)); }

size_t lr_exact_mma_smem(int d, int k, int op) {
    return em_smem_bytes(d, em_kp(k), op);
}

// Resident exact_mma_kernel blocks per SM at (d, k, op) on the current
// device (0: does not fit); a negative cudaError_t on failure; -1 past
// k = 2048.
int lr_exact_mma_occupancy(int d, int k, int op) {
    if (k < 1 || k > 2048) return -1;
    const int kp = em_kp(k);
    const size_t smem = em_smem_bytes(d, kp, op);
    return EM_DISPATCH(em_occupancy, smem);
}

// The exact search over bf16 (op = OP_BF16: q, c bf16 [nq, d], [n, d]) or
// fp32 (OP_F32: fp32, 3xTF32 products) stores, or the exact sign-dot search
// (OP_BIN: bf16 queries, c the packed sign words [n, ceil(d/32)]; euclid =
// 0): exact_mma_kernel over (query tiles x slabs), then, with more than
// one slab, exact_merge_kernel. csq is the rows' norms^2 (euclid only).
// part is [slabs, nq, k] int64 scratch (unused with one slab). Returns a
// cudaError_t, -1 past k = 2048.
int lr_exact_mma(const void* q, const void* c, const float* csq,
                 int nq, int n, int d, int k, int euclid,
                 int slab_rows, int vec, int op, long long* part,
                 float* out_s, int* out_i, void* stream) {
    if (k < 1 || k > 2048) return -1;
    const int kp = em_kp(k);
    const size_t smem = em_smem_bytes(d, kp, op);
    cudaStream_t st = (cudaStream_t)stream;
#define EM_ARGS q, c, csq, nq, n, d, k, euclid, slab_rows, vec, part, \
                out_s, out_i, smem, st
    return EM_DISPATCH(em_launch, EM_ARGS);
#undef EM_ARGS
}

}  // extern "C"

#undef EM_DISPATCH
#undef EM_DISPATCH_OP
