// The exact top-k past the exact kernel's lists (kernel 2 at k > 2048,
// replaces _exact_kernel, pallas_topk.py:182-221, which takes any k <= N)
// for bf16 stores (exact_select_kernel<OP_BF16, *>) and fp32 stores
// (<OP_F32, *>, 3xTF32 products through fold_mma.cuh's fm_split4 /
// fm_mma3). Included by fused_topk.cu after exact_mma.cuh.
//
//   exact_select_kernel<OP, false>  a histogram pass: one block = one m16
//                                   tile of queries x one corpus slab
//   exact_select_scan               one thread per query: picks the
//                                   pass's digit, narrows the prefix
//   exact_select_kernel<OP, true>   the collect pass: every key at or above
//                                   the query's threshold into its list
//   exact_select_sort               one block per query: sorts the k keys
//                                   and writes scores and ids
//
// Contract: exact_mma_kernel's (exact_mma.cuh): the top k_eff = min(k, N)
// of (score desc, row asc), ranked by the unique 64-bit key
// monotone_i32(score) << 32 | (INT_MAX - row); scores are the kernel's own
// fp32 sums, |q|^2 summed as fm_row_sq sums it; fp32 scores [Q, k] and
// int32 ids [Q, k] come out sorted best first, written by the sort kernel.
// No torch call follows.
//
// Why another design. exact_mma_kernel keeps each query's list and buffer
// in shared memory, QB x (KP + BUF) x 8 bytes, which caps k at 2048. Past
// it the lists would have to live in device memory and be merged there.
// Instead this kernel selects by radix: it finds each query's k-th key
// exactly, one 8-bit digit a pass, and then writes the keys at or above it.
//
// Select. Each query keeps a prefix (the digits found so far) and need (how
// many keys it still has to take among those that match the prefix). A
// histogram pass scores the whole corpus on the tensor cores, with the
// code, fragment order and ring of exact_mma_kernel, so every pass sees
// bit-identical scores; each key that matches the prefix above the pass's
// digit adds one to its digit's bin in the block's shared histograms
// (16 queries x 256 bins, rows 257 ints apart so that one bin of different
// queries falls in different banks), and the block adds its histograms to
// device memory. The scan then walks the query's bins from the top: the
// bin where the running count reaches need is the next digit, and need
// drops by the keys of the bins above it. When that bin holds exactly need
// keys the query is done: its threshold is the prefix, and the keys at or
// above it are its top k. Four passes take the score's 32 bits; ties of
// the k-th score go on to the row's bits (INT_MAX - row), in as many
// passes as the corpus's row count needs (3 at N = 1M, 2 at N = 5003), and
// since keys are unique the last pass always ends with one key in the bin.
// A pass whose block holds no query still selecting returns at once, so
// without ties the row passes cost a launch each. The scan and the passes
// keep their state in device memory, so the host never waits for a count.
//
// Collect and sort. The collect pass appends each key at or above its
// query's threshold to the query's list (a device-memory atomic on its
// count: exactly k keys land), and exact_select_sort sorts each list
// descending with a bitonic network, in shared memory up to 16384 entries
// and in place in device memory past that, then writes scores and ids.
//
// Bound. As exact_mma_kernel's: 2 Q N d products at the bf16 tensor-core
// peak (0.13 ms at 1024 x 1M, d = 64; fp32 3xTF32: 0.8 ms), for the work
// one search needs. This design does that work in every pass, four to
// seven times, plus a shared-memory atomic for each score that matches the
// prefix (every score in the first pass, where a few bins take nearly all
// of them). It is the simple, right kernel; cutting the passes (a first
// pass that keeps a sample, wider digits) is later work.

#define ES_BINS 256
#define ES_HSTRIDE 257   // ints between two queries' shared histograms
#define ES_SORT_SMEM 16384  // keys a sort block holds in shared memory

// Dynamic shared memory of one exact_select_kernel block.
__host__ __device__ inline size_t es_smem_bytes(int d, int op) {
    const int n_dch = (d + fm_dch(op) - 1) / fm_dch(op);
    return (size_t)FM_NST * FM_SLOT_BYTES + (size_t)n_dch * EM_QROWS * 128 +
           EM_QROWS * 8 + (size_t)EM_QROWS * ES_HSTRIDE * 4 + 2 * EM_QROWS * 4;
}

// Entries of a query's list: the least power of two >= k (the sort's
// width).
__host__ __device__ inline int es_width(int k) {
    int w = 1;
    while (w < k) w <<= 1;
    return w;
}

// grid: (ceil(nq / 16), slabs of slab_rows rows, a multiple of 128).
// COLLECT = false: histogram of digit (key >> shift) & 255 over the keys
// with (key ^ pre) & himask == 0, for queries with need > 0.
// COLLECT = true: every key >= pre into keys[q, cnt[q]++].
// Keys here are unsigned: (monotone_i32(score) ^ 0x80000000) << 32 |
// (INT_MAX - row), whose unsigned order is the signed key's order.
template <int OP, bool COLLECT>
__global__ void __launch_bounds__(FM_THREADS, 2)
exact_select_kernel(const void* __restrict__ qp,
                    const void* __restrict__ cp,
                    const float* __restrict__ csq, int nq, int n, int d,
                    int euclid, int slab_rows, int vec, int shift,
                    unsigned long long himask,
                    const unsigned long long* __restrict__ pre_g,
                    const int* __restrict__ need_g, int* __restrict__ hist_g,
                    int* __restrict__ cnt_g, i64* __restrict__ keys,
                    int width) {
    constexpr int CH = fm_dch(OP);
    extern __shared__ __align__(16) unsigned char smem[];
    const int n_dch = (d + CH - 1) / CH;
    unsigned char* ring = smem;                                // FM_NST slots
    unsigned char* Qs = ring + FM_NST * FM_SLOT_BYTES;         // [n_dch][16][128 B]
    unsigned long long* pre =
        (unsigned long long*)(Qs + n_dch * EM_QROWS * 128);    // [16]
    int* hist = (int*)(pre + EM_QROWS);                        // [16][257]
    float* qsq = (float*)(hist + EM_QROWS * ES_HSTRIDE);       // [16]
    int* act = (int*)(qsq + EM_QROWS);                         // [16]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int wc = 16 * warp;  // the warp's 16 columns of each sub-tile
    const int q0 = blockIdx.x * EM_QROWS;
    const int row0 = blockIdx.y * slab_rows;
    const int row1 = min(row0 + slab_rows, n);
    const int n_sub = (row1 - row0 + TN - 1) / TN;
    const int n_st = n_sub * n_dch;

    if (tid < EM_QROWS) {
        const int q = q0 + tid;
        act[tid] = q < nq && (COLLECT || need_g[q] > 0);
        pre[tid] = q < nq ? pre_g[q] : 0ull;
    }
    if (!COLLECT)
        for (int e = tid; e < EM_QROWS * ES_HSTRIDE; e += FM_THREADS)
            hist[e] = 0;
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int r = 0; r < EM_QROWS; ++r) any |= act[r] != 0;
    if (!any) return;  // uniform: every query of the tile is done

#pragma unroll
    for (int s = 0; s < FM_NST - 1; ++s) {
        if (s < n_st)
            fm_stage<OP>(ring + s * FM_SLOT_BYTES, cp, csq, n, d,
                         row0 + (s / n_dch) * TN, (s % n_dch) * CH, vec,
                         euclid, tid);
        fm_commit();
    }
    for (int v = tid; v < EM_QROWS * n_dch * 8; v += FM_THREADS) {
        const int r = v / (n_dch * 8), cc = v - r * (n_dch * 8);
        const int q = q0 + r;
        *reinterpret_cast<uint4*>(Qs + (cc >> 3) * EM_QROWS * 128 +
                                  fm_swz(r, cc & 7)) =
            q < nq ? fm_chunk<OP>(qp, q, d, (CH / 8) * cc)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    if (tid < EM_QROWS)  // read after the first stage's barrier
        qsq[tid] = euclid && q0 + tid < nq
                       ? fm_row_sq<OP>(Qs, EM_QROWS, tid, d)
                       : 0.f;
    // the thread's two query rows, g and g + 8, and their prefixes
    const bool act0 = act[g] != 0, act1 = act[g + 8] != 0;
    const unsigned long long pre0 = pre[g], pre1 = pre[g + 8];
    unsigned afr[4][4];
    if (n_dch == 1) fm_load_a(afr, Qs, 0, lane);

    float acc[2][4];
    for (int st = 0; st < n_st; ++st) {
        fm_wait_ring<FM_NST>();
        __syncthreads();  // stage st is in; stage st - 1's slot is free
        {
            const int s2 = st + FM_NST - 1;
            if (s2 < n_st)
                fm_stage<OP>(ring + (s2 % FM_NST) * FM_SLOT_BYTES, cp, csq, n,
                             d, row0 + (s2 / n_dch) * TN, (s2 % n_dch) * CH,
                             vec, euclid, tid);
            fm_commit();
        }
        const unsigned char* S = ring + (st % FM_NST) * FM_SLOT_BYTES;
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
        // (e & 1), as exact_mma_kernel computes them
        const int c0 = t0 + wc + 2 * t4;
        const float* cq =
            reinterpret_cast<const float*>(S + FM_STAGE_BYTES) + wc + 2 * t4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1, col = c0 + 8 * j + (e & 1);
                float s = acc[j][e];
                if (euclid) s = 2.0f * s - qsq[g + 8 * h] - cq[8 * j + (e & 1)];
                if (!(h ? act1 : act0) || col >= n) continue;
                const int r = g + 8 * h;
                const unsigned b = __float_as_uint(s);
                const unsigned u = (int)b >= 0 ? (b ^ 0x80000000u) : ~b;
                const unsigned long long key =
                    ((unsigned long long)u << 32) | (unsigned)(INT_MAX - col);
                const unsigned long long p = h ? pre1 : pre0;
                if constexpr (COLLECT) {
                    if (key >= p) {
                        const int q = q0 + r;
                        const int at = atomicAdd(&cnt_g[q], 1);
                        if (at < width)
                            keys[(size_t)q * width + at] =
                                (i64)(key ^ 0x8000000000000000ull);
                    }
                } else if (((key ^ p) & himask) == 0) {
                    atomicAdd(&hist[r * ES_HSTRIDE + (int)((key >> shift) & 255)],
                              1);
                }
            }
        }
    }
    if constexpr (!COLLECT) {
        __syncthreads();  // every append is in
        for (int e = tid; e < EM_QROWS * ES_BINS; e += FM_THREADS) {
            const int r = e / ES_BINS, bin = e - r * ES_BINS;
            const int v = hist[r * ES_HSTRIDE + bin];
            if (v) atomicAdd(&hist_g[(size_t)(q0 + r) * ES_BINS + bin], v);
        }
    }
}

// prefix 0, need k, count 0 and empty histograms for every query.
__global__ void exact_select_init(int nq, int k, unsigned long long* pre,
                                  int* need, int* cnt, int* hist) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (size_t)nq * ES_BINS) return;
    hist[e] = 0;
    if (e < (size_t)nq) {
        pre[e] = 0ull;
        need[e] = k;
        cnt[e] = 0;
    }
}

// After a histogram pass of digit `shift`: the query's next digit is the
// bin where the count from the top reaches need. A query whose bin holds
// exactly need keys is done (need = 0; its threshold is the prefix); any
// other takes `fill` into its prefix (the bits above the first row digit,
// which every row's INT_MAX - row shares). Empties the histogram.
__global__ void exact_select_scan(int nq, int shift, unsigned long long fill,
                                  unsigned long long* pre, int* need,
                                  int* hist) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= nq || need[q] == 0) return;
    int* h = hist + (size_t)q * ES_BINS;
    int left = need[q], bin = ES_BINS - 1;
    for (; bin > 0; --bin) {
        if (h[bin] >= left) break;
        left -= h[bin];
    }
    unsigned long long p = pre[q] | ((unsigned long long)bin << shift);
    if (h[bin] == left)
        left = 0;
    else
        p |= fill;
    pre[q] = p;
    need[q] = left;
    for (int b = 0; b < ES_BINS; ++b) h[b] = 0;
}

// One block per query: its k keys (width entries, the rest empty) sorted
// descending by a bitonic network, in shared memory when width <=
// ES_SORT_SMEM, else in place in `keys`; then the scores and ids.
__global__ void __launch_bounds__(FM_THREADS)
exact_select_sort(i64* __restrict__ keys, int width, int k,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int q = blockIdx.x, tid = threadIdx.x;
    i64* row = keys + (size_t)q * width;
    i64* X = width <= ES_SORT_SMEM ? (i64*)smem : row;
    for (int i = tid; i < width; i += FM_THREADS)
        X[i] = i < k ? row[i] : EMPTY64;
    __syncthreads();
#pragma unroll 1
    for (int s = 2; s <= width; s <<= 1) {
#pragma unroll 1
        for (int j = s >> 1; j > 0; j >>= 1) {
            for (int p = tid; p < width / 2; p += FM_THREADS) {
                const int i = em_pair(p, j);
                const i64 a = X[i], b = X[i + j];
                if ((a < b) == ((i & s) == 0)) {
                    X[i] = b;
                    X[i + j] = a;
                }
            }
            __syncthreads();
        }
    }
    for (int i = tid; i < k; i += FM_THREADS) {
        const size_t o = (size_t)q * k + i;
        out_s[o] = em_score(X[i]);
        out_i[o] = em_row(X[i]);
    }
}

template <int OP>
static int es_prepare() {
    static unsigned ready = 0;  // bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32 && (ready >> dev) & 1u) return 0;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    const void* fns[] = {(const void*)exact_select_kernel<OP, false>,
                         (const void*)exact_select_kernel<OP, true>,
                         (const void*)exact_select_sort};
    for (const void* f : fns) {
        e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
        if (e != cudaSuccess) return (int)e;
    }
    if (dev < 32) ready |= 1u << dev;
    return 0;
}

template <int OP>
static int es_occupancy(size_t smem) {
    int e = es_prepare<OP>();
    if (e) return -e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, exact_select_kernel<OP, false>, FM_THREADS, smem);
    return e ? -e : blocks;
}

// Bytes of the scratch lr_exact_select carves: prefixes, lists, histograms,
// needs and counts.
static size_t es_scratch_bytes(int nq, int k) {
    return (size_t)nq * 8 + (size_t)nq * es_width(k) * 8 +
           (size_t)nq * ES_BINS * 4 + (size_t)nq * 8;
}

template <int OP>
static int es_launch(const void* q, const void* c, const float* csq, int nq,
                     int n, int d, int k, int euclid, int slab_rows, int vec,
                     void* scratch, float* out_s, int* out_i, cudaStream_t st) {
    int e = es_prepare<OP>();
    if (e) return e;
    const int width = es_width(k);
    unsigned long long* pre = (unsigned long long*)scratch;
    i64* keys = (i64*)(pre + nq);
    int* hist = (int*)(keys + (size_t)nq * width);
    int* need = hist + (size_t)nq * ES_BINS;
    int* cnt = need + nq;
    const size_t smem = es_smem_bytes(d, OP);
    const dim3 grid((nq + EM_QROWS - 1) / EM_QROWS,
                    (n + slab_rows - 1) / slab_rows);
    const int nqb = (nq + FM_THREADS - 1) / FM_THREADS;

    exact_select_init<<<(unsigned)(((size_t)nq * ES_BINS + FM_THREADS - 1) /
                                   FM_THREADS),
                        FM_THREADS, 0, st>>>(nq, k, pre, need, cnt, hist);
    if ((e = (int)cudaGetLastError())) return e;
    // row digits: the bits of n - 1, in whole bytes
    int row_bits = 8;
    while (row_bits < 32 && ((unsigned)(n - 1) >> row_bits)) row_bits += 8;
    const unsigned long long fill =
        0x7FFFFFFFull & ~((1ull << row_bits) - 1);
    for (int shift = 56; shift >= 0; shift -= 8) {
        if (shift < 32 && shift >= row_bits) continue;  // bits every row shares
        const unsigned long long himask = shift == 56 ? 0ull : ~0ull << (shift + 8);
        exact_select_kernel<OP, false><<<grid, FM_THREADS, smem, st>>>(
            q, c, csq, nq, n, d, euclid, slab_rows, vec, shift, himask, pre,
            need, hist, cnt, keys, width);
        if ((e = (int)cudaGetLastError())) return e;
        exact_select_scan<<<nqb, FM_THREADS, 0, st>>>(
            nq, shift, shift == 32 ? fill : 0ull, pre, need, hist);
        if ((e = (int)cudaGetLastError())) return e;
    }
    exact_select_kernel<OP, true><<<grid, FM_THREADS, smem, st>>>(
        q, c, csq, nq, n, d, euclid, slab_rows, vec, 0, 0ull, pre, need, hist,
        cnt, keys, width);
    if ((e = (int)cudaGetLastError())) return e;
    exact_select_sort<<<nq, FM_THREADS,
                        width <= ES_SORT_SMEM ? (size_t)width * 8 : 0, st>>>(
        keys, width, k, out_s, out_i);
    return (int)cudaGetLastError();
}

extern "C" {

size_t lr_exact_select_smem(int d, int op) { return es_smem_bytes(d, op); }

size_t lr_exact_select_scratch(int nq, int k) {
    return es_scratch_bytes(nq, k);
}

// Resident exact_select_kernel blocks per SM at (d, op) on the current
// device (0: does not fit); a negative cudaError_t on failure; -1 for an
// operand kind it does not take (binary).
int lr_exact_select_occupancy(int d, int op) {
    const size_t smem = es_smem_bytes(d, op);
    if (op == OP_F32) return es_occupancy<OP_F32>(smem);
    if (op == OP_BF16) return es_occupancy<OP_BF16>(smem);
    return -1;
}

// The exact search at any k <= n over bf16 (op = OP_BF16: q, c bf16 [nq,
// d], [n, d]) or fp32 (OP_F32, 3xTF32 products) stores: init, the
// histogram passes and their scans, the collect pass and the sort, all on
// `stream`. csq is the rows' norms^2 (euclid only); scratch holds
// lr_exact_select_scratch(nq, k) bytes, 8-byte aligned. Returns a
// cudaError_t, -1 for a k outside [1, n] or a binary op.
int lr_exact_select(const void* q, const void* c, const float* csq, int nq,
                    int n, int d, int k, int euclid, int slab_rows, int vec,
                    int op, void* scratch, float* out_s, int* out_i,
                    void* stream) {
    if (k < 1 || k > n) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (op == OP_F32)
        return es_launch<OP_F32>(q, c, csq, nq, n, d, k, euclid, slab_rows,
                                 vec, scratch, out_s, out_i, st);
    if (op == OP_BF16)
        return es_launch<OP_BF16>(q, c, csq, nq, n, d, k, euclid, slab_rows,
                                  vec, scratch, out_s, out_i, st);
    return -1;
}

}  // extern "C"
