// The exact top-k past the exact kernel's lists (kernel 2 at k > 2048,
// replaces _exact_kernel, pallas_topk.py:182-221, which takes any k <= N)
// for bf16 stores (exact_select_kernel<OP_BF16, *>) and fp32 stores
// (<OP_F32, *>, 3xTF32 products through fold_mma.cuh's fm_split4 /
// fm_mma3). Included by fused_topk.cu after exact_mma.cuh.
//
//   exact_select_init               prefix, need, count of every query; the
//                                   threshold from a sample's scores
//   exact_select_kernel<OP, true>   a buffer pass: every key at or above the
//                                   query's threshold into its buffer, counted
//                                   past the buffer's end
//   exact_select_check              one thread per query: a query whose count
//                                   is not in [k, C] falls back
//   exact_select_kernel<OP, false>  a histogram pass: one block = one m16
//                                   tile of queries x one corpus slab
//   exact_select_scan               one thread per query: picks the
//                                   pass's digit, narrows the prefix
//   exact_select_sort               one block per query: sorts its buffer
//                                   and writes the best k scores and ids
//
// Contract: exact_mma_kernel's (exact_mma.cuh): the top k_eff = min(k, N)
// of (score desc, row asc), ranked by the unique 64-bit key
// monotone_i32(score) << 32 | (INT_MAX - row); scores are the kernel's own
// fp32 sums, |q|^2 summed as fm_row_sq sums it; fp32 scores [Q, k] and
// int32 ids [Q, k] come out sorted best first, written by the sort kernel.
// No torch call follows. Every route below gives the same bits: the key is
// unique, and every pass scores with one template body.
//
// Why another design. exact_mma_kernel keeps each query's list and buffer
// in shared memory, QB x (KP + BUF) x 8 bytes, which caps k at 2048. Past
// it the lists would have to live in device memory and be merged there.
// Instead this kernel places a threshold and writes the keys at or above
// it into a per-query buffer in device memory, then sorts the buffer.
//
// Routes (the wrapper's _select_plan picks one from the shapes alone, so
// the same shapes always take the same route; C = 2 es_width(k) is the
// buffer's capacity, a power of two, 8192 at k = 3000):
// - sampled (N > C): the threshold is the rank-m score of a strided sample
//   of the corpus (every s-th row, a contiguous copy made by the wrapper)
//   from exact_mma_kernel, a list of m <= 256 entries: its key with no
//   row bits, u(t) << 32, so every row that ties the score t is taken.
//   One buffer pass then scores the whole corpus once, keeps the keys at or
//   above it (up to C a query) and counts them all.
// - all (N <= C): the threshold is the least key; the buffer pass keeps
//   every row, and no query can fall back.
// - radix (C > ES_SORT_SMEM = 16384, i.e. k > 8192; or Q x C x 8 bytes of
//   buffers past 1 GiB; or route 1 of the C entry, for the checks): the
//   radix select below for every query, into buffers of es_width(k).
// Sizing of the sampled route. The target count is T = (9k + 7C) / 16,
// between k and C and a little nearer k (the count's upper tail is the
// heavier); s = ceil(T / 256) and m = ceil(T / s) <= 256, so m s ~ T and
// the sample holds ceil(N / s) > m rows. On rows in random order the
// number of corpus keys at or above the sample's m-th is about T, with a
// relative spread of about 1/sqrt(m) (the m-th order statistic of the
// sample: a Beta(m, N/s - m + 1) share of N). At N = 1M, k = 3000: C =
// 8192, T = 5271, s = 21, m = 251, 47620 sampled rows; a query falls back
// when the count leaves [k, C], which rows in random order do with a
// chance of about 2e-14 (the Beta's two tails); the worst k, a power of
// two (4096: T = 5888, s = 23, m = 256), about 3e-8 a query. Storage-ordered corpora
// (every s-th row a cluster's best), and ties at the threshold (rows
// equal in bf16: more than C keys on one score) do fall back, and stay
// exact.
// Check and fallback. exact_select_check marks a query ok when k <= count
// <= C: its buffer holds every key at or above the threshold, and so its
// top k (the k-th key is at or above the threshold). Any other query is
// reset (prefix 0, need k, count 0) and flagged; its buffer is not read.
// The radix passes, scans and a collect pass then run as on the radix
// route, for the flagged queries only (the collect appends only theirs,
// exactly k keys from the buffer's start); a block whose 16 queries are
// all done returns at once, so without a fallback they cost a launch
// each. The first 4 bytes of the scratch count the queries that fell back.
// The host never waits for a count.
//
// Select (the radix route, and the fallback). Each query keeps a prefix
// (the digits found so far) and need (how many keys it still has to take
// among those that match the prefix). A histogram pass scores the whole
// corpus on the tensor cores, with the code, fragment order and ring of
// exact_mma_kernel, so every pass sees bit-identical scores; each key that
// matches the prefix above the pass's digit adds one to its digit's bin in
// the block's shared histograms (16 queries x 256 bins, rows 257 ints
// apart so that one bin of different queries falls in different banks),
// and the block adds its histograms to device memory. The scan then walks
// the query's bins from the top: the bin where the running count reaches
// need is the next digit, and need drops by the keys of the bins above it.
// When that bin holds exactly need keys the query is done: its threshold
// is the prefix, and the keys at or above it are its top k. Four passes
// take the score's 32 bits; ties of the k-th score go on to the row's bits
// (INT_MAX - row), in as many passes as the corpus's row count needs (3 at
// N = 1M, 2 at N = 5003), and since keys are unique the last pass always
// ends with one key in the bin. The collect pass appends each key at or
// above the query's threshold to its buffer (a device-memory atomic on its
// count: exactly k keys land).
//
// Sort. exact_select_sort sorts each query's count of keys (min(count, C)
// on the buffer routes, k after a fallback or on the radix route), padded
// with empty keys to a power of two, descending with a bitonic network, in
// shared memory up to 16384 entries and in place in device memory past
// that (the radix route at k > 8192), then writes the best k. A full sort
// of up to C keys, not a select inside the buffer.
//
// Bound. As exact_mma_kernel's: 2 Q N d products at the bf16 tensor-core
// peak (0.13 ms at 1024 x 1M, d = 64; fp32 3xTF32: 0.8 ms), for the work
// one search needs. The sampled route does that work about 1 + 1/s times
// (the buffer pass and the sample); the radix route four to seven times,
// plus a shared-memory atomic for each score that matches the prefix
// (every score in the first pass, where a few bins take nearly all of
// them). The buffer pass reads the corpus once per m16 tile of 16 queries.

#define ES_BINS 256
#define ES_HSTRIDE 257   // ints between two queries' shared histograms
#define ES_SORT_SMEM 16384  // keys a sort block holds in shared memory

// Dynamic shared memory of one exact_select_kernel block.
__host__ __device__ inline size_t es_smem_bytes(int d, int op) {
    const int n_dch = (d + fm_dch(op) - 1) / fm_dch(op);
    return (size_t)FM_NST * FM_SLOT_BYTES + (size_t)n_dch * EM_QROWS * 128 +
           EM_QROWS * 8 + (size_t)EM_QROWS * ES_HSTRIDE * 4 + 2 * EM_QROWS * 4;
}

// The least power of two >= k: the radix route's buffer entries, and the
// sort's width for k keys.
__host__ __device__ inline int es_width(int k) {
    int w = 1;
    while (w < k) w <<= 1;
    return w;
}

// The high word of a score's unsigned key: monotone_i32(score) ^
// 0x80000000, whose unsigned order is the scores' order.
__device__ __forceinline__ unsigned es_u32(float s) {
    const unsigned b = __float_as_uint(s);
    return (int)b >= 0 ? (b ^ 0x80000000u) : ~b;
}

// grid: (ceil(nq / 16), slabs of slab_rows rows, a multiple of 128).
// COLLECT = false: histogram of digit (key >> shift) & 255 over the keys
// with (key ^ pre) & himask == 0, for queries with need > 0.
// COLLECT = true: every key >= pre into keys[q, cnt[q]++] (stored while
// cnt[q] < width, counted past it), for every query, or with `only` for
// the queries whose only[q] is set.
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
                    int width, const int* __restrict__ only) {
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
        act[tid] = q < nq && (COLLECT ? only == nullptr || only[q] != 0
                                      : need_g[q] > 0);
        pre[tid] = q < nq ? pre_g[q] : 0ull;
    }
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int r = 0; r < EM_QROWS; ++r) any |= act[r] != 0;
    if (!any) return;  // uniform: every query of the tile is done
    // zeroed before the first append, past the query tile's barrier below
    if (!COLLECT)
        for (int e = tid; e < EM_QROWS * ES_HSTRIDE; e += FM_THREADS)
            hist[e] = 0;

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
                const unsigned long long key =
                    ((unsigned long long)es_u32(s) << 32) |
                    (unsigned)(INT_MAX - col);
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

// Need k (with `kmin`, a device int: min(k, *kmin)), count 0 and empty
// histograms for every query, no fallback yet; the prefix is 0, or with
// `thr` (the sample's scores [nq, rank]) the key of the query's rank-th
// sampled score with no row bits.
__global__ void exact_select_init(int nq, int k, const int* kmin,
                                  const float* thr, int rank,
                                  unsigned long long* pre, int* need,
                                  int* cnt, int* hist, int* nfell) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (size_t)nq * ES_BINS) return;
    hist[e] = 0;
    if (e < (size_t)nq) {
        pre[e] = thr ? (unsigned long long)es_u32(thr[e * rank + rank - 1])
                           << 32
                     : 0ull;
        need[e] = kmin ? min(k, *kmin) : k;
        cnt[e] = 0;
    }
    if (e == 0) *nfell = 0;
}

// After the buffer pass: a query with k <= count <= cap is done (need 0;
// its buffer holds its top k); any other falls back: prefix 0, need k,
// count 0, flagged in fell and counted in nfell. With `kmin` (a device
// int) k is min(k, *kmin).
__global__ void exact_select_check(int nq, int k, const int* kmin, int cap,
                                   unsigned long long* pre, int* need,
                                   int* cnt, int* fell, int* nfell) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= nq) return;
    if (kmin) k = min(k, *kmin);
    const int c = cnt[q];
    const bool ok = c >= k && c <= cap;
    fell[q] = !ok;
    need[q] = ok ? 0 : k;
    if (!ok) {
        pre[q] = 0ull;
        cnt[q] = 0;
        atomicAdd(nfell, 1);
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

// One block per query: its min(cnt, width) keys of a buffer of width
// entries, padded with empty keys to w = es_width of their count (of k
// where fewer: a filtered search of the int stores that allowed fewer than
// k rows), sorted descending by a bitonic network, in shared memory when
// width <= ES_SORT_SMEM, else in place in `keys`; then the best k scores
// and ids, an empty slot as (LR_NEG_INF, -1).
__global__ void __launch_bounds__(FM_THREADS)
exact_select_sort(i64* __restrict__ keys, int width,
                  const int* __restrict__ cnt, int k,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int q = blockIdx.x, tid = threadIdx.x;
    i64* row = keys + (size_t)q * width;
    i64* X = width <= ES_SORT_SMEM ? (i64*)smem : row;
    const int nv = min(cnt[q], width), w = es_width(max(nv, k));
    for (int i = tid; i < w; i += FM_THREADS)
        X[i] = i < nv ? row[i] : EMPTY64;
    __syncthreads();
#pragma unroll 1
    for (int s = 2; s <= w; s <<= 1) {
#pragma unroll 1
        for (int j = s >> 1; j > 0; j >>= 1) {
            for (int p = tid; p < w / 2; p += FM_THREADS) {
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
        em_out(X[i], out_s + o, out_i + o);
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

// Entries of a query's buffer: the capacity cap on the buffer routes, else
// es_width(k).
static int es_buffer(int k, int cap) { return cap ? cap : es_width(k); }

// Bytes of the scratch lr_exact_select carves: the fallback count (8
// bytes), prefixes, buffers, histograms, needs, counts and fallback flags.
static size_t es_scratch_bytes(int nq, int k, int cap) {
    return 8 + (size_t)nq * 8 + (size_t)nq * es_buffer(k, cap) * 8 +
           (size_t)nq * ES_BINS * 4 + (size_t)nq * 12;
}

template <int OP>
static int es_launch(const void* q, const void* c, const float* csq, int nq,
                     int n, int d, int k, int euclid, int slab_rows, int vec,
                     int cap, const float* thr, int rank, void* scratch,
                     float* out_s, int* out_i, cudaStream_t st) {
    int e = es_prepare<OP>();
    if (e) return e;
    const int width = es_buffer(k, cap);
    int* nfell = (int*)scratch;
    unsigned long long* pre =
        (unsigned long long*)((unsigned char*)scratch + 8);
    i64* keys = (i64*)(pre + nq);
    int* hist = (int*)(keys + (size_t)nq * width);
    int* need = hist + (size_t)nq * ES_BINS;
    int* cnt = need + nq;
    int* fell = cnt + nq;
    const size_t smem = es_smem_bytes(d, OP);
    const dim3 grid((nq + EM_QROWS - 1) / EM_QROWS,
                    (n + slab_rows - 1) / slab_rows);
    const int nqb = (nq + FM_THREADS - 1) / FM_THREADS;

    exact_select_init<<<(unsigned)(((size_t)nq * ES_BINS + FM_THREADS - 1) /
                                   FM_THREADS),
                        FM_THREADS, 0, st>>>(nq, k, nullptr, thr, rank, pre,
                                             need, cnt, hist, nfell);
    if ((e = (int)cudaGetLastError())) return e;
    if (cap) {  // the buffer pass and its check
        exact_select_kernel<OP, true><<<grid, FM_THREADS, smem, st>>>(
            q, c, csq, nq, n, d, euclid, slab_rows, vec, 0, 0ull, pre, need,
            hist, cnt, keys, width, nullptr);
        if ((e = (int)cudaGetLastError())) return e;
        exact_select_check<<<nqb, FM_THREADS, 0, st>>>(
            nq, k, nullptr, cap, pre, need, cnt, fell, nfell);
        if ((e = (int)cudaGetLastError())) return e;
    }
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
            need, hist, cnt, keys, width, nullptr);
        if ((e = (int)cudaGetLastError())) return e;
        exact_select_scan<<<nqb, FM_THREADS, 0, st>>>(
            nq, shift, shift == 32 ? fill : 0ull, pre, need, hist);
        if ((e = (int)cudaGetLastError())) return e;
    }
    // the collect: every query on the radix route, the fallen ones else
    exact_select_kernel<OP, true><<<grid, FM_THREADS, smem, st>>>(
        q, c, csq, nq, n, d, euclid, slab_rows, vec, 0, 0ull, pre, need, hist,
        cnt, keys, width, cap ? fell : nullptr);
    if ((e = (int)cudaGetLastError())) return e;
    exact_select_sort<<<nq, FM_THREADS,
                        width <= ES_SORT_SMEM ? (size_t)width * 8 : 0, st>>>(
        keys, width, cnt, k, out_s, out_i);
    return (int)cudaGetLastError();
}

// The float stores' C interface, in the library without the row mask only
// (the rest of this header serves exact_i8_select.cuh in both).
#if !LR_MASKED
extern "C" {

size_t lr_exact_select_smem(int d, int op) { return es_smem_bytes(d, op); }

size_t lr_exact_select_scratch(int nq, int k, int cap) {
    return es_scratch_bytes(nq, k, cap);
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
// d], [n, d]) or fp32 (OP_F32, 3xTF32 products) stores, all on `stream`.
// cap = 0: the radix route (init, the histogram passes and their scans,
// the collect pass, the sort). cap > 0, a power of two in [es_width(k),
// ES_SORT_SMEM]: buffers of cap keys filled by one buffer pass at the
// threshold, their check, the radix passes and collect for the queries
// that fell back, the sort; the threshold is the rank-th of each query's
// sampled scores thr [nq, rank] (fp32, best first), or with thr null the
// least key. csq is the rows' norms^2 (euclid only); scratch holds
// lr_exact_select_scratch(nq, k, cap) bytes, 8-byte aligned, whose first
// int counts the queries that fell back. Returns a cudaError_t, -1 for a
// k outside [1, n], a bad cap or rank, or a binary op.
int lr_exact_select(const void* q, const void* c, const float* csq, int nq,
                    int n, int d, int k, int euclid, int slab_rows, int vec,
                    int op, int cap, const float* thr, int rank,
                    void* scratch, float* out_s, int* out_i, void* stream) {
    if (k < 1 || k > n) return -1;
    if (cap && (cap < es_width(k) || cap > ES_SORT_SMEM || (cap & (cap - 1))))
        return -1;
    if (thr && (!cap || rank < 1)) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (op == OP_F32)
        return es_launch<OP_F32>(q, c, csq, nq, n, d, k, euclid, slab_rows,
                                 vec, cap, thr, rank, scratch, out_s, out_i,
                                 st);
    if (op == OP_BF16)
        return es_launch<OP_BF16>(q, c, csq, nq, n, d, k, euclid, slab_rows,
                                  vec, cap, thr, rank, scratch, out_s, out_i,
                                  st);
    return -1;
}

}  // extern "C"
#endif  // !LR_MASKED
