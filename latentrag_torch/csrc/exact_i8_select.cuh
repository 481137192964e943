// The int8 and int4 stores' exact search at 256 < k <= 2048, designed for
// Hopper: a sampled threshold, one buffer pass over 64 queries a block on
// the TMA + wgmma machinery (exact_i8_select_kernel<false, MASK, WIDE>), a
// check, a radix select for the queries the buffer does not serve
// (exact_i8_select_kernel<true, MASK, WIDE>'s histogram passes) and a sort.
// It replaces the JAX package's sq8_topk and sq4_topk past 256 rows (its
// ops/quantization.py:35-80 and :144-200: a dot_general of the SQ8 codes,
// or of the unpacked nibbles, and approx_max_k, XLA there, no Pallas
// kernel), which the port ran as exact_mma_kernel<512 | 1024 | 2048, OP_I8
// / OP_I4> (exact_mma.cuh's bf16 template). Included by
// fused_topk.cu after exact_i8_wgmma.cuh (ew_select, ew_key, ew_mask_bits)
// and exact_select.cuh (exact_select_init / _check / _scan / _sort, whose
// keys are already these: monotone_i32(score) << 32 | INT_MAX - row), in
// both libraries. The contract is exact_i8_wgmma_kernel's, bit for bit: the
// top k of float32(int32 dot) * factor, ties to the lower row; with the row
// mask, slots no allowed row fills are (LR_NEG_INF, -1).
//
// Why another design. exact_mma_kernel keeps every query's sorted list and
// buffer in shared memory inside an m16 mma.sync tile, so its real queries
// shrink as k grows (16 at KP = 512, 8 at 1024, 4 at 2048): at 1024 x 8.8M
// each query tile streams the whole corpus through a cp.async ring with a
// block-wide barrier a stage, 64 / 128 / 256 times, and each flush is a
// block-wide bitonic network over 512-2048 entries (32.4 ms at k = 512).
// exact_i8_wgmma_kernel's lists, kept by each warp, take 64 k x 8 bytes:
// 256 KB at k = 512, past a block's 227 KB. The float stores' select past
// 2048 (exact_select.cuh) keeps no lists on the SM; this is that route with
// exact_i8_wgmma_kernel's scoring machinery in place of the mma.sync pass:
//   - the threshold: the rank-m score of a strided sample of the corpus
//     (the wrapper: every s-th row, searched by exact_i8_wgmma_kernel at k
//     = m <= 256, with a filter's mask over the sample: 1/s of the allowed
//     rows, and no rank-m score where fewer than m of them are sampled, so
//     that every allowed row is buffered), as a key with no row bits,
//     so that every row tying it is taken; turned once a block into the
//     least raw int32 dot that can reach it (ei_threshold, fw_threshold's
//     exact rule);
//   - one buffer pass: 64 queries a block, a TMA producer warp (int4: the
//     producer warpgroup's nibble unpack, fw_produce4), a wgmma m64n64k32
//     s8 consumer warpgroup, ew_select's skip test against the fixed
//     threshold under the second half's products; each passer keyed as
//     ew_key keys it and staged in shared memory at its quad's prefix
//     count (no atomics); when a row's stage may overflow the next half,
//     the warp copies its 16 queries' staged keys at or above their
//     thresholds into their device buffers, one device-memory atomic a
//     query for the slots (ei_flush), counting past the buffer's end. No
//     lists and no networks on the SM: two blocks an SM at every k;
//   - exact_select_check: a query whose count is not in [min(k, allowed
//     rows), C] falls back (the first int of the scratch counts them; the
//     allowed rows' count is a device int, which the host never reads);
//   - the fallback: radix passes of the same kernel (HIST: each key that
//     matches the query's prefix adds one to its digit's bin in the
//     block's shared histograms, 64 queries x 256 bins; the dot
//     threshold of the prefix's least key skips the rest), the scans, and
//     a collect pass of the buffer kernel for the flagged queries only
//     (exactly k keys each). A block whose 64 queries have nothing to do
//     returns at once;
//   - exact_select_sort: each query's buffer sorted, the best k written.
// Int scores are exact, the keys unique, and every pass scores with one
// body, so every route gives the same bits.
//
// Routes (the wrapper's quantized_select_plan, from the shapes alone):
// sampled (N > C = 8192): T = (9k + 7C) / 16 keys aimed at, s = ceil(T /
// 256), m = ceil(T / s): s = 15-19 for k = 257-2048, a sample of
// 1/15-1/19 of the corpus; all (N <= C): the threshold is the least key
// and every allowed row is buffered (the reranked int4 main's 2000 x 1997
// at k = 320); radix (Q C 8 bytes past 1 GiB, or the private
// route="radix" of the checks): the radix passes for every query.
//
// What bounds it on the H100: as exact_i8_wgmma_kernel, 2 Q N d int8
// operations at 1,979 TOPS (0.58 ms at 1024 x 8.8M, d = 64), done about 1 +
// 1/s times; the codes are read from device memory about once and each
// block streams its slab from L2 (9 GB at 1024 x 8.8M). The int8 exact
// search's split (scripts/torch_int8_exact_split.py) put the stages,
// products and skip test at 2.1-2.6 ms there with two blocks an SM.

#include "wgmma_i8.cuh"

#define EI_STAGE_MAX 128  // staged keys a query at most (a half adds <= 64)

// Shared memory of everything but the ring: the barriers, the query tile
// (d <= 64), and the 64 queries' staged keys (sb a query; the buffer pass
// and the collect) or their histograms (HIST).
__host__ __device__ inline size_t ei_fixed_bytes(int d, bool hist, int sb) {
    return FW_BAR_BYTES + fw_qtile_bytes(d) +
           (hist ? (size_t)FW_TQ * ES_HSTRIDE * 4 : (size_t)FW_TQ * sb * 8);
}

// The least int32 dot whose key can reach the unsigned key lo (its score
// bits es_u32(score), the high word): fw_threshold's rule, exact for factor
// > 0 and |dot| < 2^24. INT_MIN where lo's score is NaN or -inf (no bound).
__device__ __forceinline__ int ei_threshold(u64 lo, float factor) {
    const unsigned u = (unsigned)(lo >> 32);
    const float v =
        __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
    if (!(v == v)) return INT_MIN;
    const double t = floor((double)v / (double)factor) - 3.0;
    return t <= (double)INT_MIN ? INT_MIN
           : t >= (double)INT_MAX ? INT_MAX : (int)t;
}

// The dot of column bit b of row h (wgmma's accumulator layout, as
// ew_select sets the bits), a tree of selects on b's bits: no local array.
__device__ __forceinline__ int ei_dot(const int (&a)[32], int h, int b) {
    int s8[8], s4[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
        s8[i] = (b & 1) ? a[4 * i + 2 * h + 1] : a[4 * i + 2 * h];
#pragma unroll
    for (int i = 0; i < 4; ++i) s4[i] = (b & 2) ? s8[2 * i + 1] : s8[2 * i];
    const int s2a = (b & 4) ? s4[1] : s4[0];
    const int s2b = (b & 4) ? s4[3] : s4[2];
    return (b & 8) ? s2b : s2a;
}

// A thread's two rows, g (index 0) and g + 8 (1), of its warp's 16
// queries: whether the pass serves each, its prefix or threshold key
// (unsigned), and the keys staged in shared memory (the quad's 4 threads
// hold the same).
struct EiRows {
    bool act[2];
    u64 pre[2];
    int cnt[2];
};

// The buffer pass's appends of half HALF: each passer of ew_select keyed
// (ew_key; a NaN score stays EMPTY64, which no flush keeps) into a slot of
// its row's stage taken at its quad's prefix count. Returns (uniform in
// the warp) whether the warp must flush before its next half: a stage
// could not take another half, or the slab's last half is in.
template <int HALF>
__device__ __forceinline__ bool ei_append(const int (&a)[32],
                                          const unsigned (&pm)[2], i64* S,
                                          EiRows& st, int t0, int row1,
                                          int sb, float factor, int cw,
                                          int lane) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (!__any_sync(FM_FULL, pm[h] != 0u)) continue;  // uniform
        const int c = __popc(pm[h]);
        int x = c;  // the quad's inclusive prefix of its dots
        int y = __shfl_up_sync(FM_FULL, x, 1, 4);
        if (t4 >= 1) x += y;
        y = __shfl_up_sync(FM_FULL, x, 2, 4);
        if (t4 >= 2) x += y;
        const int total = __shfl_sync(FM_FULL, x, 3, 4);
        i64* Sq = S + (size_t)(16 * cw + g + 8 * h) * sb + st.cnt[h] + (x - c);
        unsigned m = pm[h];
        while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            *Sq++ = ew_key(ei_dot(a, h, b), factor,
                           t0 + 64 * HALF + 8 * (b >> 1) + 2 * t4 + (b & 1));
        }
        st.cnt[h] += total;
    }
    const bool last = HALF == 1 && t0 + TN >= row1;
    const int room = last ? 0 : sb - 64;  // a half adds at most 64 a row
    return __any_sync(FM_FULL, max(st.cnt[0], st.cnt[1]) > room);
}

// The warp's staged keys at or above their queries' keys (pre) into the
// device buffers keys[q][width]: the kept keys of each of its 16 queries
// counted, one atomic a query (lanes 0-15 at once) takes their slots in
// cnt_g, then each is written where its slot is below width (the count
// goes on past it). The stages start empty again.
__device__ __forceinline__ void ei_flush(const i64* S, EiRows& st, int sb,
                                         int q0, int nq, int cw, int lane,
                                         int* __restrict__ cnt_g,
                                         i64* __restrict__ keys, int width) {
    __syncwarp();  // the appends are in
    int kept = 0;  // lane r < 16: query 16 cw + r's kept keys
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
        const int h = r >> 3, src = 4 * (r & 7);
        const int c = __shfl_sync(FM_FULL, h ? st.cnt[1] : st.cnt[0], src);
        if (c == 0) continue;  // uniform
        const i64 pre = (i64)(__shfl_sync(FM_FULL, h ? st.pre[1] : st.pre[0],
                                          src) ^ 0x8000000000000000ull);
        const i64* Sq = S + (size_t)(16 * cw + r) * sb;
        int n_kept = 0;
        for (int i = lane; i < c; i += 32) {
            const i64 key = Sq[i];
            n_kept += key != EMPTY64 && key >= pre;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            n_kept += __shfl_xor_sync(FM_FULL, n_kept, o);
        if (lane == r) kept = n_kept;
    }
    const int qq = q0 + 16 * cw + lane;
    int base = 0;
    if (lane < 16 && kept > 0 && qq < nq) base = atomicAdd(&cnt_g[qq], kept);
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
        const int h = r >> 3, src = 4 * (r & 7);
        const int c = __shfl_sync(FM_FULL, h ? st.cnt[1] : st.cnt[0], src);
        const int kr = __shfl_sync(FM_FULL, kept, r);
        int at = __shfl_sync(FM_FULL, base, r);
        if (kr == 0) continue;  // uniform
        const i64 pre = (i64)(__shfl_sync(FM_FULL, h ? st.pre[1] : st.pre[0],
                                          src) ^ 0x8000000000000000ull);
        const i64* Sq = S + (size_t)(16 * cw + r) * sb;
        i64* out = keys + (size_t)(q0 + 16 * cw + r) * width;
        for (int i0 = 0; i0 < c; i0 += 32) {
            const int i = i0 + lane;
            const i64 key = i < c ? Sq[i] : EMPTY64;
            const bool ok = key != EMPTY64 && key >= pre;
            const unsigned bal = __ballot_sync(FM_FULL, ok);
            const int slot = at + __popc(bal & ((1u << lane) - 1u));
            if (ok && slot < width) out[slot] = key;
            at += __popc(bal);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) st.cnt[h] = 0;
    __syncwarp();  // before the next appends overwrite the stages
}

// A histogram pass's appends of half HALF: each passer whose key (as an
// unsigned key) matches its row's prefix above the pass's digit adds one to
// that digit's bin of its row's shared histogram.
template <int HALF>
__device__ __forceinline__ void ei_count(const int (&a)[32],
                                         const unsigned (&pm)[2], int* H,
                                         const EiRows& st, u64 himask,
                                         int shift, int t0, float factor,
                                         int cw, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (!__any_sync(FM_FULL, pm[h] != 0u)) continue;  // uniform
        int* Hq = H + (16 * cw + g + 8 * h) * ES_HSTRIDE;
        unsigned m = pm[h];
        while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            const i64 key = ew_key(
                ei_dot(a, h, b), factor,
                t0 + 64 * HALF + 8 * (b >> 1) + 2 * t4 + (b & 1));
            const u64 u = (u64)key ^ 0x8000000000000000ull;
            if (key != EMPTY64 && ((u ^ st.pre[h]) & himask) == 0)
                atomicAdd(&Hq[(int)((u >> shift) & 255)], 1);
        }
    }
}

// grid: (ceil(nq / 64), slabs of slab_rows rows, a multiple of 128); 256
// threads: warps 0-3 the producer warpgroup, 4-7 the consumers (warp 4 +
// w: queries 16 w .. 16 w + 15 of the tile); q, c, map, qmap, vec, qvec,
// i4 as exact_i8_wgmma_kernel's; fac: the one fp32 score factor; nst >= 2
// ring stages. Keys are unsigned here, (monotone_i32(score) ^ 0x80000000)
// << 32 | (INT_MAX - row), and pre_g[q] a query's key:
// HIST = false: every key >= pre_g[q] into keys[q][cnt_g[q]++] (stored
//   while below width, counted past it), for every query, or with `only`
//   for the queries whose only[q] is set; sb staged keys a query;
// HIST = true: the histogram of digit (key >> shift) & 255 over the keys
//   with (key ^ pre) & himask == 0, for the queries with need_g[q] > 0,
//   added to hist_g[q][256].
// MASK: mask is the allowed rows' bits [ceil(n/32)].
template <bool HIST, bool MASK, bool WIDE>
__global__ void __launch_bounds__(FW_THREADS, 2)
exact_i8_select_kernel(const __grid_constant__ CUtensorMap map,
                       const __grid_constant__ CUtensorMap qmap,
                       const signed char* __restrict__ q,
                       const signed char* __restrict__ c,
                       const float* __restrict__ fac,
                       const unsigned* __restrict__ mask, int nq, int n,
                       int d, int slab_rows, int nst, int sb, int vec,
                       int qvec, int i4, int shift, u64 himask,
                       const u64* __restrict__ pre_g,
                       const int* __restrict__ need_g,
                       int* __restrict__ hist_g, int* __restrict__ cnt_g,
                       i64* __restrict__ keys, int width,
                       const int* __restrict__ only) {
    extern __shared__ __align__(1024) unsigned char ei_smem_raw[];
    unsigned char* smem = ei_smem_raw;
    const int ch = fw_ch(d), n_dch = (d + ch - 1) / ch;
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
    const int q0 = blockIdx.x * FW_TQ;
    const int row0 = blockIdx.y * slab_rows;
    const int row1 = min(row0 + slab_rows, n);
    const int n_sub = (row1 - row0 + TN - 1) / TN;
    auto served = [&](int qq) {
        return qq < nq && (HIST ? need_g[qq] > 0
                                : only == nullptr || only[qq] != 0);
    };
    // a block none of whose queries this pass serves returns at once
    // (uniform): the fallback's passes cost a launch where nothing fell
    if (!__syncthreads_or(tid < FW_TQ && served(q0 + tid))) return;

    FwRing sm;
    sm.full = fm_smem(smem);
    sm.empty = sm.full + 8 * FW_NST_MAX;
    sm.ring = sm.full + FW_BAR_BYTES;
    sm.qs = sm.ring + nst * fw_stage_bytes(d);
    // the staged keys (the buffer pass) or the histograms (HIST)
    unsigned char* tail =
        smem + FW_BAR_BYTES + (size_t)nst * fw_stage_bytes(d) +
        fw_qtile_bytes(d);
    i64* S = reinterpret_cast<i64*>(tail);
    int* H = reinterpret_cast<int*>(tail);
    const unsigned qbar = sm.empty + 8 * FW_NST_MAX;  // the query tile's
    if (tid == 0)
        fw_init_ring(sm, nst, i4 ? FW_P4_THREADS / 32 : vec ? 1 : 32, qbar);
    if (tid >= 128) {
        if (!WIDE && !qvec)
            fw_load_qtile(smem + (sm.qs - sm.full), q, nq, d, q0, tid - 128);
        if (HIST)
            for (int e = tid - 128; e < FW_TQ * ES_HSTRIDE; e += 128) H[e] = 0;
    }
    __syncthreads();

    if (warp < 4) {
        // the producer warpgroup: int4, its 4 warps unpack the nibbles into
        // the ring; int8, warp 0 fills it and the rest leave
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (i4) {
            fw_produce4<WIDE>(sm, smem, &qmap, q,
                              reinterpret_cast<const unsigned char*>(c), nq,
                              n, d, q0, row0, n_sub, nst, vec, qvec, qbar,
                              tid);
            return;
        }
        if (warp != 0 || (vec && lane != 0)) return;
        fw_produce<WIDE>(sm, smem, &map, &qmap, q, c, nq, n, d, q0, row0,
                         n_sub, nst, vec, qvec, qbar, lane);
        return;
    }

    // the consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    const int cw = warp - 4, g = lane >> 2;
    const float factor = __ldg(fac);
    // the skip test needs scores that rise with the dot, and the threshold
    // rule needs |dot| < 2^24
    const bool skip = d <= EW_SKIP_MAX_D && factor > 0.f && isfinite(factor);
    EiRows st;
    EwRows thr;  // ew_select's view: the least dot that may pass, a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qq = q0 + 16 * cw + g + 8 * h;
        st.act[h] = served(qq);
        st.pre[h] = st.act[h] ? pre_g[qq] : 0ull;
        st.cnt[h] = 0;
        // the least key a passer may hold: the prefix's bits above the
        // pass's digit (HIST), else the query's key
        thr.thr[h] = !st.act[h] ? INT_MAX
                     : skip     ? ei_threshold(HIST ? st.pre[h] & himask
                                                    : st.pre[h],
                                               factor)
                                : INT_MIN;
    }
    const bool active = __any_sync(FM_FULL, st.act[0] || st.act[1]);
    if (!WIDE && qvec) fw_bar_wait(qbar, 0);
    // as in exact_i8_wgmma_kernel: the accumulators start unset, and no
    // wgmma group is in flight across a loop's back edge (C7514), so the
    // appends and the flushes, which loop, wait for both halves' products
    int acc_a[32], acc_b[32];
#define EI_SELECT(HALF, A)                                                    \
    do {                                                                      \
        ew_select<MASK, HALF>(A, thr, t0, n, mb, lane, pm);                  \
        pm[0] = st.act[0] ? pm[0] : 0u;                                       \
        pm[1] = st.act[1] ? pm[1] : 0u;                                       \
    } while (0)
#define EI_APPEND(HALF, A)                                                    \
    ei_append<HALF>(A, pm, S, st, t0, row1, sb, factor, cw, lane)
#define EI_COUNT(HALF, A)                                                     \
    ei_count<HALF>(A, pm, H, st, himask, shift, t0, factor, cw, lane)
    unsigned pm[2] = {0u, 0u};
    int slot = 0;  // the ring position, by counters
    unsigned phase = 0;
    for (int sub = 0, t0 = row0; sub < n_sub; ++sub, t0 += TN) {
        const unsigned mb = MASK ? ew_mask_bits(mask, t0, n, lane) : 0u;
        if constexpr (WIDE) {
            for (int dci = 1; dci < n_dch; ++dci) {
                fw_issue<WIDE>(acc_a, sm, slot, phase, 0, dci > 1);
                fw_issue<WIDE>(acc_b, sm, slot, phase, 1, dci > 1);
                fw_wgmma_wait<0>();
                fw_fence_acc(acc_a);
                fw_fence_acc(acc_b);
                fw_release(sm, slot, lane);
                fw_step(slot, phase, nst);
            }
        }
        const bool acc = WIDE && n_dch > 1;  // the last chunk adds to the sums
        fw_issue<WIDE>(acc_a, sm, slot, phase, 0, acc);
        fw_issue<WIDE>(acc_b, sm, slot, phase, 1, acc);
        fw_wgmma_wait<1>();
        fw_fence_acc(acc_a);
        if (active) EI_SELECT(0, acc_a);
        fw_wgmma_wait<0>();
        fw_fence_acc(acc_b);
        fw_release(sm, slot, lane);
        if constexpr (HIST) {
            if (active) {
                EI_COUNT(0, acc_a);
                EI_SELECT(1, acc_b);
                EI_COUNT(1, acc_b);
            }
        } else {
            bool flush = active && EI_APPEND(0, acc_a);
            // a flush, where one is due, after each half, from one place in
            // the code
#pragma unroll 1
            for (int half = 1;; ++half) {
                if (flush)
                    ei_flush(S, st, sb, q0, nq, cw, lane, cnt_g, keys, width);
                if (half == 2 || !active) break;
                EI_SELECT(1, acc_b);
                flush = EI_APPEND(1, acc_b);
            }
        }
        fw_step(slot, phase, nst);
    }
#undef EI_COUNT
#undef EI_APPEND
#undef EI_SELECT
    if constexpr (HIST) {
        // every count is in (the consumer warpgroup's named barrier 1)
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        for (int e = tid - 128; e < FW_TQ * ES_BINS; e += 128) {
            const int r = e / ES_BINS, bin = e - r * ES_BINS;
            const int v = H[r * ES_HSTRIDE + bin];
            if (v) atomicAdd(&hist_g[(size_t)(q0 + r) * ES_BINS + bin], v);
        }
    }
}

// The ring's depth, the stages' keys and the block's shared memory of the
// buffer pass (hist = 0) or a histogram pass at d: two blocks an SM where a
// ring of at least 2 stages fits beside the rest (stages of 128, else 96
// keys a query), else one; then up to FW_NST_MAX stages. A cudaError_t.
static int ei_plan(int d, int hist, int* nst, int* sb, size_t* smem) {
    int dev = 0, per_sm = 0, reserved = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const size_t slot = fw_stage_bytes(d);
    const size_t budgets[2] = {(size_t)(per_sm / 2 - reserved),
                               (size_t)optin};
    for (size_t budget : budgets) {
        for (int b = EI_STAGE_MAX; b >= 96; b -= 32) {
            const size_t fixed = ei_fixed_bytes(d, hist != 0, b);
            if (budget < fixed) continue;
            const size_t fit = (budget - fixed) / slot;
            const int s = fit < FW_NST_MAX ? (int)fit : FW_NST_MAX;
            if (s >= 2) {
                *nst = s;
                *sb = b;
                *smem = fixed + s * slot;
                return 0;
            }
        }
    }
    return (int)cudaErrorInvalidValue;  // does not fit a block
}

// Each instance's dynamic shared memory, and the sort's, raised to the
// card's opt-in limit once per device.
template <bool HIST, bool MASK, bool WIDE>
static int ei_prepare() {
    static unsigned ready = 0;  // bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32 && (ready >> dev) & 1u) return 0;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    const void* fns[] = {
        (const void*)exact_i8_select_kernel<HIST, MASK, WIDE>,
        (const void*)exact_select_sort};
    for (const void* f : fns) {
        e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
        if (e != cudaSuccess) return (int)e;
    }
    if (dev < 32) ready |= 1u << dev;
    return 0;
}

template <bool HIST, bool MASK, bool WIDE>
static int ei_occupancy(size_t smem) {
    int e = ei_prepare<HIST, MASK, WIDE>();
    if (e) return -e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, exact_i8_select_kernel<HIST, MASK, WIDE>, FW_THREADS, smem);
    return e ? -e : blocks;
}

// One pass's launch arguments, the same for the buffer, histogram and
// collect passes but for the mode's own.
struct EiPass {
    CUtensorMap map, qmap;
    const void *q, *c;
    const float* fac;
    const unsigned* mask;
    int nq, n, d, slab_rows, vec, qvec, i4;
};

template <bool HIST, bool MASK, bool WIDE>
static int ei_pass(const EiPass& p, int shift, u64 himask, const u64* pre,
                   const int* need, int* hist, int* cnt, i64* keys,
                   int width, const int* only, cudaStream_t st) {
    int e = ei_prepare<HIST, MASK, WIDE>();
    if (e) return e;
    int nst = 0, sb = 0;
    size_t smem = 0;
    if ((e = ei_plan(p.d, HIST, &nst, &sb, &smem))) return e;
    const dim3 grid((p.nq + FW_TQ - 1) / FW_TQ,
                    (p.n + p.slab_rows - 1) / p.slab_rows);
    exact_i8_select_kernel<HIST, MASK, WIDE><<<grid, FW_THREADS, smem, st>>>(
        p.map, p.qmap, (const signed char*)p.q, (const signed char*)p.c,
        p.fac, p.mask, p.nq, p.n, p.d, p.slab_rows, nst, sb, p.vec, p.qvec,
        p.i4, shift, himask, pre, need, hist, cnt, keys, width, only);
    return (int)cudaGetLastError();
}

// F<HIST, LR_MASK, WIDE>(args), WIDE = d > 64; the library's flavour sets
// MASK.
#define EI_DISPATCH(F, HIST, ...)                                             \
    (d > 64 ? F<HIST, LR_MASK, true>(__VA_ARGS__)                             \
            : F<HIST, LR_MASK, false>(__VA_ARGS__))

// The whole search on `st`: init (need k, or min(k, *kmin): the allowed
// rows' count, a device int; the prefixes from the sample's rank-th scores
// thr, or 0), the buffer pass and its check (cap > 0), the radix passes and
// their scans, the collect (every query on the radix route, the fallen ones
// else), the sort. With no threshold and n <= cap (the "all" route) every
// allowed row is buffered: the count, min(k, allowed rows) to n, passes any
// check, so the check, radix passes and collect are not launched.
static int ei_search(EiPass& p, int k, const int* kmin, int cap,
                     const float* thr, int rank, void* scratch, float* out_s,
                     int* out_i, cudaStream_t st) {
    const int nq = p.nq, n = p.n, d = p.d;
    const int width = es_buffer(k, cap);
    int* nfell = (int*)scratch;
    u64* pre = (u64*)((unsigned char*)scratch + 8);
    i64* keys = (i64*)(pre + nq);
    int* hist = (int*)(keys + (size_t)nq * width);
    int* need = hist + (size_t)nq * ES_BINS;
    int* cnt = need + nq;
    int* fell = cnt + nq;
    const int nqb = (nq + FM_THREADS - 1) / FM_THREADS;
    int e = 0;
    exact_select_init<<<(unsigned)(((size_t)nq * ES_BINS + FM_THREADS - 1) /
                                   FM_THREADS),
                        FM_THREADS, 0, st>>>(nq, k, kmin, thr, rank, pre,
                                             need, cnt, hist, nfell);
    if ((e = (int)cudaGetLastError())) return e;
    const bool all = cap && !thr && n <= cap;
    if (cap) {  // the buffer pass and its check
        if ((e = EI_DISPATCH(ei_pass, false, p, 0, 0ull, pre, need, hist, cnt,
                             keys, width, nullptr, st)))
            return e;
        if (!all) {
            exact_select_check<<<nqb, FM_THREADS, 0, st>>>(
                nq, k, kmin, cap, pre, need, cnt, fell, nfell);
            if ((e = (int)cudaGetLastError())) return e;
        }
    }
    // row digits: the bits of n - 1, in whole bytes
    int row_bits = 8;
    while (row_bits < 32 && ((unsigned)(n - 1) >> row_bits)) row_bits += 8;
    const u64 fill = 0x7FFFFFFFull & ~((1ull << row_bits) - 1);
    for (int shift = 56; shift >= 0 && !all; shift -= 8) {
        if (shift < 32 && shift >= row_bits) continue;  // bits every row shares
        const u64 himask = shift == 56 ? 0ull : ~0ull << (shift + 8);
        if ((e = EI_DISPATCH(ei_pass, true, p, shift, himask, pre, need, hist,
                             cnt, keys, width, nullptr, st)))
            return e;
        exact_select_scan<<<nqb, FM_THREADS, 0, st>>>(
            nq, shift, shift == 32 ? fill : 0ull, pre, need, hist);
        if ((e = (int)cudaGetLastError())) return e;
    }
    if (!all && (e = EI_DISPATCH(ei_pass, false, p, 0, 0ull, pre, need, hist,
                                 cnt, keys, width, cap ? fell : nullptr, st)))
        return e;
    exact_select_sort<<<nq, FM_THREADS,
                        width <= ES_SORT_SMEM ? (size_t)width * 8 : 0, st>>>(
        keys, width, cnt, k, out_s, out_i);
    return (int)cudaGetLastError();
}

extern "C" {

// Dynamic shared memory of one exact_i8_select_kernel block at d (hist: a
// histogram pass's); 0 if it fits no block.
size_t lr_exact_i8_select_smem(int d, int hist) {
    int nst = 0, sb = 0;
    size_t smem = 0;
    return ei_plan(d, hist, &nst, &sb, &smem) ? 0 : smem;
}

// Resident blocks per SM of the buffer pass (hist = 0) or a histogram pass
// at d, of the library's flavour (LR_MASK), on the current device (0: does
// not fit); a negative cudaError_t on failure. op: OP_I8 or OP_I4 (the same
// blocks).
int lr_exact_i8_select_occupancy(int d, int op, int hist) {
    int nst = 0, sb = 0;
    size_t smem = 0;
    if (op != OP_I8 && op != OP_I4) return -(int)cudaErrorInvalidValue;
    const int e = ei_plan(d, hist, &nst, &sb, &smem);
    if (e) return e == (int)cudaErrorInvalidValue ? 0 : -e;
    return hist ? EI_DISPATCH(ei_occupancy, true, smem)
                : EI_DISPATCH(ei_occupancy, false, smem);
}

// Bytes of the scratch lr_exact_i8_select carves, as the float select's:
// the fallback count (8 bytes), prefixes, buffers of cap keys (es_width(k)
// with cap = 0), histograms, needs, counts and fallback flags.
size_t lr_exact_i8_select_scratch(int nq, int k, int cap) {
    return es_scratch_bytes(nq, k, cap);
}

// The int8 (op = OP_I8: c int8 codes [n, d]) or int4 (OP_I4: c packed
// nibbles uint8 [n, ceil(d / 2)], low nibble the even dim) exact search
// of int8 query codes q [nq, d] at 256 < k <= 2048 (any k <= n works),
// factor the one fp32 score factor, all on `stream`; kmin (null: k) a
// device int, the allowed rows' count: a buffer must reach min(k, *kmin)
// keys, so the host never reads the count. cap = 0: the radix route; cap >
// 0, a power of two in [es_width(k), ES_SORT_SMEM]: buffers of
// cap keys filled by one buffer pass at the threshold, their check, the
// radix passes and collect for the queries that fell back, the sort; the
// threshold is the rank-th of each query's sampled scores thr [nq, rank]
// (fp32, best first), or with thr null the least key. slab_rows: the
// passes' slabs, a multiple of 128. mask (the masked library; null in the
// other): the allowed rows' bits, int32 words [ceil(n/32)]. scratch holds
// lr_exact_i8_select_scratch(nq, k, cap) bytes, 8-byte aligned, whose first
// int counts the queries that fell back. Returns a cudaError_t.
int lr_exact_i8_select(const void* q, const void* c, const float* factor,
                       int nq, int n, int d, int k, const int* kmin,
                       int slab_rows, int cap, const float* thr, int rank,
                       const unsigned* mask, int op, void* scratch,
                       float* out_s, int* out_i, void* stream) {
    if ((op != OP_I8 && op != OP_I4) || k < 1 || k > n || d < 1 || nq < 1 ||
        slab_rows < 1 || slab_rows % TN ||
        (LR_MASK && !mask) || (!LR_MASK && mask))
        return (int)cudaErrorInvalidValue;
    if (cap && (cap < es_width(k) || cap > ES_SORT_SMEM || (cap & (cap - 1))))
        return (int)cudaErrorInvalidValue;
    if (thr && (!cap || rank < 1)) return (int)cudaErrorInvalidValue;
    // the corpus's stages and the query tile by TMA where rows are whole
    // 16-byte chunks on an aligned base, as exact_i8_wgmma_kernel takes
    // them (int4: the producer warpgroup's 16-byte loads of the nibbles)
    const int i4 = op == OP_I4, ch = fw_ch(d), w = (d + 1) >> 1;
    const bool c16 = (reinterpret_cast<size_t>(c) & 15) == 0;
    EiPass p;
    memset(&p.map, 0, sizeof(p.map));
    memset(&p.qmap, 0, sizeof(p.qmap));
    p.vec = i4 ? (w & 15) == 0 && c16 : (d & 15) == 0 && c16;
    p.qvec = (d & 15) == 0 && (reinterpret_cast<size_t>(q) & 15) == 0;
    if (d > 64 && !i4) p.vec = p.qvec = p.vec && p.qvec;
    int e = 0;
    if (p.vec && !i4 && (e = fw_map(&p.map, c, d, n, ch, TN))) return e;
    if (p.qvec && !(d > 64 && i4) && (e = fw_map(&p.qmap, q, d, nq, ch, FW_TQ)))
        return e;
    p.q = q;
    p.c = c;
    p.fac = factor;
    p.mask = mask;
    p.nq = nq;
    p.n = n;
    p.d = d;
    p.slab_rows = slab_rows;
    p.i4 = i4;
    return ei_search(p, k, kmin, cap, thr, rank, scratch, out_s, out_i,
                     (cudaStream_t)stream);
}

}  // extern "C"

#undef EI_DISPATCH
