// The int8 and int4 stores' exact search, designed for Hopper:
// exact_i8_wgmma_kernel<KP, MASK, WIDE> (+ exact_merge_kernel<KP> past one
// slab), at k <= 256. It replaces the JAX package's sq8_topk and sq4_topk
// past the fold's 128 candidates (its ops/quantization.py:35-80 and
// :144-200: a dot_general of the SQ8 codes, or of the unpacked nibbles,
// and approx_max_k, XLA there, no Pallas kernel), which the port first ran
// as exact_mma_kernel<KP, OP_I8> / <KP, OP_I4>, instances of the bf16
// exact search's template (exact_mma.cuh); past k = 256 those instances
// stay. The int4 store (lr_exact_i4, a runtime flag i4 of the kernel, no
// template instance of its own) has its packed nibbles sign-extended into
// the s8 stages by the producer warpgroup's four warps (wgmma_i8.cuh's
// fw_produce4, the int4 fold's producer), so that the consumers below run
// unchanged. Included by fused_topk.cu after exact_mma.cuh, whose contract
// it keeps bit for bit: the top k of float32(int32 dot) * factor (each step
// rounded to nearest, as the JAX package rounds it), ties to the lower
// row, as keys monotone_i32(score) << 32 | INT_MAX - row (EMPTY64 an empty
// slot); with the row mask, slots no allowed row fills are (LR_NEG_INF,
// -1); past one slab each slab writes its sorted key list and
// exact_merge_kernel merges them.
//
// What bounds it on the H100. The products are 2 Q N d int8 operations at
// the tensor cores' 1,979 TOPS: at 1024 x 8.8M, d = 64, 0.58 ms. The codes
// are 563 MB, read from device memory about once (the query tiles of a
// slab run side by side and meet in the 50 MB L2), but each block streams
// its slab from L2: 64 queries a block make that 9 GB at 1024 x 8.8M.
//
// What the split of the old instance showed (PERF.md section 6,
// scripts/torch_int8_exact_split.py, 1024 x 8.8M): cutting its flushes,
// its conversion and compare, or its products each took 2-12 % off 20.6 /
// 31.1 ms (k = 10 / 160); what stays is the stages' path: a 16-query tile
// streams 36 GB from L2 through a cp.async ring with a block-wide barrier
// a stage.
//
// The design (the ring, the producer and the wgmma issue are wgmma_i8.cuh's,
// shared with the int8 fold):
//   - a 64-query tile on wgmma m64n64k32 s8: 4x the reuse of a stage of
//     the old m16 tile; a TMA producer warp, a consumer warpgroup, no
//     block-wide barrier in the loop; a sub-tile's two 64-row halves in two
//     accumulator sets, the first half's skip test under the second half's
//     products;
//   - a skip test on the raw int32 dot (ew_select): each thread holds, for
//     its rows g and g + 8 of its warp's 16 queries, the least dot whose
//     score could still reach the list's k-th key as of the last flush
//     (fw_threshold: exact for factor > 0 and |dot| < 2^24: int8, |dot|
//     <= d x 128 x 128, so d <= 1024; int4, |dot| <= d x 128 x 8, within
//     it for every d up to that limit too; two dots may round to one fp32
//     score, so it admits equal scores and the exact key compare
//     decides). A row's largest dot of a half against
//     it, and a warp vote, skip the row's 16 scores a thread on a few
//     integer instructions;
//   - only dots at or above it are converted, keyed and compared with the
//     k-th key (ew_append: one short loop over them, once both halves'
//     products are in), each written to a slot of its row's buffer taken
//     at its quad's prefix count (an empty key where the compare fails);
//   - lists owned by a warp: each query's sorted list of k keys in shared
//     memory, a buffer of `buf` keys (64 to 128) beside it. After a half in
//     which some row of the consumer warpgroup holds more than buf - 64
//     keys (at the slab's end: any), each warp flushes its own 16 queries'
//     buffers into their lists and derives the new thresholds. The warps
//     vote on it together (one named barrier a half), since they wait for
//     each other at every wgmma anyway: flushes side by side overlap where
//     flushes one warp at a time would add up. A flush is the lists' own
//     work, over 32 E = KP register slots: up to 4 E keys inserted one by
//     one (ew_offer), more sorted as a chunk of 128 and merged, two queries
//     side by side (ew_offer2), as the networks are chains of dependent
//     shuffles;
//   - the mask's words for a sub-tile are loaded before its products.
//
// What the new kernel's own split showed (PERF.md section 6): its stages,
// products and skip test alone (every vote failing) take 2.1-2.6 ms at
// 1024 x 8.8M with two blocks an SM (k = 10), 3.6-4.6 ms with one (k =
// 160); the rest is the appends and flushes, and since the warpgroup moves
// in lockstep, a half where any warp appends costs every warp. Where a
// slab holds a few sub-tiles (the msmarco main at top_k 150: 2000 x 1997)
// the flushes are most of the time, one warp's networks for 16 queries
// where the old instance ran 8 warps for its 16.
//
// Shared memory: the 64 queries' lists take 64 k x 8 bytes (64 KB at k =
// 128, 128 KB at k = 256) and the buffers 64 buf x 8; ew_plan takes the
// largest buffer (128, 96 or 64 keys) and ring (2 to 8 stages) that fit
// two blocks an SM, else one. At d <= 64 two blocks fit an SM up to k =
// 120 (k <= 56 with buffers of 128); at k = 128 (KP = 128) and at KP = 256
// one block does (k = 256: buffers of 128 and 3 stages; WIDE, d > 64:
// buffers of 64 and 2 stages of 24 KB).

#include "wgmma_i8.cuh"

#define EW_BUF_MAX 128                  // buffer keys a query at most
#define EW_SKIP_MAX_D 1024              // |dot| < 2^24: the skip test holds

// Shared memory of everything but the ring: the barriers, the query tile
// (d <= 64), the 64 queries' lists of k keys and their buffers of buf
// keys.
__host__ __device__ inline size_t ew_fixed_bytes(int d, int k, int buf) {
    return FW_BAR_BYTES + fw_qtile_bytes(d) + (size_t)FW_TQ * (k + buf) * 8;
}

// The block's shared memory, carved as ew_fixed_bytes counts it.
struct EwSmem : FwRing {
    i64* L;  // [64][k] sorted lists
    i64* B;  // [64][buf] buffers
};

__device__ __forceinline__ EwSmem ew_carve(unsigned char* smem, int nst,
                                           int d, int k, int buf) {
    EwSmem s;
    s.full = fm_smem(smem);
    s.empty = s.full + 8 * FW_NST_MAX;
    s.ring = s.full + FW_BAR_BYTES;
    s.qs = s.ring + nst * fw_stage_bytes(d);
    s.L = reinterpret_cast<i64*>(smem + FW_BAR_BYTES +
                                 (size_t)nst * fw_stage_bytes(d) +
                                 fw_qtile_bytes(d));
    s.B = s.L + (size_t)FW_TQ * k;
    return s;
}

// A thread's two rows, g (index 0) and g + 8 (1), of its warp's 16
// queries: the least dot that may enter each list (INT_MIN: every dot;
// INT_MAX: a row past nq) and its k-th key, as of the last flush, and the
// slots taken in its buffer (the same in the quad's 4 threads).
struct EwRows {
    int thr[2];
    i64 kth[2];
    int cnt[2];
};

// The key of corpus row `row` at int32 dot `dot`: the score float32(dot) *
// factor (as fm_i2f), order-preserving, over INT_MAX - row; a NaN score
// (a NaN factor) never enters, as in exact_mma_kernel.
__device__ __forceinline__ i64 ew_key(int dot, float factor, int row) {
    const float s = __fmul_rn(__int2float_rn(dot), factor);
    const int b = __float_as_int(s);
    const int m = b >= 0 ? b : (b ^ 0x7FFFFFFF);
    return s == s ? (i64)(((u64)(unsigned)m << 32) |
                          (unsigned)(INT_MAX - row))
                  : EMPTY64;
}

// fm_sort's and fm_merge's bitonic networks over two lists at once, step
// by step, so that the two lists' shuffles and compares overlap (a flush
// is a chain of dependent steps, one warp an SM sub-partition).
template <int E, bool ASC>
__device__ __forceinline__ void ew_sort2(i64 (&v)[E], i64 (&w)[E], int lane) {
#pragma unroll
    for (int s = 2; s <= 32 * E; s <<= 1) {
#pragma unroll
        for (int j = s >> 1; j > 0; j >>= 1) {
            if (j >= E) {
                const int lm = j / E;
                const bool lower = (lane & lm) == 0;
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const bool desc = (((E * lane + e) & s) == 0) != ASC;
                    const i64 o = fm_shfl_xor(v[e], lm);
                    const i64 p = fm_shfl_xor(w[e], lm);
                    v[e] = lower == desc ? fm_max(v[e], o) : fm_min(v[e], o);
                    w[e] = lower == desc ? fm_max(w[e], p) : fm_min(w[e], p);
                }
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    if (e & j) continue;
                    const bool desc = (((E * lane + e) & s) == 0) != ASC;
                    fm_cas(v[e], v[e | j], desc);
                    fm_cas(w[e], w[e | j], desc);
                }
            }
        }
    }
}

template <int E>
__device__ __forceinline__ void ew_merge2(i64 (&v)[E], i64 (&w)[E], int lane) {
#pragma unroll
    for (int j = 16 * E; j > 0; j >>= 1) {
        if (j >= E) {
            const int lm = j / E;
            const bool lower = (lane & lm) == 0;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const i64 o = fm_shfl_xor(v[e], lm);
                const i64 p = fm_shfl_xor(w[e], lm);
                v[e] = lower ? fm_max(v[e], o) : fm_min(v[e], o);
                w[e] = lower ? fm_max(w[e], p) : fm_min(w[e], p);
            }
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                if (e & j) continue;
                fm_cas(v[e], v[e | j], true);
                fm_cas(w[e], w[e | j], true);
            }
        }
    }
}

// A sorted list of 32 E >= k entries (E a lane) takes a chunk of 128 keys
// sorted ascending (4 a lane): entry by entry the larger of the list's
// and the chunk's, the chunk for the list of 256 (E = 8) laid out as the
// upper half of an ascending 256-key chunk whose lower half is empty (lane
// l >= 16 holds chunk keys 8 (l - 16) .. + 7, from lanes 2 (l - 16) and
// 2 (l - 16) + 1): a bitonic sequence holding the best 32 E of both, for
// a merge.
template <int E>
__device__ __forceinline__ void ew_take(i64 (&v)[E], const i64 (&x)[4],
                                        int lane) {
    if constexpr (E == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fm_max(v[e], x[e]);
    } else {
        static_assert(E == 8, "lists of 128 or 256");
        const int src = 2 * (lane & 15);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const i64 lo = fm_shfl(x[e], src), hi = fm_shfl(x[e], src + 1);
            if (lane >= 16) {
                v[e] = fm_max(v[e], lo);
                v[e + 4] = fm_max(v[e + 4], hi);
            }
        }
    }
}

// The list Lq[0, k) in registers as 32 E entries, E a lane (EMPTY64 past
// k), and back; entries past k are real but unkept.
template <int E>
__device__ __forceinline__ void ew_load_list(i64 (&v)[E], const i64* Lq,
                                             int k, int lane) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = E * lane + e;
        v[e] = i < k ? Lq[i] : EMPTY64;
    }
}

template <int E>
__device__ __forceinline__ void ew_store_list(const i64 (&v)[E], i64* Lq,
                                              int k, int lane) {
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = E * lane + e;
        if (i < k) Lq[i] = v[e];
    }
    __syncwarp();
}

// A query's buffer (c <= 128 slots, 4 a lane), empty past c.
__device__ __forceinline__ void ew_load_buf(i64 (&x)[4], const i64* Bq,
                                            int c, int lane) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int i = 4 * lane + e;
        x[e] = i < c ? Bq[i] : EMPTY64;
    }
}

// Offer one query's buffer (4 keys a lane) to its sorted list Lq[0, k):
// keys that do not beat the k-th are dropped; up to 4 E passers are
// inserted one by one (fm_insert); more are sorted as one chunk of 128
// (fm_sort<4>, the dropped keys empty) and merged in (ew_take, fm_merge).
template <int E>
__device__ __forceinline__ void ew_offer(i64* Lq, int k, i64 (&x)[4],
                                         int lane) {
    const i64 kth = Lq[k - 1];
    unsigned m[4];
    int np = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        m[e] = __ballot_sync(FM_FULL, x[e] > kth);
        np += __popc(m[e]);
    }
    if (np == 0) return;  // uniform
    i64 v[E];
    ew_load_list<E>(v, Lq, k, lane);
    if (np <= 4 * E) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            unsigned mm = m[e];
            while (mm) {
                const int src = __ffs(mm) - 1;
                mm &= mm - 1;
                fm_insert<E>(v, fm_shfl(x[e], src), lane);
            }
        }
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (!(x[e] > kth)) x[e] = EMPTY64;
        fm_sort<4, true>(x, lane);
        ew_take<E>(v, x, lane);
        fm_merge<E>(v, lane);
    }
    ew_store_list<E>(v, Lq, k, lane);
}

// Two queries' buffers offered as chunks side by side (ew_sort2,
// ew_merge2): a flush's queries with more than 4 E keys go in pairs.
template <int E>
__device__ __forceinline__ void ew_offer2(i64* L0, i64* L1, int k,
                                          i64 (&x)[4], i64 (&y)[4],
                                          int lane) {
    const i64 kth0 = L0[k - 1], kth1 = L1[k - 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (!(x[e] > kth0)) x[e] = EMPTY64;
        if (!(y[e] > kth1)) y[e] = EMPTY64;
    }
    i64 v[E], w[E];
    ew_load_list<E>(v, L0, k, lane);
    ew_load_list<E>(w, L1, k, lane);
    ew_sort2<4, true>(x, y, lane);
    ew_take<E>(v, x, lane);
    ew_take<E>(w, y, lane);
    ew_merge2<E>(v, w, lane);
    ew_store_list<E>(v, L0, k, lane);
    ew_store_list<E>(w, L1, k, lane);
}

// Merge the warp's buffers into their lists: each of its 16 queries that
// holds keys offers them to its list (lists of 32 E >= k entries; those
// with more than 4 E keys in pairs, ew_offer2, the rest ew_offer); then
// each thread's rows get their new k-th keys and thresholds, and the
// buffers start empty.
template <int E>
__device__ __forceinline__ void ew_flush(const EwSmem& sm, EwRows& st,
                                         int k, int buf, float factor,
                                         bool skip, int q0, int nq, int cw,
                                         int lane) {
    const int g = lane >> 2;
    __syncwarp();  // the appends are in
    int held = -1, held_c = 0;  // a query whose offer waits for a partner
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
        const int qi = 16 * cw + r;
        const int c =
            __shfl_sync(FM_FULL, r < 8 ? st.cnt[0] : st.cnt[1], 4 * (r & 7));
        if (c == 0) continue;  // uniform
        i64 x[4];
        ew_load_buf(x, sm.B + (size_t)qi * buf, c, lane);
        if (c <= 4 * E) {
            ew_offer<E>(sm.L + (size_t)qi * k, k, x, lane);
        } else if (held < 0) {
            held = qi;
            held_c = c;
        } else {
            i64 y[4];
            ew_load_buf(y, sm.B + (size_t)held * buf, held_c, lane);
            ew_offer2<E>(sm.L + (size_t)held * k, sm.L + (size_t)qi * k, k,
                         y, x, lane);
            held = -1;
        }
    }
    if (held >= 0) {
        i64 x[4];
        ew_load_buf(x, sm.B + (size_t)held * buf, held_c, lane);
        ew_offer<E>(sm.L + (size_t)held * k, k, x, lane);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qi = 16 * cw + g + 8 * h;
        if (q0 + qi < nq) {
            const i64* Lq = sm.L + (size_t)qi * k;
            st.kth[h] = Lq[k - 1];
            if (skip) st.thr[h] = fw_threshold(Lq, k, factor);
        }
        st.cnt[h] = 0;
    }
    __syncwarp();  // before the next appends overwrite the buffers
}

// The row mask's bits of the thread's 32 columns of the sub-tile at row t0
// (its 128 rows: four whole words): column 8 j + 2 t4 + h at bit 8 (j & 3)
// + 2 (j >> 2) + h.
__device__ __forceinline__ unsigned ew_mask_bits(const unsigned* mask,
                                                 int t0, int n, int lane) {
    const int t4 = lane & 3, w = t0 >> 5, n_words = (n + 31) >> 5;
    unsigned mb = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const unsigned word = w + u < n_words ? __ldg(mask + w + u) : 0u;
        mb |= ((word >> (2 * t4)) & 0x03030303u) << (2 * u);
    }
    return mb;
}

// Whether p holds in any thread of the consumer warpgroup (named barrier
// 1, its 128 threads, every one of which must arrive).
__device__ __forceinline__ bool ew_group_any(bool p) {
    unsigned r;
    asm volatile(
        "{\n.reg .pred a, b;\nsetp.ne.u32 a, %1, 0;\n"
        "bar.red.or.pred b, 1, 128, a;\nselp.u32 %0, 1, 0, b;\n}\n"
        : "=r"(r) : "r"((unsigned)p) : "memory");
    return r != 0u;
}

// The skip test of half HALF (columns 64 HALF .. 64 HALF + 63) of the
// sub-tile at row t0: for each of the thread's rows, the largest dot of
// its allowed columns against the row's threshold and a warp vote; for a
// row set that passes, pm[h] gets the thread's dots at or above the
// threshold (allowed, below n), by column; else 0. Straight-line code: it
// runs while the tensor cores take the next half's products. The thread
// holds rows g (a[4 jh + {0, 1}]) and g + 8 (a[4 jh + {2, 3}]) at columns
// 8 j + 2 t4 + {0, 1}, j = 8 HALF + jh (wgmma's accumulator layout), bit
// 2 jh + {0, 1} of pm; columns from vcol on are rows >= n; mb holds the
// row mask's bits of the thread's 32 columns (MASK only, ew_mask_bits).
template <bool MASK, int HALF>
__device__ __forceinline__ void ew_select(const int (&a)[32],
                                          const EwRows& st, int t0, int n,
                                          unsigned mb, int lane,
                                          unsigned (&pm)[2]) {
    const int t4 = lane & 3;
    const int vcol = n - t0 - 2 * t4;
    const bool edge = t0 + TN > n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int r[8];  // a tree, not a chain, of maxima (MASK: allowed columns)
#pragma unroll
        for (int jh = 0; jh < 8; ++jh) {
            int x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int j = 8 * HALF + jh;
                const bool ok =
                    !MASK || ((mb >> (8 * (j & 3) + 2 * (j >> 2) + e)) & 1u);
                x[e] = ok ? a[4 * jh + 2 * h + e] : INT_MIN;
            }
            r[jh] = max(x[0], x[1]);
        }
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
            for (int i = 0; i < w; ++i) r[i] = max(r[i], r[i + w]);
        pm[h] = 0;
        if (!__any_sync(FM_FULL, r[0] >= st.thr[h])) continue;  // uniform
#pragma unroll
        for (int jh = 0; jh < 8; ++jh) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int j = 8 * HALF + jh;
                bool ok = a[4 * jh + 2 * h + e] >= st.thr[h] &&
                          (!edge || 8 * j + e < vcol);
                if (MASK)
                    ok = ok &&
                         ((mb >> (8 * (j & 3) + 2 * (j >> 2) + e)) & 1u);
                pm[h] |= (unsigned)ok << (2 * jh + e);
            }
        }
    }
}

// The appends of half HALF, once no wgmma group is in flight (a loop with
// a group in flight would serialize every wgmma, C7514): each thread takes
// a slot of its row's buffer for each dot ew_select kept, at its quad's
// prefix count (no atomics), and one short loop over them (the code a
// passing vote runs stays small) keys each, compares it with the row's
// k-th key and writes it, or an empty key (EMPTY64, which no list takes).
// Returns (uniform in the warp) whether the warp must flush before its
// next half: a buffer could not take another half, or the slab's last
// half is in. The warps of the warpgroup then flush together
// (ew_group_any): they wait for each other at every wgmma anyway, so
// flushes one warp at a time would add up where flushes side by side
// overlap.
template <int HALF>
__device__ __forceinline__ bool ew_append(const int (&a)[32],
                                          const unsigned (&pm)[2],
                                          const EwSmem& sm, EwRows& st,
                                          int t0, int row1, int buf,
                                          float factor, int cw, int lane) {
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
        i64* Bq = sm.B + (size_t)(16 * cw + g + 8 * h) * buf + st.cnt[h] +
                  (x - c);
        unsigned m = pm[h];
        while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            // the dot of column bit b, a tree of selects on b's bits
            int s8[8], s4[4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                s8[i] = (b & 1) ? a[4 * i + 2 * h + 1] : a[4 * i + 2 * h];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                s4[i] = (b & 2) ? s8[2 * i + 1] : s8[2 * i];
            const int s2a = (b & 4) ? s4[1] : s4[0];
            const int s2b = (b & 4) ? s4[3] : s4[2];
            const int dot = (b & 8) ? s2b : s2a;
            const i64 key = ew_key(
                dot, factor, t0 + 64 * HALF + 8 * (b >> 1) + 2 * t4 + (b & 1));
            *Bq++ = key > st.kth[h] ? key : EMPTY64;
        }
        st.cnt[h] += total;
    }
    const bool last = HALF == 1 && t0 + TN >= row1;
    const int room = last ? 0 : buf - 64;  // a half adds at most 64 a row
    return __any_sync(FM_FULL, max(st.cnt[0], st.cnt[1]) > room);
}

// grid: (ceil(nq / 64), slabs of slab_rows rows, a multiple of 128); 256
// threads: warps 0-3 the producer warpgroup, 4-7 the consumers (warp 4 +
// w: queries 16 w .. 16 w + 15 of the tile). q: int8 query codes [nq, d]
// (qmap: their TMA map when qvec, but for i4 and WIDE); c: int8 codes [n,
// d] (map: their TMA map when vec; WIDE: vec covers both and qvec is vec),
// or with i4 packed nibbles [n, ceil(d / 2)] (vec: 16-byte loads; map
// unused; WIDE: qvec the queries' 16-byte loads); fac: the one fp32 score
// factor; k <= KP (128 or 256); buf: buffer keys a query (64 to 128); nst
// >= 2 ring stages. final_out (one slab): write out_s / out_i;
// else part[slab, q, :] keys. MASK: mask is the allowed rows' bits
// [ceil(n/32)].
template <int KP, bool MASK, bool WIDE>
__global__ void __launch_bounds__(FW_THREADS, 2)
exact_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                      const __grid_constant__ CUtensorMap qmap,
                      const signed char* __restrict__ q,
                      const signed char* __restrict__ c,
                      const float* __restrict__ fac,
                      const unsigned* __restrict__ mask, int nq, int n,
                      int d, int k, int buf, int slab_rows, int nst, int vec,
                      int qvec, int i4, int final_out, i64* __restrict__ part,
                      float* __restrict__ out_s, int* __restrict__ out_i) {
    constexpr int E = KP / 32;  // fm_offer's list slots a lane
    extern __shared__ __align__(1024) unsigned char ew_smem_raw[];
    unsigned char* smem = ew_smem_raw;
    const int ch = fw_ch(d), n_dch = (d + ch - 1) / ch;
    const EwSmem sm = ew_carve(smem, nst, d, k, buf);
    // the warp's index as one value for the whole warp (a shuffle), so that
    // the compiler sees the roles' branches as uniform
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
    const int q0 = blockIdx.x * FW_TQ;
    const int row0 = blockIdx.y * slab_rows;
    const int row1 = min(row0 + slab_rows, n);
    const int n_sub = (row1 - row0 + TN - 1) / TN;

    const unsigned qbar = sm.empty + 8 * FW_NST_MAX;  // the query tile's
    if (tid == 0)
        fw_init_ring(sm, nst, i4 ? FW_P4_THREADS / 32 : vec ? 1 : 32, qbar);
    if (tid >= 128) {
        // the query tile (d <= 64): by TMA (qvec, from the producer below),
        // else here; the lists emptied
        if (!WIDE && !qvec)
            fw_load_qtile(smem + (sm.qs - sm.full), q, nq, d, q0, tid - 128);
        for (int e = tid - 128; e < FW_TQ * k; e += 128) sm.L[e] = EMPTY64;
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
    const int cw = warp - 4;
    const bool active = q0 + 16 * cw < nq;  // uniform per warp
    const float factor = __ldg(fac);
    // the skip test needs scores that rise with the dot, and fw_threshold
    // needs |dot| < 2^24
    const bool skip = d <= EW_SKIP_MAX_D && factor > 0.f && isfinite(factor);
    const int g = lane >> 2;
    EwRows st;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        st.thr[h] = q0 + 16 * cw + g + 8 * h < nq ? INT_MIN : INT_MAX;
        st.kth[h] = EMPTY64;
        st.cnt[h] = 0;
    }
    if (!WIDE && qvec) fw_bar_wait(qbar, 0);
    // the accumulators start unset (each sub-tile's first wgmma does not
    // read them): a zero read from one as a constant makes ptxas serialize
    // every wgmma (C7514)
    int acc_a[32], acc_b[32];
    // the two halves of each sub-tile in two accumulator sets: the first
    // half's skip test runs while the tensor cores take the second half's
    // products. No wgmma group is in flight across a loop's back edge: ptxas
    // cannot follow one from one iteration into the next and would
    // serialize every wgmma of the kernel (C7514); so the appends and the
    // flushes, which loop, wait for both halves' products. Every consumer
    // warp, active or not, takes part in each half's flush vote
#define EW_SELECT(HALF, A) ew_select<MASK, HALF>(A, st, t0, n, mb, lane, pm)
#define EW_APPEND(HALF, A)                                                   \
    ew_append<HALF>(A, pm, sm, st, t0, row1, buf, factor, cw, lane)
#define EW_FLUSH() ew_flush<E>(sm, st, k, buf, factor, skip, q0, nq, cw, lane)
    unsigned pm[2] = {0u, 0u};
    int slot = 0;  // the ring position, by counters
    unsigned phase = 0;
    for (int sub = 0, t0 = row0; sub < n_sub; ++sub, t0 += TN) {
        // the sub-tile's mask bits, loaded before its products, under which
        // their latency hides
        const unsigned mb = MASK ? ew_mask_bits(mask, t0, n, lane) : 0u;
        if constexpr (WIDE) {
            // every dim chunk but the last: both halves' products, then its
            // stage back to the producer
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
        if (active) EW_SELECT(0, acc_a);
        fw_wgmma_wait<0>();
        fw_fence_acc(acc_b);
        fw_release(sm, slot, lane);
        bool flush = ew_group_any(active && EW_APPEND(0, acc_a));
        // a flush, where one is due, after each half, from one place in
        // the code
#pragma unroll 1
        for (int half = 1;; ++half) {
            if (flush && active) EW_FLUSH();
            if (half == 2) break;
            if (active) EW_SELECT(1, acc_b);
            flush = ew_group_any(active && EW_APPEND(1, acc_b));
        }
        fw_step(slot, phase, nst);
    }
#undef EW_FLUSH
#undef EW_APPEND
#undef EW_SELECT

    if (!active) return;
    for (int r = 0; r < 16; ++r) {  // the warp's 16 queries
        const int qi = 16 * cw + r, qq = q0 + qi;
        if (qq >= nq) break;
        const i64* Lq = sm.L + (size_t)qi * k;
        for (int i = lane; i < k; i += 32) {
            const size_t o = (size_t)qq * k + i;
            if (final_out)
                em_out(Lq[i], out_s + o, out_i + o);
            else
                part[(size_t)blockIdx.y * nq * k + o] = Lq[i];
        }
    }
}

// The buffers' and the ring's depth and the block's shared memory at (d,
// k): two blocks an SM where a ring of at least 2 stages fits beside the
// lists and buffers of at least 64 keys, else one; the largest buffer
// (128, 96, 64 keys) first, then up to FW_NST_MAX stages. A cudaError_t.
static int ew_plan(int d, int k, int* nst, int* buf, size_t* smem) {
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
        for (int b = EW_BUF_MAX; b >= 64; b -= 32) {
            const size_t fixed = ew_fixed_bytes(d, k, b);
            if (budget < fixed) continue;
            const size_t fit = (budget - fixed) / slot;
            const int s = fit < FW_NST_MAX ? (int)fit : FW_NST_MAX;
            if (s >= 2) {
                *nst = s;
                *buf = b;
                *smem = fixed + s * slot;
                return 0;
            }
        }
    }
    return (int)cudaErrorInvalidValue;  // does not fit a block
}

template <int KP, bool MASK, bool WIDE>
static int ew_prepare() {
    static unsigned ready = 0;  // bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32 && (ready >> dev) & 1u) return 0;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(exact_i8_wgmma_kernel<KP, MASK, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) ready |= 1u << dev;
    return 0;
}

template <int KP, bool MASK, bool WIDE>
static int ew_occupancy(size_t smem) {
    int e = ew_prepare<KP, MASK, WIDE>();
    if (e) return -e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, exact_i8_wgmma_kernel<KP, MASK, WIDE>, FW_THREADS, smem);
    return e ? -e : blocks;
}

template <int KP, bool MASK, bool WIDE>
static int ew_launch(const void* q, const void* c, const float* fac,
                     const unsigned* mask, int nq, int n, int d, int k,
                     int slab_rows, int nst, int buf, size_t smem, int i4,
                     long long* part, float* out_s, int* out_i,
                     cudaStream_t st) {
    int e = ew_prepare<KP, MASK, WIDE>();
    if (e) return e;
    // the corpus's stages and the query tile or its chunks by TMA where
    // rows are whole 16-byte chunks on an aligned base (fold_i8_wgmma's
    // maps); else by the producer's loads. int4 (i4), as the int4 fold
    // takes them: the producer warpgroup unpacks the stages from the
    // nibbles, by 16-byte loads where a packed row is whole 16-byte pieces
    // on an aligned base, and loads WIDE's query chunks; the query tile (d
    // <= 64) comes by TMA as the int8 store's does
    const int ch = fw_ch(d), w = (d + 1) >> 1;
    const bool c16 = (reinterpret_cast<size_t>(c) & 15) == 0;
    CUtensorMap map, qmap;
    memset(&map, 0, sizeof(map));
    memset(&qmap, 0, sizeof(qmap));
    int vec = i4 ? (w & 15) == 0 && c16 : (d & 15) == 0 && c16;
    int qvec = (d & 15) == 0 && (reinterpret_cast<size_t>(q) & 15) == 0;
    if (WIDE && !i4) vec = qvec = vec && qvec;
    if (vec && !i4) {
        e = fw_map(&map, c, d, n, ch, TN);
        if (e) return e;
    }
    if (qvec && !(WIDE && i4)) {
        e = fw_map(&qmap, q, d, nq, ch, FW_TQ);
        if (e) return e;
    }
    const int n_slabs = (n + slab_rows - 1) / slab_rows;
    dim3 grid((nq + FW_TQ - 1) / FW_TQ, n_slabs);
    exact_i8_wgmma_kernel<KP, MASK, WIDE><<<grid, FW_THREADS, smem, st>>>(
        map, qmap, (const signed char*)q, (const signed char*)c, fac, mask,
        nq, n, d, k, buf, slab_rows, nst, vec, qvec, i4, n_slabs == 1, part,
        out_s, out_i);
    e = (int)cudaGetLastError();
    if (e || n_slabs == 1) return e;
    exact_merge_kernel<KP><<<nq, FM_THREADS, 0, st>>>(part, n_slabs, nq, k,
                                                      out_s, out_i);
    return (int)cudaGetLastError();
}

// F<KP, LR_MASK, WIDE>(args) for KP = 128 (k <= 128) or 256 and WIDE = d >
// 64; the library's flavour sets MASK.
#define EW_DISPATCH_KP(F, W, ...)                                             \
    (k <= 128 ? F<128, LR_MASK, W>(__VA_ARGS__)                               \
              : F<256, LR_MASK, W>(__VA_ARGS__))
#define EW_DISPATCH(F, ...)                                                   \
    (d > 64 ? EW_DISPATCH_KP(F, true, __VA_ARGS__)                            \
            : EW_DISPATCH_KP(F, false, __VA_ARGS__))

// The exact search of either store (i4: the int4 store's nibbles).
static int ew_exact(const void* q, const void* c, const float* factor,
                    int nq, int n, int d, int k, int slab_rows,
                    const unsigned* mask, int i4, long long* part,
                    float* out_s, int* out_i, void* stream) {
    if (k < 1 || k > 256 || d < 1 || n < 1 || nq < 1 || slab_rows < 1 ||
        slab_rows % TN || (LR_MASK && !mask))
        return (int)cudaErrorInvalidValue;
    int nst = 0, buf = 0;
    size_t smem = 0;
    const int e = ew_plan(d, k, &nst, &buf, &smem);
    if (e) return e;
    cudaStream_t st = (cudaStream_t)stream;
    return EW_DISPATCH(ew_launch, q, c, factor, mask, nq, n, d, k,
                       slab_rows, nst, buf, smem, i4, part, out_s, out_i, st);
}

extern "C" {

// Dynamic shared memory of one exact_i8_wgmma_kernel block at (d, k) (op:
// OP_I8 or OP_I4, whose blocks are the same); 0 if it fits no block.
size_t lr_exact_i8_smem(int d, int k, int op) {
    int nst = 0, buf = 0;
    size_t smem = 0;
    if ((op != OP_I8 && op != OP_I4) || ew_plan(d, k, &nst, &buf, &smem))
        return 0;
    return smem;
}

// Resident exact_i8_wgmma_kernel blocks per SM at (d, k <= 256), of the
// library's flavour (LR_MASK), on the current device (0: does not fit); a
// negative cudaError_t on failure. op: OP_I8 or OP_I4 (the same blocks).
int lr_exact_i8_occupancy(int d, int k, int op) {
    int nst = 0, buf = 0;
    size_t smem = 0;
    if ((op != OP_I8 && op != OP_I4) || k < 1 || k > 256)
        return -(int)cudaErrorInvalidValue;
    const int e = ew_plan(d, k, &nst, &buf, &smem);
    if (e) return e == (int)cudaErrorInvalidValue ? 0 : -e;
    return EW_DISPATCH(ew_occupancy, smem);
}

// The int8 exact search: int8 query codes q [nq, d] against int8 codes c
// [n, d], factor the one fp32 score factor, k <= 256;
// exact_i8_wgmma_kernel over (query tiles of 64 x slabs of slab_rows rows,
// a multiple of 128), then, with more than one slab, exact_merge_kernel.
// mask (the masked library; null in the other): the allowed rows' bits,
// int32 words [ceil(n/32)]. part: [slabs, nq, k] int64 scratch (unused
// with one slab). Returns a cudaError_t.
int lr_exact_i8(const void* q, const void* c, const float* factor, int nq,
                int n, int d, int k, int slab_rows, const unsigned* mask,
                long long* part, float* out_s, int* out_i, void* stream) {
    return ew_exact(q, c, factor, nq, n, d, k, slab_rows, mask, 0, part,
                    out_s, out_i, stream);
}

// The int4 exact search: lr_exact_i8 with c the int4 store's packed
// nibbles uint8 [n, ceil(d / 2)] (low nibble the even dim, two's
// complement), which exact_i8_wgmma_kernel's producer warpgroup
// sign-extends into its s8 stages. Returns a cudaError_t.
int lr_exact_i4(const void* q, const void* c, const float* factor, int nq,
                int n, int d, int k, int slab_rows, const unsigned* mask,
                long long* part, float* out_s, int* out_i, void* stream) {
    return ew_exact(q, c, factor, nq, n, d, k, slab_rows, mask, 1, part,
                    out_s, out_i, stream);
}

}  // extern "C"

#undef EW_DISPATCH
#undef EW_DISPATCH_KP
