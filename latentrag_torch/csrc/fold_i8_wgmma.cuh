// The int8 store's fold, designed for Hopper: fold_i8_wgmma_kernel<E, MASK>
// (+ fold_merge_kernel<E, MASK> past one slab). It replaces the JAX
// package's sq8_topk (its ops/quantization.py:35-80: a dot_general of the
// SQ8 codes and approx_max_k, XLA there, no Pallas kernel), which the
// port first ran as fold_mma_kernel<E, OP_I8>, an
// instance of the bf16 fold's template (fold_mma.cuh). Included by
// fused_topk.cu, whose header states the contract this kernel keeps bit
// for bit: score(q, c) = float32(int32 dot) * factor, each step rounded to
// nearest as the JAX package rounds it; 19-bit keys with a 13-bit tile
// column; the fold per aligned block_n tile over 128 lanes; the top k of
// the lanes' union under (key desc, tile asc, column desc); the slab lists
// and fold_merge_kernel; with the row mask, slots no allowed row fills are
// (LR_NEG_INF, -1).
//
// What bounds it on the H100. The products are 2 Q N d int8 operations at
// the tensor cores' 1,979 TOPS: at 1024 x 8.8M, d = 64, 0.58 ms. Every
// score must then leave the tensor cores: the 19-bit key needs the fp32
// bits of float32(dot) * factor, and the fold keeps the lane maxima of
// packed keys, 7 instructions a score, 5 of them on the SM's 64-lane
// INT32 pipe (9.0e9 scores: ~2.7 ms). The epilogue, not the tensor cores
// or the 563 MB of codes, sets the floor.
//
// What the split of the old instance showed (PERF.md section 6,
// scripts/torch_int8_fold_split.py, 1024 x 8.8M): the exact conversion
// alone moved it by +1 %, so the conversion pipe was not its limit; the
// fold (3.4 ms) and the products' path (2.7 ms for 0.58 ms of tensor work)
// ran one after another behind the block's barriers. The same split of
// this kernel: serialised wgmma cost it most (ptxas serialises every
// wgmma of a kernel when a non-wgmma instruction reads an accumulator
// while a group is in flight, when a wgmma sits in a runtime loop, or when
// a group is in flight across a loop's back edge), then the fold.
//
// The design:
//   - warp specialisation: a producer warpgroup (40 registers; one warp
//     works) and a consumer warpgroup (216 registers, setmaxnreg), 2
//     blocks an SM where the shared memory allows it;
//   - the producer keeps TMA copies of corpus stages in flight into a ring
//     of full and empty mbarriers (2 to 8 stages): a stage is 128 rows x
//     64 dims (8 KB, one box, 64-byte swizzle) when d <= 64, beside the
//     query tile, which comes once the same way. When d > 64 (the WIDE
//     instance) a stage is one 128-dim chunk of 128 rows and of the 64
//     queries (16 + 8 KB, two boxes, 128-byte swizzle), and a sub-tile
//     takes ceil(d / 128) stages, released one by one as their products
//     finish: neither the ring nor the query tile grows with d, so any d
//     fits. Rows whose bytes are not whole 16-byte chunks, or a base that
//     is not 16-byte aligned, are copied by loads into the same swizzle
//     instead;
//   - the consumers issue wgmma.mma_async m64n64k32 s8.s8 -> s32 with the
//     64-query tile and the stage in shared memory, a sub-tile's two
//     64-row halves into two accumulator sets: the first half's fold runs
//     while the tensor cores take the second half's products (WIDE: those
//     of the last dim chunk). Every k step is unrolled, and each sub-tile's
//     groups are waited for within its iteration, so that ptxas keeps the
//     wgmma asynchronous (WIDE's loop over dim chunks is a runtime loop);
//     no block-wide barrier in the loop, the ring's mbarriers order
//     everything;
//   - the fold reads wgmma's accumulator layout: a thread holds rows g and
//     g + 8 of its warp's 16 queries at columns 8 j + 2 t + {0, 1}, the
//     same (query, column mod 128) slots in every sub-tile, so its 64
//     packed lane maxima stay in registers across a tile (as fm_fold's);
//     the low 13 bits of a packed key hold the sub-tile's index in its
//     tile, not the column: the column is 128 x index + the slot's lane
//     and a higher index is a higher column, so the order is fm_fold's
//     with one uniform register in place of a column a score;
//   - the conversion is exact and off the conversion pipe where the dot
//     fits: |dot| <= d x 128 x 128 <= 2^22 for d <= 256, and then
//     float32(dot) is (the bits of 1.5 x 2^23 + dot) - 1.5 x 2^23, an
//     integer add and an fp32 subtraction, both exact. d > 256 keeps
//     __int2float_rn (and a separate instance, WIDE, takes d > 64);
//   - a skip test in place of most folds: after each flush a thread
//     derives from its two queries' k-th keys the least int32 dot that
//     could still enter their lists (fw_threshold); a half's rows g (or
//     g + 8) whose dots lie below it in every lane of the warp are not
//     folded. Exact: a skipped score's key is below the list's k-th,
//     which only rises, so the flush would drop its lane's winner either
//     way. About a quarter of the halves pass at 1024 x 8.8M (4096-row
//     tiles, 40 candidates); the scalar work of the loop is counters, no
//     divisions;
//   - at each tile's end a warp flushes its own 16 queries' lane winners
//     through a private 8-row buffer into their lists (fm_offer), with no
//     barrier beyond the warp. Where a block holds one tile (a corpus of a
//     few thousand rows, as the main path's) this flush is most of the
//     kernel's time, twice the 8 queries a warp of the old instance
//     flushed (PERF.md section 6), and slower than it there.

#include <cuda.h>
#include <dlfcn.h>
#include <string.h>

#define FW_THREADS 256        // a producer warpgroup, then a consumer warpgroup
#define FW_TQ 64              // queries a block: wgmma's M
#define FW_NST_MAX 8          // ring stages at most
#define FW_BAR_BYTES 1024     // the mbarriers' region at the start
#define FW_T_BYTES (4 * 8 * FM_TSTRIDE * 4)  // the 4 warps' flush buffers
#define FW_C_BYTES (4 * 128 * 8)             // the 4 warps' candidate buffers
#define FW_MAGIC 0x4B400000   // the bits of 1.5 x 2^23
#define FW_MAGIC_F 12582912.0f

typedef unsigned long long u64;

// Dims a stage holds: 64 when d <= 64 (a 64-byte row), else 128.
__host__ __device__ constexpr int fw_ch(int d) { return d <= 64 ? 64 : 128; }

// Bytes of a ring stage: 128 corpus rows of 64 dims when d <= 64, else of
// a 128-dim chunk followed by the 64 queries' rows of the same chunk.
__host__ __device__ constexpr int fw_stage_bytes(int d) {
    return d <= 64 ? TN * 64 : (TN + FW_TQ) * 128;
}

// Bytes of the resident query tile: 64 rows of 64 dims when d <= 64; the
// WIDE instance's queries come with the stages.
__host__ __device__ constexpr int fw_qtile_bytes(int d) {
    return d <= 64 ? FW_TQ * 64 : 0;
}

// Shared memory of everything but the ring: the barriers, the query tile,
// the flush and candidate buffers and the 64 queries' lists of k keys.
__host__ __device__ inline size_t fw_fixed_bytes(int d, int k) {
    return FW_BAR_BYTES + fw_qtile_bytes(d) + FW_T_BYTES + FW_C_BYTES +
           (size_t)FW_TQ * k * 8;
}

__device__ __forceinline__ void fw_bar_init(unsigned bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// The spin stays inside the asm, so that the compiler sees no divergent
// loop around the wgmma that follow.
__device__ __forceinline__ void fw_bar_wait(unsigned bar, unsigned parity) {
    asm volatile(
        "{\n.reg .pred p;\nFW_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra FW_WAIT;\n}\n"
        :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void fw_bar_arrive(unsigned bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void fw_bar_expect(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// One TMA box (a stage's or the query tile's rows) from column x, row y.
__device__ __forceinline__ void fw_tma(unsigned dst, const CUtensorMap* map,
                                       int x, int y, unsigned bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<u64>(map)), "r"(x), "r"(y),
           "r"(bar)
        : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma and TMA.
__device__ __forceinline__ void fw_fence_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` of row r in rows of ch bytes, as
// TMA's 64-byte (ch = 64) or 128-byte (ch = 128) swizzle lays them out
// and wgmma reads them: the chunk index XORed with bits 7-8 (or 7-9) of
// the offset, on regions aligned to 512 (1024) bytes.
__device__ __forceinline__ int fw_swz(int r, int chunk, int ch) {
    return ch == 64 ? r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4)
                    : r * 128 + ((chunk ^ (r & 7)) << 4);
}

// A K-major wgmma operand in that swizzle: rows of ch bytes, 8-row core
// groups 8 ch bytes apart; addr may step 32 bytes along K inside a row.
__device__ __forceinline__ u64 fw_desc(unsigned addr, int ch) {
    const u64 layout = ch == 64 ? 2 : 1;  // 64- or 128-byte swizzle
    return (u64)((addr & 0x3FFFF) >> 4) | ((u64)1 << 16) |
           ((u64)((8 * ch) >> 4) << 32) | (layout << 62);
}

// The accumulators' registers are written by wgmma in the background: the
// compiler must not move their reads across the waits, nor their writes
// across the issues.
__device__ __forceinline__ void fw_fence_acc(int (&a)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

#define FW_ACC8(b)                                                            \
    "+r"(a[b]), "+r"(a[b + 1]), "+r"(a[b + 2]), "+r"(a[b + 3]),               \
        "+r"(a[b + 4]), "+r"(a[b + 5]), "+r"(a[b + 6]), "+r"(a[b + 7])

// a (+)= A . B^T for one k32 step: A 64 queries x 32 dims, B 64 corpus
// rows x 32 dims (half a sub-tile), both int8 in shared memory; a: the
// thread's 32 int32 sums. accumulate = 0 starts the sums.
__device__ __forceinline__ void fw_wgmma(int (&a)[32], u64 da, u64 db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : FW_ACC8(0), FW_ACC8(8), FW_ACC8(16), FW_ACC8(24)
        : "l"(da), "l"(db), "r"(accumulate));
}

#undef FW_ACC8

template <int N>
__device__ __forceinline__ void fw_wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The block's shared memory, carved as fw_fixed_bytes counts it.
struct FwSmem {
    unsigned full, empty;  // shared addresses of the mbarrier arrays
    unsigned ring, qs;     // shared addresses of the ring and query tile
                           // (d <= 64)
    int* T;                // [4 warps][8][FM_TSTRIDE]
    i64* C;                // [4 warps][128]
    i64* L;                // [64][k]
};

__device__ __forceinline__ FwSmem fw_carve(unsigned char* smem, int nst,
                                           int d) {
    FwSmem s;
    s.full = fm_smem(smem);
    s.empty = s.full + 8 * FW_NST_MAX;
    s.ring = s.full + FW_BAR_BYTES;
    s.qs = s.ring + nst * fw_stage_bytes(d);
    unsigned char* t = smem + FW_BAR_BYTES +
                       (size_t)nst * fw_stage_bytes(d) + fw_qtile_bytes(d);
    s.T = reinterpret_cast<int*>(t);
    s.C = reinterpret_cast<i64*>(t + FW_T_BYTES);
    s.L = s.C + 4 * 128;
    return s;
}

// Issue the products of half `half` (rows 64 half .. 64 half + 63) of
// one 128-row sub-tile with the stage at `slot` (one dim chunk: WIDE, 128
// dims and the queries' same chunk; else 64 dims against the query tile)
// into a, every k32 step of it (steps past d meet zero codes), then one
// commit. acc = 0 starts the sums. The steps are unrolled at compile time:
// a runtime loop around the wgmma would make ptxas serialize every wgmma
// of the kernel (C7514), so only the WIDE instance's loop over dim chunks
// has one.
template <bool WIDE>
__device__ __forceinline__ void fw_issue(int (&a)[32], const FwSmem& sm,
                                         int slot, unsigned phase, int half,
                                         bool acc) {
    constexpr int CH = WIDE ? 128 : 64;
    fw_fence_acc(a);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    fw_bar_wait(sm.full + 8 * slot, phase);
    const unsigned st = sm.ring + slot * (WIDE ? (TN + FW_TQ) * CH : TN * CH);
    const unsigned qa = WIDE ? st + TN * CH : sm.qs;
    const unsigned sb = st + half * 64 * CH;
#pragma unroll
    for (int s = 0; s < CH / 32; ++s)
        fw_wgmma(a, fw_desc(qa + 32 * s, CH), fw_desc(sb + 32 * s, CH),
                 acc || s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Hand a stage whose products are done back to the producer (a warp each).
__device__ __forceinline__ void fw_release(const FwSmem& sm, int slot,
                                           int lane) {
    if (lane == 0) fw_bar_arrive(sm.empty + 8 * slot);
}

// Step a ring position (slot, and the phase of its barriers' round) by one
// stage: counters in place of divisions in the loops.
__device__ __forceinline__ void fw_step(int& slot, unsigned& phase,
                                        int nst) {
    if (++slot == nst) {
        slot = 0;
        phase ^= 1u;
    }
}

// Fold half HALF of one sub-tile's int32 dots into the lane maxima: the
// score float32(dot) * factor (MAGIC: the exact conversion by an integer
// add and an fp32 subtraction), its order-preserving int with the
// sub-tile's index J in the low 13 bits, a max a slot. Columns from vcol on
// are rows >= n (EDGE only); mb holds the row mask's bits of the thread's
// 32 columns (MASK only): column 8 j + 2 t + h at bit 8 (j & 3) + 2 (j >>
// 2) + h.
// rows0 / rows1: fold the thread's row g / g + 8 (warp-uniform).
template <bool MAGIC, bool EDGE, bool MASK, int HALF>
__device__ __forceinline__ void fw_fold(int (&folded)[64], const int (&a)[32],
                                        float factor, int J, int vcol,
                                        unsigned mb, bool rows0, bool rows1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (e < 2 ? !rows0 : !rows1) continue;
#pragma unroll
        for (int jh = 0; jh < 8; ++jh) {
            const int j = 8 * HALF + jh, h = e & 1, i = 4 * jh + e;
            const float f =
                MAGIC ? __fsub_rn(__int_as_float(a[i] + FW_MAGIC), FW_MAGIC_F)
                      : __int2float_rn(a[i]);
            const int b = __float_as_int(__fmul_rn(f, factor));
            int p = (b & ~IDX_MASK) ^
                    (((b >> 31) & (0x7FFFFFFF & ~IDX_MASK)) ^ J);
            if (EDGE && 8 * j + h >= vcol) p = MIN_I32;
            if (MASK && !((mb >> (8 * (j & 3) + 2 * (j >> 2) + h)) & 1u))
                p = MIN_I32;
            folded[4 * j + e] = max(folded[4 * j + e], p);
        }
    }
}

// key64 of a lane winner: the quantized key over the row's place, low =
// R - tile_base + column (fm_key's), column = 128 x sub-tile index + lane.
__device__ __forceinline__ i64 fw_key(int p, unsigned low_base, int lane_col) {
    if (p == MIN_I32) return EMPTY64;
    const unsigned low =
        low_base + ((unsigned)(p & IDX_MASK) << 7) + (unsigned)lane_col;
    return (i64)(((u64)(unsigned)(p & ~IDX_MASK) << 32) | low);
}

// The least int32 dot whose score can still enter the list Lq (k keys):
// every dot below it scores under the smallest float v with the list's
// k-th key, so its key is below the k-th's and the list would drop it
// (the k-th only rises). With factor > 0 and |dot| <= 2^22, dot <= v /
// factor - 3 gives dot x factor <= v - 3 factor, below v by more than the
// half ulp the rounding can add. INT_MIN while the list is not full.
__device__ __forceinline__ int fw_threshold(const i64* Lq, int k,
                                            float factor) {
    const i64 kth = Lq[k - 1];
    if (kth == EMPTY64) return INT_MIN;
    const int key = (int)(kth >> 32);
    const float v = __int_as_float(key >= 0 ? key : key ^ 0x7FFFFFFF);
    const double t = floor((double)v / (double)factor) - 3.0;
    return t <= (double)INT_MIN ? INT_MIN
           : t >= (double)INT_MAX ? INT_MAX : (int)t;
}

// The fold of half HALF of the sub-tile at row t0 (in the tile from row
// tile_base) and, after the second half at the end of a tile or of the
// slab, the flush of the warp's 16 queries into their lists. thr0 / thr1:
// the least dot that can enter the list of the thread's row g / g + 8
// (fw_threshold, as of the last flush; INT_MAX for a row past nq, INT_MIN
// where skip is off). Rows of a half whose dots are all below their
// threshold, in every lane of the warp, are not folded: none of their
// scores could reach a list at this tile's flush, and a lane winner they
// would have set is dropped there all the same.
template <int E, bool MASK, int HALF>
__device__ __forceinline__ void fw_epilogue(
    int (&folded)[64], const int (&a)[32], const FwSmem& sm, int t0,
    int tile_base, int row1, int n, int nq, int q0, int k, int block_n,
    unsigned R, float factor, bool magic, bool skip, int& thr0, int& thr1,
    const unsigned* mask, int cw, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
    const int lb = t0 - tile_base;
    const int J = lb >> 7, vcol = n - t0 - 2 * t4;
    const bool edge = t0 + TN > n;
    unsigned mb = 0;
    if constexpr (MASK) {  // the sub-tile's 128 rows: four whole words
        const int w = t0 >> 5, n_words = (n + 31) >> 5;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const unsigned word = w + u < n_words ? __ldg(mask + w + u) : 0u;
            mb |= ((word >> (2 * t4)) & 0x03030303u) << (2 * u);
        }
    }
    bool pass0 = true, pass1 = true;  // rows g and g + 8 of the warp
    if (skip) {  // the rows' largest dots against their thresholds (MASK:
                 // of the allowed columns)
        int r0[8], r1[8];  // a tree, not a chain, of maxima
#pragma unroll
        for (int jh = 0; jh < 8; ++jh) {
            int x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 8 * HALF + jh, h = e & 1;
                const bool ok =
                    !MASK || ((mb >> (8 * (j & 3) + 2 * (j >> 2) + h)) & 1u);
                x[e] = ok ? a[4 * jh + e] : INT_MIN;
            }
            r0[jh] = max(x[0], x[1]);
            r1[jh] = max(x[2], x[3]);
        }
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
            for (int i = 0; i < w; ++i) {
                r0[i] = max(r0[i], r0[i + w]);
                r1[i] = max(r1[i], r1[i + w]);
            }
        pass0 = __any_sync(FM_FULL, r0[0] >= thr0);
        pass1 = __any_sync(FM_FULL, r1[0] >= thr1);
    }
#define FW_FOLD(M, ED)                                                        \
    fw_fold<M, ED, MASK, HALF>(folded, a, factor, J, vcol, mb, pass0, pass1)
    if (!pass0 && !pass1) {
    } else if (magic) {
        if (edge) FW_FOLD(true, true);
        else FW_FOLD(true, false);
    } else {
        if (edge) FW_FOLD(false, true);
        else FW_FOLD(false, false);
    }
#undef FW_FOLD
    if (HALF == 0 || (lb + TN != block_n && t0 + TN < row1))
        return;  // the tile goes on

    // flush: rows g (half 0) and g + 8 (half 1) of the warp's 16 queries
    // through its own buffer, 8 queries at a time, 4 winners a lane
    int* T = sm.T + cw * 8 * FM_TSTRIDE;
    i64* cbuf = sm.C + cw * 128;
    const unsigned low_base = R - (unsigned)tile_base;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
            *reinterpret_cast<int2*>(&T[g * FM_TSTRIDE + 8 * j + 2 * t4]) =
                half ? make_int2(folded[4 * j + 2], folded[4 * j + 3])
                     : make_int2(folded[4 * j], folded[4 * j + 1]);
        __syncwarp();
#pragma unroll 1
        for (int r = 0; r < 8; ++r) {
            const int qi = 16 * cw + 8 * half + r;
            if (q0 + qi >= nq) break;  // uniform
            const int4 pv =
                *reinterpret_cast<const int4*>(&T[r * FM_TSTRIDE + 4 * lane]);
            const i64 cand[4] = {fw_key(pv.x, low_base, 4 * lane),
                                 fw_key(pv.y, low_base, 4 * lane + 1),
                                 fw_key(pv.z, low_base, 4 * lane + 2),
                                 fw_key(pv.w, low_base, 4 * lane + 3)};
            fm_offer<E>(sm.L + (size_t)qi * k, k, cand, lane, cbuf);
        }
        __syncwarp();  // before the next half overwrites T
    }
    if (skip) {
        const int qa = 16 * cw + g, qb = qa + 8;
        thr0 = q0 + qa < nq ? fw_threshold(sm.L + (size_t)qa * k, k, factor)
                            : INT_MAX;
        thr1 = q0 + qb < nq ? fw_threshold(sm.L + (size_t)qb * k, k, factor)
                            : INT_MAX;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) folded[i] = MIN_I32;
}

// grid: (ceil(nq / 64), slabs of slab_rows rows, a multiple of block_n);
// 256 threads: warps 0-3 the producer warpgroup, 4-7 the consumers (warp
// 4 + w: queries 16 w .. 16 w + 15 of the tile). q: int8 query codes [nq,
// d] (qmap: their TMA map when qvec); c: int8 codes [n, d] (map: their TMA
// map when vec; WIDE: vec covers both and qvec is vec); fac: the one fp32
// score factor; nst >= 2 ring stages. final_out (one slab):
// write out_s / out_i; else part[slab, q, :] keys. MASK: mask is the
// allowed rows' bits [ceil(n/32)].
template <int E, bool MASK, bool WIDE>
__global__ void __launch_bounds__(FW_THREADS, 2)
fold_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap qmap,
                     const signed char* __restrict__ q,
                     const signed char* __restrict__ c,
                     const float* __restrict__ fac,
                     const unsigned* __restrict__ mask, int nq, int n, int d,
                     int k, int block_n, int slab_rows, int nst, int vec,
                     int qvec, int final_out, i64* __restrict__ part,
                     float* __restrict__ out_s, int* __restrict__ out_i) {
    extern __shared__ __align__(1024) unsigned char fw_smem_raw[];
    unsigned char* smem = fw_smem_raw;
    const int ch = fw_ch(d), n_dch = (d + ch - 1) / ch;
    const FwSmem sm = fw_carve(smem, nst, d);
    // the warp's index as one value for the whole warp (a shuffle), so that
    // the compiler sees the roles' branches as uniform
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
    const int q0 = blockIdx.x * FW_TQ;
    const int row0 = blockIdx.y * slab_rows;
    const int row1 = min(row0 + slab_rows, n);
    const int n_sub = (row1 - row0 + TN - 1) / TN;

    const unsigned qbar = sm.empty + 8 * FW_NST_MAX;  // the query tile's
    if (tid == 0) {
        for (int s = 0; s < nst; ++s) {
            fw_bar_init(sm.full + 8 * s, vec ? 1 : 32);
            fw_bar_init(sm.empty + 8 * s, 4);
        }
        fw_bar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (tid >= 128) {
        // the query tile (d <= 64): 64 rows of 64 bytes, swizzled as the
        // stages are (zero past d and past nq), by TMA (qvec, from the
        // producer below), else here; the lists emptied
        if (!WIDE && !qvec) {
            unsigned char* Q = smem + (sm.qs - sm.full);
            for (int v = tid - 128; v < FW_TQ * 4; v += 128) {
                const int r = v >> 2, cc = v & 3;
                *reinterpret_cast<uint4*>(Q + fw_swz(r, cc, 64)) =
                    q0 + r < nq
                        ? fm_row16((const unsigned char*)q +
                                       (size_t)(q0 + r) * d,
                                   d, 16 * cc)
                        : make_uint4(0u, 0u, 0u, 0u);
            }
            fw_fence_async();
        }
        for (int e = tid - 128; e < FW_TQ * k; e += 128) sm.L[e] = EMPTY64;
    }
    __syncthreads();

    if (warp < 4) {
        // the producer warpgroup: warp 0 fills the ring, the rest leave
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (warp != 0 || (vec && lane != 0)) return;
        if (!WIDE && qvec && lane == 0) {  // the query tile, one box
            fw_bar_expect(qbar, FW_TQ * 64);
            fw_tma(sm.qs, &qmap, 0, q0, qbar);
        }
        const int n_st = n_sub * n_dch;
        int slot = 0, sub = 0, dci = 0;
        unsigned phase = 0;  // the round of the slot's barriers
        for (int st = 0; st < n_st; ++st) {
            fw_bar_wait(sm.empty + 8 * slot, phase ^ 1u);
            const int t0 = row0 + sub * TN, d0 = dci * ch;
            const unsigned S = sm.ring + slot * fw_stage_bytes(d);
            const unsigned full = sm.full + 8 * slot;
            if (vec) {  // a box of 128 rows x ch bytes (WIDE: and one of the
                        // 64 queries), zero past n, nq and d
                fw_bar_expect(full, fw_stage_bytes(d));
                fw_tma(S, &map, d0, t0, full);
                if (WIDE) fw_tma(S + TN * ch, &qmap, d0, q0, full);
            } else {
                unsigned char* P = smem + (S - sm.full);
                const int cols = ch >> 4;
#pragma unroll 1
                for (int v = lane; v < cols * TN; v += 32) {
                    const int r = v / cols, cc = v - r * cols, row = t0 + r;
                    *reinterpret_cast<uint4*>(P + fw_swz(r, cc, ch)) =
                        row < n ? fm_row16((const unsigned char*)c +
                                               (size_t)row * d,
                                           d, d0 + 16 * cc)
                                : make_uint4(0u, 0u, 0u, 0u);
                }
                if (WIDE) {
#pragma unroll 1
                    for (int v = lane; v < cols * FW_TQ; v += 32) {
                        const int r = v / cols, cc = v - r * cols;
                        *reinterpret_cast<uint4*>(P + TN * ch +
                                                  fw_swz(r, cc, ch)) =
                            q0 + r < nq
                                ? fm_row16((const unsigned char*)q +
                                               (size_t)(q0 + r) * d,
                                           d, d0 + 16 * cc)
                                : make_uint4(0u, 0u, 0u, 0u);
                    }
                }
                fw_fence_async();
                fw_bar_arrive(full);
            }
            fw_step(slot, phase, nst);
            if (++dci == n_dch) {
                dci = 0;
                ++sub;
            }
        }
        return;
    }

    // the consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    const int cw = warp - 4;
    const bool active = q0 + 16 * cw < nq;  // uniform per warp
    const float factor = __ldg(fac);
    const bool magic = d <= 256;  // |dot| <= d x 128 x 128 <= 2^22
    // the skip test needs scores that rise with the dot, and fw_threshold
    // needs |dot| <= 2^22
    const bool skip = magic && factor > 0.f && isfinite(factor);
    const int g = lane >> 2;
    int thr0 = q0 + 16 * cw + g < nq ? INT_MIN : INT_MAX;
    int thr1 = q0 + 16 * cw + g + 8 < nq ? INT_MIN : INT_MAX;
    const int n_tiles = (n + block_n - 1) / block_n;
    const unsigned R = (unsigned)(n_tiles - 1) * (unsigned)block_n;
    if (!WIDE && qvec) fw_bar_wait(qbar, 0);
    // the accumulators start unset (each sub-tile's first wgmma does not
    // read them): zeroing them let the compiler read a zero from one as a
    // constant, a read that makes ptxas serialize every wgmma (C7514)
    int acc_a[32], acc_b[32], folded[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) folded[i] = MIN_I32;
    // the two halves of each sub-tile in two accumulator sets: the first
    // half's fold runs while the tensor cores take the second half's
    // products (and the other resident block's warps issue while these
    // wait). Nothing is in flight across the loop's back edge: ptxas
    // cannot follow a wgmma group from one iteration into the next and
    // would serialize every wgmma of the kernel (C7514)
#define FW_EPI(HALF, A)                                                      \
    if (active)                                                              \
        fw_epilogue<E, MASK, HALF>(folded, A, sm, t0, tile_base, row1, n,    \
                                   nq, q0, k, block_n, R, factor, magic,     \
                                   skip, thr0, thr1, mask, cw, lane)
    // the ring position and the tile, by counters (slabs are whole tiles)
    int slot = 0, tile_base = row0;
    unsigned phase = 0;
    for (int sub = 0, t0 = row0; sub < n_sub; ++sub, t0 += TN) {
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
        FW_EPI(0, acc_a);
        fw_wgmma_wait<0>();
        fw_fence_acc(acc_b);
        fw_release(sm, slot, lane);
        FW_EPI(1, acc_b);
        fw_step(slot, phase, nst);
        if (t0 + TN - tile_base == block_n) tile_base += block_n;
    }
#undef FW_EPI

    if (!active) return;
    for (int r = 0; r < 16; ++r) {  // the warp's 16 queries
        const int qi = 16 * cw + r, qq = q0 + qi;
        if (qq >= nq) break;
        const i64* Lq = sm.L + (size_t)qi * k;
        for (int i = lane; i < k; i += 32) {
            const size_t o = (size_t)qq * k + i;
            if (final_out)
                fm_decode<MASK>(Lq[i], R, block_n, out_s + o, out_i + o);
            else
                part[(size_t)blockIdx.y * nq * k + o] = Lq[i];
        }
    }
}

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link
// against libcuda: the library is built with a plain nvcc line).
typedef CUresult (*FwEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static FwEncode fw_encoder() {
    static FwEncode fn = nullptr;
    if (!fn) {
        void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
        if (h) fn = (FwEncode)dlsym(h, "cuTensorMapEncodeTiled");
    }
    return fn;
}

// A TMA map of an int8 matrix [rows, d] (d a multiple of 16, base 16-byte
// aligned) in boxes of box_rows rows x ch bytes, 64- or 128-byte swizzle.
static int fw_map(CUtensorMap* map, const void* base, int d, int rows,
                  int ch, int box_rows) {
    FwEncode encode = fw_encoder();
    if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)d};
    const cuuint32_t box[2] = {(cuuint32_t)ch, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
               const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               ch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// The ring's depth and the block's shared memory at (d, k): two blocks an
// SM where a ring of at least 2 stages (one folded, the next loading)
// fits beside them, else one; up to FW_NST_MAX stages. Neither the stage
// nor the fixed part grows with d, so every d fits. A cudaError_t.
static int fw_plan(int d, int k, int* nst, size_t* smem) {
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
    const size_t fixed = fw_fixed_bytes(d, k), slot = fw_stage_bytes(d);
    const size_t budgets[2] = {(size_t)(per_sm / 2 - reserved),
                               (size_t)optin};
    for (size_t budget : budgets) {
        if (budget < fixed) continue;
        const size_t fit = (budget - fixed) / slot;
        const int s = fit < FW_NST_MAX ? (int)fit : FW_NST_MAX;
        if (s >= 2) {
            *nst = s;
            *smem = fixed + s * slot;
            return 0;
        }
    }
    return (int)cudaErrorInvalidValue;  // does not fit a block
}

template <int E, bool MASK, bool WIDE>
static int fw_prepare() {
    static unsigned ready = 0;  // bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32 && (ready >> dev) & 1u) return 0;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(fold_i8_wgmma_kernel<E, MASK, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) ready |= 1u << dev;
    return 0;
}

template <int E, bool MASK, bool WIDE>
static int fw_occupancy(size_t smem) {
    int e = fw_prepare<E, MASK, WIDE>();
    if (e) return -e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fold_i8_wgmma_kernel<E, MASK, WIDE>, FW_THREADS, smem);
    return e ? -e : blocks;
}

template <int E, bool MASK, bool WIDE>
static int fw_launch(const void* q, const void* c, const float* fac,
                     const unsigned* mask, int nq, int n, int d, int k,
                     int block_n, int slab_rows, int nst, size_t smem,
                     long long* part, float* out_s, int* out_i,
                     cudaStream_t st) {
    int e = fw_prepare<E, MASK, WIDE>();
    if (e) return e;
    // the corpus's stages (boxes of 128 rows x ch bytes) and the query
    // tile or its chunks (64 rows x ch bytes) by TMA where rows are whole
    // 16-byte chunks on an aligned base, swizzled as wgmma reads them;
    // rows past n or nq and dims past d read as 0. WIDE's stages take both
    // by one route.
    const int ch = fw_ch(d);
    CUtensorMap map, qmap;
    memset(&map, 0, sizeof(map));
    memset(&qmap, 0, sizeof(qmap));
    int vec = (d & 15) == 0 && (reinterpret_cast<size_t>(c) & 15) == 0;
    int qvec = (d & 15) == 0 && (reinterpret_cast<size_t>(q) & 15) == 0;
    if (WIDE) vec = qvec = vec && qvec;
    if (vec) {
        e = fw_map(&map, c, d, n, ch, TN);
        if (e) return e;
    }
    if (qvec) {
        e = fw_map(&qmap, q, d, nq, ch, FW_TQ);
        if (e) return e;
    }
    const int n_slabs = (n + slab_rows - 1) / slab_rows;
    const unsigned R =
        (unsigned)((n + block_n - 1) / block_n - 1) * (unsigned)block_n;
    dim3 grid((nq + FW_TQ - 1) / FW_TQ, n_slabs);
    fold_i8_wgmma_kernel<E, MASK, WIDE><<<grid, FW_THREADS, smem, st>>>(
        map, qmap, (const signed char*)q, (const signed char*)c, fac, mask,
        nq, n, d, k, block_n, slab_rows, nst, vec, qvec, n_slabs == 1, part,
        out_s, out_i);
    e = (int)cudaGetLastError();
    if (e || n_slabs == 1) return e;
    fold_merge_kernel<E, MASK><<<(nq + FM_WARPS - 1) / FM_WARPS, FM_THREADS, 0,
                                 st>>>(
        part, n_slabs, nq, k, block_n, R, out_s, out_i);
    return (int)cudaGetLastError();
}

// F<E, LR_MASK, WIDE>(args) for E = fm_e(k) and WIDE = d > 64; the
// library's flavour sets MASK.
#define FW_DISPATCH_E(F, W, ...)                                              \
    (k <= 32   ? F<1, LR_MASK, W>(__VA_ARGS__)                                \
     : k <= 64 ? F<2, LR_MASK, W>(__VA_ARGS__)                                \
               : F<4, LR_MASK, W>(__VA_ARGS__))
#define FW_DISPATCH(F, ...)                                                   \
    (d > 64 ? FW_DISPATCH_E(F, true, __VA_ARGS__)                             \
            : FW_DISPATCH_E(F, false, __VA_ARGS__))

extern "C" {

// Dynamic shared memory of one fold_i8_wgmma_kernel block at (d, k) (op:
// OP_I8, the only kind it takes); 0 if it fits no block.
size_t lr_fold_i8_smem(int d, int k, int op) {
    int nst = 0;
    size_t smem = 0;
    if (op != OP_I8 || fw_plan(d, k, &nst, &smem)) return 0;
    return smem;
}

// Resident fold_i8_wgmma_kernel blocks per SM at (d, k), of the library's
// flavour (LR_MASK), on the current device (0: does not fit); a negative
// cudaError_t on failure.
int lr_fold_i8_occupancy(int d, int k, int op) {
    int nst = 0;
    size_t smem = 0;
    if (op != OP_I8) return -(int)cudaErrorInvalidValue;
    const int e = fw_plan(d, k, &nst, &smem);
    if (e) return e == (int)cudaErrorInvalidValue ? 0 : -e;
    return FW_DISPATCH(fw_occupancy, smem);
}

// The int8 fold: int8 query codes q [nq, d] against int8 codes c [n, d],
// factor the one fp32 score factor; fold_i8_wgmma_kernel over (query tiles
// of 64 x slabs of slab_rows rows), then, with more than one slab,
// fold_merge_kernel; lists of 32, 64 or 128 entries, the least that holds
// k <= 128. mask (the masked library; null in the other): the allowed
// rows' bits, int32 words [ceil(n/32)]. part: [slabs, nq, k] int64 scratch
// (unused with one slab). Returns a cudaError_t.
int lr_fold_i8(const void* q, const void* c, const float* factor, int nq,
               int n, int d, int k, int block_n, int slab_rows,
               const unsigned* mask, long long* part, float* out_s,
               int* out_i, void* stream) {
    if (k < 1 || k > 128 || d < 1 || n < 1 || nq < 1 || (LR_MASK && !mask))
        return (int)cudaErrorInvalidValue;
    int nst = 0;
    size_t smem = 0;
    const int e = fw_plan(d, k, &nst, &smem);
    if (e) return e;
    cudaStream_t st = (cudaStream_t)stream;
    return FW_DISPATCH(fw_launch, q, c, factor, mask, nq, n, d, k, block_n,
                       slab_rows, nst, smem, part, out_s, out_i, st);
}

}  // extern "C"

#undef FW_DISPATCH
#undef FW_DISPATCH_E
