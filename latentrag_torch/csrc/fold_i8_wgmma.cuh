// The int8 and int4 stores' fold, designed for Hopper:
// fold_i8_wgmma_kernel<E, MASK, WIDE> (+ fold_merge_kernel<E, MASK> past
// one slab); the int4 store's at the end of this note. For int8 it
// replaces the JAX package's sq8_topk (its ops/quantization.py:35-80: a
// dot_general of the SQ8 codes and approx_max_k, XLA there, no Pallas
// kernel), which the port first ran as fold_mma_kernel<E, OP_I8>, an
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
// The design (the ring, the producer and the wgmma issue are
// wgmma_i8.cuh's, which the exact search, exact_i8_wgmma.cuh, shares):
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
//
// The int4 store's fold runs on the same kernel (lr_fold_i4, its runtime
// flag i4). It replaces the JAX package's sq4_topk (its
// ops/quantization.py:147: the nibbles unpacked, a dot_general and
// approx_max_k, XLA there, no Pallas kernel), which the port first ran as
// fold_mma_kernel<E, OP_I4>: 8 warps in lockstep, each 128-row stage behind
// a cp.async barrier and a second one after every warp had sign-extended
// its share of it into a [128][128] s8 stage, half of it empty at d = 64.
// Its bound is the int8 fold's: 2 Q N d int8 operations at 1,979 TOPS
// (0.58 ms at 1024 x 8.8M, d = 64; the nibbles are half the int8 store's
// bytes), then the fold's epilogue. Once a stage is sign-extended the work
// is the int8 fold's, so the consumers are unchanged and only the producer
// differs: its warpgroup's four warps, idle in the int8 store's fold, load
// the packed rows from device memory (16-byte loads, issued before the
// wait for the slot; no ring of packed stages, which would cost the
// second block an SM at the list of 128), sign-extend them in registers
// (fm_s4x8) and write the s8 stages in TMA's swizzle, then fence the
// generic proxy's writes for wgmma before their arrivals on the stage's
// full barrier (wgmma_i8.cuh, fw_produce4). The consumers' arithmetic is
// exact on either store (|dot| <= d x 128 x 8), so both equal their plain
// folds bit for bit.

#include "wgmma_i8.cuh"

#define FW_T_BYTES (4 * 8 * FM_TSTRIDE * 4)  // the 4 warps' flush buffers
#define FW_C_BYTES (4 * 128 * 8)             // the 4 warps' candidate buffers
#define FW_MAGIC 0x4B400000   // the bits of 1.5 x 2^23
#define FW_MAGIC_F 12582912.0f

// Shared memory of everything but the ring: the barriers, the query tile,
// the flush and candidate buffers and the 64 queries' lists of k keys.
__host__ __device__ inline size_t fw_fixed_bytes(int d, int k) {
    return FW_BAR_BYTES + fw_qtile_bytes(d) + FW_T_BYTES + FW_C_BYTES +
           (size_t)FW_TQ * k * 8;
}

// The block's shared memory, carved as fw_fixed_bytes counts it.
struct FwSmem : FwRing {
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
// d] (qmap: their TMA map when qvec and d <= 64); c: int8 codes [n, d]
// (map: their TMA map when vec; WIDE: vec covers both and qvec is vec),
// or with i4 packed nibbles [n, ceil(d / 2)] (vec: 16-byte loads; map
// unused; WIDE: qvec the queries' 16-byte loads); fac: the one fp32 score
// factor; nst >= 2 ring stages. final_out (one slab): write out_s /
// out_i; else part[slab, q, :] keys. MASK: mask is the allowed rows' bits
// [ceil(n/32)].
template <int E, bool MASK, bool WIDE>
__global__ void __launch_bounds__(FW_THREADS, 2)
fold_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap qmap,
                     const signed char* __restrict__ q,
                     const signed char* __restrict__ c,
                     const float* __restrict__ fac,
                     const unsigned* __restrict__ mask, int nq, int n, int d,
                     int k, int block_n, int slab_rows, int nst, int vec,
                     int qvec, int i4, int final_out, i64* __restrict__ part,
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
                     int i4, long long* part, float* out_s, int* out_i,
                     cudaStream_t st) {
    int e = fw_prepare<E, MASK, WIDE>();
    if (e) return e;
    // the corpus's stages (boxes of 128 rows x ch bytes) and the query
    // tile or its chunks (64 rows x ch bytes) by TMA where rows are whole
    // 16-byte chunks on an aligned base, swizzled as wgmma reads them;
    // rows past n or nq and dims past d read as 0. WIDE's stages take both
    // by one route. int4 (i4): the producer warpgroup unpacks the stages
    // from the nibbles, by 16-byte loads where a packed row is whole
    // 16-byte pieces on an aligned base, and loads WIDE's query chunks;
    // the query tile (d <= 64) comes by TMA as the int8 store's does
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
    const unsigned R =
        (unsigned)((n + block_n - 1) / block_n - 1) * (unsigned)block_n;
    dim3 grid((nq + FW_TQ - 1) / FW_TQ, n_slabs);
    fold_i8_wgmma_kernel<E, MASK, WIDE><<<grid, FW_THREADS, smem, st>>>(
        map, qmap, (const signed char*)q, (const signed char*)c, fac, mask,
        nq, n, d, k, block_n, slab_rows, nst, vec, qvec, i4, n_slabs == 1,
        part, out_s, out_i);
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

// The fold of either store (i4: the int4 store's nibbles).
static int fw_fold(const void* q, const void* c, const float* factor, int nq,
                   int n, int d, int k, int block_n, int slab_rows,
                   const unsigned* mask, int i4, long long* part,
                   float* out_s, int* out_i, void* stream) {
    if (k < 1 || k > 128 || d < 1 || n < 1 || nq < 1 || (LR_MASK && !mask))
        return (int)cudaErrorInvalidValue;
    int nst = 0;
    size_t smem = 0;
    const int e = fw_plan(d, k, &nst, &smem);
    if (e) return e;
    cudaStream_t st = (cudaStream_t)stream;
    return FW_DISPATCH(fw_launch, q, c, factor, mask, nq, n, d, k, block_n,
                       slab_rows, nst, smem, i4, part, out_s, out_i, st);
}

extern "C" {

// Dynamic shared memory of one fold_i8_wgmma_kernel block at (d, k) (op:
// OP_I8 or OP_I4, whose blocks are the same); 0 if it fits no block.
size_t lr_fold_i8_smem(int d, int k, int op) {
    int nst = 0;
    size_t smem = 0;
    if ((op != OP_I8 && op != OP_I4) || fw_plan(d, k, &nst, &smem)) return 0;
    return smem;
}

// Resident fold_i8_wgmma_kernel blocks per SM at (d, k), of the library's
// flavour (LR_MASK), on the current device (0: does not fit); a negative
// cudaError_t on failure. op: OP_I8 or OP_I4 (the same blocks).
int lr_fold_i8_occupancy(int d, int k, int op) {
    int nst = 0;
    size_t smem = 0;
    if (op != OP_I8 && op != OP_I4) return -(int)cudaErrorInvalidValue;
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
    return fw_fold(q, c, factor, nq, n, d, k, block_n, slab_rows, mask, 0,
                   part, out_s, out_i, stream);
}

// The int4 fold: lr_fold_i8 with c the int4 store's packed nibbles uint8
// [n, ceil(d / 2)] (low nibble the even dim, two's complement), which
// fold_i8_wgmma_kernel's producer warpgroup sign-extends into its s8
// stages. Returns a cudaError_t.
int lr_fold_i4(const void* q, const void* c, const float* factor, int nq,
               int n, int d, int k, int block_n, int slab_rows,
               const unsigned* mask, long long* part, float* out_s,
               int* out_i, void* stream) {
    return fw_fold(q, c, factor, nq, n, d, k, block_n, slab_rows, mask, 1,
                   part, out_s, out_i, stream);
}

}  // extern "C"

#undef FW_DISPATCH
#undef FW_DISPATCH_E
