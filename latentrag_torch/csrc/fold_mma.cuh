// The fold (kernel 1) on Hopper's tensor cores: replaces _fold_kernel
// (pallas_topk.py:162-179, _fold_body :114-159) for bf16 stores
// (fold_mma_kernel<E, OP_BF16>) and fp32 stores (<E, OP_F32>), and as
// fold_mma_kernel<E, OP_BIN> the binary fold (kernel 3, _binary_fold_kernel,
// pallas_topk.py:354-401). Included by fused_topk.cu, whose header states
// the contract this kernel keeps: 19-bit keys with a 13-bit tile column, the
// fold per aligned block_n tile over 128 lanes, the top-k of the union under
// (quantized key desc, tile asc, column desc), and 3xTF32 products for fp32.
//
//   fold_mma_kernel   one block = 64 queries x one corpus slab; 8 warps, a
//                     pair of warps per 16 queries, each warp 64 of the 128
//                     columns of every 128-row sub-tile
//   fold_merge_kernel one warp per query merges the slabs' sorted lists
//
// Scores. Each warp pair owns one m16 row block of queries; a warp's bf16
// A fragments come from a swizzled copy of the query tile in shared memory
// (once when d <= 64, once per 64-dim chunk otherwise). Corpus stages of 128 rows x 64
// dims (16 KB, plus the rows' norms^2 for euclidean) arrive by 16-byte
// cp.async into a ring of 3 stages, swizzled (16-byte chunk c of row r at
// c ^ (r & 7)) so that ldmatrix reads them without bank conflicts, and
// feed mma.sync.m16n8k16 bf16 -> fp32: products of bf16 values are exact,
// only the order of the fp32 sums differs from the TPU's matrix unit. Dims
// past d are zero in the stage and in the query tile and add nothing. A d
// that is not a multiple of 8, or a corpus not 16-byte aligned, loads its
// stages element by element instead of by cp.async.
//
// The fold in registers. In the C fragment layout a thread holds the same
// (query, column mod 128) slots in every 128-row sub-tile: rows g and g+8,
// columns 64h + 8j + 2t + {0,1} for j < 8 (h: the warp's half). So the
// packed max (mono & ~IDX_MASK) | tile column of each of its 32 slots
// stays in registers across the block_n / 128 sub-tiles of a tile; with
// 32 accumulators beside them a thread fits the registers of 2 blocks of
// 8 warps an SM (the integer epilogue needs the warps). The metric and
// the corpus's ragged last sub-tile pick one of four unrolled copies of
// this epilogue, so the common one has no branch and no row check.
//
// Candidate lists. At each tile flush a warp pair passes its 16 x 128 lane
// winners through shared memory (one query's 128 winners, 4 a lane), and
// each warp of the pair keeps the lists of 8 of its 16 queries; each
// query keeps its best k, sorted, in shared memory, and works on them in
// registers as a list of KP = 32, 64 or 128 entries (the least >= k; the
// kernel is instantiated for each). The order is one signed 64-bit
// compare: key64 = quantized key << 32 | (R - tile_base + column),
// R = (n_tiles - 1) * block_n, so a larger low word is an earlier tile,
// then a higher column. Winners that do not beat the list's k-th are
// dropped with one compare; up to KP / 8 passers are inserted one by one
// (a warp count and one shuffle shift); more are packed densely and merged
// in chunks of KP: a bitonic sort of the chunk, one compare per entry
// against the list, one bitonic merge, O(log^2 KP) shuffle steps however
// many rows pass -- the TPU's batched list upkeep (_fold_body: top-k of
// the tile, then a merge with the running k).
//
// Plan (the wrapper's): grid = (ceil(Q / 64), slabs); the corpus splits
// into slabs of whole block_n tiles, as many as fill the card's resident
// block slots (occupancy x SMs) for the query tiles at hand, at least one.
// With one slab the partial kernel writes the fp32 scores (the quantized
// keys mapped back) and int32 ids itself; otherwise each slab writes its
// sorted key64 list and fold_merge_kernel merges the slabs pairwise with
// bitonic merges and writes scores and ids. No torch work follows.
//
// Bound. At d = 64 a 128-row sub-tile is 4 k-steps of mma for each warp,
// then about 4 integer ops per score on the CUDA cores to fold it. At
// 1024 x 1M that is 1.0e9 scores x 4 / (132 SMs x 64 INT32 lanes x
// ~1.75 GHz) ~ 0.28 ms, while the products at even half the bf16 peak
// take 0.27 ms: the epilogue, not the matrix units' issue rate, sets the
// pace, so mma.sync (not wgmma/TMA) and a lean fold are the design. At the
// main path's 128-row tiles every sub-tile flushes, and the list upkeep --
// bitonic networks, chains of dependent shuffles -- bounds it by latency,
// which the pairs halve by sharing each flush.
//
// The binary fold. Sign bits and bf16 queries are exact bf16 inputs to the
// same mma.sync (+-1 times a bf16 value is exact), so it keeps the bf16
// fold's contract: only the order of the fp32 sums differs from the plain
// version. Its stages move 1/16 of the bytes: the packed words of 128 rows
// x 64 dims (1 KB, two words a row) arrive by 4-byte cp.async into the
// ring, reading the row-major store [N, ceil(d/32)] as it is, and after the
// stage's barrier every thread unpacks its share once for the whole block
// into the swizzled [128][64] bf16 stage that the ldmatrix path reads: a
// set bit becomes 0x3F80 (+1), a clear one 0xBF80 (-1); a second barrier
// then releases the products. Pad bits past d and words past the row's
// last unpack to -1 and meet zero query dims, so they add nothing. With
// d <= 64 the A fragments are loaded once before the loop and the unpacked
// stage takes the query tile's room, so the list-of-128 instance -- the
// binary store always asks the fold for 128 candidates -- fits two blocks
// an SM. It is bound as the bf16 fold is: by the fold and the list upkeep,
// not by its bytes (8 B a row at d = 64), so the tensor cores and the lean
// fold are the design here too.
//
// The fp32 fold. A stage of 128 rows x 32 fp32 dims is the same 128-byte
// rows and 16 KB as a bf16 stage, so the ring, its swizzle and the
// ldmatrix addressing carry over: ldmatrix.x4 .b16 on 16-byte rows of four
// fp32 values hands lane (g, t) the value at row g, column t, which is the
// tf32 A layout of mma.sync.m16n8k8 (a0 at (g, t), a2 at (g, t + 4)) and
// its .col B layout (b0 = corpus[row g][dim t], b1 = dim t + 4), so the
// bf16 k16 step's two 16-byte chunks are one k8 step here and the C layout,
// and with it the fold, is the bf16 one. Each fragment splits in registers
// into tf32 hi and lo parts (fm_split4, see fused_topk.cu) and a k8 step is
// three mma (lo.hi, hi.lo, hi.hi) from zero, added to the running fp32 sum
// with a rounded add (fm_mma3 says why); zero rows and dims split into
// zeros. The query tile stays fp32 in shared memory, so the |q|^2 prologue
// reads the stored values. d = 64 takes two stages a sub-tile; the
// list-of-128 instance keeps a ring of 2 stages so that d = 384 still fits
// a block.
// Bound: 16 dims take six m16n8k8 tf32 mma (two k8 steps of three) where
// bf16 takes one m16n8k16 of the same tensor-core time: 3 x 2 Q N d
// operations at the 495 TFLOP/s TF32 rate (165 TFLOP/s of fp32-accurate
// products), plus the splits on the CUDA cores.
//
// The int8 and int4 folds (<E, OP_I8>, <E, OP_I4>: the int8 and int4
// stores). An int8 row of 128 dims is 128 bytes, the row of a bf16 stage, so
// a stage holds 128 dims and its 16-byte chunks, swizzle and ldmatrix
// addressing are the bf16 ones: ldmatrix .b16 hands lane (g, t) the 4
// bytes at row g, bytes 4t .. 4t + 3, which is the s8 A layout of
// mma.sync.m16n8k32 (a0 at row g, k 4t .. 4t + 3; a2 at k 16 + 4t) and its
// .col B layout, so a bf16 k16 step's two chunks are one k32 step here. The
// products sum exactly in int32 (s8 x s8 -> s32), and the fold reads
// float32(sum) * factor, rounded as the JAX package rounds it, where the
// float kinds read the fp32 sum; k steps past d are skipped (d = 64 takes
// two of a stage's four). int4 stages arrive as packed nibbles (128 rows x
// 64 bytes, 8 KB, by 16-byte cp.async when a row is whole 16-byte chunks,
// else byte by byte) and, after the stage's barrier, every thread sign-
// extends its share once for the block into a swizzled [128][128] s8 stage
// beside the query tile (fm_unpack4: nibbles to bytes by __byte_perm, the
// sign by one multiply), which the ldmatrix path reads; a second barrier
// releases the products. Pad nibbles (odd d) are code 0 and dims past the
// row's last byte load as 0, and both meet zero query codes. Bound: 2 Q N d
// operations at the int8 tensor-core rate (1,979 TOPS dense), twice the
// bf16 rate, so the epilogue (the fold and the lists), not the products,
// sets the pace as in the bf16 fold, and more so.
//
// The row mask (fold_mma_kernel<E, OP, true>: a filtered search). mask is
// the packed bits of the allowed rows, int32 words [ceil(n/32)], bit r & 31
// of word r >> 5 for row r. A warp's 64 columns of a sub-tile are two whole
// words, so a thread loads them once a sub-tile (two 4-byte reads, in the
// L1 for all 8 warps) and keeps its 16 columns' bits in one register, and
// a masked-out column packs to MIN_I32 in the fold, as a column past the
// corpus's end does: it never wins a lane, and
// a lane with no allowed row offers nothing to the lists. Lists that end
// with fewer than k allowed rows keep EMPTY64 entries, which come out as
// (LR_NEG_INF, -1) (fold_merge_kernel<E, true> too). The mask adds n / 8
// bytes to the corpus's and nothing to the products; the unmasked instance
// (MASK = false) has neither the load, the test nor the empty-slot branch.

#define FM_WARPS 8
#define FM_THREADS (FM_WARPS * 32)
#define FM_PAIRS (FM_WARPS / 2)                    // a pair shares 16 queries
#define FM_TQ (FM_PAIRS * 16)                      // queries per block
#define FM_NST 3                                   // stages in the ring
#define FM_STAGE_BYTES (TN * DCH * 2)              // 128 rows x 64 bf16
#define FM_SLOT_BYTES (FM_STAGE_BYTES + TN * 4)    // + the rows' norms^2
#define FM_WSLOT_BYTES (TN * 2 * 4)                // binary: 128 rows x 2 words
#define FM_NSLOT_BYTES (TN * 64)                   // int4: 128 rows x 64 bytes
#define FM_TSTRIDE 136                             // ints a row of the flush buffer
#define FM_FULL 0xffffffffu

typedef long long i64;
#define EMPTY64 LLONG_MIN

static_assert(TN == 128 && DCH == 64, "stages of 128 rows x 64 dims");
static_assert(FM_THREADS == 2 * TN, "one sign word a thread a binary stage");

// Dims a stage (and a query-tile chunk) holds: 128 bytes a row.
__host__ __device__ constexpr int fm_dch(int op) {
    return op == OP_F32 ? DCH / 2 : op == OP_I8 || op == OP_I4 ? 2 * DCH : DCH;
}

// Whether the operand kind scores int8 codes (products summed in int32).
__host__ __device__ constexpr bool fm_int(int op) {
    return op == OP_I8 || op == OP_I4;
}

// Bytes of a ring slot: a stage of bf16, fp32 or int8 rows (with the rows'
// norms^2 after it), of sign words, or of packed nibbles.
__host__ __device__ constexpr int fm_slot_bytes(int op) {
    return op == OP_BIN ? FM_WSLOT_BYTES
           : op == OP_I4 ? FM_NSLOT_BYTES : FM_SLOT_BYTES;
}

// Stages in the ring of fold_mma_kernel<E, OP>: the fp32 list-of-128
// instance keeps 2, so that its fp32 query tile fits a block at d = 384.
__host__ __device__ constexpr int fm_nst(int e, int op) {
    return op == OP_F32 && e == 4 ? 2 : FM_NST;
}

__device__ __forceinline__ unsigned fm_smem(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// Bytes of the query tile's region: the bf16, fp32 or int8 query tile, and
// for the binary fold the unpacked stage too (in the tile's own room when d
// <= 64, since the A fragments are then read once before the loop); for the
// int4 fold the unpacked stage after the tile.
__host__ __device__ __forceinline__ int fm_qu_bytes(int n_dch, int op) {
    const int qs = n_dch * FM_TQ * 128;
    if (op == OP_I4) return qs + FM_STAGE_BYTES;
    if (op != OP_BIN) return qs;
    return n_dch > 1 ? qs + FM_STAGE_BYTES
                     : (qs > FM_STAGE_BYTES ? qs : FM_STAGE_BYTES);
}

// Byte offset of 16-byte chunk c (8 bf16 or 4 fp32 dims) of row r in a tile
// of 128-byte rows.
__device__ __forceinline__ int fm_swz(int r, int c) {
    return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fm_cp16(unsigned dst, const void* src,
                                        int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void fm_cp4(unsigned dst, const void* src,
                                       int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void fm_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int NST>
__device__ __forceinline__ void fm_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NST - 2) : "memory");
}

__device__ __forceinline__ void fm_ldsm4(unsigned (&r)[4], unsigned addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void fm_mma(float (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 values [dim, dim + 8) of one row, zero past d (any alignment).
__device__ __forceinline__ uint4 fm_row8(const unsigned short* p, int d,
                                         int dim) {
    unsigned h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = dim + e < d ? p[dim + e] : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                      h[4] | (h[5] << 16), h[6] | (h[7] << 16));
}

// 4 fp32 values [dim, dim + 4) of one row, zero past d (any alignment).
__device__ __forceinline__ uint4 fm_row4(const float* p, int d, int dim) {
    unsigned h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        h[e] = dim + e < d ? __float_as_uint(p[dim + e]) : 0u;
    return make_uint4(h[0], h[1], h[2], h[3]);
}

// 16 int8 values [dim, dim + 16) of one row, zero past d (any alignment).
__device__ __forceinline__ uint4 fm_row16(const unsigned char* p, int d,
                                          int dim) {
    unsigned h[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        h[w] = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = dim + 4 * w + e;
            h[w] |= (j < d ? (unsigned)p[j] : 0u) << (8 * e);
        }
    }
    return make_uint4(h[0], h[1], h[2], h[3]);
}

// The 16-byte chunk from dim on of row `row` of a [*, d] matrix: 8 bf16
// values, 4 fp32 for OP_F32, or 16 int8 codes for OP_I8 and OP_I4 (whose
// queries are int8 codes); zero past d.
template <int OP>
__device__ __forceinline__ uint4 fm_chunk(const void* m, size_t row, int d,
                                          int dim) {
    if constexpr (OP == OP_F32)
        return fm_row4((const float*)m + row * d, d, dim);
    else if constexpr (fm_int(OP))
        return fm_row16((const unsigned char*)m + row * d, d, dim);
    else
        return fm_row8((const unsigned short*)m + row * d, d, dim);
}

// Stage = rows [t0, t0 + 128) x dims [d0, d0 + fm_dch(OP)) of a bf16, fp32
// or int8 corpus into a ring slot, and for euclidean the rows' norms^2 after
// it. Rows >= n and dims >= d are 0.
template <int OP>
__device__ __forceinline__ void fm_load_stage(
    unsigned char* slot, const void* c, const float* csq, int n, int d,
    int t0, int d0, int vec, int euclid, int tid) {
    constexpr int ES = OP == OP_F32 ? 4 : OP == OP_I8 ? 1 : 2;  // bytes a value
    const unsigned base = fm_smem(slot);
#pragma unroll
    for (int u = 0; u < (TN * 8) / FM_THREADS; ++u) {
        const int v = tid + FM_THREADS * u, r = v >> 3, ch = v & 7;
        const int row = t0 + r, dim = d0 + (16 / ES) * ch;
        const bool in = row < n && dim < d;
        if (vec) {
            fm_cp16(base + fm_swz(r, ch),
                    in ? (const void*)((const unsigned char*)c +
                                       ((size_t)row * d + dim) * ES)
                       : c,
                    in ? 16 : 0);
        } else {
            *reinterpret_cast<uint4*>(slot + fm_swz(r, ch)) =
                in ? fm_chunk<OP>(c, row, d, dim) : make_uint4(0u, 0u, 0u, 0u);
        }
    }
    if (euclid && tid < TN) {
        const int row = t0 + tid;
        fm_cp4(base + FM_STAGE_BYTES + 4 * tid, row < n ? csq + row : csq,
               row < n ? 4 : 0);
    }
}

// Binary stage = the sign words of rows [t0, t0 + 128) x dims [d0, d0 + 64)
// into a ring slot (word j of row r at 2 r + j), one 4-byte cp.async a
// thread; rows >= n and words past the row's last (of `words`) are 0.
__device__ __forceinline__ void fm_load_words(unsigned char* slot,
                                              const unsigned* c, int n,
                                              int words, int t0, int d0,
                                              int tid) {
    const int row = t0 + (tid >> 1), w = (d0 >> 5) + (tid & 1);
    const bool in = row < n && w < words;
    fm_cp4(fm_smem(slot) + 4 * tid,
           in ? (const void*)(c + (size_t)row * words + w) : (const void*)c,
           in ? 4 : 0);
}

// int4 stage = the packed nibbles of rows [t0, t0 + 128) x dims [d0, d0 +
// 128) into a ring slot (row r's 64 bytes at 64 r), two 16-byte chunks a
// thread: by cp.async when `vec` (a row of `w` bytes is whole chunks and the
// base is aligned), else byte by byte; rows >= n and bytes past the row's
// last are 0.
__device__ __forceinline__ void fm_load_nibbles(unsigned char* slot,
                                                const unsigned char* c, int n,
                                                int w, int t0, int d0,
                                                int vec, int tid) {
#pragma unroll
    for (int u = 0; u < (TN * 4) / FM_THREADS; ++u) {
        const int v = tid + FM_THREADS * u, r = v >> 2, ch = v & 3;
        const int row = t0 + r, b = (d0 >> 1) + 16 * ch;
        const bool in = row < n && b < w;
        if (vec) {
            fm_cp16(fm_smem(slot + 64 * r + 16 * ch),
                    in ? (const void*)(c + (size_t)row * w + b)
                       : (const void*)c,
                    in ? 16 : 0);
        } else {
            *reinterpret_cast<uint4*>(slot + 64 * r + 16 * ch) =
                in ? fm_row16(c + (size_t)row * w, w, b)
                   : make_uint4(0u, 0u, 0u, 0u);
        }
    }
}

// Four packed bytes (8 nibbles, low nibble first) as 8 sign-extended int8
// codes in two words: nibbles to bytes by __byte_perm, then each byte's
// bit 3 copied into its high 4 bits (a multiply that cannot carry).
__device__ __forceinline__ uint2 fm_s4x8(unsigned x) {
    const unsigned lo = x & 0x0F0F0F0Fu, hi = (x >> 4) & 0x0F0F0F0Fu;
    unsigned a = __byte_perm(lo, hi, 0x5140), b = __byte_perm(lo, hi, 0x7362);
    a |= (a & 0x08080808u) * 0x1Eu;
    b |= (b & 0x08080808u) * 0x1Eu;
    return make_uint2(a, b);
}

// Unpack an int4 ring slot into the swizzled [128][128] s8 stage U: a
// 16-byte chunk (16 dims) is 8 packed bytes, 4 chunks a thread.
__device__ __forceinline__ void fm_unpack4(unsigned char* U,
                                           const unsigned char* slot, int tid) {
#pragma unroll
    for (int u = 0; u < (TN * 8) / FM_THREADS; ++u) {
        const int v = tid + FM_THREADS * u, r = v >> 3, ch = v & 7;
        const uint2 p =
            *reinterpret_cast<const uint2*>(slot + 64 * r + 8 * ch);
        const uint2 a = fm_s4x8(p.x), b = fm_s4x8(p.y);
        *reinterpret_cast<uint4*>(U + fm_swz(r, ch)) =
            make_uint4(a.x, a.y, b.x, b.y);
    }
}

// Sign bits 0 and 1 of t as two bf16 values in one word, bit 0 in the low
// half: a set bit is 0x3F80 (+1.0), a clear one 0xBF80 (-1.0).
__device__ __forceinline__ unsigned fm_pm1x2(unsigned t) {
    return 0xBF80BF80u ^ ((t & 1u) << 15) ^ ((t & 2u) << 30);
}

// Unpack a binary ring slot into the swizzled [128][64] bf16 stage U: a
// 16-byte chunk (8 dims) is one byte of a word, 4 chunks a thread.
__device__ __forceinline__ void fm_unpack(unsigned char* U,
                                          const unsigned char* slot, int tid) {
    const unsigned* wd = reinterpret_cast<const unsigned*>(slot);
#pragma unroll
    for (int u = 0; u < (TN * 8) / FM_THREADS; ++u) {
        const int v = tid + FM_THREADS * u, r = v >> 3, ch = v & 7;
        const unsigned b = wd[2 * r + (ch >> 2)] >> (8 * (ch & 3));
        *reinterpret_cast<uint4*>(U + fm_swz(r, ch)) =
            make_uint4(fm_pm1x2(b), fm_pm1x2(b >> 2), fm_pm1x2(b >> 4),
                       fm_pm1x2(b >> 6));
    }
}

// One stage of the corpus into a ring slot: bf16, fp32 or int8 rows, the
// binary fold's sign words, or int4 nibbles.
template <int OP>
__device__ __forceinline__ void fm_stage(unsigned char* slot, const void* cp,
                                         const float* csq, int n, int d,
                                         int t0, int d0, int vec, int euclid,
                                         int tid) {
    if constexpr (OP == OP_BIN)
        fm_load_words(slot, (const unsigned*)cp, n, (d + 31) >> 5, t0, d0, tid);
    else if constexpr (OP == OP_I4)
        fm_load_nibbles(slot, (const unsigned char*)cp, n, (d + 1) >> 1, t0,
                        d0, vec, tid);
    else
        fm_load_stage<OP>(slot, cp, csq, n, d, t0, d0, vec, euclid, tid);
}

// Row r's value at dim dd of a swizzled query tile of `rows` rows a chunk
// (bf16 values, or fp32 for OP_F32).
template <int OP>
__device__ __forceinline__ float fm_qval(const unsigned char* Qs, int rows,
                                         int r, int dd) {
    if constexpr (OP == OP_F32)
        return *reinterpret_cast<const float*>(
            Qs + (dd >> 5) * rows * 128 + fm_swz(r, (dd >> 2) & 7) +
            4 * (dd & 3));
    const unsigned short h = *reinterpret_cast<const unsigned short*>(
        Qs + (dd >> 6) * rows * 128 + fm_swz(r, (dd >> 3) & 7) + 2 * (dd & 7));
    return __uint_as_float((unsigned)h << 16);
}

// |q|^2 of row r of a query tile: dims 0, 1, ... d - 1 in turn, each
// product and each sum rounded to fp32 (the plain version's row_sq repeats
// it with torch ops).
template <int OP>
__device__ float fm_row_sq(const unsigned char* Qs, int rows, int r, int d) {
    float s = 0.f;
    for (int dd = 0; dd < d; ++dd) {
        const float x = fm_qval<OP>(Qs, rows, r, dd);
        s = __fadd_rn(s, __fmul_rn(x, x));
    }
    return s;
}

// The A fragment of a warp's 16 queries for k step s of one chunk Qc.
__device__ __forceinline__ void fm_load_a1(unsigned (&a)[4],
                                           const unsigned char* Qc, int wq0,
                                           int lane, int s) {
    fm_ldsm4(a, fm_smem(Qc + fm_swz(wq0 + (lane & 7) + (lane & 8),
                                    2 * s + (lane >> 4))));
}

// The A fragments of a warp's 16 queries for the four k steps of Qc.
__device__ __forceinline__ void fm_load_a(unsigned (&afr)[4][4],
                                          const unsigned char* Qc, int wq0,
                                          int lane) {
#pragma unroll
    for (int s = 0; s < 4; ++s) fm_load_a1(afr[s], Qc, wq0, lane, s);
}

// tf32_rna(x) as the bits of an fp32 value: the magnitude rounded to 10
// mantissa bits, ties away from zero, low 13 bits zero -- what
// cvt.rna.tf32.f32 gives for finite x, in two integer ops. On an H100 the
// fp32 kernels ran 8-15 % faster at 1024 x 1M this way than with the cvt,
// which issues on the slower conversion path.
__device__ __forceinline__ unsigned fm_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// 3xTF32 split of four fp32 values (as bits): hi = tf32_rna(x), lo =
// tf32_rna(x - hi); x - hi is exact in fp32.
__device__ __forceinline__ void fm_split4(const unsigned (&x)[4],
                                          unsigned (&hi)[4],
                                          unsigned (&lo)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float v = __uint_as_float(x[e]);
        hi[e] = fm_tf32(v);
        lo[e] = fm_tf32(__fsub_rn(v, __uint_as_float(hi[e])));
    }
}

__device__ __forceinline__ void fm_mma_tf32(float (&c)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b for one k8 step in 3xTF32. The tensor cores truncate as they
// accumulate, so a running sum kept in the mma's C would lose up to an ulp
// of itself at every one of its 3 d / 8 mma, all in one direction: at d =
// 384 that is several times the error of plain fp32 sums (a CPU model of
// it: tests/test_torch_tf32.py). So the step's three products (the cross
// terms, then hi.hi) sum from zero, where the truncation is relative to
// the small step sum and its sign varies from step to step, and join c by
// a round-to-nearest fp32 add.
__device__ __forceinline__ void fm_mma3(float (&c)[4], const unsigned (&ah)[4],
                                        const unsigned (&al)[4], unsigned bh0,
                                        unsigned bh1, unsigned bl0,
                                        unsigned bl1) {
    float p[4];
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
        : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh0), "r"(bh1),
          "f"(0.f));
    fm_mma_tf32(p, ah, bl0, bl1);
    fm_mma_tf32(p, ah, bh0, bh1);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], p[e]);
}

// c += a.b for one k32 step of int8 codes, summed exactly in int32: the
// accumulators are int32 values kept in the bits of the float array the
// other kinds sum in (0.f is int 0), read by fm_i2f.
__device__ __forceinline__ void fm_mma_s8(float (&c)[4],
                                          const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
    unsigned r0 = __float_as_uint(c[0]), r1 = __float_as_uint(c[1]);
    unsigned r2 = __float_as_uint(c[2]), r3 = __float_as_uint(c[3]);
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(r0), "+r"(r1), "+r"(r2), "+r"(r3)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    c[0] = __uint_as_float(r0);
    c[1] = __uint_as_float(r1);
    c[2] = __uint_as_float(r2);
    c[3] = __uint_as_float(r3);
}

// The score of an int32 dot held in a float's bits: float32(dot) * factor,
// each step rounded to nearest, as the JAX package computes it.
__device__ __forceinline__ float fm_i2f(float acc, float factor) {
    return __fmul_rn(__int2float_rn(__float_as_int(acc)), factor);
}

// c0 += a.b and c1 += a.b' for one k8 step of two n8 blocks in 3xTF32, A
// already split; b: ldmatrix.x4 of the two blocks' fp32 B fragments.
__device__ __forceinline__ void fm_mma3_x2(float (&c0)[4], float (&c1)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&b)[4]) {
    unsigned bh[4], bl[4];
    fm_split4(b, bh, bl);
    fm_mma3(c0, ah, al, bh[0], bh[1], bl[0], bl[1]);
    fm_mma3(c1, ah, al, bh[2], bh[3], bl[2], bl[3]);
}

__device__ __forceinline__ i64 fm_shfl(i64 v, int src) {
    const int lo = __shfl_sync(FM_FULL, (int)v, src);
    const int hi = __shfl_sync(FM_FULL, (int)(v >> 32), src);
    return (i64)(((unsigned long long)(unsigned)hi << 32) | (unsigned)lo);
}

__device__ __forceinline__ i64 fm_shfl_xor(i64 v, int m) {
    const int lo = __shfl_xor_sync(FM_FULL, (int)v, m);
    const int hi = __shfl_xor_sync(FM_FULL, (int)(v >> 32), m);
    return (i64)(((unsigned long long)(unsigned)hi << 32) | (unsigned)lo);
}

__device__ __forceinline__ i64 fm_shfl_up(i64 v) {
    const int lo = __shfl_up_sync(FM_FULL, (int)v, 1);
    const int hi = __shfl_up_sync(FM_FULL, (int)(v >> 32), 1);
    return (i64)(((unsigned long long)(unsigned)hi << 32) | (unsigned)lo);
}

__device__ __forceinline__ i64 fm_max(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ i64 fm_min(i64 a, i64 b) { return a < b ? a : b; }

// Compare-exchange of a (lower index) and b: desc puts the larger first.
__device__ __forceinline__ void fm_cas(i64& a, i64& b, bool desc) {
    const i64 hi = fm_max(a, b), lo = fm_min(a, b);
    a = desc ? hi : lo;
    b = desc ? lo : hi;
}

// Barrier of the two warps of a pair (named barriers 1 .. FM_PAIRS).
__device__ __forceinline__ void fm_pair_sync(int pair) {
    asm volatile("bar.sync %0, 64;\n" :: "r"(pair + 1) : "memory");
}

// A sorted list of N = 32 E keys is held E a lane, blocked: lane l holds
// entries E l .. E l + E - 1. Entry i, broadcast to the warp.
template <int E>
__device__ __forceinline__ i64 fm_at(const i64 (&v)[E], int i) {
    const int e = i % E;
    i64 x = v[0];
#pragma unroll
    for (int j = 1; j < E; ++j) x = e == j ? v[j] : x;
    return fm_shfl(x, i / E);
}

// Bitonic sort of N = 32 E keys; ascending if ASC.
template <int E, bool ASC>
__device__ __forceinline__ void fm_sort(i64 (&v)[E], int lane) {
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
                    v[e] = lower == desc ? fm_max(v[e], o) : fm_min(v[e], o);
                }
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    if (e & j) continue;
                    fm_cas(v[e], v[e | j], (((E * lane + e) & s) == 0) != ASC);
                }
            }
        }
    }
}

// A bitonic sequence of N = 32 E keys, sorted descending.
template <int E>
__device__ __forceinline__ void fm_merge(i64 (&v)[E], int lane) {
#pragma unroll
    for (int j = 16 * E; j > 0; j >>= 1) {
        if (j >= E) {
            const int lm = j / E;
            const bool lower = (lane & lm) == 0;
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const i64 o = fm_shfl_xor(v[e], lm);
                v[e] = lower ? fm_max(v[e], o) : fm_min(v[e], o);
            }
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                if (e & j) continue;
                fm_cas(v[e], v[e | j], true);
            }
        }
    }
}

// Insert c into the descending list v (the last entry falls off).
template <int E>
__device__ __forceinline__ void fm_insert(i64 (&v)[E], i64 c, int lane) {
    unsigned cnt = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) cnt += v[e] > c;
    const int pos = (int)__reduce_add_sync(FM_FULL, cnt);
    const i64 prev = fm_shfl_up(v[E - 1]);  // lane - 1's last entry
#pragma unroll
    for (int e = E - 1; e >= 0; --e) {
        const int i = E * lane + e;
        const i64 below = e ? v[e - 1] : prev;
        v[e] = i < pos ? v[e] : (i == pos ? c : below);
    }
}

// Offer one query's 128 lane winners (4 a lane) to its sorted list Lq[0, k),
// held in registers as a list of 32 E >= k entries. Winners that do not
// beat the k-th are dropped; up to 4 E passers are inserted one by one;
// more are packed into cbuf (128 keys of warp scratch) and merged in
// chunks of 32 E: sort the chunk ascending, keep the larger of it and the
// list entry by entry (a bitonic sequence holding the best 32 E of both),
// merge. Entries past k in the registers are real but unkept.
template <int E>
__device__ __forceinline__ void fm_offer(i64* Lq, int k, const i64 (&cand)[4],
                                         int lane, i64* cbuf) {
    const i64 kth = Lq[k - 1];
    unsigned m[4];
    int np = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        m[e] = __ballot_sync(FM_FULL, cand[e] > kth);
        np += __popc(m[e]);
    }
    if (np == 0) return;  // uniform
    i64 v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = E * lane + e;
        v[e] = i < k ? Lq[i] : EMPTY64;
    }
    if (np <= 4 * E) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            unsigned mm = m[e];
            while (mm) {
                const int src = __ffs(mm) - 1;
                mm &= mm - 1;
                fm_insert<E>(v, fm_shfl(cand[e], src), lane);
            }
        }
    } else {
        const unsigned below = (1u << lane) - 1u;
        int base = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if ((m[e] >> lane) & 1u) cbuf[base + __popc(m[e] & below)] = cand[e];
            base += __popc(m[e]);
        }
        __syncwarp();
        for (int c0 = 0; c0 < np; c0 += 32 * E) {
            i64 x[E];
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int i = c0 + E * lane + e;
                x[e] = i < np ? cbuf[i] : EMPTY64;
            }
            fm_sort<E, true>(x, lane);
#pragma unroll
            for (int e = 0; e < E; ++e) v[e] = fm_max(v[e], x[e]);
            fm_merge<E>(v, lane);
        }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = E * lane + e;
        if (i < k) Lq[i] = v[e];
    }
    __syncwarp();
}

// Fold one 128-row sub-tile's scores into the lane maxima. local0 is the
// tile column of the thread's first slot; columns from `valid` on are
// rows >= n (EDGE only); cq holds the rows' norms^2 from the thread's
// first slot on (EUCLID only); mb holds the row mask's bits of the
// thread's 16 columns (MASK only): column 8 j + h (h < 2) of the thread's
// first slot at bit 8 j + h for j < 4, 8 (j - 4) + 2 + h for j >= 4.
template <bool EUCLID, bool EDGE, bool MASK>
__device__ __forceinline__ void fm_fold(int (&folded)[8][4],
                                        const float (&acc)[8][4], int local0,
                                        int valid, float qs0, float qs1,
                                        const float* cq, unsigned mb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col = 8 * j + h;
            float s0 = acc[j][h], s1 = acc[j][2 + h];
            if (EUCLID) {
                const float cs = cq[col];
                s0 = 2.0f * s0 - qs0 - cs;
                s1 = 2.0f * s1 - qs1 - cs;
            }
            // (monotone_i32(s) & ~IDX_MASK) | column: the column's bits are
            // below the key's, so the sign's flip and the column are one xor
            const int b0 = __float_as_int(s0), b1 = __float_as_int(s1);
            const int lc = local0 + col;
            int p0 = (b0 & ~IDX_MASK) ^ (((b0 >> 31) & (0x7FFFFFFF & ~IDX_MASK)) ^ lc);
            int p1 = (b1 & ~IDX_MASK) ^ (((b1 >> 31) & (0x7FFFFFFF & ~IDX_MASK)) ^ lc);
            if (EDGE && col >= valid) p0 = p1 = MIN_I32;
            if (MASK && !((mb >> ((j < 4 ? 8 * j : 8 * j - 30) + h)) & 1u))
                p0 = p1 = MIN_I32;
            folded[j][h] = max(folded[j][h], p0);
            folded[j][2 + h] = max(folded[j][2 + h], p1);
        }
    }
}

// key64 of a packed lane winner of the tile at row base `tile_base`.
__device__ __forceinline__ i64 fm_key(int p, unsigned low_base) {
    if (p == MIN_I32) return EMPTY64;
    const unsigned low = low_base + (unsigned)(p & IDX_MASK);
    return (i64)(((unsigned long long)(unsigned)(p & ~IDX_MASK) << 32) | low);
}

// fp32 score and corpus row of a key64 (R = (n_tiles - 1) * block_n). With
// a row mask (MASK) a slot can stay empty (the filter allowed fewer than k
// rows): it is (LR_NEG_INF, -1); without one every slot holds a row.
template <bool MASK>
__device__ __forceinline__ void fm_decode(i64 key, unsigned R, int block_n,
                                          float* s, int* row) {
    if (MASK && key == EMPTY64) {
        *s = LR_NEG_INF;
        *row = -1;
        return;
    }
    const int q = (int)(key >> 32);
    *s = __int_as_float(q >= 0 ? q : (q ^ 0x7FFFFFFF));
    const unsigned low = (unsigned)key;
    const unsigned col = low % (unsigned)block_n;
    *row = (int)(R - low + 2u * col);  // tile base R - (low - col), + col
}

// grid: (ceil(nq / FM_TQ), slabs of slab_rows rows, a multiple of block_n).
// Lists are held E = KP / 32 a lane in registers (KP >= k). final_out (one
// slab): write out_s / out_i; else part[slab, q, :] keys. qp and cp are
// bf16 [nq, d] and [n, d] (OP_BF16), fp32 (OP_F32), bf16 queries and the
// packed sign words [n, ceil(d/32)] (OP_BIN; euclid and vec are 0), or int8
// query codes and int8 codes [n, d] (OP_I8) or packed nibbles [n, ceil(d /
// 2)] (OP_I4), for which csq is the one fp32 score factor (euclid 0). MASK:
// mask is the allowed rows' bits [ceil(n/32)] (unread otherwise).
template <int E, int OP, bool MASK>
__global__ void __launch_bounds__(FM_THREADS, 2)
fold_mma_kernel(const void* __restrict__ qp, const void* __restrict__ cp,
                const float* __restrict__ csq,
                const unsigned* __restrict__ mask, int nq, int n, int d,
                int k, int euclid, int block_n, int slab_rows, int vec,
                int final_out, i64* __restrict__ part,
                float* __restrict__ out_s, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr bool BIN = OP == OP_BIN, I4 = OP == OP_I4, INT = fm_int(OP);
    constexpr int SLOT = fm_slot_bytes(OP);
    constexpr int NST = fm_nst(E, OP), CH = fm_dch(OP);
    const int n_dch = (d + CH - 1) / CH;
    unsigned char* ring = smem;                            // NST slots
    unsigned char* Qs = ring + NST * SLOT;                 // [n_dch][64][128 B]
    // BIN: the unpacked stage [128][64] bf16; I4: [128][128] s8
    unsigned char* U = Qs + (n_dch > 1 || I4 ? n_dch * FM_TQ * 128 : 0);
    float* qsq = (float*)(Qs + fm_qu_bytes(n_dch, OP));    // [64]
    int* Tb = (int*)(qsq + FM_TQ);                         // [4 pairs][8][136]
    i64* Cb = (i64*)(Tb + FM_PAIRS * 8 * FM_TSTRIDE);      // [8 warps][128]
    i64* L = Cb + FM_WARPS * 128;                          // [64][k]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    // warp = (pair of 16 queries, half of the 128 columns)
    const int pair = warp >> 1, hc = warp & 1, c64 = 64 * hc;
    const int q0 = blockIdx.x * FM_TQ, wq0 = pair * 16;
    const bool active = q0 + wq0 < nq;  // uniform per pair
    const int row0 = blockIdx.y * slab_rows;
    const int row1 = min(row0 + slab_rows, n);
    const int n_sub = (row1 - row0 + TN - 1) / TN;
    const int n_st = n_sub * n_dch;
    const int n_tiles = (n + block_n - 1) / block_n;
    const unsigned R = (unsigned)(n_tiles - 1) * (unsigned)block_n;
    const float factor = INT ? __ldg(csq) : 0.f;  // OP_I8, OP_I4

    // the ring's first stages go out before the query tile is read
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) {
        if (s < n_st)
            fm_stage<OP>(ring + s * SLOT, cp, csq, n, d,
                         row0 + (s / n_dch) * TN, (s % n_dch) * CH, vec,
                         euclid, tid);
        fm_commit();
    }
    for (int v = tid; v < FM_TQ * n_dch * 8; v += FM_THREADS) {
        const int r = v / (n_dch * 8), cc = v - r * (n_dch * 8);
        const int q = q0 + r;
        *reinterpret_cast<uint4*>(Qs + (cc >> 3) * FM_TQ * 128 +
                                  fm_swz(r, cc & 7)) =
            q < nq ? fm_chunk<OP>(qp, q, d, (CH / 8) * cc)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e = tid; e < FM_TQ * k; e += FM_THREADS) L[e] = EMPTY64;
    __syncthreads();
    // |q|^2 of the stored values, dim by dim, rounded as the plain version
    if (!INT && euclid && tid < FM_TQ)
        qsq[tid] = fm_row_sq<OP>(Qs, FM_TQ, tid, d);
    // (qsq is read after the first stage's barrier)
    // with one 64-dim chunk the A fragments are read once: the binary fold
    // here, before its first unpack takes the query tile's room; the bf16
    // fold at the loop's first stage, since loading them here makes ptxas
    // spill its k <= 64 instance (104 bytes), ~9 % slower at 1M rows. The
    // fp32 fold loads and splits one k step's fragment at a time: the tf32
    // parts of all four take 32 registers it does not have
    unsigned afr[4][4];
    if (BIN && n_dch == 1) fm_load_a(afr, Qs, wq0, lane);

    float acc[8][4];
    int folded[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            folded[j][e] = MIN_I32;
            if (MASK || INT) acc[j][e] = 0.f;
        }
    int* T = Tb + pair * 8 * FM_TSTRIDE;
    i64* cbuf = Cb + warp * 128;

    for (int st = 0; st < n_st; ++st) {
        fm_wait_ring<NST>();
        __syncthreads();  // stage st is in; stage st - 1's slot (and U) free
        {
            const int s2 = st + NST - 1;
            if (s2 < n_st)
                fm_stage<OP>(ring + (s2 % NST) * SLOT, cp, csq, n, d,
                             row0 + (s2 / n_dch) * TN, (s2 % n_dch) * CH,
                             vec, euclid, tid);
            fm_commit();
        }
        const unsigned char* S = ring + (st % NST) * SLOT;
        if constexpr (BIN || I4) {  // every warp unpacks its share, active or not
            if constexpr (BIN)
                fm_unpack(U, S, tid);
            else
                fm_unpack4(U, S, tid);
            __syncthreads();
            S = U;
        }
        if (!active) continue;
        const int sub = st / n_dch, dci = st - sub * n_dch;
        const int t0 = row0 + sub * TN;
        if (!MASK && !INT && dci == 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
        const unsigned char* Qc = Qs + dci * FM_TQ * 128;
        if (OP != OP_F32 && (n_dch > 1 || (!BIN && st == 0)))
            fm_load_a(afr, Qc, wq0, lane);
        // four k steps of 16 bf16 dims, of 8 fp32 dims in 3xTF32, or of 32
        // int8 dims (those past d skipped)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            if (INT && CH * dci + 32 * s >= d) break;
            unsigned ah[4], al[4];  // OP_F32: the A fragment's tf32 parts
            if constexpr (OP == OP_F32) {
                unsigned a[4];
                fm_load_a1(a, Qc, wq0, lane, s);
                fm_split4(a, ah, al);
            }
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
                unsigned b[4];
                fm_ldsm4(b, fm_smem(S + fm_swz(c64 + 16 * jp + (lane & 7) +
                                                   ((lane >> 4) << 3),
                                               2 * s + ((lane >> 3) & 1))));
                if constexpr (OP == OP_F32) {
                    fm_mma3_x2(acc[2 * jp], acc[2 * jp + 1], ah, al, b);
                } else if constexpr (INT) {
                    fm_mma_s8(acc[2 * jp], afr[s], b[0], b[1]);
                    fm_mma_s8(acc[2 * jp + 1], afr[s], b[2], b[3]);
                } else {
                    fm_mma(acc[2 * jp], afr[s], b[0], b[1]);
                    fm_mma(acc[2 * jp + 1], afr[s], b[2], b[3]);
                }
            }
        }
        if (dci != n_dch - 1) continue;  // more dims of this sub-tile to come
        if constexpr (INT) {  // the int32 dots as the JAX package's scores
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = fm_i2f(acc[j][e], factor);
        }

        // fold this sub-tile's scores into the lane maxima; the metric and
        // the corpus's ragged end choose one branch-free copy
        const int tile = t0 / block_n, tile_base = tile * block_n;
        const int lb = t0 - tile_base;
        const int local0 = lb + c64 + 2 * t4, valid = n - t0 - c64 - 2 * t4;
        const float* cq =
            reinterpret_cast<const float*>(S + FM_STAGE_BYTES) + c64 + 2 * t4;
        unsigned mb = 0;
        if constexpr (MASK) {  // the warp's 64 rows: two whole mask words,
            // of which the thread's 16 columns go into one register
            const int w = (t0 + c64) >> 5, n_words = (n + 31) >> 5;
            const unsigned lo = w < n_words ? __ldg(mask + w) : 0u;
            const unsigned hi = w + 1 < n_words ? __ldg(mask + w + 1) : 0u;
            mb = ((lo >> (2 * t4)) & 0x03030303u) |
                 (((hi >> (2 * t4)) & 0x03030303u) << 2);
        }
        if (euclid) {
            const float qs0 = qsq[wq0 + g], qs1 = qsq[wq0 + g + 8];
            if (t0 + TN > n)
                fm_fold<true, true, MASK>(folded, acc, local0, valid, qs0,
                                          qs1, cq, mb);
            else
                fm_fold<true, false, MASK>(folded, acc, local0, valid, qs0,
                                           qs1, cq, mb);
        } else if (t0 + TN > n) {
            fm_fold<false, true, MASK>(folded, acc, local0, valid, 0.f, 0.f,
                                       cq, mb);
        } else {
            fm_fold<false, false, MASK>(folded, acc, local0, valid, 0.f, 0.f,
                                        cq, mb);
        }
        // MASK and the int kinds: the sums start again here, not at the
        // next sub-tile's first stage, so that they are dead across the
        // flush below; live there (32 registers) they made ptxas spill 20-64
        // bytes in 7 of the 9 masked instances and 60-96 bytes in each
        // unmasked int instance. The float and binary unmasked instances
        // keep the parent's order
        if constexpr (MASK || INT) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        }
        const bool flush = lb + TN == block_n || t0 + TN >= row1;
        if (!flush) continue;  // uniform across the warp

        // flush: rows g (half 0) and g + 8 (half 1) of the pair's 16
        // queries; both warps write their columns, then each keeps the
        // lists of 4 of the 8 queries
        const unsigned low_base = R - (unsigned)tile_base;
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<int2*>(
                    &T[g * FM_TSTRIDE + c64 + 8 * j + 2 * t4]) =
                    half ? make_int2(folded[j][2], folded[j][3])
                         : make_int2(folded[j][0], folded[j][1]);
            fm_pair_sync(pair);
#pragma unroll 1
            for (int r = 4 * hc; r < 4 * hc + 4; ++r) {
                const int qi = wq0 + 8 * half + r;
                if (q0 + qi >= nq) break;  // uniform
                const int4 pv =
                    *reinterpret_cast<const int4*>(&T[r * FM_TSTRIDE + 4 * lane]);
                const i64 cand[4] = {
                    fm_key(pv.x, low_base), fm_key(pv.y, low_base),
                    fm_key(pv.z, low_base), fm_key(pv.w, low_base)};
                fm_offer<E>(L + (size_t)qi * k, k, cand, lane, cbuf);
            }
            fm_pair_sync(pair);  // before the next half overwrites T
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) folded[j][e] = MIN_I32;
    }

    if (!active) return;
    for (int r = 0; r < 8; ++r) {  // the warp's 8 queries: 4 of each half
        const int qi = wq0 + 8 * (r >> 2) + 4 * hc + (r & 3);
        const int q = q0 + qi;
        if (q >= nq) continue;
        const i64* Lq = L + (size_t)qi * k;
        for (int i = lane; i < k; i += 32) {
            const size_t o = (size_t)q * k + i;
            if (final_out) {
                fm_decode<MASK>(Lq[i], R, block_n, out_s + o, out_i + o);
            } else {
                part[(size_t)blockIdx.y * nq * k + o] = Lq[i];
            }
        }
    }
}

// One warp per query: start from slab 0's sorted list; merge in each other
// slab's list (read reversed, so ascending) with one bitonic merge. MASK:
// the slabs come from the row-mask instance, so slots may be empty.
template <int E, bool MASK>
__global__ void __launch_bounds__(FM_THREADS)
fold_merge_kernel(const i64* __restrict__ part, int S, int nq, int k,
                  int block_n, unsigned R, float* __restrict__ out_s,
                  int* __restrict__ out_i) {
    const int lane = threadIdx.x & 31;
    const int q = blockIdx.x * FM_WARPS + (threadIdx.x >> 5);
    if (q >= nq) return;  // whole warp leaves together
    i64 v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = E * lane + e;
        v[e] = i < k ? part[(size_t)q * k + i] : EMPTY64;
    }
    for (int s = 1; s < S; ++s) {
        const i64* p = part + ((size_t)s * nq + q) * k;
        if (p[0] <= fm_at<E>(v, k - 1)) continue;  // uniform: nothing enters
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int src = 32 * E - 1 - (E * lane + e);
            v[e] = fm_max(v[e], src < k ? p[src] : EMPTY64);
        }
        fm_merge<E>(v, lane);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int i = E * lane + e;
        if (i < k) {
            const size_t o = (size_t)q * k + i;
            fm_decode<MASK>(v[e], R, block_n, out_s + o, out_i + o);
        }
    }
}

// Each kernel instance's dynamic shared memory is raised to the card's
// opt-in limit once per device, not on every call.
template <int E, int OP, bool MASK>
static int fm_prepare() {
    static unsigned ready = 0;  // bit per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32 && (ready >> dev) & 1u) return 0;
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(fold_mma_kernel<E, OP, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) ready |= 1u << dev;
    return 0;
}

template <int E, int OP, bool MASK>
static int fm_occupancy(size_t smem) {
    int e = fm_prepare<E, OP, MASK>();
    if (e) return -e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fold_mma_kernel<E, OP, MASK>, FM_THREADS, smem);
    return e ? -e : blocks;
}

template <int E, int OP, bool MASK>
static int fm_launch(const void* q, const void* c, const float* csq,
                     const unsigned* mask, int nq, int n, int d, int k,
                     int euclid, int block_n, int slab_rows, int vec,
                     long long* part, float* out_s, int* out_i, size_t smem,
                     cudaStream_t st) {
    int e = fm_prepare<E, OP, MASK>();
    if (e) return e;
    const int n_slabs = (n + slab_rows - 1) / slab_rows;
    const unsigned R =
        (unsigned)((n + block_n - 1) / block_n - 1) * (unsigned)block_n;
    dim3 grid((nq + FM_TQ - 1) / FM_TQ, n_slabs);
    fold_mma_kernel<E, OP, MASK><<<grid, FM_THREADS, smem, st>>>(
        q, c, csq, mask, nq, n, d, k, euclid, block_n, slab_rows, vec,
        n_slabs == 1, part, out_s, out_i);
    e = (int)cudaGetLastError();
    if (e || n_slabs == 1) return e;
    fold_merge_kernel<E, MASK><<<(nq + FM_WARPS - 1) / FM_WARPS, FM_THREADS, 0,
                                 st>>>(
        part, n_slabs, nq, k, block_n, R, out_s, out_i);
    return (int)cudaGetLastError();
}

// List entries a lane for k: the least list of 32, 64 or 128 that holds it.
static int fm_e(int k) { return k <= 32 ? 1 : k <= 64 ? 2 : 4; }

// F<E, OP, LR_MASK>(args) for E = fm_e(k) and the operand kind op; the
// library's flavour (LR_MASK, fused_topk.cu) sets the row mask's flag.
#define FM_DISPATCH_OP(F, O, ...)                                             \
    (k <= 32   ? F<1, O, LR_MASK>(__VA_ARGS__)                                \
     : k <= 64 ? F<2, O, LR_MASK>(__VA_ARGS__)                                \
               : F<4, O, LR_MASK>(__VA_ARGS__))
#define FM_DISPATCH(F, ...)                                                   \
    (op == OP_BIN   ? FM_DISPATCH_OP(F, OP_BIN, __VA_ARGS__)                  \
     : op == OP_F32 ? FM_DISPATCH_OP(F, OP_F32, __VA_ARGS__)                  \
     : op == OP_I8  ? FM_DISPATCH_OP(F, OP_I8, __VA_ARGS__)                   \
     : op == OP_I4  ? FM_DISPATCH_OP(F, OP_I4, __VA_ARGS__)                   \
                    : FM_DISPATCH_OP(F, OP_BF16, __VA_ARGS__))

extern "C" {

// Dynamic shared memory of one fold_mma_kernel<fm_e(k), op> block.
size_t lr_fold_mma_smem(int d, int k, int op) {
    const int n_dch = (d + fm_dch(op) - 1) / fm_dch(op);
    return (size_t)fm_nst(fm_e(k), op) * fm_slot_bytes(op) +
           fm_qu_bytes(n_dch, op) + FM_TQ * 4 +
           (size_t)FM_PAIRS * 8 * FM_TSTRIDE * 4 +
           (size_t)FM_WARPS * 128 * 8 + (size_t)FM_TQ * k * 8;
}

// Resident fold_mma_kernel blocks per SM at (d, k, op), of the library's
// flavour (LR_MASK), on the current device (0: does not fit); a negative
// cudaError_t on failure.
int lr_fold_mma_occupancy(int d, int k, int op) {
    const size_t smem = lr_fold_mma_smem(d, k, op);
    return FM_DISPATCH(fm_occupancy, smem);
}

// The fold over bf16 (op = OP_BF16: q, c bf16 [nq, d], [n, d]) or fp32
// (OP_F32: fp32, 3xTF32 products) stores, the binary fold (OP_BIN: bf16
// queries, c the packed sign words [n, ceil(d/32)]; euclid = 0), or the
// int8 and int4 folds (OP_I8 / OP_I4: int8 query codes, c int8 codes [n, d]
// or packed nibbles [n, ceil(d/2)], csq the one fp32 score factor; euclid =
// 0):
// fold_mma_kernel over (query tiles x slabs), then, with more than one
// slab, fold_merge_kernel; lists of 32, 64 or 128 entries in registers,
// the least that holds k. mask (the masked library; null in the other) is
// the allowed rows' bits, int32 words [ceil(n/32)], bit r & 31 of word
// r >> 5 for row r; slots past the allowed rows come out as (LR_NEG_INF,
// -1). part is
// [slabs, nq, k] int64 scratch (unused with one slab). Returns a
// cudaError_t.
int lr_fold_mma(const void* q, const void* c, const float* csq, int nq, int n,
                int d, int k, int euclid, int block_n, int slab_rows, int vec,
                int op, const unsigned* mask, long long* part, float* out_s,
                int* out_i, void* stream) {
    const size_t smem = lr_fold_mma_smem(d, k, op);
    cudaStream_t st = (cudaStream_t)stream;
#define FM_ARGS q, c, csq, mask, nq, n, d, k, euclid, block_n, slab_rows, vec, \
                part, out_s, out_i, smem, st
    return FM_DISPATCH(fm_launch, FM_ARGS);
#undef FM_ARGS
}

}  // extern "C"

#undef FM_DISPATCH
#undef FM_DISPATCH_OP
