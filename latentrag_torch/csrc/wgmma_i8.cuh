// The int8 wgmma kernels' shared machinery: fold_i8_wgmma.cuh (the int8
// and int4 stores' fold) and exact_i8_wgmma.cuh (the int8 store's exact
// search) both stream a slab of int8 corpus rows past a 64-query tile this
// way. Included by both; fused_topk.cu's prelude and fold_mma.cuh (TN, i64,
// EMPTY64, fm_smem, fm_row16, fm_s4x8) come first.
//
//   - warp specialisation: 256 threads, a producer warpgroup (warp 0
//     works) and a consumer warpgroup, each consumer warp 16 of the 64
//     queries (wgmma's M);
//   - the producer keeps TMA copies of corpus stages in flight into a ring
//     of full and empty mbarriers (2 to FW_NST_MAX stages): a stage is 128
//     rows x 64 dims (8 KB, one box, 64-byte swizzle) when d <= 64, beside
//     the query tile, which comes once the same way. When d > 64 (the WIDE
//     instances) a stage is one 128-dim chunk of 128 rows and of the 64
//     queries (16 + 8 KB, two boxes, 128-byte swizzle), and a sub-tile takes
//     ceil(d / 128) stages: neither the ring nor the query tile grows with
//     d. Rows whose bytes are not whole 16-byte chunks, or a base that is
//     not 16-byte aligned, are copied by loads into the same swizzle
//     instead (fm_row16);
//   - the int4 store's rows are packed nibbles, which no wgmma operand
//     takes: the producer warpgroup's four warps (fw_produce4) load them
//     with 16-byte loads (or element-wise ones, as above), sign-extend them
//     in registers (fm_s4x8) and write the same s8 stages, so that the
//     consumers cannot tell the two stores apart;
//   - the consumers issue wgmma.mma_async m64n64k32 s8.s8 -> s32 with the
//     query tile and the stage in shared memory (fw_issue), a sub-tile's
//     two 64-row halves into two accumulator sets; every k step is
//     unrolled and each sub-tile's groups are waited for within its
//     iteration, so that ptxas keeps the wgmma asynchronous (C7514 lists
//     what makes it serialise them); the ring's mbarriers order everything,
//     with no block-wide barrier in the loop;
//   - the TMA maps come from the driver the runtime has loaded, through
//     dlopen (no -lcuda).

#ifndef LR_WGMMA_I8_CUH
#define LR_WGMMA_I8_CUH

#include <cuda.h>
#include <dlfcn.h>
#include <string.h>

#define FW_THREADS 256        // a producer warpgroup, then a consumer warpgroup
#define FW_TQ 64              // queries a block: wgmma's M
#define FW_NST_MAX 8          // ring stages at most
#define FW_BAR_BYTES 1024     // the mbarriers' region at the start
#define FW_P4_THREADS 128     // the int4 producer's: the producer warpgroup
                              // (all of it: the kernel launches it so)
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

// The ring's shared addresses: the full and empty mbarrier arrays, the
// stages, and the resident query tile (d <= 64).
struct FwRing {
    unsigned full, empty;  // shared addresses of the mbarrier arrays
    unsigned ring, qs;     // shared addresses of the ring and query tile
                           // (d <= 64)
};

// Issue the products of half `half` (rows 64 half .. 64 half + 63) of
// one 128-row sub-tile with the stage at `slot` (one dim chunk: WIDE, 128
// dims and the queries' same chunk; else 64 dims against the query tile)
// into a, every k32 step of it (steps past d meet zero codes), then one
// commit. acc = 0 starts the sums. The steps are unrolled at compile time:
// a runtime loop around the wgmma would make ptxas serialize every wgmma
// of the kernel (C7514), so only the WIDE instance's loop over dim chunks
// has one.
template <bool WIDE>
__device__ __forceinline__ void fw_issue(int (&a)[32], const FwRing& sm,
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
__device__ __forceinline__ void fw_release(const FwRing& sm, int slot,
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

// Thread 0: the ring's barriers (full: `arrivals`, the TMA's one arrival
// with its bytes, the producer warp's 32 copies, or the int4 producer's 4
// warps; empty: the 4 consumer warps) and the query tile's.
__device__ __forceinline__ void fw_init_ring(const FwRing& sm, int nst,
                                             int arrivals, unsigned qbar) {
    for (int s = 0; s < nst; ++s) {
        fw_bar_init(sm.full + 8 * s, arrivals);
        fw_bar_init(sm.empty + 8 * s, 4);
    }
    fw_bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The query tile (d <= 64) where it does not come by TMA, by the consumer
// warpgroup's 128 threads (t: 0 .. 127): 64 rows of 64 bytes, swizzled as
// the stages are, zero past d and past nq.
__device__ __forceinline__ void fw_load_qtile(unsigned char* Q,
                                              const signed char* q, int nq,
                                              int d, int q0, int t) {
    for (int v = t; v < FW_TQ * 4; v += 128) {
        const int r = v >> 2, cc = v & 3;
        *reinterpret_cast<uint4*>(Q + fw_swz(r, cc, 64)) =
            q0 + r < nq
                ? fm_row16((const unsigned char*)q + (size_t)(q0 + r) * d,
                           d, 16 * cc)
                : make_uint4(0u, 0u, 0u, 0u);
    }
    fw_fence_async();
}

// The producer warp (with TMA, its lane 0 alone): the query tile (d <= 64,
// qvec) by one box, then every stage of the slab's n_sub sub-tiles from
// row row0 (ceil(d / ch) a sub-tile) into the ring, each into a slot its
// consumers have released. smem: the block's shared memory, whose start
// is sm.full.
template <bool WIDE>
__device__ __forceinline__ void fw_produce(
    const FwRing& sm, unsigned char* smem, const CUtensorMap* map,
    const CUtensorMap* qmap, const signed char* q, const signed char* c,
    int nq, int n, int d, int q0, int row0, int n_sub, int nst, int vec,
    int qvec, unsigned qbar, int lane) {
    const int ch = fw_ch(d), n_dch = (d + ch - 1) / ch;
    if (!WIDE && qvec && lane == 0) {  // the query tile, one box
        fw_bar_expect(qbar, FW_TQ * 64);
        fw_tma(sm.qs, qmap, 0, q0, qbar);
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
            fw_tma(S, map, d0, t0, full);
            if (WIDE) fw_tma(S + TN * ch, qmap, d0, q0, full);
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
}

// The int4 producer: the producer warpgroup's FW_P4_THREADS threads (t: 0
// .. 127, 4 warps) turn
// the packed nibbles of the slab's n_sub sub-tiles (rows of w = ceil(d / 2)
// bytes, low nibble the even dim, two's complement) into the s8 stages the
// consumers read, in the swizzle TMA gives the int8 store's (fw_swz),
// ceil(d / ch) stages a sub-tile; d <= 64 with the query tile by one TMA
// box (qvec), WIDE with each stage's 64 queries' chunk by loads (16 bytes
// when qvec). A thread takes PT 16-byte pieces of packed rows a stage (32
// dims each: two s8 chunks), pieces of neighbouring threads neighbouring in
// memory: by one 16-byte load each when vec (rows of whole 16-byte pieces
// on an aligned base), else byte by byte; zero past n and past w, and
// dims past d meet zero query codes. Piece u of thread t is piece t % PR
// of row t / PR + u NT / PR: NT / PR (32 or 64 rows) is a multiple of 8,
// so every piece of a thread lands at the same two swizzled chunk offsets
// of its rows, computed once (offsets kept for each piece spilled at 40
// registers in the exact search's WIDE instances). The loads of a stage go
// out before the wait for its slot, so they fly while the consumers finish
// with it; then the sign extension (fm_s4x8, in registers), the stores,
// the proxy fence that shows them to wgmma, and one arrival a warp on the
// stage's full barrier (FW_P4_THREADS / 32 a stage).
template <bool WIDE>
__device__ __forceinline__ void fw_produce4(
    const FwRing& sm, unsigned char* smem, const CUtensorMap* qmap,
    const signed char* q, const unsigned char* c, int nq, int n, int d,
    int q0, int row0, int n_sub, int nst, int vec, int qvec, unsigned qbar,
    int t) {
    constexpr int CH = WIDE ? 128 : 64;  // dims (s8 bytes) a stage row
    constexpr int PR = CH / 32;          // packed pieces a row
    constexpr int NT = FW_P4_THREADS;
    constexpr int PT = TN * PR / NT;     // pieces a thread a stage: 2 or 4
    constexpr int RU = NT / PR;          // rows from one piece to the next
    static_assert(RU % 8 == 0, "a piece's rows share the swizzle");
    const int w = (d + 1) >> 1, n_dch = (d + CH - 1) / CH;
    // the thread's row and piece of a row, and its two chunks' offsets in
    // a stage (row r0 + u RU at u RU CH bytes further)
    const int r0 = t / PR, pc = t % PR;
    const int o0 = fw_swz(r0, 2 * pc, CH), o1 = fw_swz(r0, 2 * pc + 1, CH);
    if (!WIDE && qvec && t == 0) {  // the query tile, one box
        fw_bar_expect(qbar, FW_TQ * 64);
        fw_tma(sm.qs, qmap, 0, q0, qbar);
    }
    const int n_st = n_sub * n_dch;
    int slot = 0, sub = 0, dci = 0;
    unsigned phase = 0;  // the round of the slot's barriers
    for (int st = 0; st < n_st; ++st) {
        const int t0 = row0 + sub * TN, b = dci * (CH / 2) + 16 * pc;
        uint4 p[PT];
#pragma unroll
        for (int u = 0; u < PT; ++u) {
            const int row = t0 + r0 + u * RU;
            const unsigned char* src = c + (size_t)row * w;
            p[u] = row >= n || b >= w ? make_uint4(0u, 0u, 0u, 0u)
                   : vec ? __ldg(reinterpret_cast<const uint4*>(src + b))
                         : fm_row16(src, w, b);
        }
        fw_bar_wait(sm.empty + 8 * slot, phase ^ 1u);
        unsigned char* P = smem + (sm.ring + slot * fw_stage_bytes(d) -
                                   sm.full);
#pragma unroll
        for (int u = 0; u < PT; ++u) {
            const uint2 a0 = fm_s4x8(p[u].x), a1 = fm_s4x8(p[u].y);
            const uint2 a2 = fm_s4x8(p[u].z), a3 = fm_s4x8(p[u].w);
            *reinterpret_cast<uint4*>(P + u * RU * CH + o0) =
                make_uint4(a0.x, a0.y, a1.x, a1.y);
            *reinterpret_cast<uint4*>(P + u * RU * CH + o1) =
                make_uint4(a2.x, a2.y, a3.x, a3.y);
        }
        if (WIDE) {  // the 64 queries' rows of the same chunk, zero past d
                     // and nq
            const int d0 = dci * CH;
#pragma unroll 1
            for (int v = t; v < (CH / 16) * FW_TQ; v += NT) {
                const int r = v / (CH / 16), cc = v % (CH / 16);
                const int dim = d0 + 16 * cc;
                const signed char* qr = q + (size_t)(q0 + r) * d;
                *reinterpret_cast<uint4*>(P + TN * CH + fw_swz(r, cc, CH)) =
                    q0 + r >= nq || dim >= d ? make_uint4(0u, 0u, 0u, 0u)
                    : qvec ? __ldg(reinterpret_cast<const uint4*>(qr + dim))
                           : fm_row16((const unsigned char*)qr, d, dim);
            }
        }
        fw_fence_async();
        __syncwarp();
        if ((t & 31) == 0) fw_bar_arrive(sm.full + 8 * slot);
        fw_step(slot, phase, nst);
        if (++dci == n_dch) {
            dci = 0;
            ++sub;
        }
    }
}

// The least int32 dot whose score can still enter the list Lq (k keys):
// every dot below it scores under the smallest float v with the list's
// k-th key (the fold's 19-bit key; the exact search's key holds the score
// itself), so its key is below the k-th's and the list would drop it (the
// k-th only rises). With factor > 0 and |dot| < 2^24 (float32(dot) exact),
// dot <= v / factor - 4 gives dot x factor <= v - 4 factor, below v by
// more than the ulp at v (at most 2^-23 |v| <= 2 factor) that the rounding
// could close. INT_MIN while the list is not full.
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


#endif  // LR_WGMMA_I8_CUH
