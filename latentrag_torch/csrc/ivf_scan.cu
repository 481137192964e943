// The device IVF's probed-block scan for Hopper (sm_90a): ivf_scan_kernel.
//
// What it replaces. The JAX package's ivf_search scores the probed blocks in
// XLA, not in Pallas (ops/ivf.py:771-806, score_group: a jnp.take of the
// selected blocks, dot_general, then lax.top_k / approx_max_k). On the card a
// gather plus a batched product would copy [Q, S*cap, d] of probed rows into
// device memory first, and CUDA has no batched integer product for the int8
// and int4 blocks. This kernel reads the probed blocks where they lie.
//
// What it computes, for query q and selected slot s*cap + i (row i of block
// b = sel[q, s]):
//   b outside [0, nblocks) (the sentinel)        -> (LR_NEG_INF, -1), unread
//   block_ids[b, i] = -1 (pad) or masked out     -> (LR_NEG_INF, -1)
//   else score, id = block_ids[b, i]:
//     bf16 / fp32 (OP_BF16, OP_F32): dot(q, r) summed in fp32, dim 0 first;
//       euclid: 2 dot - |r|^2, |r|^2 each square rounded, then summed;
//     int8 (OP_I8): float32(int32 dot(qc, r)) * factor, the JAX package's
//       dots.astype(f32) * factor bit for bit (the int32 dot is exact);
//     int4 (OP_I4): the same over packed nibbles (low nibble the even dim,
//       sign-extended);
//     binary (OP_BIN): sum_j bf16(q_j) * (2 bit_j(r) - 1) in fp32.
//   The row mask (int32 words, bit r & 31 of word r >> 5; a word past
//   mask_words excludes the row) is read before the row, so an excluded row
//   costs no row bytes.
// The top-k select after it is the wrapper's (ops/ivf.py).
//
// Bound on the H100: a gathered matrix-vector product, 2 d operations for
// every row byte read (int8 at d = 64: 2 operations a byte), far below the
// card's ridge, so device memory bounds it: the live probed rows' bytes plus
// 4 bytes of id a slot read, and 8 bytes a slot written, over 3.35 TB/s.
// What the design does about it: one block of 256 threads per (query, chunk
// of its selected blocks, about 1024 slots), one thread a row, rows read as
// 16-byte vectors where the row width allows (VEC), the query held in shared
// memory and read by every thread at the same address (a broadcast). CUDA
// cores only: tensor cores, a fused select and blocks shared by the queries
// that probe them are later work.
//
// Launch: a plain C function, on the caller's stream, allocating nothing,
// returning cudaGetLastError() (or -1 for arguments it refuses).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define LR_NEG_INF (-3.4e38f)  // an empty slot's score (ops.topk.NEG_INF)
#define IVF_THREADS 256
#define IVF_SLOTS 1024         // slots a block scores, about

enum { OP_BF16 = 0, OP_BIN = 1, OP_F32 = 2, OP_I8 = 3, OP_I4 = 4 };

// the query in shared memory: fp32 (float kinds and binary), padded with
// zeros to the stored row's width, or int8 codes padded to 16 bytes
template <int KIND>
struct QueryType { using T = float; };
template <>
struct QueryType<OP_I8> { using T = int8_t; };
template <>
struct QueryType<OP_I4> { using T = int8_t; };

template <int KIND>
__device__ __forceinline__ float query_value(const void* q, size_t j) {
    if (KIND == OP_F32) return static_cast<const float*>(q)[j];
    return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[j]);
}

__device__ __forceinline__ int nibble_lo(uint32_t b) {
    return (int)(b << 28) >> 28;
}

__device__ __forceinline__ int nibble_hi(uint32_t b) {
    return (int)(b << 24) >> 28;
}

// the score of one row; `row` points at its first stored element
template <int KIND, bool VEC, bool EUCLID>
__device__ __forceinline__ float score_row(
        const void* row, const typename QueryType<KIND>::T* qs, int w, int d,
        float factor) {
    if constexpr (KIND == OP_BF16 || KIND == OP_F32) {
        float acc = 0.f, rsq = 0.f;
        if constexpr (VEC) {
            constexpr int PER = KIND == OP_BF16 ? 8 : 4;
            const uint4* v = static_cast<const uint4*>(row);
            for (int c = 0; c < w / PER; ++c) {
                const uint4 u = __ldg(v + c);
                float f[PER];
                if constexpr (KIND == OP_BF16) {
                    const __nv_bfloat162* h =
                        reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float2 p = __bfloat1622float2(h[j]);
                        f[2 * j] = p.x;
                        f[2 * j + 1] = p.y;
                    }
                } else {
                    const float* p = reinterpret_cast<const float*>(&u);
#pragma unroll
                    for (int j = 0; j < 4; ++j) f[j] = p[j];
                }
#pragma unroll
                for (int j = 0; j < PER; ++j) {
                    acc = fmaf(f[j], qs[c * PER + j], acc);
                    if (EUCLID) rsq = __fadd_rn(rsq, __fmul_rn(f[j], f[j]));
                }
            }
        } else {
            for (int j = 0; j < d; ++j) {
                const float f = KIND == OP_F32
                    ? static_cast<const float*>(row)[j]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(row)[j]);
                acc = fmaf(f, qs[j], acc);
                if (EUCLID) rsq = __fadd_rn(rsq, __fmul_rn(f, f));
            }
        }
        return EUCLID ? __fsub_rn(2.f * acc, rsq) : acc;
    } else if constexpr (KIND == OP_I8) {
        int acc = 0;
        if constexpr (VEC) {
            const uint4* v = static_cast<const uint4*>(row);
            const int* qw = reinterpret_cast<const int*>(qs);
            for (int c = 0; c < w / 16; ++c) {
                const uint4 u = __ldg(v + c);
                acc = __dp4a((int)u.x, qw[4 * c], acc);
                acc = __dp4a((int)u.y, qw[4 * c + 1], acc);
                acc = __dp4a((int)u.z, qw[4 * c + 2], acc);
                acc = __dp4a((int)u.w, qw[4 * c + 3], acc);
            }
        } else {
            const int8_t* r = static_cast<const int8_t*>(row);
            for (int j = 0; j < d; ++j) acc += (int)r[j] * (int)qs[j];
        }
        return __fmul_rn(__int2float_rn(acc), factor);
    } else if constexpr (KIND == OP_I4) {
        int acc = 0;
        if constexpr (VEC) {
            const uint4* v = static_cast<const uint4*>(row);
            for (int c = 0; c < w / 16; ++c) {
                const uint4 u = __ldg(v + c);
                const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
                for (int t = 0; t < 4; ++t) {
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const uint32_t byte = (words[t] >> (8 * b)) & 0xFF;
                        const int j = 2 * (16 * c + 4 * t + b);
                        acc += nibble_lo(byte) * (int)qs[j]
                             + nibble_hi(byte) * (int)qs[j + 1];
                    }
                }
            }
        } else {
            const uint8_t* r = static_cast<const uint8_t*>(row);
            for (int j = 0; j < w; ++j) {
                const uint32_t byte = r[j];
                acc += nibble_lo(byte) * (int)qs[2 * j]
                     + nibble_hi(byte) * (int)qs[2 * j + 1];
            }
        }
        return __fmul_rn(__int2float_rn(acc), factor);
    } else {  // OP_BIN: padded query dims are 0, so pad bits add +-0
        float acc = 0.f;
        const uint32_t* r = static_cast<const uint32_t*>(row);
        for (int c = 0; c < w; c += VEC ? 4 : 1) {
            uint32_t words[4];
            if constexpr (VEC) {
                const uint4 u = __ldg(reinterpret_cast<const uint4*>(r + c));
                words[0] = u.x; words[1] = u.y; words[2] = u.z; words[3] = u.w;
            } else {
                words[0] = __ldg(r + c);
            }
#pragma unroll
            for (int t = 0; t < (VEC ? 4 : 1); ++t) {
                const float* qv = qs + 32 * (c + t);
#pragma unroll
                for (int j = 0; j < 32; ++j) {
                    const float x = qv[j];
                    acc = __fadd_rn(acc, ((words[t] >> j) & 1u) ? x : -x);
                }
            }
        }
        return acc;
    }
}

template <int KIND, bool VEC, bool EUCLID>
__global__ void __launch_bounds__(IVF_THREADS) ivf_scan_kernel(
        const void* __restrict__ queries, const void* __restrict__ blocks,
        const int* __restrict__ block_ids, const int* __restrict__ sel,
        const int* __restrict__ mask, const float* __restrict__ factor_p,
        float* __restrict__ scores, int* __restrict__ ids, int S, int nblocks,
        int cap, int w, int d, int qlen, int mask_words, int chunk) {
    using QT = typename QueryType<KIND>::T;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    QT* qs = reinterpret_cast<QT*>(smem_raw);
    const int qi = blockIdx.y;
    // stage the query, zero-padded to qlen values
    for (int j = threadIdx.x; j < qlen; j += IVF_THREADS) {
        if constexpr (KIND == OP_I8 || KIND == OP_I4) {
            qs[j] = j < d ? static_cast<const int8_t*>(queries)[
                                (size_t)qi * d + j]
                          : (int8_t)0;
        } else {
            qs[j] = j < d ? query_value<KIND>(queries, (size_t)qi * d + j)
                          : 0.f;
        }
    }
    __syncthreads();
    const float factor =
        (KIND == OP_I8 || KIND == OP_I4) ? __ldg(factor_p) : 0.f;
    const int s0 = blockIdx.x * chunk;
    const int s1 = min(s0 + chunk, S);
    const int total = (s1 - s0) * cap;
    const size_t row_bytes =
        (size_t)w * (KIND == OP_BF16 ? 2 : (KIND == OP_F32 || KIND == OP_BIN)
                                               ? 4 : 1);
    for (int t = threadIdx.x; t < total; t += IVF_THREADS) {
        const int s = s0 + t / cap;
        const int i = t - (s - s0) * cap;
        const int b = __ldg(sel + (size_t)qi * S + s);
        const size_t out = ((size_t)qi * S + s) * cap + i;
        float sc = LR_NEG_INF;
        int id = -1;
        if (b >= 0 && b < nblocks) {
            const size_t slot = (size_t)b * cap + i;
            const int r = __ldg(block_ids + slot);
            bool ok = r >= 0;
            if (ok && mask != nullptr) {
                const int word = r >> 5;
                ok = word < mask_words &&
                     ((__ldg(mask + word) >> (r & 31)) & 1);
            }
            if (ok) {
                const void* row =
                    static_cast<const unsigned char*>(blocks) + slot * row_bytes;
                sc = score_row<KIND, VEC, EUCLID>(row, qs, w, d, factor);
                id = r;
            }
        }
        scores[out] = sc;
        ids[out] = id;
    }
}

template <int KIND, bool VEC, bool EUCLID>
static cudaError_t launch(const void* q, const void* blocks,
                          const int* block_ids, const int* sel,
                          const int* mask, const float* factor,
                          float* scores, int* ids, int nq, int S, int nblocks,
                          int cap, int w, int d, int qlen, size_t smem,
                          int mask_words, cudaStream_t stream) {
    const int chunk = cap >= IVF_SLOTS ? 1 : IVF_SLOTS / cap;
    const dim3 grid((S + chunk - 1) / chunk, nq);
    ivf_scan_kernel<KIND, VEC, EUCLID>
        <<<grid, IVF_THREADS, smem, stream>>>(
            q, blocks, block_ids, sel, mask, factor, scores, ids, S, nblocks,
            cap, w, d, qlen, mask_words, chunk);
    return cudaGetLastError();
}

template <int KIND, bool EUCLID>
static cudaError_t launch_vec(bool vec, const void* q, const void* blocks,
                              const int* block_ids, const int* sel,
                              const int* mask, const float* factor,
                              float* scores, int* ids, int nq, int S,
                              int nblocks, int cap, int w, int d, int qlen,
                              size_t smem, int mask_words,
                              cudaStream_t stream) {
    if (vec)
        return launch<KIND, true, EUCLID>(q, blocks, block_ids, sel, mask,
                                          factor, scores, ids, nq, S, nblocks,
                                          cap, w, d, qlen, smem, mask_words,
                                          stream);
    return launch<KIND, false, EUCLID>(q, blocks, block_ids, sel, mask,
                                       factor, scores, ids, nq, S, nblocks,
                                       cap, w, d, qlen, smem, mask_words,
                                       stream);
}

extern "C" {

const char* lr_ivf_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// kind: OP_*; vec: rows may load as 16-byte vectors (the row's bytes a
// multiple of 16, the base 16-byte aligned); w: stored elements a row (d,
// ceil(d/32) words, ceil(d/2) bytes); mask / factor may be null (factor is
// needed by OP_I8 / OP_I4).
int lr_ivf_scan(const void* queries, const void* blocks, const int* block_ids,
                const int* sel, const int* mask, const float* factor,
                float* scores, int* ids, int nq, int S, int nblocks, int cap,
                int w, int d, int mask_words, int kind, int euclid, int vec,
                void* stream_p) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    if (nq <= 0 || S <= 0 || cap <= 0 || w <= 0 || d <= 0 || nq > 65535)
        return -1;
    if (euclid && kind != OP_BF16 && kind != OP_F32) return -1;
    if ((kind == OP_I8 || kind == OP_I4) && factor == nullptr) return -1;
    int qlen;  // query values staged: the stored row's dims, padded
    size_t smem;
    switch (kind) {
        case OP_BF16:
        case OP_F32:
            qlen = d;
            smem = 4 * (size_t)qlen;
            break;
        case OP_BIN:
            qlen = 32 * w;
            smem = 4 * (size_t)qlen;
            break;
        case OP_I8:
            qlen = (d + 15) / 16 * 16;
            smem = qlen;
            break;
        case OP_I4:
            qlen = (2 * w + 31) / 32 * 32;
            smem = qlen;
            break;
        default:
            return -1;
    }
    if (smem > 48 * 1024) return -1;
    const bool v = vec != 0;
#define LR_IVF_ARGS queries, blocks, block_ids, sel, mask, factor, scores, \
    ids, nq, S, nblocks, cap, w, d, qlen, smem, mask_words, stream
    switch (kind) {
        case OP_BF16:
            return euclid ? launch_vec<OP_BF16, true>(v, LR_IVF_ARGS)
                          : launch_vec<OP_BF16, false>(v, LR_IVF_ARGS);
        case OP_F32:
            return euclid ? launch_vec<OP_F32, true>(v, LR_IVF_ARGS)
                          : launch_vec<OP_F32, false>(v, LR_IVF_ARGS);
        case OP_BIN:
            return launch_vec<OP_BIN, false>(v, LR_IVF_ARGS);
        case OP_I8:
            return launch_vec<OP_I8, false>(v, LR_IVF_ARGS);
        default:
            return launch_vec<OP_I4, false>(v, LR_IVF_ARGS);
    }
#undef LR_IVF_ARGS
}

}  // extern "C"
