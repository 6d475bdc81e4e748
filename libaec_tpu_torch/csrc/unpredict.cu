// Inverse predictor and byte layout: mapped deltas -> samples or bytes.
//
// Two entry points over one slab design:
//
// aec_unpredict_swizzle replaces unpredict_swizzle_tile_kernel
// (libaec_tpu/kernels/unpredict_pallas.py:83, entry
// unpredict_swizzle_rsis_pallas :205).  For deltas u32 [n_rsi, S] it
// computes the bytes of each RSI's samples in put_* order (decode.c:
// 144-189), MSB or LSB first, uint8 [n_rsi, S * bsz] for 1-, 2-, 3- and
// 4-byte samples.  With preprocessing off (pp = 0) it is the byte layout
// alone: for 3-byte samples that is the twin of samples_to_bytes_device
// (libaec_tpu/ops/unpredict.py:67), the XLA pass the JAX package runs
// after the kernel below.
//
// aec_unpredict_rsis replaces unpredict_tile_kernel (libaec_tpu/kernels/
// unpredict_pallas.py:22, entry unpredict_rsis_pallas :252): the inverse
// predictor alone, deltas u32 [n_rsi, S] -> samples u32 [n_rsi, S].  The
// JAX package runs it for 3-byte samples, whose layout (4 samples -> 3
// words) its fused kernel does not cover.
//
// The inverse unit-delay predictor (decode.c:67-141) is serial within an
// RSI and independent across RSIs (each starts from its reference
// sample).  The TPU kernels put RSIs on lanes and walk sample slabs in
// VMEM; here one thread owns one RSI and walks its S samples.  Rows are
// S * 4 bytes apart, so direct per-thread loads and stores would not
// coalesce: a warp stages a [32 RSI x SL sample] slab in shared memory
// (row loads with lanes on consecutive samples, issued as asynchronous
// copies so that they are all in flight together), each lane runs the
// recurrence over its row and writes its result into a shared output
// slab (its bytes, or its samples in place), and the warp stores that
// slab row by row (32-bit words when the rows are word-aligned, bytes
// otherwise).  Rows are padded by one word, so neither the row-wise nor
// the column-wise accesses conflict on banks.  A 3-byte row of SL
// samples is 96 words, within the 129-word output row.
//
// Paths, as unpredict_pallas.py:103-154: preprocessing off is a pure
// byte layout; otherwise the first sample of an RSI is its reference
// (sign-extended for signed data) and the rest follow the unsigned path,
// or the signed one when xmin != 0.  The signed path's int32 arithmetic
// wraps in JAX; signed overflow is undefined in C++, so it runs on
// uint32_t bit patterns, which wrap the same way.
//
// Bound on this card: one warp per SM walks S / SL slabs, and each slab
// costs 32 row loops of loads and of stores besides its SL serial steps
// (the layout-only path, with no serial chain, takes nearly as long).  A
// 512-RSI chunk gives 512 threads (16 warps) in all, so the card is
// mostly idle.  The two-kernel route for 3-byte samples pays the slab
// loops twice and moves the samples through device memory once more.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "unpredict_step.cuh"

namespace {

// The warp's slab of deltas, rows r0.. and columns s0.., into tin.
__device__ __forceinline__ void stage_slab(uint32_t (*tin)[SL + 1],
                                           const uint32_t* __restrict__ d,
                                           long long r0, int rows,
                                           long long S, long long s0,
                                           int len, int lane) {
    // asynchronous copies: the slab's loads are all in flight at once
    for (int r = 0; r < rows; r++) {
        const uint32_t* src = d + (r0 + r) * S + s0;
        for (int i = lane; i < len; i += 32)
            __pipeline_memcpy_async(&tin[r][i], &src[i], sizeof(uint32_t));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
}

template <int BSZ>
__global__ void unpredict_swizzle_kernel(const uint32_t* __restrict__ d,
                                         uint8_t* __restrict__ out,
                                         Params p) {
    __shared__ uint32_t tin[32][SL + 1];
    __shared__ uint32_t tout[32][SL + 1];
    const int lane = threadIdx.x;
    const long long r0 = (long long)blockIdx.x * 32;
    const int rows = (int)(p.n_rsi - r0 < 32 ? p.n_rsi - r0 : 32);
    const long long S = p.S, row_bytes = S * BSZ;
    uint8_t* mine = reinterpret_cast<uint8_t*>(tout[lane]);
    uint32_t last = 0;
    for (long long s0 = 0; s0 < S; s0 += SL) {
        const int len = (int)(S - s0 < SL ? S - s0 : SL);
        stage_slab(tin, d, r0, rows, S, s0, len, lane);
        if (lane < rows) {
            for (int i = 0; i < len; i++) {
                const uint32_t v = unpredict_one(last, tin[lane][i], s0 + i,
                                                 p);
                last = v;
                put_sample<BSZ>(mine, i, v, p.msb);
            }
        }
        __syncwarp();
        const int nbytes = len * BSZ;
        for (int r = 0; r < rows; r++)
            store_row(out + (r0 + r) * row_bytes + s0 * BSZ, tout[r], nbytes,
                      p.words, lane);
        __syncwarp();
    }
}

// The samples themselves, written back over the staged deltas.
__global__ void unpredict_rsis_kernel(const uint32_t* __restrict__ d,
                                      uint32_t* __restrict__ out, Params p) {
    __shared__ uint32_t tin[32][SL + 1];
    const int lane = threadIdx.x;
    const long long r0 = (long long)blockIdx.x * 32;
    const int rows = (int)(p.n_rsi - r0 < 32 ? p.n_rsi - r0 : 32);
    const long long S = p.S;
    uint32_t last = 0;
    for (long long s0 = 0; s0 < S; s0 += SL) {
        const int len = (int)(S - s0 < SL ? S - s0 : SL);
        stage_slab(tin, d, r0, rows, S, s0, len, lane);
        if (lane < rows) {
            for (int i = 0; i < len; i++) {
                last = unpredict_one(last, tin[lane][i], s0 + i, p);
                tin[lane][i] = last;
            }
        }
        __syncwarp();
        for (int r = 0; r < rows; r++) {
            uint32_t* dst = out + (r0 + r) * S + s0;
            for (int i = lane; i < len; i += 32) dst[i] = tin[r][i];
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" int aec_unpredict_swizzle(const void* deltas, void* out,
                                     long long n_rsi, int S, int bsz, int msb,
                                     int pp, int signed_path, int sign_ext,
                                     unsigned xmax, unsigned med,
                                     unsigned sign_bit, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    // word stores need every row and slab to start on a 4-byte boundary
    const int words = ((long long)S * bsz) % 4 == 0;
    const Params p{n_rsi, S, msb, pp, signed_path, sign_ext, words,
                   xmax, med, sign_bit};
    const unsigned grid = (unsigned)((n_rsi + 31) / 32);
    const uint32_t* d = (const uint32_t*)deltas;
    uint8_t* o = (uint8_t*)out;
    switch (bsz) {
        case 1: unpredict_swizzle_kernel<1><<<grid, 32, 0, s>>>(d, o, p); break;
        case 2: unpredict_swizzle_kernel<2><<<grid, 32, 0, s>>>(d, o, p); break;
        case 3: unpredict_swizzle_kernel<3><<<grid, 32, 0, s>>>(d, o, p); break;
        case 4: unpredict_swizzle_kernel<4><<<grid, 32, 0, s>>>(d, o, p); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int aec_unpredict_rsis(const void* deltas, void* out,
                                  long long n_rsi, int S, int signed_path,
                                  int sign_ext, unsigned xmax, unsigned med,
                                  unsigned sign_bit, void* stream) {
    const Params p{n_rsi, S, 0, 1, signed_path, sign_ext, 1,
                   xmax, med, sign_bit};
    const unsigned grid = (unsigned)((n_rsi + 31) / 32);
    unpredict_rsis_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)deltas, (uint32_t*)out, p);
    return (int)cudaGetLastError();
}
