// Decode kernel: per-block payload windows -> mapped deltas.
//
// Replaces decode_tile_kernel (libaec_tpu/kernels/decode_pallas.py:53,
// entry decode_payload_pallas :200).  It computes the same output,
// deltas u32 [NB, bs], from the raw payload windows u32 [NB, Wf] that the
// native scan memcpys out of the stream (any bucket width Wf <= 66) and
// the per-block records fs_bit, lsb_rel, meta = kind | k << 2 | ref << 7
// and ref_sample.
//
// The TPU kernel puts blocks on lanes and resolves every sample of a tile
// by dense selects over the window axis (no gathers, which Mosaic lowers
// poorly).  Hopper gathers from shared memory at no such cost, so here one
// warp decodes one block:
//   - the window goes to shared memory, byte-swapped to big-endian words
//     (__byte_perm) with the bits before the payload masked in word 0;
//   - __popc per word and a warp inclusive scan give the rank table;
//   - lane j (and j + 32) finds the word holding the payload's (j+1)-th
//     set bit by binary search over the table, then the bit by the same
//     5-step popcount bisection as decode_pallas.py:126-129; FS value j is
//     the distance to the previous lane's bit, minus one;
//   - the k-bit / raw field of sample j is one __funnelshift_l of two
//     window words;
//   - second-extension codes unpair in closed form (float sqrt, then two
//     integer corrections, decode_pallas.py:149-165), with the float steps
//     rounded one by one (__fmul_rn / __fadd_rn: no FMA contraction), so
//     the result is the plain version's for every code;
//   - a reference block shifts its payload by one and stitches the
//     reference sample at position 0.
// Stores of [NB, bs] are coalesced: a warp writes its block's bs words.
//
// Bound on this card: latency of the per-block dependency chain (load,
// scan, search, bisection); device-memory traffic is the windows and
// records read once and 4 * bs bytes written per block.
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_block.cuh"

namespace {

constexpr int WARPS = 8;    // blocks per thread block

__global__ void decode_blocks_kernel(const uint32_t* __restrict__ win,
                                     const uint32_t* __restrict__ fs_bit_a,
                                     const uint32_t* __restrict__ lsb_rel_a,
                                     const uint32_t* __restrict__ meta_a,
                                     const uint32_t* __restrict__ ref_a,
                                     uint32_t* __restrict__ out, long long nb,
                                     int wf, int bs, int bps) {
    __shared__ uint32_t s_win[WARPS][MAXWF];
    __shared__ uint32_t s_cum[WARPS][MAXWF];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long blk = (long long)blockIdx.x * WARPS + warp;
    if (blk >= nb) return;  // uniform across the warp
    uint32_t o[2];
    decode_block(win + blk * wf, s_win[warp], s_cum[warp], fs_bit_a[blk],
                 lsb_rel_a[blk], meta_a[blk], ref_a[blk], wf, bs, bps, lane,
                 o);
#pragma unroll
    for (int h = 0; h < 2; h++) {
        const int j = lane + 32 * h;
        if (j < bs) out[blk * bs + j] = o[h];
    }
}

}  // namespace

extern "C" int aec_decode_blocks(const void* win, const void* fs_bit,
                                 const void* lsb_rel, const void* meta,
                                 const void* ref_sample, void* out,
                                 long long nb, int wf, int bs, int bps,
                                 void* stream) {
    if (wf < 1 || wf > MAXWF || bs < 1 || bs > 64) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = (unsigned)((nb + WARPS - 1) / WARPS);
    decode_blocks_kernel<<<grid, 32 * WARPS, 0, s>>>(
        (const uint32_t*)win, (const uint32_t*)fs_bit,
        (const uint32_t*)lsb_rel, (const uint32_t*)meta,
        (const uint32_t*)ref_sample, (uint32_t*)out, nb, wf, bs, bps);
    return (int)cudaGetLastError();
}
