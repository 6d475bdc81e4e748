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
// warp decodes one block at a time (decode_block.cuh):
//   - the window goes to shared memory, byte-swapped to big-endian words
//     (__byte_perm) with the bits before the payload masked in word 0, as
//     far as the FS region and the fields reach;
//   - FS value j ends at the payload's (j+1)-th set bit: lane l tests bit
//     l of each word of the FS region and writes a set bit's position at
//     its rank (a __popc of the bits before it), so lane j (and j + 32)
//     reads its bit's position, where the TPU kernel counts and bisects
//     (decode_pallas.py:126-129); FS value j is the distance to the
//     previous lane's bit, minus one;
//   - the k-bit / raw field of sample j is one __funnelshift_l of two
//     window words;
//   - second-extension codes unpair in closed form (float sqrt, then two
//     integer corrections, decode_pallas.py:149-165), with the float steps
//     rounded one by one (__fmul_rn / __fadd_rn: no FMA contraction), so
//     the result is the plain version's for every code;
//   - a reference block shifts its payload by one and stitches the
//     reference sample at position 0;
//   - zero blocks skip all of it, uncompressed blocks the table and search.
// A warp takes BLOCKS_PER_WARP consecutive blocks: its lanes load their
// records with one coalesced load per record array, and each block takes
// its four from the lanes by shuffle.  Stores of [NB, bs] are coalesced: a
// warp writes its block's bs words.
//
// Bound on this card: instruction slots.  Device-memory traffic is the records
// and the window words the parse needs read once and 4 * bs bytes written
// per block, some 12 us at the bench chunk; the parse was ~500
// instructions a block, most of them a rank table and a binary search
// over the whole window (up to 34 words at the bench config) and a
// bisection per sample, where the answer lies in the first 2-6 words.  The FS positions now cost a few instructions a word
// of that region, and a block's kind decides what runs.
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_block.cuh"

namespace {

constexpr int WARPS = 8;            // warps per thread block
constexpr int BLOCKS_PER_WARP = 4;  // consecutive blocks a warp decodes

__global__ void __launch_bounds__(32 * WARPS) decode_blocks_kernel(
        const uint32_t* __restrict__ win,
        const uint32_t* __restrict__ fs_bit_a,
        const uint32_t* __restrict__ lsb_rel_a,
        const uint32_t* __restrict__ meta_a,
        const uint32_t* __restrict__ ref_a, uint32_t* __restrict__ out,
        long long nb, int wf, int bs, int bps) {
    __shared__ uint32_t s_win[WARPS][MAXWF];
    __shared__ uint32_t s_pos[WARPS][MAXWF];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long first =
        ((long long)blockIdx.x * WARPS + warp) * BLOCKS_PER_WARP;
    if (first >= nb) return;  // uniform across the warp
    const int n = nb - first < BLOCKS_PER_WARP ? (int)(nb - first)
                                               : BLOCKS_PER_WARP;
    // lane b < n holds block first + b's records
    uint32_t r_fs = 0, r_lsb = 0, r_meta = 0, r_ref = 0;
    if (lane < n) {
        r_fs = fs_bit_a[first + lane];
        r_lsb = lsb_rel_a[first + lane];
        r_meta = meta_a[first + lane];
        r_ref = ref_a[first + lane];
    }
    for (int b = 0; b < n; b++) {
        const long long blk = first + b;
        const uint32_t fs_bit = __shfl_sync(FULL, r_fs, b);
        const uint32_t lsb_rel = __shfl_sync(FULL, r_lsb, b);
        const uint32_t meta = __shfl_sync(FULL, r_meta, b);
        const uint32_t ref = __shfl_sync(FULL, r_ref, b);
        uint32_t o[2] = {0u, 0u};
        decode_block(win + blk * wf, s_win[warp], s_pos[warp], fs_bit,
                     lsb_rel, meta, ref, wf, bs, bps, lane, o);
#pragma unroll
        for (int h = 0; h < 2; h++) {
            const int j = lane + 32 * h;
            if (j < bs) out[blk * bs + j] = o[h];
        }
        __syncwarp();  // the next block rewrites s_win, s_pos
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
    const long long per = (long long)WARPS * BLOCKS_PER_WARP;
    const unsigned grid = (unsigned)((nb + per - 1) / per);
    decode_blocks_kernel<<<grid, 32 * WARPS, 0, s>>>(
        (const uint32_t*)win, (const uint32_t*)fs_bit,
        (const uint32_t*)lsb_rel, (const uint32_t*)meta,
        (const uint32_t*)ref_sample, (uint32_t*)out, nb, wf, bs, bps);
    return (int)cudaGetLastError();
}
