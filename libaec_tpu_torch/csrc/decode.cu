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

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 8;    // blocks per thread block
constexpr int MAXWF = 66;   // bs * bps / 32 + 2 for bs <= 64, bps <= 32

// largest L in [0, 31] with popc(w >> (32 - L)) <= r: the MSB-first
// position of w's (r+1)-th set bit, 31 when there is none
__device__ __forceinline__ uint32_t select_from_msb(uint32_t w, uint32_t r) {
    uint32_t L = 0;
#pragma unroll
    for (uint32_t s = 16; s >= 1; s >>= 1)
        if ((uint32_t)__popc(w >> (32 - (L + s))) <= r) L += s;
    return L;
}

// value of lane - 1 for the first half (j = lane), of the previous sample
// for the second (j = lane + 32); `first` for j = 0
__device__ __forceinline__ void prev_pair(const uint32_t v[2], uint32_t first,
                                          int lane, uint32_t out[2]) {
    const uint32_t up0 = __shfl_up_sync(FULL, v[0], 1);
    const uint32_t up1 = __shfl_up_sync(FULL, v[1], 1);
    const uint32_t end0 = __shfl_sync(FULL, v[0], 31);
    out[0] = lane == 0 ? first : up0;
    out[1] = lane == 0 ? end0 : up1;
}

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
    uint32_t* w = s_win[warp];
    uint32_t* cum = s_cum[warp];

    const uint32_t fs_bit = fs_bit_a[blk], lsb_rel = lsb_rel_a[blk];
    const uint32_t meta = meta_a[blk];
    const uint32_t kind = meta & 3u, k = (meta >> 2) & 31u;
    const uint32_t ref = (meta >> 7) & 1u;

    // window -> shared memory, big-endian, word 0 masked; rank table
    const uint32_t* src = win + blk * wf;
    uint32_t carry = 0;
    for (int base = 0; base < wf; base += 32) {
        const int i = base + lane;
        uint32_t v = 0;
        if (i < wf) {
            v = __byte_perm(src[i], 0, 0x0123);
            if (i == 0) v &= FULL >> fs_bit;
            w[i] = v;
        }
        uint32_t c = __popc(v);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t n = __shfl_up_sync(FULL, c, o);
            if (lane >= o) c += n;
        }
        if (i < wf) cum[i] = carry + c;
        carry += __shfl_sync(FULL, c, 31);
    }
    __syncwarp();

    const uint32_t n_fs = kind == 2 ? bs - ref : (kind == 1 ? bs / 2 : 0);
    const uint32_t keff = kind == 3 ? (uint32_t)bps : (kind == 2 ? k : 0);
    uint32_t sel[2], field[2];
#pragma unroll
    for (int h = 0; h < 2; h++) {
        const uint32_t j = lane + 32 * h;
        // FS: the word holding the (j+1)-th set bit, then the bit
        int lo = 0, hi = wf;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (cum[mid] <= j) lo = mid + 1; else hi = mid;
        }
        const uint32_t ce = lo > 0 ? cum[lo - 1] : 0;
        const uint32_t ws = lo < wf ? w[lo] : 0;
        sel[h] = ((uint32_t)lo << 5) + select_from_msb(ws, j - ce) - fs_bit;
        // field of payload sample pj: bits [q, q + keff) of the window
        const uint32_t pj = j >= ref ? j - ref : 0;
        const uint32_t q = fs_bit + lsb_rel + pj * keff;
        const uint32_t qw = q >> 5;
        const uint32_t w0 = qw < (uint32_t)wf ? w[qw] : 0;
        const uint32_t w1 = qw + 1 < (uint32_t)wf ? w[qw + 1] : 0;
        const uint32_t f = __funnelshift_l(w1, w0, q & 31);
        field[h] = keff == 0 ? 0 : f >> (32 - keff);
    }
    uint32_t prev[2], fs[2], fs_prev[2];
    prev_pair(sel, FULL, lane, prev);
#pragma unroll
    for (int h = 0; h < 2; h++) {
        const uint32_t j = lane + 32 * h;
        fs[h] = j < n_fs ? sel[h] - prev[h] - 1 : 0;
    }
    prev_pair(fs, 0, lane, fs_prev);

#pragma unroll
    for (int h = 0; h < 2; h++) {
        const uint32_t j = lane + 32 * h;
        const uint32_t fsp = ref ? fs_prev[h] : fs[h];
        uint32_t o = (fsp << k) | field[h];
        // second extension: position j holds half of code j / 2
        const uint32_t m = __shfl_sync(FULL, fs[0], (lane >> 1) + 16 * h);
        if (kind == 1) {
            const float x = __fadd_rn(__fmul_rn(8.0f, __uint2float_rn(m)),
                                      1.0f);
            uint32_t i = __float2uint_rz(
                __fmul_rn(__fsub_rn(__fsqrt_rn(x), 1.0f), 0.5f));
#pragma unroll
            for (int c = 0; c < 2; c++) {
                i += (i + 1) * (i + 2) / 2 <= m ? 1 : 0;
                i -= i * (i + 1) / 2 > m ? 1 : 0;
            }
            const uint32_t vb = m - i * (i + 1) / 2;
            o = (j & 1) ? vb : i - vb;
        }
        if (ref && j == 0) o = ref_a[blk];
        if (j < (uint32_t)bs) out[blk * bs + j] = o;
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
