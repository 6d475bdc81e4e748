// One block's payload parse, shared by decode.cu (kernel 3) and
// decode_fused.cu (kernel 6): a warp turns one block's payload window and
// records into its bs mapped deltas, two per lane.
#pragma once
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
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

// The warp's block: window `src` (wf raw stream words) and its records ->
// o[h], the mapped delta of sample j = lane + 32 * h (meaningful for
// j < bs).  w and cum are the warp's own wf words of shared memory; the
// caller runs __syncwarp() before it hands them to the next block.
__device__ __forceinline__ void decode_block(
        const uint32_t* __restrict__ src, uint32_t* w, uint32_t* cum,
        uint32_t fs_bit, uint32_t lsb_rel, uint32_t meta, uint32_t ref_sample,
        int wf, int bs, int bps, int lane, uint32_t o[2]) {
    const uint32_t kind = meta & 3u, k = (meta >> 2) & 31u;
    const uint32_t ref = (meta >> 7) & 1u;

    // window -> shared memory, big-endian, word 0 masked; rank table
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
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t n = __shfl_up_sync(FULL, c, d);
            if (lane >= d) c += n;
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
        uint32_t v = (fsp << k) | field[h];
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
            v = (j & 1) ? vb : i - vb;
        }
        o[h] = (ref && j == 0) ? ref_sample : v;
    }
}

}  // namespace
