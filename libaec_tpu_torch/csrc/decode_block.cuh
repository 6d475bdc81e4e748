// One block's payload parse, shared by decode.cu (kernel 3) and
// decode_fused.cu (kernel 6): a warp turns one block's payload window and
// records into its bs mapped deltas, two per lane.
//
// The parse is bound by instruction slots, not bytes, so it does only what
// the block's kind needs; the kind is the same on every lane of the warp:
//   - kind 0 (a zero block) has no payload: zeros and the reference, and
//     the window is not read;
//   - kind 3 (uncompressed) is fields alone: no rank table, no search;
//   - kinds 1 (second extension) and 2 (split): FS value j ends at the
//     payload's (j+1)-th set bit, and the first n_fs set bits lie in the FS
//     region at the payload's start (2-6 words on smooth data, where the
//     bucketed window may be 34).  Lane l tests bit l of each word of the
//     region and writes a set bit's position at its rank, so the region
//     costs a few instructions a word; sample j then reads position j.
//     (A per-sample search of a rank table and a 5-step bisection of the
//     word cost ~110 instructions a sample pair even over the region
//     alone.)  The staging stops once the region's set bits are counted:
//     the record's lsb_rel bounds the region of a split block, but a
//     second-extension record has lsb_rel 0;
//   - the window is staged in shared memory only as far as the FS region
//     and the fields reach.
#pragma once
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAXWF = 66;   // bs * bps / 32 + 2 for bs <= 64, bps <= 32

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
// j < bs).  w and pos are the warp's own MAXWF words of shared memory (the
// staged window, the FS positions); the caller runs __syncwarp() before it
// hands them to the next block.
__device__ __forceinline__ void decode_block(
        const uint32_t* __restrict__ src, uint32_t* w, uint32_t* pos,
        uint32_t fs_bit, uint32_t lsb_rel, uint32_t meta, uint32_t ref_sample,
        int wf, int bs, int bps, int lane, uint32_t o[2]) {
    const uint32_t kind = meta & 3u, k = (meta >> 2) & 31u;
    const uint32_t ref = (meta >> 7) & 1u;
    if (kind == 0) {  // a zero block
        o[0] = ref && lane == 0 ? ref_sample : 0u;
        o[1] = 0u;
        return;
    }
    const uint32_t n_fs = kind == 2 ? bs - ref : (kind == 1 ? bs / 2 : 0);
    const uint32_t keff = kind == 3 ? (uint32_t)bps : (kind == 2 ? k : 0);
    const uint32_t q0 = fs_bit + lsb_rel;  // the first field's bit
    // the fields read words [0, nfield): up to the one after their end (a
    // word past that holds none of their bits)
    int nfield = 0;
    if (keff) {
        nfield = (int)((q0 + (bs - ref) * keff) >> 5) + 2;
        if (nfield > wf) nfield = wf;
    }

    // window -> shared memory, big-endian, word 0 masked: the fields'
    // words and, for kinds 1 and 2, whole chunks of 32 words until they
    // hold n_fs set bits
    uint32_t carry = 0;
    for (int base = 0; base < wf && (base < nfield || carry < n_fs);
         base += 32) {
        const int i = base + lane;
        uint32_t v = 0;
        if (i < wf) {
            v = __byte_perm(src[i], 0, 0x0123);
            if (i == 0) v &= FULL >> fs_bit;
            w[i] = v;
        }
        if (carry < n_fs) carry += __reduce_add_sync(FULL, __popc(v));
    }
    __syncwarp();

    uint32_t sel[2] = {0u, 0u}, field[2] = {0u, 0u};
    if (n_fs) {
        // FS value j ends at the (j+1)-th set bit: lane l tests bit l of
        // each word, from word 0 until n_fs set bits have passed, and
        // writes a set bit's payload position at its rank
        uint32_t before = 0;
        for (int i = 0; before < n_fs && i < wf; i++) {
            const uint32_t word = w[i];
            if ((word << lane) >> 31) {
                const uint32_t r = before + __popc(word & ~(FULL >> lane));
                if (r < n_fs) pos[r] = ((uint32_t)i << 5) + lane - fs_bit;
            }
            before += __popc(word);
        }
        __syncwarp();
    }
#pragma unroll
    for (int h = 0; h < 2; h++) {
        const uint32_t j = lane + 32 * h;
        if (j < n_fs) sel[h] = pos[j];
        if (keff) {
            // field of payload sample pj: bits [q, q + keff) of the window
            const uint32_t pj = j >= ref ? j - ref : 0;
            const uint32_t q = q0 + pj * keff;
            const uint32_t qw = q >> 5;
            const uint32_t w0 = qw < (uint32_t)nfield ? w[qw] : 0;
            const uint32_t w1 = qw + 1 < (uint32_t)nfield ? w[qw + 1] : 0;
            field[h] = __funnelshift_l(w1, w0, q & 31) >> (32 - keff);
        }
    }
    if (kind == 3) {  // uncompressed: the fields are the deltas
#pragma unroll
        for (int h = 0; h < 2; h++)
            o[h] = ref && lane + 32 * h == 0 ? ref_sample : field[h];
        return;
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
        if (kind == 1) {
            // second extension: position j holds half of code j / 2
            const uint32_t m = __shfl_sync(FULL, fs[0], (lane >> 1) + 16 * h);
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
