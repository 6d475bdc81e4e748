// The inverse predictor's per-sample step, a warp's verified scan over a
// group of samples, and the byte layout, shared by unpredict.cu (kernels 4
// and 5) and decode_fused.cu (kernel 6).
#pragma once
#include <cstdint>

namespace {

struct Params {
    long long n_rsi;
    int S, msb, pp, signed_path, sign_ext;
    uint32_t xmax, med, sign_bit;
};

__device__ __forceinline__ uint32_t half_of(uint32_t d) {
    return (d >> 1) + (d & 1);
}

__device__ __forceinline__ uint32_t zig_of(uint32_t d) {
    return (d >> 1) ^ ~((d & 1) - 1);
}

// The step is the serial chain of every walk, so both forms keep the
// operations that depend on `last` few and shallow.
//
// Unsigned (decode.c:111-141): the residual fits if |residual| rounded up
// is at most the distance from `last` to the nearer end of the range, 0
// below med and xmax above; else d is an escape value counted from that
// end.  xmax ^ last flips every bit from med down, so the distance to the
// nearer end is the smaller of last and xmax ^ last, for any u32 `last`.
__device__ __forceinline__ uint32_t step_unsigned(uint32_t last, uint32_t d,
                                                  const Params& p) {
    const uint32_t room = min(last, last ^ p.xmax);
    const uint32_t esc = (last & p.med) ? p.xmax ^ d : d;
    return half_of(d) <= room ? last + zig_of(d) : esc;
}

// int32 step of unpredict_pallas.py:119-127 on bit patterns (xmax is
// sxmax's bit pattern): the room is xmax - last for last >= 0 and
// xmax + last + 1 = xmax - ~last for last < 0, and the larger of last and
// ~last as int32 is the one that is not negative.
__device__ __forceinline__ uint32_t step_signed(uint32_t last, uint32_t d,
                                                const Params& p) {
    const uint32_t away = (uint32_t)max((int32_t)last, (int32_t)~last);
    const uint32_t esc = (int32_t)last < 0 ? d - p.xmax - 1u : p.xmax - d;
    return half_of(d) <= p.xmax - away ? last + zig_of(d) : esc;
}

// Sample v's BSZ bytes at position i of a row of output bytes, in put_*
// order (decode.c:144-189).
template <int BSZ>
__device__ __forceinline__ void put_sample(uint8_t* row, int i, uint32_t v,
                                           int msb) {
#pragma unroll
    for (int b = 0; b < BSZ; b++)
        row[i * BSZ + b] = (uint8_t)(v >> (8 * (msb ? BSZ - 1 - b : b)));
}

// Sample v's BSZ bytes in put_* order, as the little-endian integer that
// holds them at its low end: stored as it is, its bytes land in order.
template <int BSZ>
__device__ __forceinline__ uint32_t sample_bytes(uint32_t v, int msb) {
    if (BSZ == 4) return msb ? __byte_perm(v, 0, 0x0123) : v;
    if (BSZ == 3) return msb ? __byte_perm(v, 0, 0x4012) : v & 0xFFFFFFu;
    if (BSZ == 2) return msb ? __byte_perm(v, 0, 0x4401) : v & 0xFFFFu;
    return v & 0xFFu;
}

// Four samples' bytes in put_* order as BSZ little-endian words.
template <int BSZ>
__device__ __forceinline__ void pack4(const uint32_t* v, int msb,
                                      uint32_t* w) {
    uint32_t t[4];
#pragma unroll
    for (int q = 0; q < 4; q++) t[q] = sample_bytes<BSZ>(v[q], msb);
    if (BSZ == 4) {
#pragma unroll
        for (int q = 0; q < 4; q++) w[q] = t[q];
    } else if (BSZ == 3) {
        w[0] = t[0] | (t[1] << 24);
        w[1] = (t[1] >> 8) | (t[2] << 16);
        w[2] = (t[2] >> 16) | (t[3] << 8);
    } else if (BSZ == 2) {
        w[0] = t[0] | (t[1] << 16);
        w[1] = t[2] | (t[3] << 16);
    } else {
        w[0] = t[0] | (t[1] << 8) | (t[2] << 16) | (t[3] << 24);
    }
}

// BSZ words to dst, which is aligned to the vector that holds them (4, 8
// or 16 bytes; 4 for the 12 bytes of BSZ 3).
template <int BSZ>
__device__ __forceinline__ void store_words(uint8_t* __restrict__ dst,
                                            const uint32_t* w) {
    if (BSZ == 4) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if (BSZ == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
        uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
        for (int q = 0; q < BSZ; q++) dw[q] = w[q];
    }
}

enum ChainPath { LAYOUT_ONLY = 0, UNSIGNED_PATH = 1, SIGNED_PATH = 2 };

template <int PATH>
__device__ __forceinline__ uint32_t step_of(uint32_t last, uint32_t d,
                                            const Params& p) {
    return PATH == SIGNED_PATH ? step_signed(last, d, p)
                               : step_unsigned(last, d, p);
}

constexpr int SCAN_V = 8;            // consecutive samples a lane holds
constexpr int SCAN_G = 32 * SCAN_V;  // samples a warp scans at once
constexpr int SCAN_REPAIRS = 8;      // repairs a group may take

// A warp's verified scan over SCAN_G consecutive deltas of one RSI, in two
// halves: lane l holds deltas d[k] of positions l * SCAN_V + k and gets
// their samples x[k], what the predictor's SCAN_G steps give.  `first`
// says that position 0 is the RSI's first sample, its reference.  Deltas
// past the end of the RSI are passed as 0: they repeat the last sample and
// never escape.
//
// scan_guess: where no delta escapes, the samples are the sample before
// the group plus the prefix sum of the residuals zig(d), which the warp
// computes in log steps.  It leaves that sum in x, short of the sample
// before the group, so it depends on no other group: a caller can run it
// for the next group while this one is verified.
//
// scan_verify: `carry` brings the sample before position 0 in and takes
// the group's last one out (the same in every lane).  Every lane evaluates
// the step itself on its guessed predecessor and compares with its guess.
// By induction every guess before the first mismatch is the true sample,
// and at the first mismatch the step's value is the true one; all later
// guesses are off by the same difference, so the repair adds it to them
// and checks again.  The guessed sums may wrap: a guess is never trusted
// past its first mismatch, so the check must stay the step function and
// not a range test.
//
// A group takes at most SCAN_REPAIRS repairs, and none more once more
// lanes mismatch than it has repairs left (noise: about every other delta
// escapes).  The rest is a serial walk: every lane walks its own SCAN_V
// samples from the last sample of the lane before, round after round,
// until no lane's last sample changes.  Lane l walks from a true sample
// in round l at the latest, so the rounds number 32 at most, one chain of
// SCAN_G steps, and fewer where escapes make a walk forget its start.
__device__ __forceinline__ void scan_guess(const uint32_t (&d)[SCAN_V],
                                           uint32_t (&x)[SCAN_V], bool first,
                                           const Params& p, int lane) {
    constexpr unsigned FULL = 0xFFFFFFFFu;
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_V; k++) {
        uint32_t z = zig_of(d[k]);
        if (k == 0 && first && lane == 0)
            z = p.sign_ext ? (d[0] ^ p.sign_bit) - p.sign_bit : d[0];
        sum += z;
        x[k] = sum;
    }
    uint32_t inc = sum;  // inclusive scan of the lanes' totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += t;
    }
#pragma unroll
    for (int k = 0; k < SCAN_V; k++) x[k] += inc - sum;
}

template <int PATH>
__device__ __forceinline__ void scan_verify(const uint32_t (&d)[SCAN_V],
                                            uint32_t (&x)[SCAN_V], bool first,
                                            uint32_t& carry, const Params& p,
                                            int lane) {
    constexpr unsigned FULL = 0xFFFFFFFFu;
    const bool ref_here = first && lane == 0;
    if (first) carry = 0;  // the reference is its own start
#pragma unroll
    for (int k = 0; k < SCAN_V; k++) x[k] += carry;

    // the sample before this lane's first, as guessed so far
    uint32_t pred = __shfl_up_sync(FULL, x[SCAN_V - 1], 1);
    if (lane == 0) pred = carry;
    bool walk = false;
    for (int rep = 0;; rep++) {
        // the check: the step on each guessed predecessor (diff: the
        // step's value at the lane's first mismatch, less the guess there)
        uint32_t wrong = 0, diff = 0, prev = pred;
#pragma unroll
        for (int k = 0; k < SCAN_V; k++) {
            const uint32_t want = step_of<PATH>(prev, d[k], p);
            if (want != x[k] && !(k == 0 && ref_here)) {
                if (!wrong) diff = want - x[k];
                wrong |= 1u << k;
            }
            prev = x[k];
        }
        const unsigned bad = __ballot_sync(FULL, wrong != 0);
        if (!bad) break;
        if (__popc(bad) > SCAN_REPAIRS - rep) {
            walk = true;
            break;
        }
        // the repair at the first mismatch, lane L, position K within it:
        // the difference goes to that guess and every later one
        const int L = __ffs(bad) - 1;
        const int K = __ffs(__shfl_sync(FULL, wrong, L)) - 1;
        diff = __shfl_sync(FULL, diff, L);
#pragma unroll
        for (int k = 0; k < SCAN_V; k++)
            if (lane > L || (lane == L && k >= K)) x[k] += diff;
        pred = __shfl_up_sync(FULL, x[SCAN_V - 1], 1);
        if (lane == 0) pred = carry;
    }
    while (walk) {
        uint32_t cur = pred;
#pragma unroll
        for (int k = 0; k < SCAN_V; k++) {
            if (!(k == 0 && ref_here)) x[k] = step_of<PATH>(cur, d[k], p);
            cur = x[k];
        }
        uint32_t next = __shfl_up_sync(FULL, cur, 1);
        if (lane == 0) next = carry;
        walk = __ballot_sync(FULL, next != pred) != 0;
        pred = next;
    }
    carry = __shfl_sync(FULL, x[SCAN_V - 1], 31);
}

// Lane's SCAN_V samples of group g of a row of S samples to the row's
// output: the samples themselves (BSZ 0) or their BSZ bytes each.  `vec`
// says that the row starts on a 16-byte boundary and S is a multiple of 4,
// so that four samples go out as one vector; otherwise they go one by one.
template <int BSZ>
__device__ __forceinline__ void store_group(uint8_t* __restrict__ row, int S,
                                            int g, int lane, int vec, int msb,
                                            const uint32_t (&x)[SCAN_V]) {
    const int base = g * SCAN_G + lane * SCAN_V;
    if (vec) {
#pragma unroll
        for (int h = 0; h < SCAN_V; h += 4) {
            if (base + h >= S) break;
            if constexpr (BSZ == 0) {
                store_words<4>(row + (long long)(base + h) * 4, &x[h]);
            } else {
                uint32_t w[BSZ];
                pack4<BSZ>(&x[h], msb, w);
                store_words<BSZ>(row + (long long)(base + h) * BSZ, w);
            }
        }
    } else {
#pragma unroll
        for (int k = 0; k < SCAN_V; k++) {
            if (base + k >= S) break;
            if constexpr (BSZ == 0)
                reinterpret_cast<uint32_t*>(row)[base + k] = x[k];
            else
                put_sample<BSZ>(row, base + k, x[k], msb);
        }
    }
}

}  // namespace
