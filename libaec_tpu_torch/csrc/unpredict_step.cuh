// The inverse predictor's per-sample step and the slab's byte layout,
// shared by unpredict.cu (kernels 4 and 5) and decode_fused.cu (kernel 6).
#pragma once
#include <cstdint>

namespace {

constexpr int SL = 128;  // samples per slab

struct Params {
    long long n_rsi;
    int S, msb, pp, signed_path, sign_ext, words;
    uint32_t xmax, med, sign_bit;
};

__device__ __forceinline__ uint32_t half_of(uint32_t d) {
    return (d >> 1) + (d & 1);
}

__device__ __forceinline__ uint32_t zig_of(uint32_t d) {
    return (d >> 1) ^ ~((d & 1) - 1);
}

__device__ __forceinline__ uint32_t step_unsigned(uint32_t last, uint32_t d,
                                                  const Params& p) {
    const uint32_t mask = (last & p.med) ? p.xmax : 0u;
    return half_of(d) <= (mask ^ last) ? last + zig_of(d) : mask ^ d;
}

// int32 step of unpredict_pallas.py:119-127 on bit patterns (xmax is
// sxmax's bit pattern)
__device__ __forceinline__ uint32_t step_signed(uint32_t last, uint32_t d,
                                                const Params& p) {
    const bool neg = (int32_t)last < 0;
    const uint32_t lim = neg ? p.xmax + last + 1u : p.xmax - last;
    const uint32_t esc = neg ? d - p.xmax - 1u : p.xmax - d;
    return half_of(d) <= lim ? last + zig_of(d) : esc;
}

// Sample s of an RSI from its delta dv and the sample before it.
__device__ __forceinline__ uint32_t unpredict_one(uint32_t last, uint32_t dv,
                                                  long long s,
                                                  const Params& p) {
    if (!p.pp) return dv;
    if (s == 0) return p.sign_ext ? (dv ^ p.sign_bit) - p.sign_bit : dv;
    return p.signed_path ? step_signed(last, dv, p)
                         : step_unsigned(last, dv, p);
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
    if (BSZ == 2) return msb ? __byte_perm(v, 0, 0x4401) : v & 0xFFFFu;
    return v & 0xFFu;
}

enum ChainPath { LAYOUT_ONLY = 0, UNSIGNED_PATH = 1, SIGNED_PATH = 2 };

// One thread's walk over `len` consecutive deltas of its RSI, `in`, into
// the bytes of their samples at `out` (word-aligned; BSZ 1, 2 or 4): what
// len calls of unpredict_one and put_sample give.  `first` says that in[0]
// is the RSI's first sample, its reference; `last` carries the sample
// before in[0] in and the last one out.  The path is a template argument
// and the deltas come eight at a time, loaded before and stored after the
// eight dependent steps, so that nothing but the steps themselves is on
// the serial chain.
template <int BSZ, int PATH>
__device__ __forceinline__ void chain_run(const uint32_t* __restrict__ in,
                                          uint32_t* __restrict__ out, int len,
                                          bool first, uint32_t& last,
                                          const Params& p) {
    constexpr int B = 8, PER_WORD = 4 / BSZ;
    uint8_t* out_bytes = reinterpret_cast<uint8_t*>(out);
    int k = 0;
    for (; k + B <= len; k += B) {
        uint32_t d[B], v[B];
#pragma unroll
        for (int u = 0; u < B; u++) d[u] = in[k + u];
#pragma unroll
        for (int u = 0; u < B; u++) {
            if (PATH == LAYOUT_ONLY) {
                v[u] = d[u];
            } else {
                v[u] = PATH == SIGNED_PATH ? step_signed(last, d[u], p)
                                           : step_unsigned(last, d[u], p);
                if (u == 0 && first && k == 0)
                    v[u] = p.sign_ext ? (d[u] ^ p.sign_bit) - p.sign_bit
                                      : d[u];
                last = v[u];
            }
        }
#pragma unroll
        for (int w = 0; w < B / PER_WORD; w++) {
            uint32_t word = 0;
#pragma unroll
            for (int q = 0; q < PER_WORD; q++)
                word |= sample_bytes<BSZ>(v[w * PER_WORD + q], p.msb)
                    << (8 * BSZ * q);
            out[k / PER_WORD + w] = word;
        }
    }
    for (; k < len; k++) {  // a slab that ends short of eight samples
        uint32_t v = in[k];
        if (PATH != LAYOUT_ONLY) {
            v = PATH == SIGNED_PATH ? step_signed(last, v, p)
                                    : step_unsigned(last, v, p);
            if (first && k == 0)
                v = p.sign_ext ? (in[k] ^ p.sign_bit) - p.sign_bit : in[k];
            last = v;
        }
        put_sample<BSZ>(out_bytes, k, v, p.msb);
    }
}

// A warp stores nbytes of a shared output row to dst: 32-bit words when
// every row and slab starts on a 4-byte boundary, bytes otherwise.
__device__ __forceinline__ void store_row(uint8_t* __restrict__ dst,
                                          const uint32_t* row, int nbytes,
                                          int words, int lane) {
    if (words) {
        uint32_t* dw = reinterpret_cast<uint32_t*>(dst);
        for (int i = lane; i < nbytes / 4; i += 32) dw[i] = row[i];
    } else {
        const uint8_t* sb = reinterpret_cast<const uint8_t*>(row);
        for (int i = lane; i < nbytes; i += 32) dst[i] = sb[i];
    }
}

}  // namespace
