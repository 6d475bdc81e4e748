// Inverse predictor and byte layout: mapped deltas -> samples or bytes.
//
// Two entry points over one design:
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
// Bound on this card: bytes.  Each delta is read once (4 bytes) and each
// sample written once (its bsz bytes, or 4 as a sample), at 3.35 TB/s:
// 0.015 ms for a chunk of 8 Mi 2-byte samples, 0.020 ms for kernel 5.
// The arithmetic is a dozen integer operations a sample, far under that.
// What stands between a kernel and this bound is the inverse unit-delay
// predictor (decode.c:67-141): sample i is a function of sample i - 1 and
// delta i, serial within an RSI, independent across RSIs (each starts from
// its reference sample).  The TPU kernels put RSIs on lanes and walk
// sample slabs in VMEM; one thread per RSI here would leave a 512-RSI
// chunk on 16 warps, each a chain of S dependent steps.
//
// The predictor paths (pp = 1): a warp owns an RSI and its lanes sit on
// consecutive samples.  It walks the row in groups of SCAN_G samples:
// every lane loads SCAN_V consecutive deltas as 16-byte vectors, a few
// groups ahead of the one at work, so that loads are in flight while the
// warp computes.  Wherever no delta escapes to the end of the range, the
// samples are a prefix sum of the residuals, which the warp computes in log
// steps; each lane then checks its guesses with the step function itself,
// and the first mismatch is repaired exactly (scan_guess and scan_verify,
// unpredict_step.cuh; the next group's guess runs beside this group's
// check).  Smooth data, what the codec is for, almost never
// escapes and runs at the scan's speed.  Noise escapes at every other
// sample: such a group takes no repair (at most SCAN_REPAIRS otherwise) and
// falls back to a serial walk, every lane over its own samples in rounds,
// so the worst case costs about one chain.  The data decide
// the route inside the kernel; the result never depends on it.  The lanes
// hold four consecutive samples per 16 bytes loaded, so they pack the
// bytes in registers (__byte_perm) and write whole vectors; no
// transposing slab in shared memory is needed.  Rows whose start is not
// 16-byte aligned (S % 4 != 0: block sizes under AEC_NOT_ENFORCE with an
// odd RSI length) load and store sample by sample.  The launch gives one
// warp per RSI, in thread blocks of 1 to 8 warps: few RSIs get a block
// each, so that they spread over the card's SMs and schedulers.
//
// The layout-only path (pp = 0) has no chain and no RSI structure: the
// output is n_rsi * S * bsz contiguous bytes.  A flat grid-stride kernel
// gives each thread 4 samples (one 16-byte load, 4 * bsz bytes stored as
// one vector), with a sample-by-sample tail.
//
// The signed path's int32 arithmetic wraps in JAX; signed overflow is
// undefined in C++, so it runs on uint32_t bit patterns, which wrap the
// same way.
#include <cstdint>
#include <cuda_runtime.h>

#include "unpredict_step.cuh"

namespace {

constexpr int AHEAD = 3;  // groups a warp keeps loaded ahead of its scan
static_assert(AHEAD >= 2, "the next group's deltas must be loaded");

// Lane's SCAN_V deltas of group g of a row of S; 0 past the row's end.
__device__ __forceinline__ void load_group(const uint32_t* __restrict__ row,
                                           int S, int g, int lane, int vec,
                                           uint32_t (&d)[SCAN_V]) {
    const int base = g * SCAN_G + lane * SCAN_V;
    if (vec) {
#pragma unroll
        for (int h = 0; h < SCAN_V; h += 4) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (base + h < S)
                v = __ldg(reinterpret_cast<const uint4*>(row + base + h));
            d[h] = v.x, d[h + 1] = v.y, d[h + 2] = v.z, d[h + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < SCAN_V; k++)
            d[k] = base + k < S ? __ldg(row + base + k) : 0u;
    }
}

// One warp per RSI: deltas -> samples (BSZ 0) or their bytes.
template <int BSZ, int PATH>
__global__ void __launch_bounds__(256)
unpredict_scan_kernel(const uint32_t* __restrict__ d,
                      uint8_t* __restrict__ out, Params p, int vec) {
    const long long rsi = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
        >> 5;
    if (rsi >= p.n_rsi) return;  // whole warps leave; there is no barrier
    const int lane = threadIdx.x & 31, S = p.S;
    const uint32_t* row = d + rsi * S;
    uint8_t* orow = out + rsi * S * (BSZ ? BSZ : 4);
    const int groups = (S + SCAN_G - 1) / SCAN_G;
    uint32_t ahead[AHEAD][SCAN_V], guess[SCAN_V];
#pragma unroll
    for (int q = 0; q < AHEAD; q++) load_group(row, S, q, lane, vec, ahead[q]);
    scan_guess(ahead[0], guess, true, p, lane);
    uint32_t carry = 0;
    for (int g0 = 0; g0 < groups; g0 += AHEAD) {
#pragma unroll
        for (int q = 0; q < AHEAD; q++) {
            const int g = g0 + q;
            if (g >= groups) break;
            uint32_t dl[SCAN_V], x[SCAN_V];
#pragma unroll
            for (int k = 0; k < SCAN_V; k++)
                dl[k] = ahead[q][k], x[k] = guess[k];
            load_group(row, S, g + AHEAD, lane, vec, ahead[q]);
            // the next group's guess needs nothing of this one: its
            // shuffles overlap this group's check (past the row's end it
            // sums zeros)
            scan_guess(ahead[(q + 1) % AHEAD], guess, false, p, lane);
            scan_verify<PATH>(dl, x, g == 0, carry, p, lane);
            store_group<BSZ>(orow, S, g, lane, vec, p.msb, x);
        }
    }
}

// The byte layout alone, flat over the chunk's n samples: 4 samples a
// thread where `vec` says the pointers allow vectors, then the rest one
// sample a thread.
template <int BSZ>
__global__ void __launch_bounds__(256)
layout_kernel(const uint32_t* __restrict__ v, uint8_t* __restrict__ out,
              long long n, int msb, int vec) {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long step = (long long)gridDim.x * blockDim.x;
    const long long quads = vec ? n / 4 : 0;
    for (long long i = tid; i < quads; i += step) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(v) + i);
        const uint32_t s[4] = {q.x, q.y, q.z, q.w};
        uint32_t w[BSZ];
        pack4<BSZ>(s, msb, w);
        store_words<BSZ>(out + i * 4 * BSZ, w);
    }
    for (long long i = quads * 4 + tid; i < n; i += step) {
        const uint32_t s = __ldg(v + i);
#pragma unroll
        for (int b = 0; b < BSZ; b++)
            out[i * BSZ + b] = (uint8_t)(s >> (8 * (msb ? BSZ - 1 - b : b)));
    }
}

int sm_count(int* sms) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                   device);
    return (int)e;
}

bool aligned16(const void* a, const void* b) {
    return ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
}

template <int BSZ>
int launch_scan(const uint32_t* d, uint8_t* out, const Params& p,
                cudaStream_t s) {
    int sms = 0;
    const int e = sm_count(&sms);
    if (e) return e;
    // one warp per RSI; the fewest warps a block (1 to 8) that keep the
    // blocks within four per SM, so that few RSIs spread over the card
    int warps = 1;
    while (warps < 8 && (p.n_rsi + warps - 1) / warps > 4LL * sms) warps *= 2;
    const unsigned grid = (unsigned)((p.n_rsi + warps - 1) / warps);
    // vectors need every row to start on a 16-byte boundary
    const int vec = p.S % 4 == 0 && aligned16(d, out);
    if (p.signed_path)
        unpredict_scan_kernel<BSZ, SIGNED_PATH><<<grid, 32 * warps, 0, s>>>(
            d, out, p, vec);
    else
        unpredict_scan_kernel<BSZ, UNSIGNED_PATH><<<grid, 32 * warps, 0, s>>>(
            d, out, p, vec);
    return (int)cudaGetLastError();
}

template <int BSZ>
int launch_layout(const uint32_t* v, uint8_t* out, const Params& p,
                  cudaStream_t s) {
    int sms = 0;
    const int e = sm_count(&sms);
    if (e) return e;
    const long long n = p.n_rsi * p.S;
    const long long want = (n / 4 + 255) / 256 + 1;
    const unsigned grid = (unsigned)(want < 16LL * sms ? want : 16LL * sms);
    layout_kernel<BSZ><<<grid, 256, 0, s>>>(v, out, n, p.msb,
                                            aligned16(v, out));
    return (int)cudaGetLastError();
}

template <int BSZ>
int launch_swizzle(const uint32_t* d, uint8_t* out, const Params& p,
                   cudaStream_t s) {
    return p.pp ? launch_scan<BSZ>(d, out, p, s)
                : launch_layout<BSZ>(d, out, p, s);
}

}  // namespace

extern "C" int aec_unpredict_swizzle(const void* deltas, void* out,
                                     long long n_rsi, int S, int bsz, int msb,
                                     int pp, int signed_path, int sign_ext,
                                     unsigned xmax, unsigned med,
                                     unsigned sign_bit, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const Params p{n_rsi, S, msb, pp, signed_path, sign_ext,
                   xmax, med, sign_bit};
    const uint32_t* d = (const uint32_t*)deltas;
    uint8_t* o = (uint8_t*)out;
    switch (bsz) {
        case 1: return launch_swizzle<1>(d, o, p, s);
        case 2: return launch_swizzle<2>(d, o, p, s);
        case 3: return launch_swizzle<3>(d, o, p, s);
        case 4: return launch_swizzle<4>(d, o, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int aec_unpredict_rsis(const void* deltas, void* out,
                                  long long n_rsi, int S, int signed_path,
                                  int sign_ext, unsigned xmax, unsigned med,
                                  unsigned sign_bit, void* stream) {
    const Params p{n_rsi, S, 0, 1, signed_path, sign_ext,
                   xmax, med, sign_bit};
    return launch_scan<0>((const uint32_t*)deltas, (uint8_t*)out, p,
                          (cudaStream_t)stream);
}
