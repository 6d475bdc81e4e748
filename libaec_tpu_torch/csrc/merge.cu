// Merge kernel: per-block bit windows -> the packed word stream.
//
// Replaces _merge_tile_kernel (libaec_tpu/kernels/merge_pallas.py:77,
// entry merge_to_groups_pallas :238) together with the XLA group scan
// merge_groups_scan (libaec_tpu/ops/bitpack.py:211) that follows it.  On
// the TPU, Mosaic DMA slices must be 1024-word aligned, so windows merge in
// a tree of 512-block groups and a serial scan places the groups.  Hopper
// has no such rule: each word of the stream is gathered where it lies.
//
// Input: windows u32 [NB, W] (window word 0 is a zero pad, the block's
// bits are window bits [32, 32 + block_bits) and every other bit is 0),
// block_bits u32 [NB], bit0 int64 [1] in [0, 8).  Buffer word 0 is the
// front pad and stream bit b is buffer bit 32 + b, so block i starts at
// buffer bit 32 + bit0 + (block_bits[0] + ... + block_bits[i - 1]).
// Output: words [0, ceil((total + 32) / 32)), big-endian (byte-swapped on
// the way out), total = bit0 + the sum of block_bits; tail = (total,
// total & 7).  Words past that prefix are not written: no caller reads
// them (kernels/merge_cuda.py).
//
// Two launches on the stream, no other work around them:
//   1. tile_sums: the bits of each tile of TILE blocks (a warp reduction);
//   2. merge_gather, a thread block a tile, one block a thread:
//      a. the tile's exclusive prefix of block_bits by warp shuffles, and
//         the bits of all earlier tiles, reduced from launch 1's sums (a
//         tile reads at most NB / TILE of them, all in L2);
//      b. the tile owns the stream words whose first bit lies in its
//         blocks, and writes each of them once: a thread per word finds
//         the block that holds the word's first bit by a binary search
//         over the tile's starts in shared memory, then ORs the
//         funnel-shifted window words of that block and of every following
//         block that starts inside the word (zero-bit blocks add nothing: a
//         zero run's code sits on its last block).  Word 0 and the bits
//         before bit0 stay 0; so do the last word's bits after total, which
//         makes the next chunk's shared byte right.  The tile's last word
//         may reach into the next tiles' blocks: warp 0 gathers that part
//         from their block_bits and windows.
// No atomics on the words, no zeroed buffer, no state kept between calls:
// the sums live in a scratch tensor of the call.
//
// What bounds it on this card: the bytes are the words of the stream
// written once and the window words under them read once (a block's bits
// are a prefix of its window, so most of each window is never read),
// block_bits read two or three times and the NB / TILE sums once a tile
// from L2.  The time is the gather's latency: a tile's words wait on a
// chain of dependent loads (the search over the starts, then each block's
// window words, then warp 0's walk past the tile), ~90 % of a call and not
// growing with the words.  Before this design the wrapper ran a cumsum and
// a memset of the whole worst-case buffer (6-80x the stream) and the
// kernel atomicOr-ed each block's edge words.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;            // blocks per thread block, one a thread
constexpr unsigned FULL = 0xFFFFFFFFu;

// Block j's bits in the stream word whose first bit is window bit s of
// the block (s >= 1: a gathered block starts before the word ends).
__device__ __forceinline__ uint32_t window_part(
        const uint32_t* __restrict__ win, long long j, int w, long long s) {
    const uint32_t* src = win + j * w;
    const int a = (int)(s >> 5), r = (int)(s & 31);
    const uint32_t hi = a < w ? src[a] : 0u;
    const uint32_t lo = r && a + 1 < w ? src[a + 1] : 0u;
    return __funnelshift_l(lo, hi, r);
}

// The bits of word wi from the tile's blocks (starts relative to base,
// s_start[n] is the tile's sum).
__device__ __forceinline__ uint32_t gather_in_tile(
        const uint32_t* __restrict__ win, const uint32_t* s_start, int n,
        long long b0, int w, long long base, long long wi) {
    const long long x = 32 * wi - base;  // the word's first bit, relative
    int lo = 0, hi = n;                  // first start past x
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((long long)s_start[mid] <= x) lo = mid + 1; else hi = mid;
    }
    uint32_t v = 0;
    for (int j = lo > 0 ? lo - 1 : 0;
         j < n && (long long)s_start[j] < x + 32; j++)
        if (s_start[j + 1] > s_start[j])
            v |= window_part(win, b0 + j, w, x + 32 - s_start[j]);
    return v;
}

__global__ void __launch_bounds__(TILE) tile_sums(
        const uint32_t* __restrict__ block_bits, uint32_t* __restrict__ sums,
        long long nb) {
    __shared__ uint32_t s_warp[TILE / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long i = (long long)blockIdx.x * TILE + threadIdx.x;
    const uint32_t v = __reduce_add_sync(FULL, i < nb ? block_bits[i] : 0u);
    if (lane == 0) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
        const uint32_t x = __reduce_add_sync(
            FULL, lane < TILE / 32 ? s_warp[lane] : 0u);
        if (lane == 0) sums[blockIdx.x] = x;
    }
}

__global__ void __launch_bounds__(TILE) merge_gather(
        const uint32_t* __restrict__ win,
        const uint32_t* __restrict__ block_bits,
        const uint32_t* __restrict__ sums,
        const long long* __restrict__ bit0_p, uint32_t* __restrict__ words,
        long long* __restrict__ tail, long long nb, int w, long long nwords) {
    __shared__ uint32_t s_start[TILE + 1];
    __shared__ uint32_t s_warp[TILE / 32];
    __shared__ unsigned long long s_before[TILE / 32];
    __shared__ long long s_prefix;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long t = blockIdx.x, b0 = t * TILE;
    const int n = nb - b0 < TILE ? (int)(nb - b0) : TILE;
    const bool last_tile = t == (long long)gridDim.x - 1;

    // a. the tile's exclusive prefix, and the bits of the earlier tiles
    const uint32_t bb = tid < n ? block_bits[b0 + tid] : 0u;
    uint32_t c = bb;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t up = __shfl_up_sync(FULL, c, d);
        if (lane >= d) c += up;
    }
    unsigned long long before = 0;
    for (long long i = tid; i < t; i += TILE) before += sums[i];
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1)
        before += __shfl_xor_sync(FULL, before, d);
    if (lane == 31) s_warp[warp] = c;
    if (lane == 0) s_before[warp] = before;
    __syncthreads();
    if (warp == 0) {
        uint32_t x = lane < TILE / 32 ? s_warp[lane] : 0u;
        unsigned long long y = lane < TILE / 32 ? s_before[lane] : 0ull;
#pragma unroll
        for (int d = 1; d < TILE / 32; d <<= 1) {
            const uint32_t up = __shfl_up_sync(FULL, x, d);
            if (lane >= d) x += up;
            y += __shfl_xor_sync(FULL, y, d);
        }
        __syncwarp();
        if (lane < TILE / 32) s_warp[lane] = x;
        if (lane == 0) s_prefix = (long long)y;
    }
    __syncthreads();
    s_start[tid] = c - bb + (warp ? s_warp[warp - 1] : 0u);
    const uint32_t agg = s_warp[TILE / 32 - 1];
    if (tid == 0) s_start[TILE] = agg;
    __syncthreads();

    // b. the words whose first bit lies in the tile's blocks: [lo, hi)
    const long long base = 32 + *bit0_p + s_prefix;  // the tile's first bit
    const long long end = base + agg;
    const long long lo = t == 0 ? 1 : (base + 31) >> 5;
    const long long hi = (end + 31) >> 5;
    if (t == 0 && tid == 0 && nwords > 0) words[0] = 0u;
    if (last_tile && tid == 0) {
        tail[0] = end - 32;
        tail[1] = (end - 32) & 7;
    }
    // the last word reaches past the tile's bits into the next tiles'
    const bool spill = !last_tile && hi > lo && (hi << 5) > end;
    const long long own = spill ? hi - 1 : hi;
    for (long long wi = lo + tid; wi < own && wi < nwords; wi += TILE)
        words[wi] = __byte_perm(
            gather_in_tile(win, s_start, n, b0, w, base, wi), 0, 0x0123);
    if (spill && warp == 0 && hi - 1 < nwords) {
        const long long wi = hi - 1, stop = 32 * (wi + 1);
        uint32_t v = lane == 0
            ? gather_in_tile(win, s_start, n, b0, w, base, wi) : 0u;
        long long start = end;  // of the next block to look at
        for (long long jb = b0 + TILE; jb < nb && start < stop; jb += 32) {
            const long long j = jb + lane;
            const uint32_t b = j < nb ? block_bits[j] : 0u;
            uint32_t s = b;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const uint32_t up = __shfl_up_sync(FULL, s, d);
                if (lane >= d) s += up;
            }
            const long long mine = start + s - b;
            if (b && mine < stop) v |= window_part(win, j, w, stop - mine);
            start += __shfl_sync(FULL, s, 31);
        }
        v = __reduce_or_sync(FULL, v);
        if (lane == 0) words[wi] = __byte_perm(v, 0, 0x0123);
    }
}

}  // namespace

extern "C" int aec_merge_windows(const void* win, const void* block_bits,
                                 const void* bit0, void* words, void* tail,
                                 void* sums, long long nb, int w,
                                 long long nwords, void* stream) {
    if (nb < 1 || w < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = (unsigned)((nb + TILE - 1) / TILE);
    tile_sums<<<grid, TILE, 0, s>>>((const uint32_t*)block_bits,
                                    (uint32_t*)sums, nb);
    merge_gather<<<grid, TILE, 0, s>>>(
        (const uint32_t*)win, (const uint32_t*)block_bits,
        (const uint32_t*)sums, (const long long*)bit0, (uint32_t*)words,
        (long long*)tail, nb, w, nwords);
    return (int)cudaGetLastError();
}
