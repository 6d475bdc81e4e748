// One-kernel decode: payload windows + records -> the stream's bytes.
//
// Replaces fused_tile_kernel (libaec_tpu/kernels/decode_fused_pallas.py:48,
// entry decode_unpredict_swizzle_pallas :284).  It computes the same
// output: for raw payload windows u32 [NB, Wf] and the per-block records
// fs_bit, lsb_rel, meta, ref_sample u32 [NB] of NB = n_rsi * rsi blocks,
// the bytes of each RSI's samples in put_* order, uint8 [n_rsi, S * bsz]
// for 1-, 2- and 4-byte samples -- kernel 3 (decode.cu) and kernel 4
// (unpredict.cu) in one, with no [NB, bs] delta array in device memory.
//
// The TPU kernel's tile (128 RSIs on lanes x BSL blocks, windows
// transposed block-major beforehand, n_rsi a multiple of 128) exists for
// Mosaic's shape-cast rules; none of it is carried over.  Here a thread
// block owns `group` consecutive RSIs (4 to 32) and walks their samples in
// slabs of whole blocks, floor(128 / bs) blocks (at most 128 samples) per
// RSI.  A slab goes through three steps:
//   a. the parse warps decode its payload blocks, one block per warp at a
//      time (decode_block.cuh, the parse of kernel 3), and store the bs
//      deltas into the shared slab tin[rsi in group][sample in slab];
//   b. the chain warp runs the inverse predictor (unpredict_step.cuh, the
//      step of kernel 4): lane r walks row r, eight deltas at a time from
//      registers, carries the last sample in a register across slabs, and
//      writes the samples' bytes into tout a word at a time;
//   c. the parse warps store rows of tout, 32-bit words when the rows are
//      word-aligned and bytes otherwise.
// The steps are pipelined over two copies of tin and tout: between two
// barriers the parse warps store slab i - 2 and parse slab i while the
// chain warp walks slab i - 1, so the serial chain, the only step that
// cannot be spread over threads, runs without waiting for the others.
// Any n_rsi and any rsi: the last group has fewer rows, the last slab of
// an RSI fewer blocks, and no warp leaves before the last barrier.
//
// A warp's window load is coalesced (Wf consecutive words); consecutive
// tasks of step a are consecutive records of one RSI, but the RSIs of a
// group lie rsi * Wf words apart, so the group's reads are strided.
//
// Bound on this card: device-memory traffic is the least any decoder
// could move (windows and records read once, output bytes written once),
// some ten microseconds for a chunk; what it takes is latency: every RSI
// is a chain of S dependent steps.  The host picks the smallest group
// that still fits all thread blocks on the card at once (a 512-RSI chunk:
// 128 blocks of 4 RSIs), so that as many chains as possible run side by
// side; the time is then the number of slabs times the longer of a
// slab's chain and its parse.
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_block.cuh"
#include "unpredict_step.cuh"

namespace {

constexpr int PARSERS = 8;          // parse warps per thread block
constexpr int WARPS = PARSERS + 1;  // and the chain warp, warp 0
constexpr int PITCH = SL + 1;       // words per slab row: no bank conflicts

// dynamic shared memory: tin[2][group][PITCH], tout[2][group][PITCH], then
// the parse warps' window and rank tables
constexpr size_t shared_words(int group) {
    return (size_t)4 * group * PITCH + 2 * PARSERS * MAXWF;
}

template <int BSZ>
__global__ void __launch_bounds__(32 * WARPS)
decode_fused_kernel(const uint32_t* __restrict__ win,
                    const uint32_t* __restrict__ fs_bit_a,
                    const uint32_t* __restrict__ lsb_rel_a,
                    const uint32_t* __restrict__ meta_a,
                    const uint32_t* __restrict__ ref_a,
                    uint8_t* __restrict__ out, Params p, int rsi, int wf,
                    int bs, int bps, int group) {
    extern __shared__ uint32_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slab_words = group * PITCH;
    uint32_t* tin = smem;                    // [2][group][PITCH]
    uint32_t* tout = smem + 2 * slab_words;  // [2][group][PITCH]
    uint32_t* s_win = smem + 4 * slab_words + (warp ? warp - 1 : 0) * MAXWF;
    uint32_t* s_cum = s_win + PARSERS * MAXWF;
    const long long r0 = (long long)blockIdx.x * group;
    const int rows = (int)(p.n_rsi - r0 < group ? p.n_rsi - r0 : group);
    const long long row_bytes = (long long)p.S * BSZ;
    const int per_slab = SL / bs;  // blocks of one RSI in a slab
    const int n_slabs = (rsi + per_slab - 1) / per_slab;
    uint32_t last = 0;             // chain warp: lane r's RSI
    for (int i = 0; i < n_slabs + 2; i++) {
        if (warp == 0) {
            // b. the serial chain of slab i - 1, one lane per RSI
            const int s = i - 1;
            if (s >= 0 && s < n_slabs && lane < rows) {
                const int b0 = s * per_slab;
                const int len = (rsi - b0 < per_slab ? rsi - b0 : per_slab)
                    * bs;
                const uint32_t* in = tin + (s & 1) * slab_words
                    + lane * PITCH;
                uint32_t* mine = tout + (s & 1) * slab_words + lane * PITCH;
                if (!p.pp)
                    chain_run<BSZ, LAYOUT_ONLY>(in, mine, len, s == 0, last,
                                                p);
                else if (p.signed_path)
                    chain_run<BSZ, SIGNED_PATH>(in, mine, len, s == 0, last,
                                                p);
                else
                    chain_run<BSZ, UNSIGNED_PATH>(in, mine, len, s == 0, last,
                                                  p);
            }
        } else {
            // c. store the bytes of slab i - 2, rows dealt over the warps
            const int s = i - 2;
            if (s >= 0) {
                const int b0 = s * per_slab;
                const int len = (rsi - b0 < per_slab ? rsi - b0 : per_slab)
                    * bs;
                const uint32_t* src = tout + (s & 1) * slab_words;
                for (int r = warp - 1; r < rows; r += PARSERS)
                    store_row(out + (r0 + r) * row_bytes
                              + (long long)b0 * bs * BSZ, src + r * PITCH,
                              len * BSZ, p.words, lane);
            }
            // a. parse slab i: task t is block b0 + t % nblk of row
            //    t / nblk
            if (i < n_slabs) {
                const int b0 = i * per_slab;
                const int nblk = rsi - b0 < per_slab ? rsi - b0 : per_slab;
                uint32_t* dst = tin + (i & 1) * slab_words;
                for (int t = warp - 1; t < rows * nblk; t += PARSERS) {
                    const int r = t / nblk, b = t - r * nblk;
                    const long long blk = (r0 + r) * rsi + b0 + b;
                    uint32_t o[2];
                    decode_block(win + blk * wf, s_win, s_cum, fs_bit_a[blk],
                                 lsb_rel_a[blk], meta_a[blk], ref_a[blk], wf,
                                 bs, bps, lane, o);
#pragma unroll
                    for (int h = 0; h < 2; h++) {
                        const int j = lane + 32 * h;
                        if (j < bs) dst[r * PITCH + b * bs + j] = o[h];
                    }
                    __syncwarp();  // the next task rewrites s_win, s_cum
                }
            }
        }
        // slab i is parsed, slab i - 1 walked, slab i - 2 stored: each step
        // of the next round touches the other copy of what this one read
        __syncthreads();
    }
}

template <int BSZ>
int launch(const uint32_t* win, const uint32_t* fs_bit,
           const uint32_t* lsb_rel, const uint32_t* meta,
           const uint32_t* ref_sample, uint8_t* out, const Params& p, int rsi,
           int wf, int bs, int bps, int group, cudaStream_t s) {
    const size_t smem = shared_words(group) * sizeof(uint32_t);
    if (smem > 48 * 1024) {  // above the static limit: ask for it
        const cudaError_t e = cudaFuncSetAttribute(
            decode_fused_kernel<BSZ>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const unsigned grid = (unsigned)((p.n_rsi + group - 1) / group);
    decode_fused_kernel<BSZ><<<grid, 32 * WARPS, smem, s>>>(
        win, fs_bit, lsb_rel, meta, ref_sample, out, p, rsi, wf, bs, bps,
        group);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aec_decode_fused(const void* win, const void* fs_bit,
                                const void* lsb_rel, const void* meta,
                                const void* ref_sample, void* out,
                                long long n_rsi, int rsi, int wf, int bs,
                                int bps, int bsz, int msb, int pp,
                                int signed_path, int sign_ext, unsigned xmax,
                                unsigned med, unsigned sign_bit,
                                void* stream) {
    if (wf < 1 || wf > MAXWF || bs < 8 || bs > 64 || rsi < 1)
        return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (e != cudaSuccess) return (int)e;
    // the smallest group whose thread blocks are all on the card at once
    // (an SM's registers hold about 4 blocks of 288 threads)
    int group = 4;
    while (group < 32 && (n_rsi + group - 1) / group > 4LL * sms) group *= 2;
    const int S = rsi * bs;
    // word stores need every row and every slab to start on a 4-byte
    // boundary
    const int words = ((long long)S * bsz) % 4 == 0
        && ((SL / bs) * bs * bsz) % 4 == 0;
    const Params p{n_rsi, S, msb, pp, signed_path, sign_ext, words,
                   xmax, med, sign_bit};
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* w = (const uint32_t*)win;
    const uint32_t* a = (const uint32_t*)fs_bit;
    const uint32_t* b = (const uint32_t*)lsb_rel;
    const uint32_t* c = (const uint32_t*)meta;
    const uint32_t* d = (const uint32_t*)ref_sample;
    uint8_t* o = (uint8_t*)out;
    switch (bsz) {
        case 1: return launch<1>(w, a, b, c, d, o, p, rsi, wf, bs, bps,
                                 group, s);
        case 2: return launch<2>(w, a, b, c, d, o, p, rsi, wf, bs, bps,
                                 group, s);
        case 4: return launch<4>(w, a, b, c, d, o, p, rsi, wf, bs, bps,
                                 group, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
