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
// block owns `group` consecutive RSIs (1 to 32) and walks their samples in
// slabs of whole blocks: up to SLAB_GROUPS scan groups of SCAN_G samples
// per RSI (at 64-sample blocks and 8 groups, 32 blocks = 2048 samples).  A
// slab goes through two steps:
//   a. the parse warps decode its payload blocks, one block per warp at a
//      time (decode_block.cuh, the parse of kernel 3), and store the bs
//      deltas into the shared slab tin[rsi in group][sample in slab];
//   b. the chain warps run the inverse predictor the way kernel 4 does
//      (unpredict_step.cuh): a warp scans a row, its lanes on consecutive
//      samples, eight a lane.  Per scan group it guesses by prefix sum
//      (scan_guess), checks with the step itself and repairs (scan_verify),
//      packs the samples' bytes in registers and writes them to device
//      memory as vectors.  The last sample of a row's slab is carried to
//      its next slab in shared memory; rows are dealt over the chain warps,
//      and no lane walks an RSI alone.
//      A slab's last scan group may end short of SCAN_G samples (a block
//      size that does not divide it, the end of the RSI): the missing
//      deltas are passed as 0, which repeat the last real sample, so the
//      carry that scan_verify hands on is that sample.
// With preprocessing off step b is the byte packing alone.
// The steps are pipelined over two copies of tin: between two barriers
// the parse warps parse slab i while the chain warps scan slab i - 1.  Any
// n_rsi and any rsi: the last group has fewer rows, the last slab of an
// RSI fewer blocks, and no warp leaves before the last barrier.
//
// A warp's window load is coalesced (Wf consecutive words); consecutive
// tasks of step a are consecutive records of one RSI, but the RSIs of a
// group lie rsi * Wf words apart, so the group's reads are strided.
//
// Bound on this card: device-memory traffic is the least any decoder
// could move (windows and records read once, output bytes written once),
// some ten microseconds for a chunk.  What it takes is instruction slots:
// the parse of a split block is some hundreds of instructions, of a zero
// block a few dozen (decode_block.cuh; kernel 3 alone is bound by them),
// the scan some 170 a group of 256 samples.
// So the design is about keeping an SM's schedulers full of parse warps:
// the host picks the smallest group whose thread blocks are all on the
// card at once, BLOCKS_PER_SM to an SM (a 512-RSI chunk: 256 blocks of 2
// RSIs), a slab wide enough that every parse warp has whole tasks between
// two barriers, and a chain warp a row up to MAX_CHAINERS of the block's
// FUSED_WARPS warps, which hide behind the others.  On rough data
// (escapes in most groups) a row's scan falls back to kernel 4's serial
// walk and the chain warps set the pace, as there.
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_block.cuh"
#include "unpredict_step.cuh"

namespace {

constexpr int FUSED_WARPS = 18;    // warps per thread block
constexpr int MAX_CHAINERS = 4;    // of them chain warps, at most
constexpr int SLAB_GROUPS = 8;     // scan groups in a slab row, at most
constexpr int MAX_GROUP = 32;      // RSIs per thread block, at most
constexpr int BLOCKS_PER_SM = 2;   // thread blocks an SM holds at once
// scratch builds that time one step alone (tools/tune_unpredict_scan.py):
// 1 leaves out the chain, 2 the parse (the chain then scans zeros)
constexpr int SKIP_STEP = 0;

// dynamic shared memory in words: tin[2][group][pitch], carry[MAX_GROUP],
// then the parse warps' windows and FS positions
constexpr size_t shared_words(int group, int pitch) {
    return (size_t)2 * group * pitch + MAX_GROUP + 2 * FUSED_WARPS * MAXWF;
}

// Lane's SCAN_V deltas of scan group q of a slab row of len samples; 0
// past its end.
__device__ __forceinline__ void load_slab_group(const uint32_t* row, int len,
                                                int q, int lane,
                                                uint32_t (&d)[SCAN_V]) {
    const int base = q * SCAN_G + lane * SCAN_V;
#pragma unroll
    for (int h = 0; h < SCAN_V; h += 4) {
        if (base + h + 4 <= len) {
            const uint4 v = *reinterpret_cast<const uint4*>(row + base + h);
            d[h] = v.x, d[h + 1] = v.y, d[h + 2] = v.z, d[h + 3] = v.w;
        } else {
#pragma unroll
            for (int k = h; k < h + 4; k++)
                d[k] = base + k < len ? row[base + k] : 0u;
        }
    }
}

template <int BSZ, int PATH>
__global__ void __launch_bounds__(32 * FUSED_WARPS, BLOCKS_PER_SM)
decode_fused_kernel(const uint32_t* __restrict__ win,
                    const uint32_t* __restrict__ fs_bit_a,
                    const uint32_t* __restrict__ lsb_rel_a,
                    const uint32_t* __restrict__ meta_a,
                    const uint32_t* __restrict__ ref_a,
                    uint8_t* __restrict__ out, Params p, int rsi, int wf,
                    int bs, int bps, int group, int chainers, int per_slab,
                    int pitch, int vec) {
    extern __shared__ uint4 smem4[];  // 16-byte aligned: rows load vectors
    uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slab_words = group * pitch;
    uint32_t* tin = smem;                        // [2][group][pitch]
    uint32_t* s_carry = smem + 2 * slab_words;   // [MAX_GROUP]
    // warps 0 .. chainers - 1 scan, the others parse
    const int parser = warp - chainers, parsers = FUSED_WARPS - chainers;
    uint32_t* s_win = s_carry + MAX_GROUP + warp * MAXWF;
    uint32_t* s_pos = s_win + FUSED_WARPS * MAXWF;
    const long long r0 = (long long)blockIdx.x * group;
    const int rows = (int)(p.n_rsi - r0 < group ? p.n_rsi - r0 : group);
    const long long row_bytes = (long long)p.S * BSZ;
    const int n_slabs = (rsi + per_slab - 1) / per_slab;
    for (int i = 0; i <= n_slabs; i++) {
        if (warp < chainers) {
            // b. the scan of slab i - 1, a warp on a row at a time
            const int s = i - 1;
            if (s >= 0 && SKIP_STEP != 1) {
                const int b0 = s * per_slab;
                const int len = (rsi - b0 < per_slab ? rsi - b0 : per_slab)
                    * bs;
                for (int r = warp; r < rows; r += chainers) {
                    const uint32_t* in = tin + (s & 1) * slab_words
                        + r * pitch;
                    uint8_t* orow = out + (r0 + r) * row_bytes
                        + (long long)b0 * bs * BSZ;
                    uint32_t carry = s_carry[r];
                    for (int q = 0; q * SCAN_G < len; q++) {
                        uint32_t d[SCAN_V], x[SCAN_V];
                        load_slab_group(in, len, q, lane, d);
                        if (PATH == LAYOUT_ONLY) {
#pragma unroll
                            for (int k = 0; k < SCAN_V; k++) x[k] = d[k];
                        } else {
                            const bool first = s == 0 && q == 0;
                            scan_guess(d, x, first, p, lane);
                            scan_verify<PATH>(d, x, first, carry, p, lane);
                        }
                        store_group<BSZ>(orow, len, q, lane, vec, p.msb, x);
                    }
                    if (lane == 0) s_carry[r] = carry;
                }
            }
        } else if (i < n_slabs) {
            // a. parse slab i: task t is block b0 + t % nblk of row
            //    t / nblk
            const int b0 = i * per_slab;
            const int nblk = rsi - b0 < per_slab ? rsi - b0 : per_slab;
            uint32_t* dst = tin + (i & 1) * slab_words;
            for (int t = parser; t < rows * nblk; t += parsers) {
                const int r = t / nblk, b = t - r * nblk;
                const long long blk = (r0 + r) * rsi + b0 + b;
                uint32_t o[2] = {0, 0};
                if (SKIP_STEP != 2)
                    decode_block(win + blk * wf, s_win, s_pos, fs_bit_a[blk],
                                 lsb_rel_a[blk], meta_a[blk], ref_a[blk], wf,
                                 bs, bps, lane, o);
#pragma unroll
                for (int h = 0; h < 2; h++) {
                    const int j = lane + 32 * h;
                    if (j < bs) dst[r * pitch + b * bs + j] = o[h];
                }
                __syncwarp();  // the next task rewrites s_win, s_pos
            }
        }
        // slab i is parsed and slab i - 1 scanned: each step of the next
        // round touches the other copy of what this one read
        __syncthreads();
    }
}

struct Geometry {
    int rsi, wf, bs, bps, group, chainers, per_slab, pitch, vec;
};

template <int BSZ, int PATH>
int launch(const uint32_t* win, const uint32_t* fs_bit,
           const uint32_t* lsb_rel, const uint32_t* meta,
           const uint32_t* ref_sample, uint8_t* out, const Params& p,
           const Geometry& g, cudaStream_t s) {
    const size_t smem = shared_words(g.group, g.pitch) * sizeof(uint32_t);
    if (smem > 48 * 1024) {  // above the static limit: ask for it
        const cudaError_t e = cudaFuncSetAttribute(
            decode_fused_kernel<BSZ, PATH>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const unsigned grid = (unsigned)((p.n_rsi + g.group - 1) / g.group);
    decode_fused_kernel<BSZ, PATH><<<grid, 32 * FUSED_WARPS, smem, s>>>(
        win, fs_bit, lsb_rel, meta, ref_sample, out, p, g.rsi, g.wf, g.bs,
        g.bps, g.group, g.chainers, g.per_slab, g.pitch, g.vec);
    return (int)cudaGetLastError();
}

template <int BSZ>
int launch_path(const uint32_t* win, const uint32_t* fs_bit,
                const uint32_t* lsb_rel, const uint32_t* meta,
                const uint32_t* ref_sample, uint8_t* out, const Params& p,
                const Geometry& g, cudaStream_t s) {
    if (!p.pp)
        return launch<BSZ, LAYOUT_ONLY>(win, fs_bit, lsb_rel, meta,
                                        ref_sample, out, p, g, s);
    if (p.signed_path)
        return launch<BSZ, SIGNED_PATH>(win, fs_bit, lsb_rel, meta,
                                        ref_sample, out, p, g, s);
    return launch<BSZ, UNSIGNED_PATH>(win, fs_bit, lsb_rel, meta, ref_sample,
                                      out, p, g, s);
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
    int group = 1;
    while (group < MAX_GROUP
           && (n_rsi + group - 1) / group > (long long)BLOCKS_PER_SM * sms)
        group *= 2;
    const int S = rsi * bs;
    // a slab row: as many scan groups as the shared memory of the largest
    // group allows (group * groups <= MAX_GROUP) and the RSI has, in whole
    // blocks, their samples a multiple of 4 so that every slab starts on
    // a whole vector of output
    int groups = MAX_GROUP / group < SLAB_GROUPS ? MAX_GROUP / group
                                                 : SLAB_GROUPS;
    if (groups > (S + SCAN_G - 1) / SCAN_G) groups = (S + SCAN_G - 1) / SCAN_G;
    int per_slab = groups * SCAN_G / bs;
    if (bs % 4) per_slab &= ~1;
    const int vec = S % 4 == 0 && (uintptr_t)out % 16 == 0;
    // a chain warp a row, up to MAX_CHAINERS: on smooth data two keep up
    // with the parse of any group; on rough data the rows a chain warp
    // takes in turn are what the kernel waits for
    const int chainers = group < MAX_CHAINERS ? group : MAX_CHAINERS;
    const Geometry g{rsi, wf, bs, bps, group, chainers, per_slab,
                     groups * SCAN_G, vec};
    const Params p{n_rsi, S, msb, pp, signed_path, sign_ext,
                   xmax, med, sign_bit};
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* w = (const uint32_t*)win;
    const uint32_t* a = (const uint32_t*)fs_bit;
    const uint32_t* b = (const uint32_t*)lsb_rel;
    const uint32_t* c = (const uint32_t*)meta;
    const uint32_t* d = (const uint32_t*)ref_sample;
    uint8_t* o = (uint8_t*)out;
    switch (bsz) {
        case 1: return launch_path<1>(w, a, b, c, d, o, p, g, s);
        case 2: return launch_path<2>(w, a, b, c, d, o, p, g, s);
        case 4: return launch_path<4>(w, a, b, c, d, o, p, g, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
