// Encode kernel: raw stream bytes -> per-block packed bit windows.
//
// Replaces encode_tile_kernel (libaec_tpu/kernels/encode_pallas.py:83,
// entry encode_chunk_fields_pallas :533).  It computes the same outputs:
// win u32 [NB, W0] (MSB-first words, word 0 the front pad), block_bits
// u32 [NB] and k_final, from the chunk's raw bytes and k_init in device
// memory.
//
// The TPU kernel runs its grid in order and carries the k warm-start
// chain (state->k, encode.c:369) across tiles in SMEM.  Hopper runs blocks
// in no order, so the chain is a scan over maps: a block's warm-start walk
// is a map from every incoming k to the k its search ends at (32 entries,
// lane k computes entry k, encode.c:356-409), and maps compose
// associatively.  Three launches:
//   A  a thread block owns a tile of TILE consecutive CCSDS blocks, each of
//      its warps PER_WARP consecutive ones, a block at a time: ingest +
//      mask, delta map, zero flag, exact split lengths L(k), the map in
//      closed form (to scratch, uint8 [NB, 32]).  The warp composes its
//      maps as it goes, by shuffle (lane c holds entry c); the warps'
//      composites go through shared memory into the tile's composite (B1).
//   B2 one thread block of RUNS warps: each composes a contiguous run of
//      tile composites, one thread chains the RUNS run composites from
//      k_init, each warp walks its run again from the k that enters it:
//      every tile's incoming k, and k_final.  No thread walks all tiles.
//   C  the same tiling: a warp loads its blocks' maps, composes them,
//      takes the tile's incoming k through the warps before it and walks
//      its own maps from there (B3, by shuffle); then per block zero runs
//      / ROS within the 64-block segment (ballot), SE length with the
//      `< 128` gate, option select, fields, and the pack: a warp prefix sum
//      of the mid field widths (the lsb fields are all k wide, so their
//      places follow from their index), then OR into a shared-memory
//      window.
// A lane holds two consecutive samples of its warp's block: they come in
// as one aligned vector (the block's bytes read once per pass, not byte by
// byte, the predecessor by shuffle), are one second-extension pair, and
// their fields, adjacent in the stream, go into the window as one where
// they fit 32 bits.  Pass A's sums of d >> k for every k run on all lanes
// over the deltas in shared memory; pass C's two sums (the split length at
// the chosen k, the SE length) are warp reductions (__reduce_add_sync).
// Passes A and C each recompute the delta map from the raw bytes rather
// than keep [NB, bs] deltas in device memory.
//
// Bound on this card: device-memory traffic is small (the raw bytes read
// twice, the maps written and read, the windows written once); the passes
// are bound by instruction slots: some hundreds a block in each
// of A and C, a warp per block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 8;      // warps per thread block in A and C
constexpr int TILE = 64;      // blocks per chain tile, one thread block's
constexpr int PER_WARP = TILE / WARPS;  // consecutive blocks a warp takes
static_assert(PER_WARP * WARPS == TILE && PER_WARP <= 8,
              "pass C keeps a warp's k values in the bytes of one u64");
constexpr int RUNS = 32;      // B2: warps, each on a run of tile composites
constexpr int PIECE = 32;     // B2: composites a warp stages at a time
constexpr int MAXW = 80;      // window words (W0 <= 68 for bs <= 64)

struct Params {
    long long nb;
    int rsi, bs, bps, bsz, msb, pp, sgn, id_len, kmax, w0;
    int wide;    // the raw bytes start on an 8-byte boundary: vector loads
    int narrow;  // bps <= 25: a block's sums of deltas and its split
                 // lengths L(k) < 64 * 2^25 + 64 * 32 fit 32 bits
    uint32_t xmax, xmin, mask;
};

__device__ __forceinline__ uint32_t load_sample(const uint8_t* raw,
                                                long long g,
                                                const Params& p) {
    const uint8_t* s = raw + g * p.bsz;
    uint32_t v = 0;
    if (p.msb) {
        for (int j = 0; j < p.bsz; j++) v = (v << 8) | s[j];
    } else {
        for (int j = p.bsz - 1; j >= 0; j--) v = (v << 8) | s[j];
    }
    return v & p.mask;
}

// Unit-delay predictor + sign mapper (encode.c:235-311), u32 arithmetic.
__device__ __forceinline__ uint32_t delta(uint32_t x, uint32_t xp,
                                          const Params& p) {
    if (p.sgn) {
        const uint32_t m = 1u << (p.bps - 1);
        const uint32_t ux = (x ^ m) - m, uxp = (xp ^ m) - m;
        if ((int32_t)ux < (int32_t)uxp) {
            const uint32_t D = uxp - ux;
            return D <= p.xmax - uxp ? 2u * D - 1u : p.xmax - ux;
        }
        const uint32_t D = ux - uxp;
        return D <= uxp - p.xmin ? 2u * D : ux - p.xmin;
    }
    if (x >= xp) {
        const uint32_t D = x - xp;
        return D <= xp ? 2u * D : x;
    }
    const uint32_t D = xp - x;
    return D <= p.xmax - xp ? 2u * D - 1u : p.xmax - x;
}

// The bsz bytes of a sample, read as a little-endian integer, as the
// sample's value.
__device__ __forceinline__ uint32_t sample_of(uint32_t v, const Params& p) {
    if (p.msb) {
        if (p.bsz == 2) v = __byte_perm(v, 0, 0x4401);
        else if (p.bsz == 3) v = __byte_perm(v, 0, 0x4012);
        else if (p.bsz == 4) v = __byte_perm(v, 0, 0x0123);
    }
    return v & p.mask;
}

// A warp's block, two consecutive samples a lane: raw values x[r] and
// mapped values d[r] of samples i = 2 * lane + r (both 0 for i >= bs).
// The pair's 2 * bsz bytes start on a multiple of 2 * bsz (bs is even), so
// they come in as one aligned vector where the chunk itself is aligned
// (three 16-bit loads for 3-byte samples) and byte by byte otherwise.  A
// sample's predecessor is its lane's own first sample or the second of
// the lane before; lane 0 fetches the last sample of the block before.
// The first sample of an RSI is its reference (d = 0).
__device__ __forceinline__ void load_pair(const uint8_t* __restrict__ raw,
                                          long long blk, int b_in_rsi,
                                          int lane, const Params& p,
                                          uint32_t (&x)[2], uint32_t (&d)[2]) {
    const bool mine = 2 * lane < p.bs;
    const long long g = blk * p.bs + 2 * lane;
    x[0] = x[1] = 0;
    if (mine) {
        if (p.wide) {
            const uint8_t* s = raw + g * p.bsz;
            uint32_t v0, v1;
            if (p.bsz == 2) {
                const uint32_t w = *reinterpret_cast<const uint32_t*>(s);
                v0 = w & 0xFFFFu, v1 = w >> 16;
            } else if (p.bsz == 1) {
                const uint32_t w = *reinterpret_cast<const uint16_t*>(s);
                v0 = w & 0xFFu, v1 = w >> 8;
            } else if (p.bsz == 4) {
                const uint2 w = *reinterpret_cast<const uint2*>(s);
                v0 = w.x, v1 = w.y;
            } else {
                const uint16_t* h = reinterpret_cast<const uint16_t*>(s);
                const uint32_t h0 = h[0], h1 = h[1], h2 = h[2];
                v0 = h0 | (h1 & 0xFFu) << 16, v1 = h1 >> 8 | h2 << 8;
            }
            x[0] = sample_of(v0, p), x[1] = sample_of(v1, p);
        } else {
            x[0] = load_sample(raw, g, p), x[1] = load_sample(raw, g + 1, p);
        }
    }
    d[0] = x[0], d[1] = x[1];
    if (!p.pp) return;
    uint32_t before = __shfl_up_sync(FULL, x[1], 1);
    const bool ref = lane == 0 && b_in_rsi == 0;
    if (lane == 0 && !ref) before = load_sample(raw, g - 1, p);
    d[0] = d[1] = 0;
    if (mine) {
        if (!ref) d[0] = delta(x[0], before, p);
        d[1] = delta(x[1], x[0], p);
    }
}

// The block's sums over its samples of d >> k for every k < K, F(k) in
// lane k: K * bs shifts and adds, spread over all 32 lanes.  The lanes put
// their deltas into the warp's shared row sd (64 words, zeros past bs) and
// read them back four at a time, every lane the same words (a broadcast).
// Up to 16 values of k, a lane takes one k and half of the samples, and a
// shuffle adds the halves; else it takes one k and all samples.  Sums are
// kept in 32 bits for narrow samples (Params::narrow), else in 64.
template <typename Acc>
__device__ __forceinline__ Acc shifted_sum(const uint32_t* sd, int quads,
                                           int k) {
    const uint4* q = reinterpret_cast<const uint4*>(sd);
    Acc acc = 0;
    if (quads == 8) {  // half of a 64-sample block, the usual case: unrolled
#pragma unroll
        for (int i = 0; i < 8; i++) {
            const uint4 v = q[i];
            acc += (Acc)(v.x >> k) + (v.y >> k);
            acc += (Acc)(v.z >> k) + (v.w >> k);
        }
    } else {
#pragma unroll 4
        for (int i = 0; i < quads; i++) {
            const uint4 v = q[i];
            acc += (Acc)(v.x >> k) + (v.y >> k);
            acc += (Acc)(v.z >> k) + (v.w >> k);
        }
    }
    return acc;
}

__device__ __forceinline__ unsigned long long fs_sums(
        const uint32_t (&d)[2], uint32_t* sd, int K, int bs, bool narrow,
        int lane) {
    *reinterpret_cast<uint2*>(sd + 2 * lane) = make_uint2(d[0], d[1]);
    __syncwarp();
    const int n = (bs + 3) & ~3;
    const bool halves = K <= 16;
    const int k = halves ? lane & 15 : lane;
    const int from = halves && lane >= 16 ? 32 : 0;
    const int to = halves && lane < 16 && n > 32 ? 32 : n;
    const int quads = to > from ? (to - from) / 4 : 0;
    unsigned long long F;
    if (narrow)
        F = shifted_sum<uint32_t>(sd + from, quads, k);
    else
        F = shifted_sum<unsigned long long>(sd + from, quads, k);
    if (halves) F += __shfl_xor_sync(FULL, F, 16);
    __syncwarp();  // the warp's next block rewrites sd
    return F;
}

// The block's warm-start walk (encode.c:356-409, native/encoder.cpp
// walk_k) as a map over every incoming k, lane k0 computing entry k0, in
// the closed form of ops/options.k_walk_maps.  With L(k) the split length
// of lane k < K and F(k) its fs_len part:
//   A(k) := k >= kmax || L(k + 1) >= L(k)      the ascent stops at k
//   C(k) := k > 0 && F(k) < this_bs && L(k - 1) < L(k)   the descent passes k
// From k0 = 0 or where A(k0) fails the walk ascends to the first k >= k0
// with A(k); else, if L(k0 - 1) < L(k0), it descends to the last j < k0
// that C does not pass; else it stays.  Both ends are bit scans of a
// ballot.  T holds L: 32 bits are enough for narrow samples.
template <typename T>
__device__ __forceinline__ int walk_entry(T L, T F, uint32_t this_bs, int K,
                                          int kmax, int lane) {
    const T next = __shfl_down_sync(FULL, L, 1);
    const T prev = __shfl_up_sync(FULL, L, 1);
    const bool in = lane < K;
    const bool stops = lane >= kmax || next >= L;
    const bool prev_lt = lane > 0 && prev < L;
    const bool passes = prev_lt && F < this_bs;
    const uint32_t stop_mask = __ballot_sync(FULL, in && stops);
    const uint32_t hold_mask = __ballot_sync(FULL, !passes);
    if (!in) return lane;
    if (lane == 0 || !stops)  // kmax stops: a bit at or above lane is set
        return lane + __ffs(stop_mask >> lane) - 1;
    if (!prev_lt) return lane;
    // lane 0 never passes: a bit below lane is set
    return 31 - __clz(hold_mask & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(32 * WARPS)
pass_a(const uint8_t* __restrict__ raw, uint8_t* maps, uint8_t* zflag,
       uint8_t* comp, Params p) {
    __shared__ uint8_t seg[WARPS][32];
    __shared__ __align__(16) uint32_t sd[WARPS][64];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b0 = (long long)blockIdx.x * TILE + warp * PER_WARP;
    const int K = p.kmax + 1;
    int b_in_rsi = (int)(b0 % p.rsi);
    int c = lane;  // entry `lane` of the composite of the warp's maps so far
    for (int j = 0; j < PER_WARP && b0 + j < p.nb; j++) {  // warp-uniform
        const long long blk = b0 + j;
        const bool ref = p.pp && b_in_rsi == 0;
        const uint32_t this_bs = p.bs - (ref ? 1 : 0);

        uint32_t x[2], d[2];
        load_pair(raw, blk, b_in_rsi, lane, p, x, d);
        const bool z = !__any_sync(FULL, (d[0] | d[1]) != 0);

        const unsigned long long F = fs_sums(d, sd[warp], K, p.bs, p.narrow,
                                             lane);
        const unsigned long long L = F
            + (unsigned long long)this_bs * (lane + 1);
        const int k = p.narrow
            ? walk_entry((uint32_t)L, (uint32_t)F, this_bs, K, p.kmax, lane)
            : walk_entry(L, F, this_bs, K, p.kmax, lane);
        // a zero block is not searched: it hands k on as it came
        const int entry = z ? lane : k;
        maps[blk * 32 + lane] = (uint8_t)entry;
        if (lane == 0) zflag[blk] = z ? 1 : 0;
        // lane c holds this map's entry c: the composite takes it in
        c = __shfl_sync(FULL, entry, c);
        if (++b_in_rsi == p.rsi) b_in_rsi = 0;
    }
    // B1: the tile's composite, the warps' composites in turn
    seg[warp][lane] = (uint8_t)c;
    __syncthreads();
    if (warp == 0) {
        int e = lane;
        for (int s = 0; s < WARPS; s++) e = seg[s][e];
        comp[(long long)blockIdx.x * 32 + lane] = (uint8_t)e;
    }
}

// B2: one thread block of RUNS warps.  Composition of maps is associative,
// so warp w composes its own contiguous run of tile composites, lane k
// following entry k; one thread chains the RUNS run composites from k_init;
// then every warp walks its run again from the k that enters it and writes
// each tile's incoming k.  A warp stages PIECE composites at a time in
// shared memory, the next piece's loads in flight while it walks this one.
__device__ __forceinline__ void load_piece(const uint8_t* comp, long long t,
                                           long long t1, int lane,
                                           uint4 (&v)[PIECE / 16]) {
    const uint4* src = reinterpret_cast<const uint4*>(comp + t * 32);
    const long long n = (t1 - t) * 2;  // 16-byte vectors left in the run
#pragma unroll
    for (int j = 0; j < PIECE / 16; j++)
        if (lane + 32 * j < n) v[j] = src[lane + 32 * j];
}

__global__ void __launch_bounds__(32 * RUNS)
chain_scan(const uint8_t* comp, int* tile_kin, const int* k_init,
           int* k_final, long long nt) {
    __shared__ __align__(16) uint8_t piece[RUNS][PIECE * 32];
    __shared__ uint8_t run_comp[RUNS][32];
    __shared__ int run_kin[RUNS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long run = (nt + RUNS - 1) / RUNS;
    const long long t0 = warp * run;
    const long long t1 = t0 + run < nt ? t0 + run : nt;  // <= t0: no tiles
    uint4* mine = reinterpret_cast<uint4*>(piece[warp]);
    for (int pass = 0; pass < 2; pass++) {
        // pass 0: entry k of the run's composite; pass 1: the k that
        // enters each tile, the same in every lane
        int k = pass ? run_kin[warp] : lane;
        uint4 v[PIECE / 16];
        if (t0 < t1) load_piece(comp, t0, t1, lane, v);
        for (long long t = t0; t < t1; t += PIECE) {
            const int n = (int)(t1 - t < PIECE ? t1 - t : PIECE);
#pragma unroll
            for (int j = 0; j < PIECE / 16; j++) mine[lane + 32 * j] = v[j];
            __syncwarp();
            if (t + PIECE < t1) load_piece(comp, t + PIECE, t1, lane, v);
            int kin = 0;
            for (int i = 0; i < n; i++) {
                if (lane == i) kin = k;
                k = piece[warp][i * 32 + k];
            }
            if (pass && lane < n) tile_kin[t + lane] = kin;
            __syncwarp();
        }
        if (pass) break;
        run_comp[warp][lane] = (uint8_t)k;
        __syncthreads();
        if (threadIdx.x == 0) {
            const int k0 = *k_init;
            int kk = k0 < 0 ? 0 : (k0 > 31 ? 31 : k0);
            for (int w = 0; w < RUNS; w++) {
                run_kin[w] = kk;
                kk = run_comp[w][kk];
            }
            *k_final = kk;
        }
        __syncthreads();
    }
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
    for (int s = 1; s < 32; s <<= 1) {
        const uint32_t o = __shfl_up_sync(FULL, v, s);
        if (lane >= s) v += o;
    }
    return v;
}

// OR a field of value v ending at window bit e into the window
// (ops/bitpack.py stage A: words (e >> 5) - 1 and e >> 5).
__device__ __forceinline__ void put(uint32_t* w, int w0, uint32_t e,
                                    uint32_t v) {
    const uint32_t t = e & 31, q = e >> 5;
    if (q >= 1 && q - 1 < (uint32_t)w0) atomicOr(&w[q - 1], v >> t);
    if (t && q < (uint32_t)w0) atomicOr(&w[q], v << (32 - t));
}

// A lane's two adjacent fields, of widths wa then wb and values va, vb,
// the second ending at window bit e: one field where the two values fit
// 32 bits together, two otherwise.
__device__ __forceinline__ void put_two(uint32_t* w, int w0, uint32_t e,
                                        uint32_t wa, uint32_t va,
                                        uint32_t wb, uint32_t vb) {
    if (wb < 32 && ((unsigned long long)va << wb) <= 0xFFFFFFFFull) {
        if (wa | wb) put(w, w0, e, va << wb | vb);
    } else {
        if (wa) put(w, w0, e - wb, va);
        if (wb) put(w, w0, e, vb);
    }
}

// C for one block: the warp's window w (shared memory), then win[blk] and
// block_bits[blk], from the k its search ends at.
__device__ __forceinline__ void emit_block(
        const uint8_t* __restrict__ raw, const uint8_t* zflag, uint32_t* win,
        uint32_t* block_bits, long long blk, int b_in_rsi, uint32_t ku,
        uint32_t* w, int lane, const Params& p) {
    const long long rsi_first = blk - b_in_rsi;
    const bool ref = p.pp && b_in_rsi == 0;
    const uint32_t refu = ref ? 1 : 0;
    const uint32_t this_bs = p.bs - refu;
    const uint32_t ub = this_bs * p.bps;

    for (int j = lane; j < p.w0; j += 32) w[j] = 0;

    // samples i = 2 * lane + r, r = 0, 1
    uint32_t x[2], d[2];
    load_pair(raw, blk, b_in_rsi, lane, p, x, d);
    const bool mine = 2 * lane < p.bs;
    const bool z = zflag[blk] != 0;

    // split length at the chosen k, truncated to u32 (encode.c:409): the
    // lanes' terms and their sum wrap as the truncation does
    const uint32_t split32 = __reduce_add_sync(
        FULL, (d[0] >> ku) + (d[1] >> ku)) + this_bs * (ku + 1);

    // second extension (assess_se_option, encode.c:412-434): a lane's two
    // samples are one pair
    const uint32_t dsum = d[0] + d[1];
    const uint32_t fsx = dsum * (dsum + 1u) / 2u + d[1];
    const bool small = dsum >= d[0] && dsum < 128u;
    const uint32_t se_total = 1u + __reduce_add_sync(
        FULL, mine ? (small ? fsx : (1u << 20)) + 1u : 0u);
    const uint32_t se_len = se_total > ub ? 0xFFFFFFFFu : se_total;

    // option select (m_select_code_option, encode.c:585-612)
    const bool pick_split = split32 < ub && split32 < se_len;
    const bool pick_unc = !(split32 < ub) && ub <= se_len;
    const bool is_split = !z && pick_split;
    const bool is_unc = !z && !pick_split && pick_unc;
    const bool is_se = !z && !pick_split && !pick_unc;

    // zero-block runs (m_check_zero_block, encode.c:614-659): the run's
    // CDS sits on its last zero block within the 64-block segment
    bool zero_emit = false, zero_ref = false;
    uint32_t zero_fsval = 0;
    if (z) {
        const int seg_base = b_in_rsi & ~63;
        const int seg_len = p.rsi - seg_base < 64 ? p.rsi - seg_base : 64;
        const int pos = b_in_rsi - seg_base;
        const uint8_t* zs = zflag + rsi_first + seg_base;
        const bool z0 = lane < seg_len && zs[lane];
        const bool z1 = lane + 32 < seg_len && zs[lane + 32];
        const unsigned long long zm =
            (unsigned long long)__ballot_sync(FULL, z0) |
            ((unsigned long long)__ballot_sync(FULL, z1) << 32);
        const bool seg_last = pos == 63 || b_in_rsi == p.rsi - 1;
        const bool znext = pos + 1 < seg_len && ((zm >> (pos + 1)) & 1);
        zero_emit = seg_last || !znext;
        if (zero_emit) {
            const unsigned long long below =
                pos ? ~zm & ((1ull << pos) - 1) : 0ull;
            const int start = below ? 64 - __clzll((long long)below) : 0;
            const int n_run = pos - start + 1;
            const bool ros = seg_last && n_run > 4;
            zero_fsval = ros ? 4u : (n_run >= 5 ? n_run : n_run - 1);
            zero_ref = p.pp && seg_base + start == 0;
        }
    }

    // header: option id and reference sample (encode.c:520-583)
    const uint32_t id_w = (is_split || is_unc) ? p.id_len
                          : (is_se || zero_emit) ? p.id_len + 1 : 0;
    const uint32_t id_v = is_split ? ku + 1
                          : is_unc ? (1u << p.id_len) - 1u
                          : is_se ? 1u : 0u;
    const bool ref_here = ((is_split || is_se) && ref) ||
                          (zero_emit && zero_ref);
    const uint32_t ref_w = ref_here ? p.bps : 0;

    // per-sample mid (FS / raw / SE / zero-run) and lsb fields
    uint32_t mw[2], mv[2], lw[2], lv[2];
    for (int r = 0; r < 2; r++) {
        const uint32_t i = 2 * lane + r;
        mw[r] = mv[r] = lw[r] = lv[r] = 0;
        if (!mine) continue;
        const bool act = i >= refu;
        if (is_split && act) {
            mw[r] = (d[r] >> ku) + 1u;
            mv[r] = 1;
            if (ku > 0) {
                lw[r] = ku;
                lv[r] = d[r] & ((1u << ku) - 1u);
            }
        } else if (is_unc) {
            mw[r] = p.bps;
            mv[r] = (i == 0 && ref ? x[r] : d[r]) & p.mask;
        } else if (is_se && r == 0) {
            mw[r] = fsx + 1u;
            mv[r] = 1;
        }
        if (i == 0 && zero_emit) {
            mw[r] = zero_fsval + 1u;
            mv[r] = 1;
        }
    }

    // bit offsets in stream order: a prefix sum over the lanes' mid
    // widths; the lsb fields, all ku wide, lie where their index says
    const uint32_t m_end = warp_incl_scan(mw[0] + mw[1], lane);
    const uint32_t mid_tot = __shfl_sync(FULL, m_end, 31);
    const uint32_t lsb_tot = is_split ? ku * this_bs : 0;
    const uint32_t l_end = ku * (2 * lane + 2 - refu);  // of sample 2l + 1

    const uint32_t e_h0 = 32u + id_w;
    const uint32_t e_h1 = e_h0 + ref_w;
    const uint32_t e_mid0 = e_h1 + mid_tot;
    const uint32_t e_end = e_mid0 + lsb_tot;

    __syncwarp();  // the window is zero
    if (lane == 0) {
        if (id_w) put(w, p.w0, e_h0, id_v);
        if (ref_w) put(w, p.w0, e_h1, load_sample(raw, rsi_first * p.bs, p));
    }
    put_two(w, p.w0, e_h1 + m_end, mw[0], mv[0], mw[1], mv[1]);
    put_two(w, p.w0, e_mid0 + l_end, lw[0], lv[0], lw[1], lv[1]);
    __syncwarp();
    uint32_t* out = win + blk * p.w0;
    for (int j = lane; j < p.w0; j += 32) out[j] = w[j];
    if (lane == 0) block_bits[blk] = e_end - 32u;
}

__global__ void __launch_bounds__(32 * WARPS)
pass_c(const uint8_t* __restrict__ raw, const uint8_t* zflag,
       const uint8_t* maps, const int* tile_kin, uint32_t* win,
       uint32_t* block_bits, Params p) {
    __shared__ uint32_t sw[WARPS][MAXW];
    __shared__ uint8_t seg[WARPS][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b0 = (long long)blockIdx.x * TILE + warp * PER_WARP;
    // B3: entry `lane` of each of the warp's maps (identity past the last
    // block) and of their composite
    uint32_t m[PER_WARP];
#pragma unroll
    for (int j = 0; j < PER_WARP; j++)
        m[j] = b0 + j < p.nb ? maps[(b0 + j) * 32 + lane] : lane;
    int c = lane;
#pragma unroll
    for (int j = 0; j < PER_WARP; j++) c = __shfl_sync(FULL, m[j], c);
    seg[warp][lane] = (uint8_t)c;
    __syncthreads();
    // the k that enters the warp's first block, then the k each of its
    // blocks' searches ends at, a byte each
    int k = tile_kin[blockIdx.x];
    for (int s = 0; s < warp; s++) k = seg[s][k];
    unsigned long long ks = 0;
#pragma unroll
    for (int j = 0; j < PER_WARP; j++) {
        k = __shfl_sync(FULL, m[j], k);
        ks |= (unsigned long long)k << (8 * j);
    }
    int b_in_rsi = (int)(b0 % p.rsi);
    for (int j = 0; j < PER_WARP && b0 + j < p.nb; j++) {  // warp-uniform
        emit_block(raw, zflag, win, block_bits, b0 + j, b_in_rsi,
                   (uint32_t)(ks >> (8 * j)) & 31u, sw[warp], lane, p);
        if (++b_in_rsi == p.rsi) b_in_rsi = 0;
        __syncwarp();  // the next block rewrites the window
    }
}

}  // namespace

extern "C" int aec_encode_fields(
    const void* raw, void* win, void* block_bits, void* maps, void* zflag,
    void* comp, void* tile_kin, const void* k_init, void* k_final,
    long long nb, int rsi, int bs, int bps, int bsz, int msb, int pp,
    int sgn, int id_len, int kmax, int w0, unsigned xmax, unsigned xmin,
    unsigned mask, void* stream) {
    if (w0 > MAXW || bs > 64 || bs % 2 || kmax > 31)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    Params p{nb, rsi, bs, bps, bsz, msb, pp, sgn, id_len, kmax, w0,
             (uintptr_t)raw % 8 == 0, bps <= 25, xmax, xmin, mask};
    const long long nt = (nb + TILE - 1) / TILE;
    pass_a<<<(unsigned)nt, 32 * WARPS, 0, s>>>(
        (const uint8_t*)raw, (uint8_t*)maps, (uint8_t*)zflag, (uint8_t*)comp,
        p);
    chain_scan<<<1, 32 * RUNS, 0, s>>>((const uint8_t*)comp, (int*)tile_kin,
                                       (const int*)k_init, (int*)k_final, nt);
    pass_c<<<(unsigned)nt, 32 * WARPS, 0, s>>>(
        (const uint8_t*)raw, (const uint8_t*)zflag, (const uint8_t*)maps,
        (const int*)tile_kin, (uint32_t*)win, (uint32_t*)block_bits, p);
    return (int)cudaGetLastError();
}
