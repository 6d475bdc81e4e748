// Native scalar CCSDS 121.0-B-2 encoder.
//
// From-scratch single-pass design (NOT the reference's resumable FSM,
// libaec's src/encode.c:467-754): one forward loop over blocks with
// a 64-bit accumulator emitter, the option search expressed exactly as the
// oracle-validated formulations in libaec_tpu/ops/{options,zeroruns,
// fields,preprocess}.py.  Roles in the TPU framework:
//   * low-latency encode for small buffers (the device pipeline wins only
//     once dispatch overhead amortises);
//   * the encode half of the C-ABI compatibility layer, so non-Python
//     consumers (HDF5 szip-style filters) get a standalone native codec.
//
// Behavioural contracts reproduced (same as the Python pipeline):
//   option selection precedence  encode.c:585-612 (split<uncomp, uncomp<=se)
//   warm-started k walk          encode.c:329-410 (see ops/options.py's
//                                closed-form derivation; scalar walk here)
//   zero-run/ROS segmentation    encode.c:565-659 (ops/zeroruns.py rules)
//   Δ-preprocessor               encode.c:235-311 (ops/preprocess.py maps)
//   field layout                 ops/fields.py (id / ref-sample / FS / LSB)
//   tail-RSI padding             encode.c:676-685 (repeat last sample)
//   final zero-bit flush + empty-input flush byte   encode.c:686-696
//   AEC_PAD_RSI per-RSI byte alignment              encode.c:499-505

#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

constexpr int E_AEC_OK = 0;
constexpr int E_AEC_CONF_ERROR = -1;
constexpr int E_AEC_STREAM_ERROR = -2;

constexpr unsigned E_FLAG_SIGNED = 1;
constexpr unsigned E_FLAG_3BYTE = 2;
constexpr unsigned E_FLAG_MSB = 4;
constexpr unsigned E_FLAG_PREPROCESS = 8;
constexpr unsigned E_FLAG_RESTRICTED = 16;
constexpr unsigned E_FLAG_PAD_RSI = 32;
constexpr unsigned E_FLAG_NOT_ENFORCE = 64;

struct EncParams {
    unsigned bps, bs, rsi, flags;

    int id_len() const {
        if (bps > 16) return 5;
        if (bps > 8) return 4;
        if (flags & E_FLAG_RESTRICTED) return bps <= 2 ? 1 : 2;
        return 3;
    }
    int bytes_per_sample() const {
        if (bps > 16) return (bps <= 24 && (flags & E_FLAG_3BYTE)) ? 3 : 4;
        return bps > 8 ? 2 : 1;
    }
    uint32_t mask() const {
        return bps >= 32 ? 0xFFFFFFFFu : ((1u << bps) - 1);
    }
    uint32_t xmax() const {
        if (flags & E_FLAG_SIGNED)
            return UINT32_MAX >> ((32 - bps + 1) & 31);
        return UINT32_MAX >> (32 - bps);
    }
    uint32_t xmin() const {
        return (flags & E_FLAG_SIGNED) ? ~xmax() : 0;
    }
    int kmax() const { return (1 << id_len()) - 3; }
    bool pp() const { return flags & E_FLAG_PREPROCESS; }
};

// MSB-first accumulator emitter with output-capacity accounting: bytes
// past the capacity are counted but not stored, so the caller learns the
// full stream size alongside AEC_STREAM_ERROR (aec_buffer_encode's
// caller-owned next_out/avail_out contract, libaec.h:154-166).
class Emitter {
  public:
    Emitter(uint8_t* out, size_t cap) : out_(out), cap_(cap) {}

    void emit(uint32_t v, int w) {  // w in [0, 32]
        if (w == 0) return;
        uint64_t vv = (w == 32) ? v : (v & ((1u << w) - 1));
        acc_ = (acc_ << w) | vv;
        nbits_ += w;  // < 64: at most 31 carried + 32 emitted
        if (nbits_ >= 32) {
            nbits_ -= 32;
            put_word((uint32_t)(acc_ >> nbits_));
        }
    }

    void emit_fs(uint64_t fs) {  // fs zeros then a 1
        while (fs >= 32) {
            emit(0, 32);
            fs -= 32;
        }
        emit(1, (int)fs + 1);
    }

    void pad_to_byte() {
        while (nbits_ >= 8) {
            nbits_ -= 8;
            put_byte((uint8_t)(acc_ >> nbits_));
        }
        if (nbits_) {
            put_byte((uint8_t)(acc_ << (8 - nbits_)));
            nbits_ = 0;
        }
        acc_ = 0;
    }

    size_t total_bytes() const { return pos_ + (nbits_ + 7) / 8; }
    size_t flushed_bytes() const { return pos_; }
    bool overflow() const { return overflow_; }

    // bit-carry transfer between per-chunk emitters (streaming sessions)
    uint64_t carry_acc() const { return acc_; }
    int carry_bits() const { return nbits_; }
    void set_carry(uint64_t a, int n) { acc_ = a; nbits_ = n; }

  private:
    void put_byte(uint8_t b) {
        if (pos_ < cap_)
            out_[pos_] = b;
        else
            overflow_ = true;
        pos_++;
    }

    void put_word(uint32_t w) {  // 4 stream bytes, big-endian bit order
        if (pos_ + 4 <= cap_) {
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
            w = __builtin_bswap32(w);
#endif
            std::memcpy(out_ + pos_, &w, 4);
            pos_ += 4;
        } else {
            put_byte((uint8_t)(w >> 24));
            put_byte((uint8_t)(w >> 16));
            put_byte((uint8_t)(w >> 8));
            put_byte((uint8_t)w);
        }
    }

    uint8_t* out_;
    size_t cap_;
    size_t pos_ = 0;
    uint64_t acc_ = 0;
    int nbits_ = 0;
    bool overflow_ = false;
};

// Byte layout -> u32 samples (ops/accessors.bytes_to_samples semantics).
// Samples are MASKED to bits_per_sample at ingest -- a deliberate
// deviation: the reference's accessors never mask and its emitters then
// byte-add out-of-range bits into neighbouring fields (encode.c:61-83's
// `+=`), corrupting its own bitstream; masking yields the deterministic
// stream of the masked input, identical across every backend here
// (Config.mask documents the same for the Python side).
static void read_samples(const uint8_t* p, size_t n, int bsz, bool msb,
                         uint32_t mask, uint32_t* x) {
    switch (bsz) {
        case 1:
            for (size_t i = 0; i < n; i++) x[i] = p[i] & mask;
            break;
        case 2:
            // memcpy+bswap formulation: the byte-combine form defeats
            // auto-vectorisation and was ~44% of total encode time
            if (msb)
                for (size_t i = 0; i < n; i++) {
                    uint16_t t;
                    std::memcpy(&t, p + 2 * i, 2);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
                    t = __builtin_bswap16(t);
#endif
                    x[i] = t & mask;
                }
            else
                for (size_t i = 0; i < n; i++) {
                    uint16_t t;
                    std::memcpy(&t, p + 2 * i, 2);
#if __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
                    t = __builtin_bswap16(t);
#endif
                    x[i] = t & mask;
                }
            break;
        case 3:
            if (msb)
                for (size_t i = 0; i < n; i++)
                    x[i] = (((uint32_t)p[3 * i] << 16) |
                            ((uint32_t)p[3 * i + 1] << 8) | p[3 * i + 2]) &
                           mask;
            else
                for (size_t i = 0; i < n; i++)
                    x[i] = (((uint32_t)p[3 * i + 2] << 16) |
                            ((uint32_t)p[3 * i + 1] << 8) | p[3 * i]) &
                           mask;
            break;
        default:
            if (msb)
                for (size_t i = 0; i < n; i++) {
                    uint32_t v;
                    std::memcpy(&v, p + 4 * i, 4);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
                    v = __builtin_bswap32(v);
#endif
                    x[i] = v & mask;
                }
            else
                for (size_t i = 0; i < n; i++) {
                    uint32_t v;
                    std::memcpy(&v, p + 4 * i, 4);
#if __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
                    v = __builtin_bswap32(v);
#endif
                    x[i] = v & mask;
                }
    }
}

// Forward Δ-map of one RSI, out-of-place (d[0] = 0; the caller keeps the
// reference sample from x[0]).  Semantics are the reference's four-branch
// mapping (encode.c:255-309 / ops/preprocess.py), rewritten in the
// equivalent branchless theta form:
//     theta = min(prev - xmin, xmax - prev)
//     |D| <= theta  ->  zigzag(D)         (2D for D>=0, -2D-1 for D<0)
//     else          ->  theta + |D|
// Equivalence: up-moves have D <= xmax - prev always, so the clamp branch
// (d = cur - xmin = theta + D) is reachable only when theta = prev - xmin;
// symmetrically for down-moves.  The map touches only (x[i-1], x[i]) --
// no loop-carried state -- so writing OUT-of-place makes it a pure
// vectorisable map (the in-place version serialised on the store).
template <typename T>
static inline void delta_map(const uint32_t* x, uint32_t* d, size_t n,
                             uint32_t m, T xmin, T xmax) {
    using U = typename std::make_unsigned<T>::type;
    for (size_t i = 1; i < n; i++) {
        T prev = (T)(int32_t)((x[i - 1] ^ m) - m);
        T cur = (T)(int32_t)((x[i] ^ m) - m);
        T D = cur - prev;
        T sgn = D >> (sizeof(T) * 8 - 1);  // 0 or -1
        T mag = (D ^ sgn) - sgn;
        T t_up = prev - xmin, t_dn = xmax - prev;
        T theta = t_up < t_dn ? t_up : t_dn;
        // zigzag in unsigned arithmetic: D<<1 may exceed T's positive
        // range (it is only SELECTED when mag <= theta, but it must not
        // be UB to compute)
        U zz = ((U)D << 1) ^ (U)sgn;
        d[i] = (uint32_t)(mag <= theta ? zz : (U)(theta + mag));
    }
}

// unsigned specialisation: no sign-extension, values are already u32
static inline void delta_map_u(const uint32_t* x, uint32_t* d, size_t n,
                               uint32_t xmax) {
    for (size_t i = 1; i < n; i++) {
        uint32_t prev = x[i - 1], cur = x[i];
        int32_t D = (int32_t)(cur - prev);
        int32_t sgn = D >> 31;
        uint32_t mag = (uint32_t)((D ^ sgn) - sgn);
        uint32_t t_dn = xmax - prev;
        uint32_t theta = prev < t_dn ? prev : t_dn;
        uint32_t zz = ((uint32_t)D << 1) ^ (uint32_t)sgn;
        d[i] = mag <= theta ? zz : theta + mag;
    }
}

// unsigned bps=32: differences exceed int32; zero-extend into int64
static inline void delta_map_u64(const uint32_t* x, uint32_t* d, size_t n,
                                 int64_t xmax) {
    for (size_t i = 1; i < n; i++) {
        int64_t prev = x[i - 1], cur = x[i];
        int64_t D = cur - prev;
        int64_t sgn = D >> 63;
        int64_t mag = (D ^ sgn) - sgn;
        int64_t t_dn = xmax - prev;
        int64_t theta = prev < t_dn ? prev : t_dn;
        int64_t zz = (int64_t)(((uint64_t)D << 1) ^ (uint64_t)sgn);
        d[i] = (uint32_t)(mag <= theta ? zz : theta + mag);
    }
}

static void delta_rsi(const uint32_t* x, uint32_t* d, size_t n,
                      const EncParams& p) {
    if (n == 0) return;
    d[0] = 0;
    // samples are masked at ingest (read_samples), so the branchless
    // theta maps below are exact: their equivalence proof needs
    // xmin <= value <= xmax, which masking guarantees
    if (!(p.flags & E_FLAG_SIGNED)) {
        if (p.bps <= 31)
            // bps<=31: cur-prev fits int32 exactly
            delta_map_u(x, d, n, p.xmax());
        else
            delta_map_u64(x, d, n, (int64_t)p.xmax());
    } else if (p.bps == 1) {
        // reference quirk (encode.c:866): signed bps=1 derives xmax from
        // an out-of-range shift (UINT32_MAX >> 32), leaving
        // xmax=UINT32_MAX / xmin=0 on x86 -- the clamp conditions then
        // never fire, so the map degenerates to pure zigzag
        // (config.py:104-112 documents the same for the device path)
        delta_map<int64_t>(x, d, n, 1u, INT64_MIN / 2, INT64_MAX / 2);
    } else {
        const uint32_t m = 1u << (p.bps - 1);
        if (p.bps <= 31)
            delta_map<int32_t>(x, d, n, m, (int32_t)p.xmin(),
                               (int32_t)p.xmax());
        else
            delta_map<int64_t>(x, d, n, m, (int64_t)(int32_t)p.xmin(),
                               (int64_t)(int32_t)p.xmax());
    }
}

// One block's encode context.
struct BlockCtx {
    const uint32_t* d;  // bs preprocessed samples (d[0]==0 on ref blocks)
    unsigned bs;
    bool ref;            // block carries the RSI reference sample
    uint32_t ref_sample; // raw, pre-masked
};

// fs_len(k) = sum_i(d_i >> k) over the WHOLE block (ops/options.fs_tables:
// the reference sums the ref slot too; d[0]==0 there so it is harmless).
static uint64_t fs_len(const BlockCtx& c, int k) {
    uint64_t s = 0;
    for (unsigned i = 0; i < c.bs; i++) s += c.d[i] >> k;
    return s;
}

// One fused vector pass per block: the OR of all samples (zero-block
// test) and the three fs sums the warm-started k walk touches first
// (k0-1, k0, k0+1) -- branch-free reductions the compiler vectorises,
// replacing the early-exit scalar zero check plus a separate sum pass.
struct BlockScan {
    uint32_t orv;
    uint64_t s0, s1, s2;
    int lo;
};

static BlockScan scan_block(const uint32_t* db, unsigned bs, int k0) {
    const int lo = k0 > 0 ? k0 - 1 : 0;
    uint32_t orv = 0;
    uint64_t s0 = 0, s1 = 0, s2 = 0;
    for (unsigned i = 0; i < bs; i++) {
        uint32_t raw = db[i];
        orv |= raw;
        uint32_t v = raw >> lo;
        s0 += v;
        s1 += v >> 1;
        s2 += v >> 2;
    }
    return {orv, s0, s1, s2, lo};
}

// Warm-started k walk (ops/options.k_walk_maps derivation of
// encode.c:356-409):
//   A(k) := k >= kmax || L(k+1) >= L(k)        (ascent stops at k)
//   C(j) := j > 0 && fs_len(j) < this_bs && L(j-1) < L(j)
//   k0 == 0 || !A(k0) -> min{k >= k0 : A(k)};
//   else L(k0-1) < L(k0) ? max{j <= k0-1 : !C(j)} : k0.
static int walk_k(const BlockCtx& c, uint32_t this_bs, int kmax, int k0,
                  const BlockScan& sc, uint64_t* L_out) {
    uint64_t Lmemo[34];
    bool have[34] = {false};
    // seed from the fused scan pass: L at lo, lo+1, lo+2
    {
        const int lo = sc.lo;
        Lmemo[lo] = sc.s0 + (uint64_t)this_bs * (lo + 1);
        Lmemo[lo + 1] = sc.s1 + (uint64_t)this_bs * (lo + 2);
        Lmemo[lo + 2] = sc.s2 + (uint64_t)this_bs * (lo + 3);
        have[lo] = have[lo + 1] = have[lo + 2] = true;
    }
    auto L = [&](int k) -> uint64_t {
        if (!have[k]) {
            Lmemo[k] = fs_len(c, k) + (uint64_t)this_bs * (k + 1);
            have[k] = true;
        }
        return Lmemo[k];
    };
    auto A = [&](int k) { return k >= kmax || L(k + 1) >= L(k); };

    int k;
    if (k0 != 0 && A(k0)) {
        if (L(k0 - 1) < L(k0)) {
            int j = k0 - 1;
            // fs_len(j) recovered from the memoised L(j)
            while (j > 0 &&
                   L(j) - (uint64_t)this_bs * (j + 1) < this_bs &&
                   L(j - 1) < L(j))
                j--;
            k = j;
        } else {
            k = k0;
        }
    } else {
        k = k0;
        while (!A(k)) k++;
    }
    *L_out = L(k);
    return k;
}

// SE comparison length (ops/options.se_lengths): 1 + sum over pairs of
// (fs + 1) with the oracle-validated smallness gate (u32-wrapping sums or
// sums >= 128 can never be selected: their fs alone exceeds any
// uncomp_len <= 2048).  `bound` is the tightest competitor length (the
// min of uncomp_len and the split length): SE is only ever SELECTED when
// strictly below both, so the loop may abort as soon as len exceeds it --
// the returned sentinel compares correctly in either direction.
static uint64_t se_len(const BlockCtx& c, uint64_t bound) {
    uint64_t len = 1;
    for (unsigned i = 0; i < c.bs; i += 2) {
        uint32_t a = c.d[i], b = c.d[i + 1];
        uint32_t s = a + b;
        uint64_t m = (s >= a && s < 128)
                         ? (uint64_t)s * (s + 1) / 2 + b
                         : (uint64_t)1 << 20;
        len += m + 1;
        if (len > bound) return UINT32_MAX;
    }
    return len;
}

struct ZeroRun {
    unsigned count = 0;
    bool ref = false;
    uint32_t ref_sample = 0;
};

static void emit_zero_run(Emitter& em, ZeroRun& z, const EncParams& p,
                          bool at_seg_end) {
    // codeword: id 0 in id_len+1 bits, optional reference sample, FS of
    // 4 (ROS) / count (>=5) / count-1 (1..4)  -- ops/zeroruns.py rules
    em.emit(0, p.id_len() + 1);
    if (z.ref) em.emit(z.ref_sample & p.mask(), p.bps);
    uint64_t fsval;
    if (at_seg_end && z.count > 4)
        fsval = 4;  // remainder-of-segment marker
    else if (z.count >= 5)
        fsval = z.count;
    else
        fsval = z.count - 1;
    em.emit_fs(fsval);
    z = ZeroRun{};
}

// Register-resident 64-bit batcher over an Emitter: codes accumulate
// locally (no member-field traffic) and flush to the emitter one whole
// 32-bit word at a time -- the same accumulator idea as the reference's
// emitblock (encode.c:144-233), expressed as a tiny adapter.
struct Batch {
    Emitter& em;
    uint64_t a = 0;
    int n = 0;  // invariant: n < 32 between push() calls

    explicit Batch(Emitter& e) : em(e) {}
    inline void push(uint32_t v, int w) {  // w in [1, 32]
        a = (a << w) | (uint64_t)v;
        n += w;
        if (n >= 32) {
            n -= 32;
            em.emit((uint32_t)(a >> n), 32);
        }
    }
    void flush() {
        if (n) em.emit((uint32_t)a, n);
        a = 0;
        n = 0;
    }
};

// Per-block plan byte: 0xFF = all-zero block; otherwise (sel << 5) | k
// with sel 0 = splitting, 1 = uncompressed, 2 = second extension.
// Decision and emission are separate so the parallel encoder can run the
// (serial, k-chained) decision pass ahead of (parallel) emission.
constexpr uint8_t PLAN_ZERO = 0xFF;

static uint8_t decide_block(const BlockCtx& c, const EncParams& p,
                            int* k_state, const BlockScan& sc) {
    const int id_len = p.id_len();
    const uint32_t this_bs = c.bs - (c.ref ? 1 : 0);
    const uint64_t uncomp_len = (uint64_t)this_bs * p.bps;

    uint64_t split_len64 = UINT64_MAX;
    int k = *k_state;
    if (id_len > 1) {
        k = walk_k(c, this_bs, p.kmax(), *k_state, sc, &split_len64);
        *k_state = k;
    }
    // the reference compares the u32 truncation (encode.c:409)
    uint32_t split32 =
        id_len > 1 ? (uint32_t)split_len64 : 0xFFFFFFFFu;
    uint64_t se_bound = uncomp_len < split32 ? uncomp_len : split32;
    uint64_t se = se_len(c, se_bound);

    unsigned sel;
    if (split32 < uncomp_len && split32 < se)
        sel = 0;
    else if (!(split32 < uncomp_len) && uncomp_len <= se)
        sel = 1;
    else
        sel = 2;
    return (uint8_t)((sel << 5) | (unsigned)k);  // k <= 29 fits 5 bits
}

static void emit_block_planned(Emitter& em, const BlockCtx& c,
                               const EncParams& p, uint8_t plan) {
    const int id_len = p.id_len();
    const uint32_t mask = p.mask();
    const unsigned sel = plan >> 5;
    const int k = plan & 31;

    if (sel == 0) {  // splitting, id = k+1
        Batch b(em);
        b.push((uint32_t)k + 1, id_len);
        if (c.ref) b.push(c.ref_sample & mask, p.bps);
        // FS pass, two codes per push (halves the serial accumulator
        // chain): typical codes are 1-4 bits, so pairs almost always fit
        // one push; oversized codes flush and take the chunked emit_fs
        // path
        unsigned i = c.ref ? 1 : 0;
        for (; i + 1 < c.bs; i += 2) {
            uint32_t fa = c.d[i] >> k, fb = c.d[i + 1] >> k;
            uint64_t w = (uint64_t)fa + fb + 2;  // u64: no wrap on huge fs
            if (w <= 32) {
                b.push((1u << (fb + 1)) | 1u, (int)w);
            } else if (fa < 32 && fb < 32) {
                b.push(1u, (int)fa + 1);
                b.push(1u, (int)fb + 1);
            } else {
                b.flush();
                if (fa < 32)
                    b.push(1u, (int)fa + 1);
                else
                    em.emit_fs(fa);
                b.flush();
                if (fb < 32)
                    b.push(1u, (int)fb + 1);
                else
                    em.emit_fs(fb);
            }
        }
        for (; i < c.bs; i++) {
            uint32_t fs = c.d[i] >> k;
            if (fs < 32) {
                b.push(1u, (int)fs + 1);
            } else {
                b.flush();
                em.emit_fs(fs);
            }
        }
        if (k) {
            const uint32_t km = (1u << k) - 1;
            unsigned j = c.ref ? 1 : 0;
            if (k <= 16)  // pair-combine: halves the pushes
                for (; j + 1 < c.bs; j += 2)
                    b.push(((c.d[j] & km) << k) | (c.d[j + 1] & km),
                           2 * k);
            for (; j < c.bs; j++) b.push(c.d[j] & km, k);
        }
        b.flush();
    } else if (sel == 1) {  // uncompressed, id = all-ones
        Batch b(em);
        b.push((1u << id_len) - 1, id_len);
        for (unsigned i = 0; i < c.bs; i++) {
            uint32_t v = (i == 0 && c.ref) ? c.ref_sample : c.d[i];
            b.push(v & mask, p.bps);
        }
        b.flush();
    } else {  // second extension, id 1 in id_len+1 bits
        em.emit(1, id_len + 1);
        if (c.ref) em.emit(c.ref_sample & mask, p.bps);
        for (unsigned i = 0; i < c.bs; i += 2) {
            uint64_t s = (uint64_t)c.d[i] + c.d[i + 1];
            em.emit_fs(s * (s + 1) / 2 + c.d[i + 1]);
        }
    }
}

static inline void encode_block(Emitter& em, const BlockCtx& c,
                                const EncParams& p, int* k_state,
                                const BlockScan& sc) {
    emit_block_planned(em, c, p, decide_block(c, p, k_state, sc));
}

// Encode one RSI's worth of preprocessed samples (nb whole blocks).
static void encode_rsi(Emitter& em, const uint32_t* d, unsigned nb,
                       uint32_t ref_sample, const EncParams& p,
                       int* k_state) {
    const unsigned bs = p.bs;
    ZeroRun z;
    for (unsigned b = 0; b < nb; b++) {
        const uint32_t* db = d + (size_t)b * bs;
        bool ref = p.pp() && b == 0;
        BlockScan sc = scan_block(db, bs, *k_state);
        if (!sc.orv) {  // all-zero block
            if (z.count == 0 && ref) {
                z.ref = true;
                z.ref_sample = ref_sample;
            }
            z.count++;
            if (b % 64 == 63 || b == nb - 1)
                emit_zero_run(em, z, p, /*at_seg_end=*/true);
            continue;
        }
        if (z.count) emit_zero_run(em, z, p, /*at_seg_end=*/false);
        BlockCtx c{db, bs, ref, ref_sample};
        encode_block(em, c, p, k_state, sc);
    }
    if (p.flags & E_FLAG_PAD_RSI) em.pad_to_byte();
}

// Emit one RSI from recorded per-block plans (parallel pass 2): identical
// control flow to encode_rsi, with scan/walk/SE replaced by plan bytes.
static void encode_rsi_planned(Emitter& em, const uint32_t* d, unsigned nb,
                               uint32_t ref_sample, const EncParams& p,
                               const uint8_t* plans) {
    const unsigned bs = p.bs;
    ZeroRun z;
    for (unsigned b = 0; b < nb; b++) {
        bool ref = p.pp() && b == 0;
        if (plans[b] == PLAN_ZERO) {
            if (z.count == 0 && ref) {
                z.ref = true;
                z.ref_sample = ref_sample;
            }
            z.count++;
            if (b % 64 == 63 || b == nb - 1)
                emit_zero_run(em, z, p, /*at_seg_end=*/true);
            continue;
        }
        if (z.count) emit_zero_run(em, z, p, /*at_seg_end=*/false);
        BlockCtx c{d + (size_t)b * bs, bs, ref, ref_sample};
        emit_block_planned(em, c, p, plans[b]);
    }
    if (p.flags & E_FLAG_PAD_RSI) em.pad_to_byte();
}

static bool params_valid(const EncParams& p) {
    if (p.bps == 0 || p.bps > 32) return false;
    // rsi==0 passes the reference's init (encode.c:793 checks only >4096)
    // but its encoder then segfaults on the first buffer (verified against
    // .refbuild); rejecting it up front is the memory-safe deviation
    if (p.rsi == 0 || p.rsi > 4096) return false;
    if (p.flags & E_FLAG_NOT_ENFORCE) {
        if (p.bs == 0 || (p.bs & 1)) return false;
    } else if (p.bs != 8 && p.bs != 16 && p.bs != 32 && p.bs != 64) {
        return false;
    }
    // the reference checks RESTRICTED only in its bps<=8 branch
    // (encode.c:843-851): 5..8 is a CONF_ERROR, >8 silently ignores the
    // flag (verified: RESTRICTED|bps=16 encodes identically to plain)
    if ((p.flags & E_FLAG_RESTRICTED) && p.bps > 4 && p.bps <= 8)
        return false;
    return true;
}

// Upper bound on one RSI's emitted bytes (mirror of
// encode.worst_case_bits_per_block plus pad slack).
static size_t worst_rsi_bytes(const EncParams& p) {
    size_t per_block = p.id_len() + 1 + p.bps +
                       ((size_t)p.bs * p.bps > 64 ? (size_t)p.bs * p.bps
                                                  : 64);
    return (p.rsi * per_block) / 8 + 16;
}

// Streaming encode session: whole RSIs are fed incrementally; the k
// warm-start and the bit-cursor remainder carry across feeds, so the
// concatenated output is byte-identical to a one-shot encode of the same
// bytes (the chunk-equivalence contract the Python host layer and the
// C-ABI streaming API are built on).
struct EncSession {
    EncParams p;
    int k_state = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool any = false;     // any samples fed
    bool done = false;    // finish() ran
    std::vector<uint8_t> out;
    size_t drained = 0;
    std::vector<uint32_t> x;  // one RSI of widened samples
    std::vector<uint32_t> d;  // one RSI of Δ-mapped samples
};

// Encode `nb` whole blocks of widened samples already in s->x.
static void session_encode_blocks(EncSession* s, unsigned nb) {
    size_t base = s->out.size();
    size_t worst = worst_rsi_bytes(s->p);
    s->out.resize(base + worst);
    Emitter em(s->out.data() + base, worst);
    em.set_carry(s->acc, s->nbits);
    uint32_t ref_sample = s->x[0];
    const uint32_t* dptr = s->x.data();
    if (s->p.pp()) {
        delta_rsi(s->x.data(), s->d.data(), (size_t)nb * s->p.bs, s->p);
        dptr = s->d.data();
    }
    encode_rsi(em, dptr, nb, ref_sample, s->p, &s->k_state);
    s->acc = em.carry_acc();
    s->nbits = em.carry_bits();
    s->out.resize(base + em.flushed_bytes());
}

}  // namespace

extern "C" {

// ---- streaming encode session (C-ABI aec_encode / host streaming) ------

void* aectpu_enc_new(unsigned bps, unsigned bs, unsigned rsi,
                     unsigned flags) {
    EncParams p{bps, bs, rsi, flags};
    if (!params_valid(p)) return nullptr;
    EncSession* s = new EncSession;
    s->p = p;
    s->x.resize((size_t)rsi * bs);
    s->d.resize((size_t)rsi * bs);
    return s;
}

// Feed n_rsis whole RSIs of raw sample bytes.
int aectpu_enc_feed(void* sess, const uint8_t* in, size_t n_rsis) {
    EncSession* s = (EncSession*)sess;
    const size_t S = (size_t)s->p.rsi * s->p.bs;
    const int bsz = s->p.bytes_per_sample();
    for (size_t r = 0; r < n_rsis; r++) {
        read_samples(in + r * S * bsz, S, bsz, s->p.flags & E_FLAG_MSB,
                     s->p.mask(), s->x.data());
        s->any = true;
        session_encode_blocks(s, s->p.rsi);
    }
    return E_AEC_OK;
}

// Final (possibly partial) RSI + flush: tail_samples < rsi*block_size
// sample's worth of bytes; repeat-last-sample padding + zero-bit flush.
int aectpu_enc_finish(void* sess, const uint8_t* tail,
                      size_t tail_samples) {
    EncSession* s = (EncSession*)sess;
    if (s->done) return E_AEC_OK;
    const int bsz = s->p.bytes_per_sample();
    if (tail_samples) {
        read_samples(tail, tail_samples, bsz, s->p.flags & E_FLAG_MSB,
                     s->p.mask(), s->x.data());
        unsigned nb = (unsigned)((tail_samples + s->p.bs - 1) / s->p.bs);
        size_t padded = (size_t)nb * s->p.bs;
        for (size_t i = tail_samples; i < padded; i++)
            s->x[i] = s->x[tail_samples - 1];
        s->any = true;
        session_encode_blocks(s, nb);
    }
    // final flush: pad the last byte with zero bits; an empty stream
    // still flushes one zero byte
    size_t base = s->out.size();
    s->out.resize(base + 16);
    Emitter em(s->out.data() + base, 16);
    em.set_carry(s->acc, s->nbits);
    if (!s->any && s->nbits == 0 && base == 0) em.emit(0, 8);
    em.pad_to_byte();
    s->acc = 0;
    s->nbits = 0;
    s->out.resize(base + em.flushed_bytes());
    s->done = true;
    return E_AEC_OK;
}

size_t aectpu_enc_pending(void* sess) {
    EncSession* s = (EncSession*)sess;
    return s->out.size() - s->drained;
}

size_t aectpu_enc_read(void* sess, uint8_t* out, size_t cap) {
    EncSession* s = (EncSession*)sess;
    size_t n = s->out.size() - s->drained;
    if (n > cap) n = cap;
    std::memcpy(out, s->out.data() + s->drained, n);
    s->drained += n;
    if (s->drained == s->out.size() && s->drained > (1u << 20)) {
        s->out.clear();
        s->drained = 0;
    }
    return n;
}

void aectpu_enc_free(void* sess) { delete (EncSession*)sess; }

// One-shot native encode (aec_buffer_encode semantics): trailing bytes
// short of a whole sample are ignored; a trailing partial RSI is padded
// by repeating the last sample.  Returns AEC_OK, or AEC_STREAM_ERROR when
// the stream does not fit out_cap (out gets the first out_cap bytes;
// *out_written reports the FULL stream size either way).
int aectpu_encode(const uint8_t* in, size_t in_len, uint8_t* out,
                  size_t out_cap, size_t* out_written, unsigned bps,
                  unsigned bs, unsigned rsi, unsigned flags) {
    EncParams p{bps, bs, rsi, flags};
    if (!params_valid(p)) return E_AEC_CONF_ERROR;

    const int bsz = p.bytes_per_sample();
    const bool msb = flags & E_FLAG_MSB;
    const size_t S = (size_t)rsi * bs;
    const size_t n_samples = in_len / bsz;

    Emitter em(out, out_cap);
    if (n_samples == 0) {
        // the reference still flushes one zero byte on an empty stream
        em.emit(0, 8);
        em.pad_to_byte();
        *out_written = em.total_bytes();
        return em.overflow() ? E_AEC_STREAM_ERROR : E_AEC_OK;
    }

    std::vector<uint32_t> x(S), dbuf(S);
    int k_state = 0;
    size_t done = 0;
    while (done < n_samples) {
        size_t take = n_samples - done < S ? n_samples - done : S;
        read_samples(in + done * (size_t)bsz, take, bsz, msb, p.mask(),
                     x.data());
        // partial trailing RSI: whole blocks, repeating the last sample
        unsigned nb = (unsigned)((take + bs - 1) / bs);
        size_t padded = (size_t)nb * bs;
        for (size_t i = take; i < padded; i++) x[i] = x[take - 1];
        uint32_t ref_sample = x[0];
        const uint32_t* dptr = x.data();
        if (p.pp()) {
            delta_rsi(x.data(), dbuf.data(), padded, p);
            dptr = dbuf.data();
        }
        encode_rsi(em, dptr, nb, ref_sample, p, &k_state);
        done += take;
    }
    em.pad_to_byte();  // final zero-bit padding (encode.c:686-688)
    *out_written = em.total_bytes();
    return em.overflow() ? E_AEC_STREAM_ERROR : E_AEC_OK;
}

// Parallel one-shot encode, bit-identical to aectpu_encode by
// construction.  The format's k warm-start chains through every non-zero
// block, so the DECISION pass (widen + Δ + block scan/walk/SE) stays
// serial on the calling thread; workers chase its published frontier and
// EMIT whole RSIs into private buffers from recorded plan bytes (RSIs are
// otherwise independent: predictor reference and zero-run state reset at
// each RSI, encode.c:252-254, 649-655).  A final parallel stitch
// shift-ORs the per-RSI substreams at their exact bit offsets -- the same
// offset-prefix-sum assembly the TPU mesh encoder uses (parallel/dist.py),
// here over threads instead of chips.  Windowed to bound memory.
int aectpu_encode_parallel(const uint8_t* in, size_t in_len, uint8_t* out,
                           size_t out_cap, size_t* out_written,
                           unsigned bps, unsigned bs, unsigned rsi,
                           unsigned flags, int n_threads) {
    EncParams p{bps, bs, rsi, flags};
    if (!params_valid(p)) return E_AEC_CONF_ERROR;
    const int bsz = p.bytes_per_sample();
    const bool msb = flags & E_FLAG_MSB;
    const size_t S = (size_t)rsi * bs;
    const size_t n_samples = in_len / bsz;
    const size_t n_rsis = (n_samples + S - 1) / S;
    if (n_threads <= 1 || n_rsis < 4)
        return aectpu_encode(in, in_len, out, out_cap, out_written, bps, bs,
                             rsi, flags);

    const size_t WINDOW = n_rsis < 512 ? n_rsis : 512;
    const size_t worst = worst_rsi_bytes(p);
    // big scratch stays UNINITIALISED (std::vector's zero-fill of the
    // ~50 MB working set costs more than a whole pass over the input)
    std::unique_ptr<uint32_t[]> x(new uint32_t[S]);
    std::unique_ptr<uint32_t[]> d_all(new uint32_t[WINDOW * S]);
    std::unique_ptr<uint8_t[]> plans(new uint8_t[WINDOW * rsi]);
    std::unique_ptr<uint8_t[]> bufs(new uint8_t[WINDOW * worst]);
    std::vector<uint32_t> refs(WINDOW);
    std::vector<unsigned> nbs(WINDOW);
    std::vector<uint64_t> Lbits(WINDOW), offs(WINDOW);
    std::vector<uint8_t> tails(WINDOW);

    int k_state = 0;
    uint64_t bitpos = 0;      // absolute output bit cursor
    uint8_t carry_tail = 0;   // pending partial byte from previous window
    bool overflow = false;

    size_t r0 = 0;
    while (r0 < n_rsis) {
        const size_t nw = n_rsis - r0 < WINDOW ? n_rsis - r0 : WINDOW;
        // Three stages per window, work-stolen across all threads:
        //   delta (parallel): widen + Δ into d_all[r]
        //   decide (serial, this thread): block scan + k-walk chain
        //   emit (parallel): per-RSI bitstream from the recorded plans
        std::atomic<size_t> delta_claim{0};
        std::atomic<size_t> decide_pub{0};
        std::atomic<size_t> emit_claim{0};
        std::vector<std::atomic<uint8_t>> delta_done(nw);
        for (auto& f : delta_done) f.store(0, std::memory_order_relaxed);

        auto do_delta = [&](size_t r, uint32_t* xbuf) {
            size_t done_s = (r0 + r) * S;
            size_t take = n_samples - done_s < S ? n_samples - done_s : S;
            read_samples(in + done_s * (size_t)bsz, take, bsz, msb,
                         p.mask(), xbuf);
            unsigned nb = (unsigned)((take + bs - 1) / bs);
            size_t padded = (size_t)nb * bs;
            for (size_t i = take; i < padded; i++) xbuf[i] = xbuf[take - 1];
            nbs[r] = nb;
            refs[r] = xbuf[0];
            uint32_t* dr = d_all.get() + r * S;
            if (p.pp())
                delta_rsi(xbuf, dr, padded, p);
            else
                std::memcpy(dr, xbuf, padded * 4);
            delta_done[r].store(1, std::memory_order_release);
        };
        auto do_emit = [&](size_t r) {
            Emitter em(bufs.get() + r * worst, worst);
            encode_rsi_planned(em, d_all.get() + r * S, nbs[r], refs[r], p,
                               plans.get() + r * rsi);
            Lbits[r] = 8 * em.flushed_bytes() + em.carry_bits();
            em.pad_to_byte();
        };

        auto emit_worker = [&]() {
            std::unique_ptr<uint32_t[]> xbuf(new uint32_t[S]);
            for (;;) {
                size_t r = emit_claim.fetch_add(1,
                                                std::memory_order_relaxed);
                if (r >= nw) return;
                // while waiting for the decide frontier, run delta work
                // ahead of it instead of spinning
                while (r >= decide_pub.load(std::memory_order_acquire)) {
                    size_t dr = delta_claim.load(std::memory_order_relaxed);
                    if (dr < nw &&
                        delta_claim.compare_exchange_weak(
                            dr, dr + 1, std::memory_order_relaxed)) {
                        do_delta(dr, xbuf.get());
                    } else {
                        std::this_thread::yield();
                    }
                }
                do_emit(r);
            }
        };
        std::vector<std::thread> pool;
        for (int t = 0; t < n_threads - 1; t++)
            pool.emplace_back(emit_worker);

        // decide chain (serial): consume deltas in order, helping with
        // delta work whenever the needed RSI is not ready yet
        for (size_t r = 0; r < nw; r++) {
            while (!delta_done[r].load(std::memory_order_acquire)) {
                size_t dr = delta_claim.load(std::memory_order_relaxed);
                if (dr < nw &&
                    delta_claim.compare_exchange_weak(
                        dr, dr + 1, std::memory_order_relaxed)) {
                    do_delta(dr, x.get());
                } else {
                    std::this_thread::yield();
                }
            }
            const uint32_t* dr = d_all.get() + r * S;
            uint8_t* pr = plans.get() + r * rsi;
            unsigned nb = nbs[r];
            for (unsigned b = 0; b < nb; b++) {
                const uint32_t* db = dr + (size_t)b * bs;
                BlockScan sc = scan_block(db, bs, k_state);
                if (!sc.orv) {
                    pr[b] = PLAN_ZERO;
                    continue;
                }
                BlockCtx c{db, bs, p.pp() && b == 0, refs[r]};
                pr[b] = decide_block(c, p, &k_state, sc);
            }
            decide_pub.store(r + 1, std::memory_order_release);
        }
        emit_worker();  // the decision thread joins the emit pool
        for (auto& t : pool) t.join();

        // offsets + serial tail-byte chain (tiny; see stitch ownership)
        for (size_t r = 0; r < nw; r++) {
            offs[r] = bitpos;
            bitpos += Lbits[r];
        }
        uint8_t prev_tail = carry_tail;
        for (size_t r = 0; r < nw; r++) {
            const uint8_t* B = bufs.get() + r * worst;
            uint64_t ob = offs[r], L = Lbits[r];
            unsigned s = (unsigned)(ob & 7);
            uint64_t end = ob + L;
            uint8_t t;
            if (end & 7) {
                // shifted last partial byte of stream r
                uint64_t last = (end >> 3) - (ob >> 3);  // byte idx in out
                // source bits for out byte `last`: stream bytes around
                // (last*8 - s)
                size_t m = (size_t)((L + 7) / 8);
                auto src = [&](int64_t j) -> uint32_t {
                    return (j >= 0 && (size_t)j < m) ? B[j] : 0;
                };
                int64_t j = (int64_t)last - 1;  // B index feeding high bits
                t = (uint8_t)((src(j) << (8 - s)) | (src(j + 1) >> s));
                if (s == 0) t = (uint8_t)src(last);
                if ((ob >> 3) == (end >> 3) && s)
                    t |= prev_tail;  // stream lives inside the shared byte
            } else {
                t = 0;
            }
            tails[r] = t;
            prev_tail = t;
        }

        // parallel stitch: each RSI writes bytes [a, b) of the output,
        // where a = off/8 (OR'd with the previous stream's tail bits) and
        // b = (off+L)/8; the trailing partial byte is owned by whichever
        // stream extends it next (tails chain above)
        std::atomic<size_t> srnext{0};
        auto stitch_worker = [&]() {
            for (;;) {
                size_t r = srnext.fetch_add(1, std::memory_order_relaxed);
                if (r >= nw) return;
                const uint8_t* B = bufs.get() + r * worst;
                uint64_t ob = offs[r], L = Lbits[r];
                size_t a = (size_t)(ob >> 3), bend = (size_t)((ob + L) >> 3);
                unsigned s = (unsigned)(ob & 7);
                uint8_t pt = r == 0 ? carry_tail : tails[r - 1];
                size_t m = (size_t)((L + 7) / 8);
                if (a >= bend) continue;
                size_t lim = bend < out_cap ? bend : out_cap;
                size_t n = lim > a ? lim - a : 0;
                if (!n) continue;
                if (s == 0) {
                    std::memcpy(out + a, B, n);
                } else {
                    // dst[j] = (B[j-1] << (8-s)) | (B[j] >> s): eight
                    // dest bytes per pair of unaligned big-endian loads
                    size_t j = 0;
                    out[a] = (uint8_t)(B[0] >> s);
                    j = 1;
                    while (j + 8 <= n && j + 8 < m) {
                        uint64_t w0, w1;
                        std::memcpy(&w0, B + j - 1, 8);
                        std::memcpy(&w1, B + j, 8);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
                        w0 = __builtin_bswap64(w0);
                        w1 = __builtin_bswap64(w1);
#endif
                        uint64_t d64 = (w0 << (8 - s)) | (w1 >> s);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
                        d64 = __builtin_bswap64(d64);
#endif
                        std::memcpy(out + a + j, &d64, 8);
                        j += 8;
                    }
                    for (; j < n; j++) {
                        uint8_t lo = (j < m) ? (uint8_t)(B[j] >> s) : 0;
                        out[a + j] =
                            (uint8_t)((B[j - 1] << (8 - s)) | lo);
                    }
                }
                if (a < out_cap) out[a] |= pt;
            }
        };
        std::vector<std::thread> spool;
        for (int t = 0; t < n_threads - 1; t++)
            spool.emplace_back(stitch_worker);
        stitch_worker();
        for (auto& t : spool) t.join();

        carry_tail = nw ? tails[nw - 1] : carry_tail;
        r0 += nw;
    }

    // final partial byte (zero-padded by construction of the tails)
    if (bitpos & 7) {
        size_t last = (size_t)(bitpos >> 3);
        if (last < out_cap)
            out[last] = carry_tail;
    }
    // (n_samples == 0 routed to the serial path above: n_rsis < 4)
    size_t total = (size_t)((bitpos + 7) / 8);
    *out_written = total;
    if (total > out_cap) overflow = true;
    return overflow ? E_AEC_STREAM_ERROR : E_AEC_OK;
}

}  // extern "C"
