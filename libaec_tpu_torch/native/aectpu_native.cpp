// Native host-side runtime for libaec_tpu: scalar CCSDS 121.0-B-2 decoder
// and bitstream index scanner.
//
// This is a from-scratch implementation of the wire format described by
// CCSDS 121.0-B-2 (reference behaviour: libaec's src/decode.c).  It is
// NOT a port of the reference FSM: a single forward loop with a 64-bit
// big-endian bit window replaces the resumable state machine; suspend/resume
// for streaming is handled by the Python host layer instead.
//
// Roles in the TPU framework:
//  * scalar decode path for small buffers and byte-dribble streaming;
//  * the sequential "index scan" producing per-CDS records that unlock
//    data-parallel payload decode on the TPU (CDS boundaries are only
//    discoverable serially; everything after is parallel).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libaectpu.so aectpu_native.cpp

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

constexpr int AEC_OK = 0;
constexpr int AEC_CONF_ERROR = -1;
constexpr int AEC_DATA_ERROR = -3;
constexpr int AEC_MEM_ERROR = -4;

constexpr unsigned FLAG_SIGNED = 1;
constexpr unsigned FLAG_3BYTE = 2;
constexpr unsigned FLAG_MSB = 4;
constexpr unsigned FLAG_PREPROCESS = 8;
constexpr unsigned FLAG_RESTRICTED = 16;
constexpr unsigned FLAG_PAD_RSI = 32;

struct Params {
    unsigned bits_per_sample;
    unsigned block_size;
    unsigned rsi;
    unsigned flags;

    int id_len() const {
        if (bits_per_sample > 16) return 5;
        if (bits_per_sample > 8) return 4;
        if (flags & FLAG_RESTRICTED) return bits_per_sample <= 2 ? 1 : 2;
        return 3;
    }
    int bytes_per_sample() const {
        if (bits_per_sample > 16)
            return (bits_per_sample <= 24 && (flags & FLAG_3BYTE)) ? 3 : 4;
        return bits_per_sample > 8 ? 2 : 1;
    }
    uint32_t xmax() const {
        if (flags & FLAG_SIGNED)
            return UINT32_MAX >> ((32 - bits_per_sample + 1) & 31);
        return UINT32_MAX >> (32 - bits_per_sample);
    }
    bool pp() const { return flags & FLAG_PREPROCESS; }
};

// Zero-copy view of the input stream.  Bit cursors do raw 8-byte window
// loads on the caller's buffer; the rare loads whose span would run past
// the logical end are served from a small zero-padded tail copy instead,
// so no full-input copy is ever made (copying a multi-MB stream costs more
// than the entire structural walk).  Reads past the end observe zero bits,
// matching the reference's exhaustion behaviour.  Shared read-only by all
// cursors (incl. worker threads).
struct InputView {
    InputView(const uint8_t* data, size_t len)
        : nbits(8 * len), data_(data), len_(len) {
        std::memset(tail_, 0, sizeof(tail_));
        size_t keep = len < 8 ? len : 8;
        if (keep) std::memcpy(tail_, data + len - keep, keep);
        tail_start_ = len - keep;
    }

    size_t nbits;
    size_t len() const { return len_; }

    // Big-endian 64-bit load of bytes [p, p+8).  Callers keep p within
    // len_ + 8 (cursor positions never exceed the stream end by more than
    // one refill), which the 32-byte tail buffer covers.
    uint64_t load64_be(size_t p) const {
        uint64_t w;
        if (p + 8 <= len_)
            std::memcpy(&w, data_ + p, 8);
        else
            std::memcpy(&w, tail_ + (p - tail_start_), 8);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
        w = __builtin_bswap64(w);
#endif
        return w;
    }

    // Stream words [byte_off, byte_off + 4*nw) copied RAW (host byte
    // order as stored -- the device byteswaps to big-endian word values
    // itself, ops/bitunpack.py); words past the end read as zero.  The
    // bswap used to make this the other third of the scan's time; a pure
    // memcpy runs at memory speed.
    void copy_words_raw(size_t byte_off, uint32_t* dst, int nw) const {
        if (byte_off + 4 * (size_t)nw <= len_) {
            std::memcpy(dst, data_ + byte_off, 4 * (size_t)nw);
            return;
        }
        for (int w = 0; w < nw; w++) {
            size_t p = byte_off + 4 * (size_t)w;
            uint32_t v = 0;
            if (p + 4 <= len_) {
                std::memcpy(&v, data_ + p, 4);
            } else if (p < len_) {
                uint8_t tmp[4] = {0, 0, 0, 0};
                std::memcpy(tmp, data_ + p, len_ - p);
                std::memcpy(&v, tmp, 4);
            }
            dst[w] = v;
        }
    }

    const uint8_t* raw() const { return data_; }

  private:
    const uint8_t* data_;
    size_t len_;
    size_t tail_start_;
    uint8_t tail_[32];
};

// MSB-first bit cursor over an InputView; logical exhaustion is
// checked against nbits explicitly.
class BitCursor {
  public:
    BitCursor(const InputView& in, size_t start_bit = 0)
        : in_(in), nbits_(in.nbits), pos_(start_bit) {}

    size_t pos() const { return pos_; }
    void seek(size_t p) { pos_ = p; }
    size_t remaining() const { return pos_ < nbits_ ? nbits_ - pos_ : 0; }
    bool has(size_t n) const { return pos_ + n <= nbits_; }

    uint64_t window() const {  // 64 bits MSB-aligned at the cursor
        return in_.load64_be(pos_ >> 3) << (pos_ & 7);
    }

    uint32_t get(int n) {  // caller must ensure has(n); n in [0, 32]
        if (n == 0) return 0;
        uint32_t v = (uint32_t)(window() >> (64 - n));
        pos_ += n;
        return v;
    }

    // Fundamental sequence: number of 0 bits before the next 1 bit.
    // Returns false if the stream ends before a 1 is found.
    bool get_fs(uint32_t* out) {
        uint32_t zeros = 0;
        for (;;) {
            if (pos_ >= nbits_) return false;
            uint64_t w = window();
            if (w == 0) {
                size_t avail = 64 - (pos_ & 7);
                size_t take = remaining() < avail ? remaining() : avail;
                zeros += (uint32_t)take;
                pos_ += take;
                continue;
            }
            int lz = __builtin_clzll(w);
            if (pos_ + lz >= nbits_) {  // the 1 we saw is past the end pad
                pos_ = nbits_;
                return false;
            }
            *out = zeros + (uint32_t)lz;
            pos_ += lz + 1;
            return true;
        }
    }

    // Skip `count` whole FS codes (advance just past the count-th 1 bit).
    // Bulk path for the structural scan: popcount per window instead of a
    // clz per code.  Returns false if the stream ends first.
    // (A 32-byte popcount-stride variant with a pdep refine was measured
    // ~8% SLOWER on this workload -- typical FS regions span only ~2
    // windows, so the per-window early exit wins; see docs/DESIGN.md.)
    bool skip_fs(uint32_t count) {
        while (count) {
            if (pos_ >= nbits_) return false;
            uint64_t w = window();
            unsigned vbits = 64 - (unsigned)(pos_ & 7);
            size_t avail = nbits_ - pos_;
            if (avail < vbits) vbits = (unsigned)avail;
            if (vbits < 64) w &= ~0ull << (64 - vbits);
            unsigned pc = (unsigned)__builtin_popcountll(w);
            if (pc < count) {
                if (avail <= vbits) { pos_ = nbits_; return false; }
                count -= pc;
                pos_ += vbits;
            } else {
#ifdef __BMI2__
                // count-th set bit from MSB == (pc-count+1)-th from LSB
                uint64_t bit = __builtin_ia32_pdep_di(1ull << (pc - count), w);
                unsigned from_msb = 63 - (unsigned)__builtin_ctzll(bit);
#else
                unsigned from_msb = 0;
                uint64_t ww = w;
                for (unsigned j = 1; j < count; j++)
                    ww &= ~(0x8000000000000000ull >> __builtin_clzll(ww));
                from_msb = (unsigned)__builtin_clzll(ww);
#endif
                pos_ += from_msb + 1;
                return true;
            }
        }
        return true;
    }

  private:
    const InputView& in_;
    size_t nbits_;
    size_t pos_;
};

// Registerized bit cursor for the decode hot path: the reference decoder's
// 64-bit accumulator scheme (decode.c:222-340, acc/bitp) with multi-byte
// refills.  Invariant: the top navail_ bits of acc_ are valid stream bits
// and everything below is zero, so clz directly yields FS run lengths.
class RegBitCursor {
  public:
    RegBitCursor(const InputView& in, size_t start_bit = 0)
        : in_(in), nbits_(in.nbits) {
        seek(start_bit);
    }

    size_t pos() const { return (bytepos_ << 3) - (size_t)navail_; }
    size_t remaining() const {
        size_t p = pos();
        return p < nbits_ ? nbits_ - p : 0;
    }
    bool has(size_t n) const { return pos() + n <= nbits_; }

    void seek(size_t p) {
        bytepos_ = p >> 3;
        acc_ = 0;
        navail_ = 0;
        refill();
        int off = (int)(p & 7);
        acc_ <<= off;
        navail_ -= off;
    }

    uint32_t get(int n) {  // caller must ensure has(n); n in [0, 32]
        if (n == 0) return 0;
        if (navail_ < n) refill();
        uint32_t v = (uint32_t)(acc_ >> (64 - n));
        acc_ <<= n;
        navail_ -= n;
        return v;
    }

    // Fundamental sequence: zeros before the next 1.  False on exhaustion
    // (cursor left at end-of-stream, like BitCursor::get_fs).
    bool get_fs(uint32_t* out) {
        uint32_t zeros = 0;
        for (;;) {
            if (acc_) {  // bits below navail_ are zero => clz < navail_
                int lz = __builtin_clzll(acc_);
                zeros += (uint32_t)lz;
                acc_ <<= lz + 1;
                navail_ -= lz + 1;
                *out = zeros;
                return true;
            }
            zeros += (uint32_t)navail_;
            navail_ = 0;
            acc_ = 0;
            if ((bytepos_ << 3) >= nbits_) return false;
            refill();
        }
    }

  private:
    void refill() {
        int nbytes = (63 - navail_) >> 3;
        if (nbytes == 0) return;
        uint64_t w = in_.load64_be(bytepos_);
        int nb = nbytes << 3;
        acc_ |= (w & (~0ull << (64 - nb))) >> navail_;
        navail_ += nb;
        bytepos_ += (size_t)nbytes;
    }

    const InputView& in_;
    size_t nbits_;
    size_t bytepos_ = 0;
    uint64_t acc_ = 0;
    int navail_ = 0;
};

// Output writer: converts decoded uint32 samples to the byte layout.
class SampleWriter {
  public:
    SampleWriter(uint8_t* out, size_t cap_bytes, int bytes_per_sample,
                 bool msb)
        : out_(out), cap_(cap_bytes), bsz_(bytes_per_sample), msb_(msb) {}

    bool full() const { return cap_ - written_ < (size_t)bsz_; }
    size_t written() const { return written_; }
    size_t cap_left() const { return cap_ - written_; }

    void put(uint32_t v) {
        uint8_t* p = out_ + written_;
        switch (bsz_) {
            case 1:
                p[0] = (uint8_t)v;
                break;
            case 2:
                if (msb_) { p[0] = (uint8_t)(v >> 8); p[1] = (uint8_t)v; }
                else { p[0] = (uint8_t)v; p[1] = (uint8_t)(v >> 8); }
                break;
            case 3:
                if (msb_) { p[0] = (uint8_t)(v >> 16); p[1] = (uint8_t)(v >> 8); p[2] = (uint8_t)v; }
                else { p[0] = (uint8_t)v; p[1] = (uint8_t)(v >> 8); p[2] = (uint8_t)(v >> 16); }
                break;
            default:
                if (msb_) { p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16); p[2] = (uint8_t)(v >> 8); p[3] = (uint8_t)v; }
                else { p[0] = (uint8_t)v; p[1] = (uint8_t)(v >> 8); p[2] = (uint8_t)(v >> 16); p[3] = (uint8_t)(v >> 24); }
        }
        written_ += bsz_;
    }

    // Bulk variant with the layout switch hoisted out of the sample loop so
    // the compiler can vectorise each case (flush writes whole RSIs).
    void put_many(const uint32_t* v, size_t n) {
        uint8_t* p = out_ + written_;
        switch (bsz_) {
            case 1:
                for (size_t i = 0; i < n; i++) p[i] = (uint8_t)v[i];
                break;
            case 2:
                if (msb_) {
                    for (size_t i = 0; i < n; i++) {
                        uint16_t t = __builtin_bswap16((uint16_t)v[i]);
                        std::memcpy(p + 2 * i, &t, 2);
                    }
                } else {
                    for (size_t i = 0; i < n; i++) {
                        uint16_t t = (uint16_t)v[i];
                        std::memcpy(p + 2 * i, &t, 2);
                    }
                }
                break;
            case 3:
                for (size_t i = 0; i < n; i++) put(v[i]);
                return;  // put() advanced written_
            default:
                if (msb_) {
                    for (size_t i = 0; i < n; i++) {
                        uint32_t t = __builtin_bswap32(v[i]);
                        std::memcpy(p + 4 * i, &t, 4);
                    }
                } else {
                    std::memcpy(p, v, 4 * n);
                }
        }
        written_ += (size_t)bsz_ * n;
    }

  private:
    uint8_t* out_;
    size_t cap_;
    int bsz_;
    bool msb_;
    size_t written_ = 0;
};

// Second-extension unpairing: fs value m -> pair (a, b) with a + b = i,
// m = i(i+1)/2 + b.  Closed form instead of the reference's 91-entry table
// (decode.c:679-692), which only covers i < 13; valid encoders can emit
// larger groups whenever the SE length fits under uncomp_len.
static inline void se_unpair(uint32_t m, uint32_t* a, uint32_t* b) {
    // group index i = floor((sqrt(8m+1) - 1) / 2), with float correction
    uint32_t i = (uint32_t)((__builtin_sqrt(8.0 * (double)m + 1.0) - 1.0) * 0.5);
    while ((uint64_t)(i + 1) * (i + 2) / 2 <= m) i++;
    while ((uint64_t)i * (i + 1) / 2 > m) i--;
    uint32_t ms = i * (i + 1) / 2;
    *b = m - ms;
    *a = i - *b;
}

// Inverse of the unit-delay predictor + sign mapper.  Processes samples
// [begin, end) of an RSI in place, where samples[0] of the RSI (if `first`)
// is the reference.  Carries `last` across calls within one stream.
class Unpredictor {
  public:
    explicit Unpredictor(const Params& p)
        : pp_(p.pp()), is_signed_(p.flags & FLAG_SIGNED),
          bps_(p.bits_per_sample), xmax_(p.xmax()) {
        // The inverse-map branch follows xmin == 0, not the SIGNED flag
        // (decode.c:91,111): signed 1-bit data has xmin == ~xmax == 0 due to
        // the x86 shift quirk and therefore uses the unsigned path.
        uint32_t xmin = is_signed_ ? ~xmax_ : 0;
        unsigned_path_ = (xmin == 0);
    }

    // deltas: pointer to RSI-local sample array; n: count; first_of_rsi:
    // deltas[0] is the reference sample.
    void apply(uint32_t* v, size_t n, bool first_of_rsi) {
        if (!pp_ || n == 0) return;
        size_t i = 0;
        if (first_of_rsi) {
            int32_t r = (int32_t)v[0];
            if (is_signed_) {
                uint32_t m = 1u << (bps_ - 1);
                r = (int32_t)(((uint32_t)r ^ m) - m);
            }
            last_ = r;
            v[0] = (uint32_t)r;
            i = 1;
        }
        if (!unsigned_path_) {
            int32_t last = last_;
            const int32_t xmax = (int32_t)xmax_;
            for (; i < n; i++) {
                uint32_t d = v[i];
                uint32_t half = (d >> 1) + (d & 1);
                // zig = +d/2 for even d, -(d+1)/2 for odd d
                uint32_t zig = (d >> 1) ^ (~((d & 1) - 1));
                if (last < 0) {
                    if (half <= (uint32_t)xmax + (uint32_t)last + 1)
                        last = (int32_t)((uint32_t)last + zig);
                    else
                        last = (int32_t)d - xmax - 1;
                } else {
                    if (half <= (uint32_t)(xmax - last))
                        last = (int32_t)((uint32_t)last + zig);
                    else
                        last = xmax - (int32_t)d;
                }
                v[i] = (uint32_t)last;
            }
            last_ = last;
        } else {
            uint32_t last = (uint32_t)last_;
            const uint32_t xmax = xmax_;
            const uint32_t med = xmax / 2 + 1;
            for (; i < n; i++) {
                uint32_t d = v[i];
                uint32_t half = (d >> 1) + (d & 1);
                uint32_t zig = (d >> 1) ^ (~((d & 1) - 1));
                uint32_t mask = (last & med) ? xmax : 0;
                if (half <= (mask ^ last))
                    last += zig;
                else
                    last = mask ^ d;
                v[i] = last;
            }
            last_ = (int32_t)last;
        }
    }

  private:
    bool pp_;
    bool is_signed_;
    bool unsigned_path_;
    unsigned bps_;
    uint32_t xmax_;
    int32_t last_ = 0;
};

// ---------------------------------------------------------------------------
// Structural scan: validate one RSI and (optionally) emit per-block payload
// records for the device (TPU) entropy decoder (libaec_tpu/ops/bitunpack.py).
// The record is everything the data-parallel phase needs to decode one
// output block without re-walking the bitstream serially.
// ---------------------------------------------------------------------------

constexpr uint32_t KIND_ZERO = 0;    // all-zero block (zero-run member)
constexpr uint32_t KIND_SE = 1;      // second extension
constexpr uint32_t KIND_SPLIT = 2;   // split, k = (meta >> 2) & 31
constexpr uint32_t KIND_UNCOMP = 3;  // raw block

struct BlockRecSink {
    uint64_t* fs_off;      // bit offset of the FS region (se/split) or the
                           // raw field region (uncomp); 0 for zero blocks
    uint64_t* lsb_off;     // bit offset of the split LSB region (== end of
                           // FS region); == fs_off for uncomp/se; 0 for zero
    uint32_t* meta;        // kind | k << 2 | ref << 7
    uint32_t* ref_sample;  // raw reference sample (first block of RSI, pp)
    uint32_t* win;         // optional [n, wf] native-endian payload windows
                           // (the wf big-endian stream words from the
                           // payload's word): shipping these instead of the
                           // raw stream removes the device-side gather
    int wf = 0;
    const InputView* stream = nullptr;
    size_t n = 0;

    void push(uint64_t fso, uint64_t lsbo, uint32_t kind, uint32_t k,
              uint32_t ref, uint32_t refs) {
        fs_off[n] = fso;
        lsb_off[n] = lsbo;
        meta[n] = kind | (k << 2) | (ref << 7);
        ref_sample[n] = refs;
        if (win && kind != KIND_ZERO)  // zero blocks never read their win
            stream->copy_words_raw((fso >> 5) << 2, win + (size_t)wf * n, wf);
        n++;
    }
};

// Deferred window materialisation: fill records [lo, hi) from the stream.
// Pure memcpy+bswap work, so it runs on worker threads behind the scan.
static void fill_windows(const InputView& in, const uint64_t* fs_off,
                         const uint32_t* meta, uint32_t* win, int wf,
                         size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; i++) {
        if ((meta[i] & 3u) == KIND_ZERO) continue;
        in.copy_words_raw((fs_off[i] >> 5) << 2, win + (size_t)wf * i, wf);
    }
}

// Walk one RSI's structure, advancing the cursor past it.  Emits exactly
// p.rsi records into *rec when rec != nullptr.  max_fs_bits > 0 additionally
// rejects RSIs with any block payload (FS region + LSB plane) longer than
// max_fs_bits, the device decoder's static window (conforming encoders keep
// every CDS under uncomp_len bits, but the reference's garbage-in stance
// means arbitrary input must fall back to the exact serial core rather than
// mis-decode).  Returns false on any rejection; the cursor is then mid-RSI
// and the caller must restore it.
template <class Cursor>
static bool scan_one_rsi(Cursor& bits, const Params& p, BlockRecSink* rec,
                         int max_fs_bits) {
    const int id_len = p.id_len();
    const unsigned bs = p.block_size;
    const unsigned bps = p.bits_per_sample;
    const uint32_t uncomp_id = (1u << id_len) - 1;
    const bool pp = p.pp();
    const size_t S = (size_t)p.rsi * bs;

    size_t rsip = 0;
    while (rsip < S) {
        bool ref = pp && rsip == 0;
        uint32_t refs = 0;
        if (!bits.has(id_len)) return false;
        uint32_t id = bits.get(id_len);
        if (id == 0) {  // low-entropy options
            if (!bits.has(1)) return false;
            uint32_t sub = bits.get(1);
            if (ref) {
                if (!bits.has(bps)) return false;
                refs = bits.get(bps);
                rsip++;
            }
            if (sub == 1) {  // second extension: bs/2 FS codes
                unsigned n_smp = bs - (ref ? 1 : 0);
                if (S - rsip < n_smp) return false;
                uint64_t fso = bits.pos();
                if (!bits.skip_fs(bs / 2)) return false;
                if (max_fs_bits > 0 &&
                    bits.pos() - fso > (uint64_t)max_fs_bits)
                    return false;
                if (rec) rec->push(fso, fso, KIND_SE, 0, ref, refs);
                rsip += n_smp;
            } else {  // zero-block run
                uint32_t fs;
                if (!bits.get_fs(&fs)) return false;
                uint32_t zb = fs + 1;
                if (zb == 5) {
                    uint32_t b = (uint32_t)(rsip / bs);
                    uint32_t rest_rsi = p.rsi - b;
                    uint32_t rest_seg = 64 - (b % 64);
                    zb = rest_rsi < rest_seg ? rest_rsi : rest_seg;
                } else if (zb > 5) {
                    zb--;
                }
                size_t n = (size_t)zb * bs - (ref ? 1 : 0);
                if (S - rsip < n) return false;
                rsip += n;
                if (rec)
                    for (uint32_t z = 0; z < zb; z++)
                        rec->push(0, 0, KIND_ZERO, 0, z == 0 ? ref : 0,
                                  z == 0 ? refs : 0);
            }
        } else if (id == uncomp_id) {
            if (!bits.has((size_t)bs * bps)) return false;
            uint64_t fso = bits.pos();
            bits.seek(bits.pos() + (size_t)bs * bps);
            if (S - rsip < bs) return false;
            if (rec) rec->push(fso, fso, KIND_UNCOMP, 0, 0, 0);
            rsip += bs;
        } else {  // split, k = id - 1
            unsigned k = id - 1;
            if (ref) {
                if (!bits.has(bps)) return false;
                refs = bits.get(bps);
                rsip++;
            }
            unsigned n = bs - (ref ? 1 : 0);
            if (S - rsip < n) return false;
            uint64_t fso = bits.pos();
            if (!bits.skip_fs(n)) return false;
            uint64_t lsbo = bits.pos();
            if (max_fs_bits > 0 &&
                lsbo - fso + (uint64_t)n * k > (uint64_t)max_fs_bits)
                return false;
            if (!bits.has((size_t)n * k)) return false;
            bits.seek(bits.pos() + (size_t)n * k);
            if (rec) rec->push(fso, lsbo, KIND_SPLIT, k, ref, refs);
            rsip += n;
        }
    }
    return rsip == S;
}

// Full scalar decode starting at an arbitrary bit offset (RSI-start state).
// Returns an AEC status code; *out_written receives the bytes produced.
// Truncation semantics match the reference: decode proceeds until input bits
// or output capacity run out, whole samples only.
// emit_deltas: skip the inverse predictor and write raw native-endian
// uint32 mapped deltas -- phase-1 output for the TPU payload decoder
// (libaec_tpu/decode.py), which runs the inverse predictor as a lane-
// parallel scan across RSIs.
static int decode_core(const InputView& input, uint64_t start_bit,
                       uint8_t* out, size_t out_cap, size_t* out_written,
                       const Params& p, bool emit_deltas = false) {
    const int id_len = p.id_len();
    const int bsz = emit_deltas ? 4 : p.bytes_per_sample();
    const unsigned bs = p.block_size;
    const unsigned rsi = p.rsi;
    const unsigned bits_per_sample = p.bits_per_sample;
    const unsigned flags = p.flags;
    const size_t S = (size_t)rsi * bs;
    const uint32_t uncomp_id = (1u << id_len) - 1;
    const bool pp = p.pp();

    RegBitCursor bits(input, start_bit);
    SampleWriter w(out, out_cap, bsz, !emit_deltas && (flags & FLAG_MSB));
    Unpredictor up(p);

    std::vector<uint32_t> rsibuf(S, 0);
    size_t rsip = 0;         // samples collected in current RSI
    size_t flush_start = 0;  // first un-flushed sample in rsibuf
    int status = AEC_OK;
    // Output capacity is reserved per *buffered* sample, exactly like the
    // reference's avail_out accounting at put_sample time (decode.c:213-220).
    const size_t max_samples = out_cap / (size_t)bsz;
    size_t samples_put = 0;
    auto have_room = [&](size_t n) { return samples_put + n <= max_samples; };

    auto flush = [&]() {
        if (rsip > flush_start) {
            if (!emit_deltas)
                up.apply(rsibuf.data() + flush_start, rsip - flush_start,
                         pp && flush_start == 0);
            w.put_many(rsibuf.data() + flush_start, rsip - flush_start);
            flush_start = rsip;
        }
        if (rsip == S) { rsip = 0; flush_start = 0; }
    };

    // put one sample into the RSI buffer; flushes a completed RSI
    auto put = [&](uint32_t v) {
        rsibuf[rsip++] = v;
        samples_put++;
        if (rsip == S) flush();
    };

    for (;;) {
        bool ref = false;
        if (rsip == 0) {
            if (flags & FLAG_PAD_RSI) bits.seek((bits.pos() + 7) & ~7ull);
            ref = pp;
        }
        if (!bits.has(id_len)) break;
        uint32_t id = bits.get(id_len);

        if (id == 0) {  // low-entropy options
            if (!bits.has(1)) break;
            uint32_t sub = bits.get(1);
            if (ref) {
                if (!bits.has(bits_per_sample) || !have_room(1)) break;
                put(bits.get(bits_per_sample));
            }
            if (sub == 1) {  // second extension
                uint32_t i = ref ? 1 : 0;
                while (i < bs) {
                    uint32_t m, va, vb;
                    if (!bits.get_fs(&m)) goto done;
                    se_unpair(m, &va, &vb);
                    if ((i & 1) == 0) {
                        if (!have_room(1)) goto done;
                        if (rsip >= S) { status = AEC_DATA_ERROR; goto done; }
                        put(va);
                        i++;
                    }
                    if (!have_room(1)) goto done;
                    if (rsip >= S) { status = AEC_DATA_ERROR; goto done; }
                    put(vb);
                    i++;
                }
            } else {  // zero-block run
                uint32_t fs;
                if (!bits.get_fs(&fs)) break;
                uint32_t zb = fs + 1;
                if (zb == 5) {
                    uint32_t b = (uint32_t)(rsip / bs);
                    uint32_t rest_rsi = rsi - b;
                    uint32_t rest_seg = 64 - (b % 64);
                    zb = rest_rsi < rest_seg ? rest_rsi : rest_seg;
                } else if (zb > 5) {
                    zb--;
                }
                size_t n = (size_t)zb * bs - (ref ? 1 : 0);
                if (S - rsip < n) { status = AEC_DATA_ERROR; break; }
                size_t can = max_samples - samples_put;
                size_t m = n < can ? n : can;
                std::fill(rsibuf.begin() + rsip, rsibuf.begin() + rsip + m,
                          0u);
                rsip += m;
                samples_put += m;
                if (rsip == S) flush();
                if (m < n) goto done;
            }
        } else if (id == uncomp_id) {
            if (bits.has((size_t)bits_per_sample * bs) && have_room(bs) &&
                S - rsip >= bs) {
                uint32_t* dst = rsibuf.data() + rsip;
                for (unsigned i = 0; i < bs; i++)
                    dst[i] = bits.get(bits_per_sample);
                rsip += bs;
                samples_put += bs;
                if (rsip == S) flush();
            } else {
                for (unsigned i = 0; i < bs; i++) {
                    if (!bits.has(bits_per_sample)) goto done;
                    if (!have_room(1)) goto done;
                    if (rsip >= S) { status = AEC_DATA_ERROR; goto done; }
                    put(bits.get(bits_per_sample));
                }
            }
        } else {  // split, k = id - 1
            int k = (int)id - 1;
            unsigned nref = ref ? 1 : 0;
            if (ref) {
                if (!bits.has(bits_per_sample)) break;
                if (!have_room(1)) break;
                if (rsip >= S) { status = AEC_DATA_ERROR; break; }
                put(bits.get(bits_per_sample));
            }
            unsigned n = bs - nref;
            if (S - rsip < n) { status = AEC_DATA_ERROR; break; }
            // FS phase: all fs values must parse before any sample is out
            uint32_t* dst = rsibuf.data() + rsip;
            {
                unsigned i = 0;
                for (; i < n; i++) {
                    uint32_t fs;
                    if (!bits.get_fs(&fs)) goto done;
                    dst[i] = fs << k;
                }
            }
            // LSB phase: samples complete one by one
            if (bits.has((size_t)k * n) && have_room(n)) {
                if (k)
                    for (unsigned i = 0; i < n; i++) dst[i] |= bits.get(k);
                rsip += n;
                samples_put += n;
                if (rsip == S) flush();
            } else {
                for (unsigned i = 0; i < n; i++) {
                    if (!bits.has((size_t)k)) goto done;
                    if (!have_room(1)) goto done;
                    uint32_t lsb = k ? bits.get(k) : 0;
                    put(dst[i] | lsb);
                }
            }
        }
    }
done:
    if (status == AEC_OK) {
        // reference: leftover output space smaller than one sample is an
        // error, checked *before* the final partial-RSI flush
        // (decode.c:821-825); on any error the final flush is skipped, so
        // only whole-RSI flushes are visible in the output.
        size_t left = out_cap - (size_t)bsz * samples_put;
        if (left > 0 && left < (size_t)bsz) status = AEC_MEM_ERROR;
    }
    if (status == AEC_OK) flush();
    *out_written = w.written();
    return status;
}

}  // namespace

extern "C" {

int aectpu_decode_deltas(const uint8_t* in, size_t in_len, uint8_t* out,
                         size_t out_cap, size_t* out_written,
                         unsigned bits_per_sample, unsigned block_size,
                         unsigned rsi, unsigned flags) {
    Params p{bits_per_sample, block_size, rsi, flags};
    if (bits_per_sample == 0 || bits_per_sample > 32) return AEC_CONF_ERROR;
    InputView input(in, in_len);
    return decode_core(input, 0, out, out_cap, out_written, p, true);
}

// Serial decode resuming at an RSI-start bit offset: finishes the tail the
// structural scan could not validate (truncated / malformed / oversized-FS
// input), preserving the reference's truncation and error semantics.
int aectpu_decode_tail(const uint8_t* in, size_t in_len, uint64_t start_bit,
                       uint8_t* out, size_t out_cap, size_t* out_written,
                       unsigned bits_per_sample, unsigned block_size,
                       unsigned rsi, unsigned flags) {
    Params p{bits_per_sample, block_size, rsi, flags};
    if (bits_per_sample == 0 || bits_per_sample > 32) return AEC_CONF_ERROR;
    InputView input(in, in_len);
    return decode_core(input, start_bit, out, out_cap, out_written, p);
}

int aectpu_decode(const uint8_t* in, size_t in_len, uint8_t* out,
                  size_t out_cap, size_t* out_written,
                  unsigned bits_per_sample, unsigned block_size, unsigned rsi,
                  unsigned flags) {
    Params p{bits_per_sample, block_size, rsi, flags};
    if (bits_per_sample == 0 || bits_per_sample > 32) return AEC_CONF_ERROR;
    InputView input(in, in_len);
    return decode_core(input, 0, out, out_cap, out_written, p);
}

// Two-phase parallel decode: a structural scan finds RSI start bits (exact
// mirror of decode_core's bit consumption), worker threads decode whole
// validated RSIs concurrently (RSIs are self-contained: the predictor
// reference restarts at each RSI, decode.c:410-413), and the serial core
// finishes the tail to preserve truncation/error semantics bit-exactly.
// The scan overlaps the workers: workers claim RSIs as they are published.
int aectpu_decode_parallel(const uint8_t* in, size_t in_len,
                           uint64_t start_bit, uint8_t* out, size_t out_cap,
                           size_t* out_written, unsigned bits_per_sample,
                           unsigned block_size, unsigned rsi, unsigned flags,
                           int n_threads) {
    Params p{bits_per_sample, block_size, rsi, flags};
    if (bits_per_sample == 0 || bits_per_sample > 32) return AEC_CONF_ERROR;
    const size_t S = (size_t)rsi * block_size;
    const size_t rsi_bytes = S * (size_t)p.bytes_per_sample();
    InputView input(in, in_len);

    const size_t cap_rsis = out_cap / rsi_bytes;
    if (n_threads < 1) n_threads = 1;
    if (cap_rsis < 4 || n_threads == 1) {
        return decode_core(input, start_bit, out, out_cap, out_written, p);
    }

    std::vector<uint64_t> offsets;
    offsets.reserve(cap_rsis + 1);
    std::atomic<size_t> published{0};
    std::atomic<bool> scan_done{false};
    std::atomic<size_t> next_claim{0};

    auto worker = [&]() {
        for (;;) {
            size_t i = next_claim.fetch_add(1, std::memory_order_relaxed);
            while (i >= published.load(std::memory_order_acquire)) {
                if (scan_done.load(std::memory_order_acquire) &&
                    i >= published.load(std::memory_order_acquire))
                    return;
                std::this_thread::yield();
            }
            size_t wr = 0;
            decode_core(input, offsets[i], out + i * rsi_bytes, rsi_bytes,
                        &wr, p);
        }
    };

    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads - 1; t++) threads.emplace_back(worker);

    // scan on this thread, publishing offsets as they validate
    {
        BitCursor bits(input, start_bit);
        while (published.load(std::memory_order_relaxed) < cap_rsis) {
            uint64_t rsi_start = bits.pos();
            if (flags & FLAG_PAD_RSI) bits.seek((bits.pos() + 7) & ~7ull);
            if (!scan_one_rsi(bits, p, nullptr, 0)) {
                bits.seek(rsi_start);  // tail resumes at this RSI
                break;
            }
            offsets.push_back(rsi_start);
            published.store(offsets.size(), std::memory_order_release);
        }
        scan_done.store(true, std::memory_order_release);
        worker();  // the scan thread joins the decode pool
        for (auto& t : threads) t.join();

        const size_t n_par = published.load(std::memory_order_relaxed);
        const size_t done_bytes = n_par * rsi_bytes;
        size_t tail_wr = 0;
        int status = decode_core(input, bits.pos(), out + done_bytes,
                                 out_cap - done_bytes, &tail_wr, p);
        *out_written = done_bytes + tail_wr;
        return status;
    }
}

// Standalone window materialisation for records produced by a wf=0 scan:
// lets the caller pick the window width AFTER the walk (bucketed from the
// chunk's actual max payload span instead of the worst-case conforming
// payload -- decode.py's per-chunk wf bucketing), then fill on `threads`
// workers.  Pure memcpy work, embarrassingly parallel over records.
int aectpu_fill_windows(const uint8_t* in, size_t in_len,
                        const uint64_t* fs_off, const uint32_t* meta,
                        uint32_t* win, int wf, size_t n, int threads) {
    InputView input(in, in_len);
    if (threads < 1) threads = 1;
    if (threads == 1 || n < 4096) {
        fill_windows(input, fs_off, meta, win, wf, 0, n);
        return AEC_OK;
    }
    std::vector<std::thread> pool;
    size_t per = (n + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        size_t lo = (size_t)t * per;
        size_t hi = lo + per < n ? lo + per : n;
        if (lo >= hi) break;
        pool.emplace_back([&, lo, hi] {
            fill_windows(input, fs_off, meta, win, wf, lo, hi);
        });
    }
    for (auto& t : pool) t.join();
    return AEC_OK;
}

// Offsets-only structural scan: count complete RSIs from start_bit (at most
// max_rsis) and report where the next RSI would begin.  Powers bounded-
// memory chunked decode (CLI) and incremental streaming decode (stream.py):
// the caller decodes [start_bit, end_bit) knowing it holds exactly n whole
// RSIs.
int aectpu_scan_rsis(const uint8_t* in, size_t in_len, uint64_t start_bit,
                     size_t max_rsis, size_t* n_rsis_out,
                     uint64_t* end_bit_out, unsigned bits_per_sample,
                     unsigned block_size, unsigned rsi, unsigned flags) {
    Params p{bits_per_sample, block_size, rsi, flags};
    if (bits_per_sample == 0 || bits_per_sample > 32) return AEC_CONF_ERROR;
    InputView input(in, in_len);
    BitCursor bits(input, start_bit);
    size_t n_rsis = 0;
    while (n_rsis < max_rsis) {
        uint64_t rsi_start = bits.pos();
        if (flags & FLAG_PAD_RSI) bits.seek((bits.pos() + 7) & ~7ull);
        if (!scan_one_rsi(bits, p, nullptr, 0)) {
            bits.seek(rsi_start);
            break;
        }
        n_rsis++;
    }
    *n_rsis_out = n_rsis;
    *end_bit_out = bits.pos();
    return AEC_OK;
}

// Phase-1 of the device (TPU) decode: walk the stream from start_bit (an
// RSI boundary; 0 for the stream head) and emit one payload record per
// output block for every complete, device-decodable RSI.  The caller
// provides arrays of max_rsis * rsi records; *n_rsis_out receives the
// number of complete RSIs recorded and *tail_bit_out the bit position where
// the next call (or the exact serial core, on a truncated/malformed/
// oversized-FS tail) must resume.  Resumability is what lets the host
// overlap scan chunks with in-flight device decode dispatches (decode.py).
// max_fs_bits is the device kernel's static FS window in bits.
int aectpu_scan_blocks(const uint8_t* in, size_t in_len, uint64_t start_bit,
                       size_t max_rsis,
                       int max_fs_bits, uint64_t* fs_off, uint64_t* lsb_off,
                       uint32_t* meta, uint32_t* ref_sample, uint32_t* win,
                       int wf, size_t* n_rsis_out, uint64_t* tail_bit_out,
                       unsigned bits_per_sample, unsigned block_size,
                       unsigned rsi, unsigned flags, int n_threads) {
    Params p{bits_per_sample, block_size, rsi, flags};
    if (bits_per_sample == 0 || bits_per_sample > 32) return AEC_CONF_ERROR;
    if (wf > 66) return AEC_CONF_ERROR;  // worst conforming payload bound
    InputView input(in, in_len);
    BitCursor bits(input, start_bit);
    const bool deferred = win && n_threads > 1;
    BlockRecSink rec{fs_off, lsb_off, meta, ref_sample,
                     deferred ? nullptr : win, wf, &input};

    // With n_threads > 1 the window memcpys (the other ~third of scan time)
    // run on worker threads chasing the scan: records [0, published) are
    // final once published, so fillers CAS-claim bounded ranges behind it.
    std::atomic<size_t> published{0};
    std::atomic<size_t> fill_next{0};
    std::atomic<bool> scan_done{false};
    constexpr size_t GRAIN = 2048;

    auto filler = [&]() {
        for (;;) {
            size_t avail = published.load(std::memory_order_acquire);
            size_t lo = fill_next.load(std::memory_order_relaxed);
            if (lo >= avail) {
                if (scan_done.load(std::memory_order_acquire) &&
                    lo >= published.load(std::memory_order_acquire))
                    return;
                std::this_thread::yield();
                continue;
            }
            size_t want = avail - lo < GRAIN ? avail - lo : GRAIN;
            if (!fill_next.compare_exchange_weak(
                    lo, lo + want, std::memory_order_relaxed))
                continue;
            fill_windows(input, fs_off, meta, win, wf, lo, lo + want);
        }
    };

    std::vector<std::thread> threads;
    if (deferred)
        for (int t = 0; t < n_threads - 1; t++) threads.emplace_back(filler);

    size_t n_rsis = 0;
    while (n_rsis < max_rsis) {
        uint64_t rsi_start = bits.pos();
        size_t rec_start = rec.n;
        if (flags & FLAG_PAD_RSI) bits.seek((bits.pos() + 7) & ~7ull);
        if (!scan_one_rsi(bits, p, &rec, max_fs_bits)) {
            bits.seek(rsi_start);
            rec.n = rec_start;
            break;
        }
        n_rsis++;
        if (deferred)
            published.store(rec.n, std::memory_order_release);
    }
    if (deferred) {
        scan_done.store(true, std::memory_order_release);
        filler();  // the scan thread joins the fill pool to drain
        for (auto& t : threads) t.join();
    }
    *n_rsis_out = n_rsis;
    *tail_bit_out = bits.pos();
    return AEC_OK;
}

}  // extern "C"
