"""Payload decode, plain torch: twin of libaec_tpu/ops/bitunpack.py.

Phase 2 of the two-phase decode.  The native structural scan emits one
record per output block (payload offset, LSB-region offset, kind|k|ref,
reference sample) and a raw payload window of Wf stream words; this
module turns each block's payload into its bs mapped deltas.  It is the
plain version of kernel 3 (kernels/decode_cuda.py): the tests hold it
against the JAX package's interpret-mode Pallas kernel, chip_smoke.py
holds the CUDA kernel against it.

u32 values live in int64 tensors, masked after every operation that can
leave 32 bits (ops/u32.py).  The JAX formulation's dense [NB, bs, Wf]
selects become a searchsorted and gathers over the window axis: the same
values, without the cubic intermediate.
"""
import sys

import numpy as np
import torch

from . import u32
from .u32 import MASK32, from_bits, to_bits

KIND_SE, KIND_SPLIT, KIND_UNCOMP = 1, 2, 3  # meta & 3; 0 is a zero block

# Per-chunk window-width buckets, in words (libaec_tpu/decode.py:178).  The
# worst-case window (window_words) covers an uncompressed payload, but
# typical data's largest payload is a split block of a few words; sizing the
# windows from the chunk's largest span cuts the fill, the H2D copy and the
# kernel's reads by the same factor.
WF_BUCKETS = (6, 10, 18)


def window_words(cfg):
    """Worst-case payload window in u32 words (bitunpack.py:44-48)."""
    return (cfg.block_size * cfg.bits_per_sample) // 32 + 2


def max_fs_bits(cfg):
    """FS-region bit budget the scan enforces (bitunpack.py:51-55)."""
    return cfg.block_size * cfg.bits_per_sample


def swap32(w):
    """Raw scan words (int32 bit patterns) -> big-endian u32 values in
    int64.  The scan memcpys the windows raw; on a big-endian host the
    words already read big-endian (bitunpack.py:58-75)."""
    w = from_bits(w)
    return w if sys.byteorder == "big" else u32.swap32(w)


def popcount32(x):
    """Set bits of int64 u32 values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _as_i32(x):
    """int64 u32 bit patterns -> their int32 values, in int64."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def _gather_words(win, idx):
    """win[b, idx[b, j]], 0 where idx is outside [0, Wf)."""
    Wf = win.shape[1]
    ok = (idx >= 0) & (idx < Wf)
    got = torch.gather(win, 1, idx.clamp(0, Wf - 1))
    return torch.where(ok, got, 0)


def decode_payload(cfg, win, fs_bit, lsb_rel, meta):
    """Twin of _decode_payload_xla (bitunpack.py:96-166).

    win: [NB, Wf] raw scan words (int32 bits); records [NB] (int32 bits).
    Returns (val, fs) int64 u32 [NB, bs]: composed split/uncomp/zero
    deltas and raw FS values (the SE codes)."""
    bs, bps = cfg.block_size, cfg.bits_per_sample
    dev = win.device
    fs_bit, lsb_rel, meta = (from_bits(t)[:, None]
                             for t in (fs_bit, lsb_rel, meta))
    kind = meta & 3
    k = (meta >> 2) & 31
    ref = (meta >> 7) & 1
    is_se, is_split = kind == KIND_SE, kind == KIND_SPLIT
    is_uncomp = kind == KIND_UNCOMP

    win = swap32(win)
    win[:, :1] &= torch.full_like(fs_bit, MASK32) >> fs_bit

    # FS parse: the (j+1)-th set bit of the payload ends FS value j
    n_fs = torch.where(is_split, bs - ref, torch.where(is_se, bs // 2, 0))
    pc = popcount32(win)
    cum = torch.cumsum(pc, dim=1)                    # inclusive [NB, Wf]
    j = torch.arange(bs, device=dev).expand(win.shape[0], bs)
    t = torch.searchsorted(cum, j.contiguous(), right=True)  # word index
    ce = torch.where(t > 0, _gather_words(cum, t - 1), 0)    # rank before it
    wsel = _gather_words(win, t)
    r = j - ce
    L = torch.zeros_like(j)
    for s in (16, 8, 4, 2, 1):  # (r+1)-th set bit from the MSB
        cnt = popcount32(wsel >> (32 - (L + s)))
        L = L + torch.where(cnt <= r, s, 0)
    sel = _as_i32((t << 5) + L - fs_bit)
    prev = torch.cat([torch.full_like(sel[:, :1], -1), sel[:, :-1]], dim=1)
    fs = torch.where(j < n_fs, (sel - prev - 1) & MASK32, 0)

    # LSB / raw fields by funnel shift of two window words
    pj = torch.maximum(j, ref) - ref  # a reference shifts the payload
    keff = torch.where(is_uncomp, bps, torch.where(is_split, k, 0))
    q = (fs_bit + lsb_rel + pj * keff) & MASK32
    qw, qb = q >> 5, q & 31
    w0, w1 = _gather_words(win, qw), _gather_words(win, qw + 1)
    hi = (w0 << qb) & MASK32
    lo = torch.where(qb == 0, 0, w1 >> (32 - qb.clamp(min=1)))
    field = torch.where(keff == 0, 0, (hi | lo) >> (32 - keff.clamp(min=1)))

    fs_shift = torch.cat([torch.zeros_like(fs[:, :1]), fs[:, :-1]], dim=1)
    fsp = torch.where(ref == 1, fs_shift, fs)
    val = ((fsp << k) & MASK32) | field
    return val, fs


def compose_blocks(cfg, val, fs, meta, ref_sample):
    """Twin of compose_blocks (bitunpack.py:169-197): second-extension
    unpairing from the FS codes, then the reference-sample stitch.
    Returns int64 u32 [NB, bs]."""
    bs = cfg.block_size
    meta = from_bits(meta)[:, None]
    kind, ref = meta & 3, (meta >> 7) & 1
    pos = torch.arange(bs, device=val.device)[None, :]

    m2 = torch.repeat_interleave(fs[:, : bs // 2], 2, dim=1)
    i0 = ((torch.sqrt(8.0 * m2.to(torch.float32) + 1.0) - 1.0)
          * 0.5).to(torch.int64)

    def corr(i):
        i = i + (((i + 1) * (i + 2) & MASK32) // 2 <= m2).to(torch.int64)
        return i - ((i * (i + 1) & MASK32) // 2 > m2).to(torch.int64)

    ii = corr(corr(i0)) & MASK32
    vb = (m2 - (ii * (ii + 1) & MASK32) // 2) & MASK32
    va = (ii - vb) & MASK32
    se_val = torch.where((pos & 1) == 0, va, vb)

    out = torch.where(kind == KIND_SE, se_val, val)
    return torch.where((ref == 1) & (pos == 0),
                       from_bits(ref_sample)[:, None], out)


def decode_blocks(cfg, win, fs_bit, lsb_rel, meta, ref_sample):
    """Mapped deltas int32 [NB, bs] (u32 bits) of every block; the
    contract of kernels/decode_cuda.decode_blocks."""
    val, fs = decode_payload(cfg, win, fs_bit, lsb_rel, meta)
    return to_bits(compose_blocks(cfg, val, fs, meta, ref_sample))


def decode_payload_region(cfg, win, fs_bit, lsb_rel, meta):
    """Kernel 3's parse (csrc/decode_block.cuh) as tensor code: the same
    (val, fs) as decode_payload, reading only what the kernel reads.

    FS value j ends at the payload's (j+1)-th set bit; a block's FS
    positions come from words [0, nsearch) alone, up to the one that holds
    its n_fs-th set bit (the FS region, where the kernel's lanes write each
    set bit's position at its rank), its fields read words [0, nfield) (up
    to the one after the last field's end), and every other window word is
    zeroed before the parse, as the kernel never stages it; zero blocks
    read no window at all, and blocks with no FS values (zero,
    uncompressed) look for none.  Returns (val, fs, nsearch, nfield), the
    last two int64 [NB]."""
    bs, bps = cfg.block_size, cfg.bits_per_sample
    dev = win.device
    fs_bit, lsb_rel, meta = (from_bits(t)[:, None]
                             for t in (fs_bit, lsb_rel, meta))
    kind = meta & 3
    k = (meta >> 2) & 31
    ref = (meta >> 7) & 1
    is_se, is_split = kind == KIND_SE, kind == KIND_SPLIT
    NB, Wf = win.shape
    n_fs = torch.where(is_split, bs - ref, torch.where(is_se, bs // 2, 0))
    keff = torch.where(kind == KIND_UNCOMP, bps, torch.where(is_split, k, 0))
    q0 = fs_bit + lsb_rel
    nfield = torch.where(keff > 0, torch.clamp(
        ((q0 + (bs - ref) * keff) >> 5) + 2, max=Wf), 0)

    w = swap32(win)
    w[:, :1] &= torch.full_like(fs_bit, MASK32) >> fs_bit
    pos = torch.arange(Wf, device=dev)[None, :]
    cum = torch.cumsum(popcount32(w), dim=1)
    reached = (cum >= n_fs) & (n_fs > 0)
    nsearch = torch.where(reached.any(1, keepdim=True),
                          reached.int().argmax(1, keepdim=True) + 1,
                          torch.where(n_fs > 0, Wf, 0))
    staged = torch.maximum(nsearch, nfield)
    w = torch.where((pos < staged) & (kind != 0), w, 0)

    # FS: bit l of word i (MSB first) is tested by lane l; a set bit of
    # rank r < n_fs writes its payload position 32 i + l - fs_bit to sel[r]
    j = torch.arange(bs, device=dev).expand(NB, bs)
    lane = torch.arange(32, device=dev)
    bits = ((w[:, :, None] >> (31 - lane)) & 1).reshape(NB, Wf * 32)
    bit_word = torch.arange(Wf * 32, device=dev)[None, :] >> 5
    bits = bits * (bit_word < nsearch)
    rank = torch.cumsum(bits, dim=1) - 1
    hit = (bits == 1) & (rank < n_fs)
    row, col = hit.nonzero(as_tuple=True)
    sel = torch.zeros(NB, bs, dtype=torch.int64, device=dev)
    sel[row, rank[row, col]] = _as_i32(col - fs_bit[row, 0])
    prev = torch.cat([torch.full_like(sel[:, :1], -1), sel[:, :-1]], dim=1)
    fs = torch.where(j < n_fs, (sel - prev - 1) & MASK32, 0)

    pj = torch.maximum(j, ref) - ref
    q = (q0 + pj * keff) & MASK32
    qw, qb = q >> 5, q & 31
    w0 = torch.where(qw < nfield, _gather_words(w, qw), 0)
    w1 = torch.where(qw + 1 < nfield, _gather_words(w, qw + 1), 0)
    hi = (w0 << qb) & MASK32
    lo = torch.where(qb == 0, 0, w1 >> (32 - qb.clamp(min=1)))
    field = torch.where(keff == 0, 0, (hi | lo) >> (32 - keff.clamp(min=1)))

    fs_shift = torch.cat([torch.zeros_like(fs[:, :1]), fs[:, :-1]], dim=1)
    fsp = torch.where(ref == 1, fs_shift, fs)
    val = ((fsp << k) & MASK32) | field
    return val, fs, nsearch[:, 0], nfield[:, 0]


def decode_blocks_region(cfg, win, fs_bit, lsb_rel, meta, ref_sample):
    """decode_blocks through decode_payload_region: int32 [NB, bs]."""
    val, fs, _, _ = decode_payload_region(cfg, win, fs_bit, lsb_rel, meta)
    return to_bits(compose_blocks(cfg, val, fs, meta, ref_sample))


class BucketScratch:
    """Arrays bucket_wf works in, for up to n records: a caller that
    buckets chunk after chunk (decode._Slot) keeps one, so that a chunk
    makes no arrays of its own but numpy's index of its non-zero
    payloads."""

    def __init__(self, n):
        self.kind = np.empty(n, np.uint32)
        self.nonzero = np.empty(n, np.bool_)
        self.nz = np.empty(n, np.uint64)
        self.span = np.empty(n, np.uint64)


def bucket_wf(cfg, recs, tail_bit, scratch=None):
    """Twin of _bucket_wf (libaec_tpu/decode.py:181-199): the smallest
    width of WF_BUCKETS that covers every payload span of the chunk, or
    the worst-case window.  A span runs from a non-zero payload to the
    next one (the last to tail_bit), in u64 as the twin's; the steps
    write into `scratch` (a BucketScratch; a new one when None)."""
    wf_max = window_words(cfg)
    fs_off = recs["fs_off"]
    n = len(fs_off)
    s = scratch if scratch is not None else BucketScratch(n)
    kind = np.bitwise_and(recs["meta"], np.uint32(3), out=s.kind[:n])
    nonzero = np.not_equal(kind, 0, out=s.nonzero[:n])
    cnt = int(np.count_nonzero(nonzero))
    if cnt == 0:
        return min(WF_BUCKETS[0], wf_max)
    nz = np.compress(nonzero, fs_off, out=s.nz[:cnt])
    span = (tail_bit - int(nz[-1])) % (1 << 64)
    if cnt > 1:
        span = max(span, int(np.subtract(nz[1:], nz[:-1],
                                         out=s.span[:cnt - 1]).max()))
    need = (31 + span + 31) // 32 + 1
    for b in WF_BUCKETS:
        if need <= b <= wf_max:
            return b
    return wf_max
