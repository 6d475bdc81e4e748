"""Bit assembly: the plain stage-A window pack and the plain merge.

Stage A (libaec_tpu/ops/bitpack.py:137-152): each block's fields, at
exclusive-prefix bit offsets behind a one-word front pad, land in a
window of W0 MSB-first u32 words.  A field of width w ending at bit e
touches words (e >> 5) - 1 and e >> 5; field windows never overlap, so a
scatter-add is an OR.

Merge: window word j of a block whose window starts at stream-buffer bit
`off` covers buffer bits [off + 32 j, off + 32 j + 32): it is shifted
right by off & 31 and added at word (off >> 5) + j.  Buffer word 0 is the
front pad, so stream bit b is buffer bit 32 + b and `off` = bit0 + the
exclusive prefix of block_bits.
"""
import torch

from .u32 import MASK32, from_bits, swap32, to_bits


def _shift_parts(v, t):
    """A u32 value split across the word pair it straddles after a right
    shift by t in [0, 32): (high word part, low word part)."""
    hi = v >> t
    lo = torch.where(t == 0, 0, (v << ((32 - t) & 31)) & MASK32)
    return hi, lo


def pack_windows(widths, values, W0):
    """widths/values: int64 [NB, F] fields in stream order.  Returns
    (win int64 [NB, W0] u32 words, block_bits int64 [NB])."""
    NB = widths.shape[0]
    e = torch.cumsum(widths, dim=1) + 32
    c1, c2 = _shift_parts(values, e & 31)
    i1 = (e >> 5) - 1
    i2 = torch.where(c2 == 0, 0, e >> 5)
    win = torch.zeros(NB, W0, dtype=torch.int64, device=widths.device)
    win.scatter_add_(1, i1, c1)
    win.scatter_add_(1, i2, c2)
    return win, e[:, -1] - 32


def merge_windows(win, block_bits, bit0, nwords):
    """Place block windows into the packed word stream.

    win: int32 or int64 [NB, W] u32 words; block_bits: [NB];
    bit0: int64 [1] starting bit offset in [0, 8).
    Returns (words int32 [nwords] in stream byte order (swap32 applied),
    tail int64 [2] = (total_bits incl. bit0, total_bits & 7))."""
    w = from_bits(win)
    NB, W = w.shape
    bb = block_bits.to(torch.int64)
    off = torch.cumsum(bb, 0) - bb + bit0
    q = (off >> 5)[:, None] + torch.arange(W, device=w.device)[None, :]
    hi, lo = _shift_parts(w, (off & 31)[:, None])
    n = max(nwords, int(q.max()) + 2) if NB else nwords
    buf = torch.zeros(n, dtype=torch.int64, device=w.device)
    buf.index_add_(0, q.reshape(-1), hi.reshape(-1))
    buf.index_add_(0, (q + 1).reshape(-1), lo.reshape(-1))
    total = off[-1:] + bb[-1:] if NB else bit0.clone()
    tail = torch.cat([total, total & 7])
    return to_bits(swap32(buf[:nwords])), tail


def _window_part(w, j, s):
    """Block j's bits in the word whose first bit is window bit s >= 1 of
    the block (merge.cu's window_part), for tensors j, s."""
    W = w.shape[1]
    a, r = s >> 5, s & 31
    hi = torch.where(a < W, w[j, a.clamp(0, W - 1)], 0)
    lo = torch.where((r > 0) & (a + 1 < W), w[j, (a + 1).clamp(0, W - 1)],
                     0)
    return ((hi << r) | (lo >> (32 - r))) & MASK32


def merge_windows_owned(win, block_bits, bit0, nwords, tile=256):
    """Kernel 2's design (csrc/merge.cu) as tensor code: the same words as
    merge_windows over the used prefix, gathered by the word's owner.

    Blocks form tiles of `tile`; a tile's sum and exclusive prefix give its
    first bit, as the kernel's two launches do.  The tile owns the words
    whose first bit lies in its blocks; each such word ORs the windows of
    the block that holds its first bit and of every block after it that
    starts inside the word, within the tile.  A tile's last word may reach
    past the tile's bits: its part from the following tiles' blocks is
    gathered apart (the kernel's warp 0).  Word 0 is written zero.

    Returns (words int32 [nwords], zero past the used prefix; tail as
    merge_windows; writes int64 [used words]: how many times each word of
    the used prefix was written -- the design writes each exactly once)."""
    w = from_bits(win)
    NB = w.shape[0]
    dev = w.device
    bb = block_bits.to(torch.int64)
    T = -(-NB // tile)
    rows = torch.cat([bb, bb.new_zeros(T * tile - NB)]).view(T, tile)
    agg = rows.sum(1)
    local = torch.cumsum(rows, 1) - rows          # the tile's own prefix
    base = 32 + bit0.to(torch.int64) + torch.cumsum(agg, 0) - agg
    end = base + agg
    start = (base[:, None] + local).reshape(-1)[:NB]  # buffer bits
    total = end[-1:] - 32
    used = (int(total) + 63) // 32
    tiles = torch.arange(T, device=dev)
    lo = torch.where(tiles == 0, 1, (base + 31) >> 5)
    hi = (end + 31) >> 5
    spill = (tiles < T - 1) & (hi > lo) & ((hi << 5) > end)
    own = torch.where(spill, hi - 1, hi).clamp(max=nwords)
    n_own = (own - lo).clamp(min=0)

    # words a thread of tile t writes: [lo, own), from the tile's blocks
    tile_of = torch.repeat_interleave(tiles, n_own)
    first = torch.repeat_interleave(torch.cumsum(n_own, 0) - n_own, n_own)
    wi = lo[tile_of] + torch.arange(len(tile_of), device=dev) - first
    # spill words: the tile's blocks by the same gather, then the rest
    sp = tiles[spill & (hi - 1 < nwords)]
    wi = torch.cat([wi, hi[sp] - 1])
    tile_of = torch.cat([tile_of, sp])

    n_blk = torch.clamp(NB - tiles * tile, max=tile)
    x = 32 * wi - base[tile_of]                   # first bit, tile-relative
    k = torch.searchsorted(local[tile_of].contiguous(), x[:, None],
                           right=True)[:, 0]
    j = (k - 1).clamp(min=0)
    val = torch.zeros_like(wi)
    while True:  # blocks of the tile that start inside the word
        on = j < n_blk[tile_of]
        jc = torch.where(on, j, 0)
        s_rel = local[tile_of, jc.clamp(max=tile - 1)]
        on &= s_rel < x + 32
        if not bool(on.any()):
            break
        blk = tile_of * tile + jc
        take = on & (bb[blk.clamp(max=NB - 1)] > 0)
        part = _window_part(w, blk.clamp(max=NB - 1), x + 32 - s_rel)
        val |= torch.where(take, part, 0)
        j = j + 1
    n_in = len(wi) - len(sp)
    stop = 32 * (hi[sp])                          # the spill words' ends
    jb = (sp + 1) * tile
    spilled = torch.zeros_like(stop)
    while len(sp):  # blocks of the following tiles inside the spill word
        on = jb < NB
        jc = torch.where(on, jb, 0)
        on &= start[jc] < stop
        if not bool(on.any()):
            break
        take = on & (bb[jc] > 0)
        part = _window_part(w, jc, stop - start[jc])
        spilled |= torch.where(take, part, 0)
        jb = jb + 1
    val[n_in:] |= spilled

    buf = torch.zeros(nwords, dtype=torch.int64, device=dev)
    writes = torch.zeros(used, dtype=torch.int64, device=dev)
    buf[wi] = val
    writes.index_add_(0, wi, torch.ones_like(wi))
    if nwords:
        writes[0] += 1                            # word 0, zero
    tail = torch.cat([total, total & 7])
    return to_bits(swap32(buf)), tail, writes
