"""Kernel 1: raw chunk bytes -> per-block bit windows, block_bits, k_final.

CUDA route: csrc/encode.cu, the port of encode_tile_kernel
(libaec_tpu/kernels/encode_pallas.py:83), in three launches: pass A (a
thread block per tile of 64 blocks: deltas, zero flags, split lengths,
each block's warm-start map and the tile's composite), the k chain as a
scan over runs of tile composites (one thread block), pass C (the same
tiles: each block's k from its tile's incoming k, option select, fields,
pack), and under AEC_PAD_RSI a fourth (each RSI's pad to a byte).  It
takes every block size a Config accepts: blocks over 64 samples (any
even size under AEC_NOT_ENFORCE, where the JAX package falls back to its
XLA pipeline) take the kernel's wide path: a group of warps a block,
each warp on its share of the block's segments of 64 samples, groups of
a thread block of 8 warps on consecutive blocks (`wide_layout`).  The
plain versions of its two algorithms that differ from the
straightforward ones are ops/options.chain_k_tiled and
ops/options.fs_tables_lanes.  A stream's short last RSI (fewer samples
than an RSI) is, to the kernel, a chunk of one RSI of nb < rsi blocks:
`encode_fields(..., nb=nb)` passes nb where the C entry takes the RSI
length, which every zero-run segment, reference sample and pad is
measured from.  Plain route:
`encode_fields_plain`, the field pipeline of ops/ (accessors, preprocess,
zeroruns, options, fields, bitpack stage A) -- the twin of the JAX
package's XLA pipeline, used only as a reference: on the CPU by the
tests, on the card by chip_smoke.py.  `encode_fields` takes the plain
route only for a CPU tensor; a CUDA tensor launches the kernel or raises.

A shard of a stream cut over several cards (parallel/dist.py) runs the
same kernel in two phases: `encode_kmap` (pass A, then the chain scan in
its map mode: the shard's total k-map, plain twin ops/options.shard_kmap)
and, once the k entering the shard is known, `encode_fields_resume` (the
chain scan from that k, then pass C, on the scratch the first phase
left).  Each wrapper counts its calls: `launches` (encode_fields, three
launches a call), `kmap_launches` and `resume_launches` (two each).
"""
from typing import NamedTuple, Optional

import torch

from ..ops import accessors, bitpack, fields, options, preprocess, zeroruns
from ..ops.u32 import MASK32, to_bits
from . import _build

launches = 0
kmap_launches = 0
resume_launches = 0


# csrc/encode.cu's tiles: TILE blocks a thread block of WARPS warps, or
# on the wide path WARPS / group groups of `per_group` blocks
TILE, WARPS = 64, 8
SMEM = 48 << 10         # shared memory a launch gets without opting in
SMEM_OPTIN = 227 << 10  # and with, on the H100
FULL_WAVE = 132 * 8     # thread blocks of 8 warps the H100's SMs hold


class WideLayout(NamedTuple):
    """How kernel 1's wide path lays a chunk of blocks over 64 samples
    on the card: `group` warps a block (each on its share of the block's
    segments of 64 samples), `per_group` consecutive blocks a group takes
    in turn, the windows in shared memory (`smem`) or straight in device
    memory."""
    group: int
    per_group: int
    smem: bool


def wide_layout(cfg, NB):
    """The wide path's layout for NB blocks.  Groups a thread block: up to
    8, as many as keep a full wave of thread blocks and whose windows fit
    the shared memory a launch gets without opting in (one window of more
    takes the whole thread block, its shared memory up to the card's
    opt-in limit, else device memory).  Blocks a group: up to 8, as many
    as keep a full wave (fewer tiles for the k chain to walk)."""
    w_bytes = 4 * window_words(cfg)
    per_tb = WARPS
    while per_tb > 1 and (per_tb * w_bytes > SMEM
                          or NB < per_tb * FULL_WAVE):
        per_tb //= 2
    per_group = 1
    while per_group < 8 and NB >= 2 * per_group * per_tb * FULL_WAVE:
        per_group *= 2
    return WideLayout(WARPS // per_tb, per_group,
                      per_tb * w_bytes <= SMEM_OPTIN)


def tiles(cfg, NB):
    """Tiles of passes A and C (and tile composites of the k chain) for
    NB blocks."""
    if cfg.block_size <= 64:
        return -(-NB // TILE)
    layout = wide_layout(cfg, NB)
    return -(-NB // (WARPS // layout.group * layout.per_group))


def worst_case_bits_per_block(cfg):
    """Upper bound on one block's emitted bits: id + reference sample +
    the larger of the uncompressed payload and a zero-run FS field (a run
    emitted mid-segment can span 63 blocks: fsval 63, a 64-bit unary
    field, which exceeds block_size * bps for small blocks of narrow
    samples).  As libaec_tpu/encode.py:112."""
    return cfg.id_len + 1 + cfg.bits_per_sample + max(
        cfg.block_size * cfg.bits_per_sample, 64)


def window_words(cfg):
    """W0: words per block window, front pad word included.  The window
    holds 32 bits past the worst case's, room for AEC_PAD_RSI's pad of at
    most 7 zero bits on an RSI's last block."""
    local_words = (worst_case_bits_per_block(cfg) + 31) // 32 + 1
    return local_words + 1


def _block_rows(cfg, raw_u8, nb):
    """The front of the field pipeline: (mapped samples d_blk [NB, bs],
    reference-block flags ref [NB], this_bs [NB], reference samples
    ref_sample [NB], zero-block flags z2 [n_rsi, nb]).  nb is the number
    of blocks per RSI."""
    bs = cfg.block_size
    S = nb * bs
    x = accessors.bytes_to_samples(raw_u8, cfg.bytes_per_sample, cfg.msb,
                                   cfg.mask)
    n_rsi = x.shape[0] // S
    x = x.reshape(n_rsi, S)
    if cfg.preprocess:
        d, ref_samples = preprocess.delta_map(x, cfg)
    else:
        d, ref_samples = x, torch.zeros_like(x[:, 0])
    d_blk = d.reshape(n_rsi * nb, bs)
    b_in_rsi = torch.arange(nb, device=x.device).repeat(n_rsi)
    ref = (b_in_rsi == 0) if cfg.preprocess else torch.zeros_like(
        b_in_rsi, dtype=torch.bool)
    this_bs = bs - ref.to(torch.int64)
    z2 = (d_blk == 0).all(dim=-1).reshape(n_rsi, nb)
    return d_blk, ref, this_bs, ref_samples.repeat_interleave(nb), z2


def _split_tables(cfg, d_blk, this_bs, is_zero):
    """The split lengths L(k) [NB, K] and each block's warm-start map
    [NB, K] (the identity for a zero block).  Only for id_len > 1: the
    restricted set (K = 0) has no split option."""
    fs = options.fs_tables(d_blk, cfg.kmax + 1)
    L = options.split_lengths(fs, this_bs)
    return L, options.k_walk_maps(fs, L, this_bs, cfg.kmax, ~is_zero)


def pad_rsis(cfg, block_bits, nb):
    """AEC_PAD_RSI (libaec_tpu/encode.py:92-108): each RSI of nb blocks
    ends on a byte boundary, its last block lengthened by (-rsi_bits) mod
    8 zero bits; block_bits int64 [NB], in place.  The windows need no
    change: their bits past a block are zero."""
    if cfg.pad_rsi:
        rows = block_bits.view(-1, nb)
        rows[:, -1] += (-rows.sum(dim=1)) % 8
    return block_bits


def encode_fields_plain(cfg, raw_u8, k_init, nb=None):
    """Plain version of the kernel; same contract as `encode_fields`."""
    nb = cfg.rsi if nb is None else nb
    d_blk, ref, this_bs, ref_sample, z2 = _block_rows(cfg, raw_u8, nb)
    NB = d_blk.shape[0]
    ub = this_bs * cfg.bits_per_sample
    zinfo = zeroruns.zero_run_info(z2, nb, cfg.preprocess)
    is_zero = z2.reshape(NB)

    if cfg.id_len > 1:
        L, maps = _split_tables(cfg, d_blk, this_bs, is_zero)
        k0 = torch.as_tensor(k_init, device=d_blk.device).reshape(1).to(
            torch.int64)
        chosen_k, k_final = options.chain_k(maps, k0)
        split32 = torch.gather(L, 1, chosen_k[:, None])[:, 0] & MASK32
    else:  # the restricted set: k stays 0, no split option
        chosen_k = torch.zeros(NB, dtype=torch.int64, device=d_blk.device)
        k_final = chosen_k[:1]
        split32 = torch.full_like(chosen_k, MASK32)

    se_len, se_fs = options.se_lengths(d_blk, ub)
    opt = options.select_option(split32, se_len, ub)
    w, v = fields.gen_fields(
        cfg, d_blk, opt, chosen_k, ref, ref_sample, is_zero,
        zinfo["emit"].reshape(NB), zinfo["fsval"].reshape(NB),
        zinfo["zero_ref"].reshape(NB), se_fs)
    win, block_bits = bitpack.pack_windows(w, v, window_words(cfg))
    return (to_bits(win), to_bits(pad_rsis(cfg, block_bits, nb)),
            k_final.to(torch.int32))


def encode_kmap_plain(cfg, raw_u8):
    """Plain version of `encode_kmap`'s map: int32 [32] (the identity for
    the restricted set, which searches no k)."""
    if cfg.id_len == 1:
        return torch.arange(32, dtype=torch.int32, device=raw_u8.device)
    d_blk, _, this_bs, _, z2 = _block_rows(cfg, raw_u8, cfg.rsi)
    _, maps = _split_tables(cfg, d_blk, this_bs, z2.reshape(-1))
    return options.shard_kmap(maps).to(torch.int32)


def _check(t, dtype, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}")


def _check_input(cfg, raw_u8, nb):
    if not 1 <= nb <= cfg.rsi:
        raise ValueError(f"nb must be in [1, {cfg.rsi}], got {nb}")
    rsi_bytes = nb * cfg.block_size * cfg.bytes_per_sample
    if raw_u8.shape[0] == 0 or raw_u8.shape[0] % rsi_bytes:
        raise ValueError("input must hold one or more whole RSIs")
    if raw_u8.device.type != "cpu":
        _check(raw_u8, torch.uint8, "raw_u8")


def _check_k(k, raw_u8, name):
    _check(k, torch.int32, name)
    if k.numel() != 1 or k.device != raw_u8.device:
        raise ValueError(f"{name} must be one int32 on the input's device")


def _params(cfg, NB, nb):
    """The kernels' trailing C arguments from nb on, but the stream: NB
    blocks in RSIs of nb."""
    return (NB, nb, cfg.block_size, cfg.bits_per_sample,
            cfg.bytes_per_sample, int(cfg.msb), int(cfg.preprocess),
            int(cfg.signed), cfg.id_len, cfg.kmax, window_words(cfg),
            int(cfg.pad_rsi), cfg.xmax, cfg.xmin, cfg.mask,
            *(wide_layout(cfg, NB) if cfg.block_size > 64 else (1, 1, 0)))


class Scratch(NamedTuple):
    """What `encode_kmap` leaves for `encode_fields_resume`: the shard's
    raw bytes and, on the card, the kernel's scratch (each block's map,
    its zero flag, each tile's composite)."""
    raw: torch.Tensor
    maps: Optional[torch.Tensor] = None
    zflag: Optional[torch.Tensor] = None
    comp: Optional[torch.Tensor] = None


def encode_fields(cfg, raw_u8, k_init, nb=None):
    """raw_u8: uint8 whole RSIs of nb blocks of stream bytes; k_init:
    int32 [1], the incoming warm-start k, in device memory.  nb is the
    blocks an RSI: None for cfg.rsi, or fewer for a stream's short last
    RSI (its last block filled with repeats of its last sample), which
    the kernel codes as a chunk of one RSI of nb blocks.

    Returns (win int32 [NB, W0] u32 words, block_bits int32 [NB],
    k_final int32 [1]) on raw_u8's device."""
    nb = cfg.rsi if nb is None else nb
    _check_input(cfg, raw_u8, nb)
    if raw_u8.device.type == "cpu":
        return encode_fields_plain(cfg, raw_u8, k_init, nb=nb)
    _check_k(k_init, raw_u8, "k_init")
    lib = _build.load()
    dev = raw_u8.device
    NB = raw_u8.shape[0] // (nb * cfg.block_size * cfg.bytes_per_sample) * nb
    nt = tiles(cfg, NB)

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    win = empty(NB, window_words(cfg), dtype=torch.int32)
    block_bits = empty(NB, dtype=torch.int32)
    maps = empty(NB, 32, dtype=torch.uint8)
    zflag = empty(NB, dtype=torch.uint8)
    comp = empty(nt, 32, dtype=torch.uint8)
    tile_kin = empty(nt, dtype=torch.int32)
    k_final = empty(1, dtype=torch.int32)
    status = lib.aec_encode_fields(
        raw_u8.data_ptr(), win.data_ptr(), block_bits.data_ptr(),
        maps.data_ptr(), zflag.data_ptr(), comp.data_ptr(),
        tile_kin.data_ptr(), k_init.data_ptr(), k_final.data_ptr(),
        *_params(cfg, NB, nb), _build.stream_handle(dev))
    _build.check(status, "aec_encode_fields")
    global launches
    launches += 1
    return win, block_bits, k_final


def encode_kmap(cfg, raw_u8):
    """Phase one of the kernel for one shard of a stream: the shard's
    total k-map, before its incoming k is known.

    raw_u8 as `encode_fields`.  Returns (kmap int32 [32]: entry k is the
    k that leaves the shard when k enters it, the identity past kmax;
    a Scratch for `encode_fields_resume`), on raw_u8's device."""
    _check_input(cfg, raw_u8, cfg.rsi)
    if raw_u8.device.type == "cpu":
        return encode_kmap_plain(cfg, raw_u8), Scratch(raw_u8)
    lib = _build.load()
    dev = raw_u8.device
    NB = raw_u8.shape[0] // cfg.rsi_len_bytes * cfg.rsi
    scratch = Scratch(
        raw_u8, torch.empty(NB, 32, dtype=torch.uint8, device=dev),
        torch.empty(NB, dtype=torch.uint8, device=dev),
        torch.empty(tiles(cfg, NB), 32, dtype=torch.uint8, device=dev))
    kmap = torch.empty(32, dtype=torch.int32, device=dev)
    status = lib.aec_encode_kmap(
        raw_u8.data_ptr(), scratch.maps.data_ptr(), scratch.zflag.data_ptr(),
        scratch.comp.data_ptr(), kmap.data_ptr(),
        *_params(cfg, NB, cfg.rsi), _build.stream_handle(dev))
    _build.check(status, "aec_encode_kmap")
    global kmap_launches
    kmap_launches += 1
    return kmap, scratch


def encode_fields_resume(cfg, scratch, k_in):
    """Phase two: `encode_fields`' outputs for the shard `encode_kmap`
    left `scratch` for, with k_in (int32 [1] on its device) the k that
    enters it."""
    raw_u8 = scratch.raw
    if raw_u8.device.type == "cpu":
        return encode_fields_plain(cfg, raw_u8, k_in)
    _check_k(k_in, raw_u8, "k_in")
    lib = _build.load()
    dev = raw_u8.device
    NB = scratch.maps.shape[0]
    win = torch.empty(NB, window_words(cfg), dtype=torch.int32, device=dev)
    block_bits = torch.empty(NB, dtype=torch.int32, device=dev)
    tile_kin = torch.empty(scratch.comp.shape[0], dtype=torch.int32,
                           device=dev)
    k_final = torch.empty(1, dtype=torch.int32, device=dev)
    status = lib.aec_encode_resume(
        raw_u8.data_ptr(), win.data_ptr(), block_bits.data_ptr(),
        scratch.maps.data_ptr(), scratch.zflag.data_ptr(),
        scratch.comp.data_ptr(), tile_kin.data_ptr(), k_in.data_ptr(),
        k_final.data_ptr(), *_params(cfg, NB, cfg.rsi),
        _build.stream_handle(dev))
    _build.check(status, "aec_encode_resume")
    global resume_launches
    resume_launches += 1
    return win, block_bits, k_final
