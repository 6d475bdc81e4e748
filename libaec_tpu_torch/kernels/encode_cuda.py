"""Kernel 1: raw chunk bytes -> per-block bit windows, block_bits, k_final.

CUDA route: csrc/encode.cu, the port of encode_tile_kernel
(libaec_tpu/kernels/encode_pallas.py:83), in three launches: pass A (a
thread block per tile of 64 blocks: deltas, zero flags, split lengths,
each block's warm-start map and the tile's composite), the k chain as a
scan over runs of tile composites (one thread block), pass C (the same
tiles: each block's k from its tile's incoming k, option select, fields,
pack).  The plain versions of its two algorithms that differ from the
straightforward ones are ops/options.chain_k_tiled and
ops/options.fs_tables_lanes.  Plain route:
`encode_fields_plain`, the field pipeline of ops/ (accessors, preprocess,
zeroruns, options, fields, bitpack stage A) -- the twin of the JAX
package's XLA pipeline, used only as a reference: on the CPU by the
tests, on the card by chip_smoke.py.  `encode_fields` takes the plain
route only for a CPU tensor; a CUDA tensor launches the kernel or raises.
"""
import torch

from ..ops import accessors, bitpack, fields, options, preprocess, zeroruns
from ..ops.u32 import MASK32, to_bits
from . import _build

launches = 0


def kernel_supported(cfg):
    """The kernel gate: splitting on, blocks of 8 to 64 samples (any even
    size under AEC_NOT_ENFORCE), no per-RSI padding
    (encode_pallas.kernel_supported minus TPU tiling)."""
    return (cfg.id_len >= 2 and 8 <= cfg.block_size <= 64
            and not cfg.pad_rsi)


def worst_case_bits_per_block(cfg):
    """Upper bound on one block's emitted bits: id + reference sample +
    the larger of the uncompressed payload and a zero-run FS field (a run
    emitted mid-segment can span 63 blocks: fsval 63, a 64-bit unary
    field, which exceeds block_size * bps for small blocks of narrow
    samples).  As libaec_tpu/encode.py:112."""
    return cfg.id_len + 1 + cfg.bits_per_sample + max(
        cfg.block_size * cfg.bits_per_sample, 64)


def window_words(cfg):
    """W0: words per block window, front pad word included."""
    local_words = (worst_case_bits_per_block(cfg) + 31) // 32 + 1
    return local_words + 1


def encode_fields_plain(cfg, raw_u8, k_init, nb=None):
    """Plain version of the kernel; same contract as `encode_fields`.

    nb is the number of blocks per RSI: cfg.rsi, or fewer for the short
    last RSI of a stream (the host tail of encode.encode_buffer)."""
    bs = cfg.block_size
    nb = cfg.rsi if nb is None else nb
    S = nb * bs
    x = accessors.bytes_to_samples(raw_u8, cfg.bytes_per_sample, cfg.msb,
                                   cfg.mask)
    n_rsi = x.shape[0] // S
    NB = n_rsi * nb
    x = x.reshape(n_rsi, S)
    if cfg.preprocess:
        d, ref_samples = preprocess.delta_map(x, cfg)
    else:
        d, ref_samples = x, torch.zeros_like(x[:, 0])
    d_blk = d.reshape(NB, bs)
    b_in_rsi = torch.arange(nb, device=x.device).repeat(n_rsi)
    ref = (b_in_rsi == 0) if cfg.preprocess else torch.zeros_like(
        b_in_rsi, dtype=torch.bool)
    this_bs = bs - ref.to(torch.int64)
    ub = this_bs * cfg.bits_per_sample
    ref_sample = ref_samples.repeat_interleave(nb)

    z2 = (d_blk == 0).all(dim=-1).reshape(n_rsi, nb)
    zinfo = zeroruns.zero_run_info(z2, nb, cfg.preprocess)
    is_zero = z2.reshape(NB)

    K = cfg.kmax + 1
    fs = options.fs_tables(d_blk, K)
    L = options.split_lengths(fs, this_bs)
    maps = options.k_walk_maps(fs, L, this_bs, cfg.kmax, ~is_zero)
    k0 = torch.as_tensor(k_init, device=x.device).reshape(1).to(torch.int64)
    chosen_k, k_final = options.chain_k(maps, k0)
    split32 = torch.gather(L, 1, chosen_k[:, None])[:, 0] & MASK32

    se_len, se_fs = options.se_lengths(d_blk, ub)
    opt = options.select_option(split32, se_len, ub)
    w, v = fields.gen_fields(
        cfg, d_blk, opt, chosen_k, ref, ref_sample, is_zero,
        zinfo["emit"].reshape(NB), zinfo["fsval"].reshape(NB),
        zinfo["zero_ref"].reshape(NB), se_fs)
    win, block_bits = bitpack.pack_windows(w, v, window_words(cfg))
    return to_bits(win), to_bits(block_bits), k_final.to(torch.int32)


def _check(t, dtype, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}")


def encode_fields(cfg, raw_u8, k_init):
    """raw_u8: uint8 [n_rsi * rsi_len_bytes] whole RSIs of stream bytes;
    k_init: int32 [1], the incoming warm-start k, in device memory.

    Returns (win int32 [NB, W0] u32 words, block_bits int32 [NB],
    k_final int32 [1]) on raw_u8's device."""
    if not kernel_supported(cfg):
        raise ValueError(f"config outside the kernel gate: {cfg}")
    if raw_u8.shape[0] == 0 or raw_u8.shape[0] % cfg.rsi_len_bytes:
        raise ValueError("input must hold one or more whole RSIs")
    if raw_u8.device.type == "cpu":
        return encode_fields_plain(cfg, raw_u8, k_init)
    _check(raw_u8, torch.uint8, "raw_u8")
    _check(k_init, torch.int32, "k_init")
    if k_init.numel() != 1 or k_init.device != raw_u8.device:
        raise ValueError("k_init must be one int32 on the input's device")
    lib = _build.load()
    dev = raw_u8.device
    NB = raw_u8.shape[0] // cfg.rsi_len_bytes * cfg.rsi
    W0 = window_words(cfg)
    nt = -(-NB // 64)

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    win = empty(NB, W0, dtype=torch.int32)
    block_bits = empty(NB, dtype=torch.int32)
    maps = empty(NB, 32, dtype=torch.uint8)
    zflag = empty(NB, dtype=torch.uint8)
    comp = empty(nt, 32, dtype=torch.uint8)
    tile_kin = empty(nt, dtype=torch.int32)
    k_final = empty(1, dtype=torch.int32)
    status = lib.aec_encode_fields(
        raw_u8.data_ptr(), win.data_ptr(), block_bits.data_ptr(),
        maps.data_ptr(), zflag.data_ptr(), comp.data_ptr(),
        tile_kin.data_ptr(), k_init.data_ptr(),
        k_final.data_ptr(), NB, cfg.rsi, cfg.block_size,
        cfg.bits_per_sample, cfg.bytes_per_sample, int(cfg.msb),
        int(cfg.preprocess), int(cfg.signed), cfg.id_len, cfg.kmax, W0,
        cfg.xmax, cfg.xmin, cfg.mask, _build.stream_handle(dev))
    _build.check(status, "aec_encode_fields")
    global launches
    launches += 1
    return win, block_bits, k_final
