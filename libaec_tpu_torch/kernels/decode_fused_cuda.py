"""Kernel 6: payload windows + block records -> the stream's bytes.

CUDA route: csrc/decode_fused.cu, the port of fused_tile_kernel
(libaec_tpu/kernels/decode_fused_pallas.py:48): kernels 3 and 4 in one,
with no [NB, bs] delta array in device memory.  A thread block owns a few
RSIs and walks them in slabs of whole blocks; its parse warps decode a
slab's blocks into shared memory (kernel 3's parse) while its chain warps
scan the slab before, a warp on a row: kernel 4's verified scan (guess by
prefix sum, check with the step, repair or walk), the carry handed from
slab to slab.  Plain route: `decode_unpredict_swizzle_plain`,
ops/bitunpack.decode_blocks followed by ops/unpredict.unpredict_swizzle,
used only as a reference: on the CPU by the tests, on the card by
chip_smoke.py.  `decode_unpredict_swizzle_scan_plain` is the same function
by the kernel's algorithm and slab geometry (`slab_geometry`), for the
same callers.  `decode_unpredict_swizzle` takes the plain route only for
CPU tensors; CUDA tensors launch the kernel or raise.
"""
import torch

from ..ops import bitunpack, unpredict
from ..ops.u32 import from_bits
from . import _build
from .decode_cuda import MAX_WF

launches = 0

# constants of csrc/decode_fused.cu and csrc/unpredict_step.cuh
SLAB_GROUPS = 8     # scan groups in a slab row, at most
MAX_GROUP = 32      # RSIs per thread block, at most
BLOCKS_PER_SM = 2   # thread blocks an SM holds at once
SCAN_G = unpredict.SCAN_LANES * unpredict.SCAN_V
H100_SMS = 132


def fused_supported(cfg):
    """The kernel gate: blocks of 8 to 64 samples, 1-, 2- or 4-byte
    samples -- decode_fused_pallas.fused_supported without its tile
    geometry (any n_rsi, any rsi).  3-byte samples stay on kernels
    3 + 5 + 4."""
    return 8 <= cfg.block_size <= 64 and cfg.bytes_per_sample in (1, 2, 4)


def decode_unpredict_swizzle_plain(cfg, win, fs_bit, lsb_rel, meta,
                                   ref_sample, n_rsi):
    """Plain version of the kernel; same contract as
    `decode_unpredict_swizzle`."""
    deltas = bitunpack.decode_blocks(cfg, win, fs_bit, lsb_rel, meta,
                                     ref_sample)
    return unpredict.unpredict_swizzle(
        cfg, deltas.view(n_rsi, cfg.samples_per_rsi))


def slab_geometry(cfg, n_rsi, sms=H100_SMS):
    """(RSIs a thread block owns, blocks of one RSI in a slab) as
    aec_decode_fused chooses them for n_rsi RSIs on a card of `sms` SMs:
    the smallest group whose thread blocks are all on the card at once;
    a slab row of as many scan groups as the largest group's shared
    memory allows and the RSI has, in whole blocks whose samples are a
    multiple of 4."""
    group = 1
    while group < MAX_GROUP and -(-n_rsi // group) > BLOCKS_PER_SM * sms:
        group *= 2
    groups = min(SLAB_GROUPS, MAX_GROUP // group,
                 -(-cfg.samples_per_rsi // SCAN_G))
    per_slab = groups * SCAN_G // cfg.block_size
    if cfg.block_size % 4:
        per_slab &= ~1
    return group, per_slab


def decode_unpredict_swizzle_scan_plain(cfg, win, fs_bit, lsb_rel, meta,
                                        ref_sample, n_rsi, sms=H100_SMS):
    """`decode_unpredict_swizzle_plain` by the kernel's algorithm: the
    verified scan over the slabs the kernel would cut for n_rsi RSIs."""
    deltas = bitunpack.decode_blocks(cfg, win, fs_bit, lsb_rel, meta,
                                     ref_sample)
    _, per_slab = slab_geometry(cfg, n_rsi, sms)
    samples = unpredict.unpredict_rsis_scan(
        cfg, from_bits(deltas.view(n_rsi, cfg.samples_per_rsi)),
        slab=per_slab * cfg.block_size)
    return unpredict.samples_to_bytes(cfg, samples)


def decode_unpredict_swizzle(cfg, win, fs_bit, lsb_rel, meta, ref_sample,
                             n_rsi):
    """win: int32 [NB, Wf] raw scan windows (u32 bits, any bucket width up
    to bitunpack.window_words(cfg)); fs_bit, lsb_rel, meta, ref_sample:
    int32 [NB] records (decode.scan_record_arrays), NB = n_rsi * cfg.rsi
    blocks of n_rsi whole RSIs.

    Returns uint8 [n_rsi, S * bytes_per_sample], each row its RSI's output
    bytes in stream order, on win's device."""
    if not fused_supported(cfg):
        raise ValueError(f"config outside the kernel gate: {cfg}")
    recs = (fs_bit, lsb_rel, meta, ref_sample)
    NB = n_rsi * cfg.rsi
    if win.dim() != 2 or win.shape[0] != NB:
        raise ValueError(f"win must be [{NB}, Wf], got {tuple(win.shape)}")
    for t, name in zip(recs, ("fs_bit", "lsb_rel", "meta", "ref_sample")):
        if t.shape != (NB,):
            raise ValueError(f"{name} must be [{NB}], got {tuple(t.shape)}")
    if win.device.type == "cpu":
        return decode_unpredict_swizzle_plain(cfg, win, *recs, n_rsi)
    Wf = win.shape[1]
    if not 1 <= Wf <= MAX_WF:
        raise ValueError(f"window width {Wf} outside [1, {MAX_WF}]")
    for t, name in ((win, "win"), *zip(recs, ("fs_bit", "lsb_rel", "meta",
                                              "ref_sample"))):
        if (t.device != win.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 on "
                             f"{win.device}")
    out = torch.empty(n_rsi, cfg.rsi_len_bytes, dtype=torch.uint8,
                      device=win.device)
    if n_rsi == 0:
        return out
    pp = cfg.preprocess
    status = _build.load().aec_decode_fused(
        win.data_ptr(), fs_bit.data_ptr(), lsb_rel.data_ptr(),
        meta.data_ptr(), ref_sample.data_ptr(), out.data_ptr(), n_rsi,
        cfg.rsi, Wf, cfg.block_size, cfg.bits_per_sample,
        cfg.bytes_per_sample, int(cfg.msb), int(pp),
        int(pp and cfg.xmin != 0), int(cfg.signed), cfg.xmax,
        cfg.xmax // 2 + 1, (1 << (cfg.bits_per_sample - 1)) & 0xFFFFFFFF,
        _build.stream_handle(win.device))
    _build.check(status, "aec_decode_fused")
    global launches
    launches += 1
    return out
