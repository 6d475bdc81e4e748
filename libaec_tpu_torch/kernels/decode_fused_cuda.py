"""Kernel 6: payload windows + block records -> the stream's bytes.

CUDA route: csrc/decode_fused.cu, the port of fused_tile_kernel
(libaec_tpu/kernels/decode_fused_pallas.py:48): kernels 3 and 4 in one,
with no [NB, bs] delta array in device memory.  Plain route:
`decode_unpredict_swizzle_plain`, ops/bitunpack.decode_blocks followed by
ops/unpredict.unpredict_swizzle, used only as a reference: on the CPU by
the tests, on the card by chip_smoke.py.  `decode_unpredict_swizzle` takes
the plain route only for CPU tensors; CUDA tensors launch the kernel or
raise.
"""
import torch

from ..ops import bitunpack, unpredict
from . import _build
from .decode_cuda import MAX_WF

launches = 0


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
