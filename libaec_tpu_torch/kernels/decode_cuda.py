"""Kernel 3: payload windows + block records -> mapped deltas.

CUDA route: csrc/decode.cu, the port of decode_tile_kernel
(libaec_tpu/kernels/decode_pallas.py:53).  Plain route:
`decode_blocks_plain`, ops/bitunpack.decode_blocks -- the twin of the
JAX package's XLA payload parse, used only as a reference: on the CPU by
the tests, on the card by chip_smoke.py.  `decode_blocks` takes the plain
route only for CPU tensors; CUDA tensors launch the kernel or raise.
"""
import torch

from ..ops import bitunpack
from . import _build

launches = 0
MAX_WF = 66  # the kernel's shared-memory window, bs * bps / 32 + 2 at most

decode_blocks_plain = bitunpack.decode_blocks


def kernel_supported(cfg):
    """The kernel gate: one warp holds a block's samples (as
    decode_pallas.kernel_supported, decode_pallas.py:196)."""
    return 8 <= cfg.block_size <= 64


def decode_blocks(cfg, win, fs_bit, lsb_rel, meta, ref_sample):
    """win: int32 [NB, Wf] raw scan windows (u32 bits, any bucket width
    up to bitunpack.window_words(cfg)); fs_bit, lsb_rel, meta, ref_sample:
    int32 [NB] records (libaec_tpu.decode.scan_record_arrays).

    Returns mapped deltas int32 [NB, bs] (u32 bits) on win's device."""
    if not kernel_supported(cfg):
        raise ValueError(f"config outside the kernel gate: {cfg}")
    recs = (fs_bit, lsb_rel, meta, ref_sample)
    if win.device.type == "cpu":
        return decode_blocks_plain(cfg, win, *recs)
    NB, Wf = win.shape
    if not 1 <= Wf <= MAX_WF:
        raise ValueError(f"window width {Wf} outside [1, {MAX_WF}]")
    for t, name in ((win, "win"), *zip(recs, ("fs_bit", "lsb_rel", "meta",
                                              "ref_sample"))):
        if (t.device != win.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 on "
                             f"{win.device}")
        if t.shape[0] != NB:
            raise ValueError(f"{name} has {t.shape[0]} rows, not {NB}")
    out = torch.empty(NB, cfg.block_size, dtype=torch.int32,
                      device=win.device)
    if NB == 0:
        return out
    lib = _build.load()
    status = lib.aec_decode_blocks(
        win.data_ptr(), fs_bit.data_ptr(), lsb_rel.data_ptr(),
        meta.data_ptr(), ref_sample.data_ptr(), out.data_ptr(), NB, Wf,
        cfg.block_size, cfg.bits_per_sample, _build.stream_handle(win.device))
    _build.check(status, "aec_decode_blocks")
    global launches
    launches += 1
    return out
