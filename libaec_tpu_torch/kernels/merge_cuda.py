"""Kernel 2: per-block windows -> packed big-endian word stream.

CUDA route: csrc/merge.cu, the port of _merge_tile_kernel
(libaec_tpu/kernels/merge_pallas.py:77) together with the XLA group scan
merge_groups_scan (libaec_tpu/ops/bitpack.py:211).  Plain route:
ops/bitpack.merge_windows.  `merge_windows` takes the plain route only
for CPU tensors; CUDA tensors launch the kernel or raise.
"""
import torch

from ..ops import bitpack
from . import _build
from .encode_cuda import worst_case_bits_per_block

launches = 0


def word_count(cfg, NB, local_words):
    """Word-buffer size of one chunk, as the JAX package sizes its Pallas
    route (encode.py:176-178 with merge_pallas.group_window_words at
    group 512)."""
    group_words = -(-(512 * (local_words - 1) + 3) // 128) * 128
    return (NB * worst_case_bits_per_block(cfg) + 8) // 32 + group_words + 3


def merge_windows(win, block_bits, bit0, nwords):
    """win: int32 [NB, W] block windows (word 0 the front pad);
    block_bits: int32 [NB]; bit0: int64 [1] in [0, 8).

    Returns (words int32 [nwords] in stream byte order, tail int64 [2] =
    (total_bits incl. bit0, total_bits & 7)), all on win's device."""
    if win.device.type == "cpu":
        return bitpack.merge_windows(win, block_bits, bit0, nwords)
    for t, dt, name in ((win, torch.int32, "win"),
                        (block_bits, torch.int32, "block_bits"),
                        (bit0, torch.int64, "bit0")):
        if t.device != win.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {win.device}")
    NB, W = win.shape
    if block_bits.shape != (NB,) or bit0.numel() != 1 or NB == 0:
        raise ValueError("shape mismatch")
    lib = _build.load()
    bb = block_bits.to(torch.int64)
    off = torch.cumsum(bb, 0) - bb + bit0
    words = torch.zeros(nwords, dtype=torch.int32, device=win.device)
    tail = torch.empty(2, dtype=torch.int64, device=win.device)
    status = lib.aec_merge_windows(
        win.data_ptr(), off.data_ptr(), block_bits.data_ptr(),
        words.data_ptr(), tail.data_ptr(), NB, W, nwords,
        _build.stream_handle(win.device))
    _build.check(status, "aec_merge_windows")
    global launches
    launches += 1
    return words, tail
