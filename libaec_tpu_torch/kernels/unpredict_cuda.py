"""Kernel 4: mapped deltas -> the stream's output bytes.

CUDA route: csrc/unpredict.cu, the port of unpredict_swizzle_tile_kernel
(libaec_tpu/kernels/unpredict_pallas.py:83).  Plain route:
`unpredict_swizzle_plain`, ops/unpredict.unpredict_swizzle -- the twin
of the JAX package's unpredict_rsis + samples_to_bytes_device, used only
as a reference: on the CPU by the tests, on the card by chip_smoke.py.
`unpredict_swizzle` takes the plain route only for a CPU tensor; a CUDA
tensor launches the kernel or raises.
"""
import torch

from ..ops import unpredict
from . import _build

launches = 0

unpredict_swizzle_plain = unpredict.unpredict_swizzle


def kernel_supported(cfg):
    """The kernel gate: 1-, 2- or 4-byte samples (unpredict_pallas.py:
    197-202); 3-byte samples route to the native decoder."""
    return cfg.bytes_per_sample in (1, 2, 4)


def unpredict_swizzle(cfg, deltas):
    """deltas: int32 [n_rsi, S] mapped deltas (u32 bits), S the samples
    per RSI.  Returns uint8 [n_rsi, S * bytes_per_sample], each row its
    RSI's output bytes in stream order, on deltas' device."""
    if not kernel_supported(cfg):
        raise ValueError(f"config outside the kernel gate: {cfg}")
    n_rsi, S = deltas.shape
    if S != cfg.samples_per_rsi:
        raise ValueError(f"rows of {S} samples, not {cfg.samples_per_rsi}")
    if deltas.device.type == "cpu":
        return unpredict_swizzle_plain(cfg, deltas)
    if deltas.dtype != torch.int32 or not deltas.is_contiguous():
        raise ValueError("deltas must be contiguous int32")
    bsz = cfg.bytes_per_sample
    out = torch.empty(n_rsi, S * bsz, dtype=torch.uint8,
                      device=deltas.device)
    if n_rsi == 0:
        return out
    lib = _build.load()
    status = lib.aec_unpredict_swizzle(
        deltas.data_ptr(), out.data_ptr(), n_rsi, S, bsz, int(cfg.msb),
        int(cfg.preprocess), int(cfg.preprocess and cfg.xmin != 0),
        int(cfg.signed), cfg.xmax, cfg.xmax // 2 + 1,
        (1 << (cfg.bits_per_sample - 1)) & 0xFFFFFFFF,
        _build.stream_handle(deltas.device))
    _build.check(status, "aec_unpredict_swizzle")
    global launches
    launches += 1
    return out
