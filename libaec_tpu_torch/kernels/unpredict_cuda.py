"""Kernels 4 and 5: mapped deltas -> the stream's bytes, or samples.

CUDA route: csrc/unpredict.cu.  `unpredict_swizzle` is the port of
unpredict_swizzle_tile_kernel (libaec_tpu/kernels/unpredict_pallas.py:83):
inverse predictor and byte layout in one pass.  `samples_to_bytes`
launches the same kernel with preprocessing off, as the byte layout alone
(the twin of the XLA samples_to_bytes_device, libaec_tpu/ops/
unpredict.py:67).  `unpredict_rsis` is the port of unpredict_tile_kernel
(unpredict_pallas.py:22): the inverse predictor alone.  The decode path
runs the last two for 3-byte samples, as the JAX package does, and the
first for every other width.

Plain routes (`*_plain`, ops/unpredict.py, the twins of the JAX
package's XLA versions) are used only as references: on the CPU by the
tests, on the card by chip_smoke.py.  Each wrapper takes the plain route
only for a CPU tensor; a CUDA tensor launches the kernel or raises.
Each wrapper counts its own launches.
"""
import torch

from ..ops import unpredict
from ..ops.u32 import from_bits, to_bits
from . import _build

launches = 0         # unpredict_swizzle
layout_launches = 0  # samples_to_bytes
rsis_launches = 0    # unpredict_rsis

unpredict_swizzle_plain = unpredict.unpredict_swizzle


def unpredict_rsis_plain(cfg, deltas):
    """Plain version of `unpredict_rsis`, same contract."""
    if not cfg.preprocess:
        return deltas
    return to_bits(unpredict.unpredict_rsis(cfg, from_bits(deltas)))


def samples_to_bytes_plain(cfg, samples):
    """Plain version of `samples_to_bytes`, same contract."""
    return unpredict.samples_to_bytes(cfg, from_bits(samples))


def kernel_supported(cfg):
    """The kernel gate: 1-, 2-, 3- or 4-byte samples, every width the
    format has (3-byte samples take unpredict_rsis + samples_to_bytes)."""
    return cfg.bytes_per_sample in (1, 2, 3, 4)


def _check_rows(cfg, t, name):
    if not kernel_supported(cfg):
        raise ValueError(f"config outside the kernel gate: {cfg}")
    if t.dim() != 2 or t.shape[1] != cfg.samples_per_rsi:
        raise ValueError(f"{name} must be [n_rsi, {cfg.samples_per_rsi}], "
                         f"got {tuple(t.shape)}")
    if t.device.type != "cpu" and (t.dtype != torch.int32
                                   or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous int32")


def _sign_bit(cfg):
    return (1 << (cfg.bits_per_sample - 1)) & 0xFFFFFFFF


def _swizzle(cfg, rows, pp):
    """Kernel 4 on CUDA rows, with preprocessing on or off."""
    n_rsi, S = rows.shape
    bsz = cfg.bytes_per_sample
    out = torch.empty(n_rsi, S * bsz, dtype=torch.uint8, device=rows.device)
    if n_rsi:
        status = _build.load().aec_unpredict_swizzle(
            rows.data_ptr(), out.data_ptr(), n_rsi, S, bsz, int(cfg.msb),
            int(pp), int(pp and cfg.xmin != 0), int(cfg.signed), cfg.xmax,
            cfg.xmax // 2 + 1, _sign_bit(cfg),
            _build.stream_handle(rows.device))
        _build.check(status, "aec_unpredict_swizzle")
    return out


def unpredict_swizzle(cfg, deltas):
    """deltas: int32 [n_rsi, S] mapped deltas (u32 bits), S the samples
    per RSI.  Returns uint8 [n_rsi, S * bytes_per_sample], each row its
    RSI's output bytes in stream order, on deltas' device."""
    _check_rows(cfg, deltas, "deltas")
    if deltas.device.type == "cpu":
        return unpredict_swizzle_plain(cfg, deltas)
    global launches
    out = _swizzle(cfg, deltas, cfg.preprocess)
    launches += deltas.shape[0] > 0
    return out


def samples_to_bytes(cfg, samples):
    """samples: int32 [n_rsi, S] (u32 bits).  Returns uint8
    [n_rsi, S * bytes_per_sample], each row its samples' bytes in put_*
    order, MSB or LSB first (decode.c:144-189), on samples' device."""
    _check_rows(cfg, samples, "samples")
    if samples.device.type == "cpu":
        return samples_to_bytes_plain(cfg, samples)
    global layout_launches
    out = _swizzle(cfg, samples, False)
    layout_launches += samples.shape[0] > 0
    return out


def unpredict_rsis(cfg, deltas):
    """deltas: int32 [n_rsi, S] mapped deltas (u32 bits), the first of
    each row its RSI's reference.  Returns the samples, int32 [n_rsi, S]
    (u32 bits; signed data sign-extended), on deltas' device.  With
    preprocessing off the deltas are the samples and come back as they
    are (unpredict_pallas.py:254-255)."""
    _check_rows(cfg, deltas, "deltas")
    if not cfg.preprocess:
        return deltas
    if deltas.device.type == "cpu":
        return unpredict_rsis_plain(cfg, deltas)
    global rsis_launches
    n_rsi, S = deltas.shape
    out = torch.empty_like(deltas)
    if n_rsi:
        status = _build.load().aec_unpredict_rsis(
            deltas.data_ptr(), out.data_ptr(), n_rsi, S,
            int(cfg.xmin != 0), int(cfg.signed), cfg.xmax,
            cfg.xmax // 2 + 1, _sign_bit(cfg),
            _build.stream_handle(deltas.device))
        _build.check(status, "aec_unpredict_rsis")
        rsis_launches += 1
    return out
