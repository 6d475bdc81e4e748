"""Inverse predictor and byte layout, plain torch: twin of
libaec_tpu/ops/unpredict.py.

The plain version of kernel 4 (kernels/unpredict_cuda.py).  The inverse
of the unit-delay predictor (decode.c:67-141) is serial within an RSI and
independent across RSIs, so the loop runs over sample positions with all
RSIs of the chunk as one vector; what depends only on the delta (half,
zig) is computed for the whole chunk first.  u32 values live in int64,
int32 wrap-around is reproduced with _wrap_i32.
"""
import torch

from .u32 import MASK32, from_bits


def _wrap_i32(x):
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def unpredict_rsis(cfg, deltas):
    """deltas: int64 u32 [n_rsi, S] mapped residuals, the first of each
    row the absolute reference.  Returns int64 u32 samples [n_rsi, S]
    (twin of unpredict_rsis, unpredict.py:17-64)."""
    if not cfg.preprocess:
        return deltas
    bps, xmax = cfg.bits_per_sample, cfg.xmax
    d = deltas.t().contiguous()  # one row per sample position
    half = (d >> 1) + (d & 1)
    zig = (d >> 1) ^ (~((d & 1) - 1) & MASK32)  # u32 bits of the residual
    ref = d[0]
    if cfg.signed:
        m = (1 << (bps - 1)) & MASK32
        ref = ((ref ^ m) - m) & MASK32  # sign-extend (decode.c:80-85)
    out = torch.empty_like(d)
    out[0] = ref
    if cfg.xmin != 0:  # decode.c:91,111 branch on xmin == 0
        sxmax = xmax - (1 << 32) if xmax >= (1 << 31) else xmax
        zig, d = _wrap_i32(zig), _wrap_i32(d)
        last = _wrap_i32(ref)
        for i in range(1, d.shape[0]):
            neg = last < 0
            lim = torch.where(neg, sxmax + last + 1, sxmax - last) & MASK32
            esc = torch.where(neg, d[i] - sxmax - 1, sxmax - d[i])
            last = _wrap_i32(torch.where(half[i] <= lim, last + zig[i], esc))
            out[i] = last
        out &= MASK32
    else:
        med = xmax // 2 + 1
        last = ref
        for i in range(1, d.shape[0]):
            mask = torch.where((last & med) != 0, xmax, 0)
            last = torch.where(half[i] <= (mask ^ last),
                               (last + zig[i]) & MASK32, mask ^ d[i])
            out[i] = last
    return out.t().contiguous()


def samples_to_bytes(cfg, samples):
    """int64 u32 samples [..., n] -> the stream's bytes, uint8 [..., n * bsz]
    in put_* order, MSB or LSB first (decode.c:144-189; the byte layout of
    samples_to_bytes_device, unpredict.py:67-112, for 1-, 2-, 3- and
    4-byte samples)."""
    bsz = cfg.bytes_per_sample
    shifts = [8 * ((bsz - 1 - b) if cfg.msb else b) for b in range(bsz)]
    parts = [(samples >> s) & 0xFF for s in shifts]
    out = torch.stack(parts, dim=-1).to(torch.uint8)
    return out.reshape(*samples.shape[:-1], samples.shape[-1] * bsz)


def unpredict_swizzle(cfg, deltas):
    """deltas: int32 [n_rsi, S] (u32 bits).  Returns uint8 [n_rsi, S * bsz],
    each row its RSI's output bytes; the contract of
    kernels/unpredict_cuda.unpredict_swizzle."""
    return samples_to_bytes(cfg, unpredict_rsis(cfg, from_bits(deltas)))
