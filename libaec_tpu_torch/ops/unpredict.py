"""Inverse predictor and byte layout, plain torch: twin of
libaec_tpu/ops/unpredict.py.

The plain version of kernels 4 and 5 (kernels/unpredict_cuda.py).  The
inverse of the unit-delay predictor (decode.c:67-141) is serial within an
RSI and independent across RSIs, so the loop of `unpredict_rsis` runs over
sample positions with all RSIs of the chunk as one vector; what depends
only on the delta (half, zig) is computed for the whole chunk first.  u32
values live in int64, int32 wrap-around is reproduced with _wrap_i32.

`unpredict_rsis_scan` computes the same samples the way the CUDA kernels
do (csrc/unpredict_step.cuh, scan_guess and scan_verify): a prefix sum per group of
samples as a guess, checked with the step itself, repaired at its first
mismatch, a serial walk after a bounded number of repairs.  It exists so
that this algorithm is held against the serial loop and the JAX package
where the kernel cannot run; nothing but tests and chip_smoke.py calls it.
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


SCAN_LANES = 32    # a warp
SCAN_V = 8         # SCAN_V of csrc/unpredict_step.cuh
SCAN_REPAIRS = 8   # SCAN_REPAIRS there


def half(d):
    """What a mapped delta d needs of the range: |residual|, rounded up."""
    return (d >> 1) + (d & 1)


def zig(d):
    """The residual a mapped delta d stands for, as u32 bits."""
    return (d >> 1) ^ (~((d & 1) - 1) & MASK32)


def step_fn(cfg):
    """The predictor's step on u32 values in int64: (last, d) -> sample
    (step_unsigned / step_signed of csrc/unpredict_step.cuh)."""
    xmax = cfg.xmax

    def unsigned(last, d):
        mask = torch.where((last & (xmax // 2 + 1)) != 0, xmax, 0)
        return torch.where(half(d) <= (mask ^ last),
                           (last + zig(d)) & MASK32, mask ^ d)

    def signed(last, d):
        neg = last >= (1 << 31)
        lim = torch.where(neg, xmax + last + 1, xmax - last) & MASK32
        esc = torch.where(neg, d - xmax - 1, xmax - d) & MASK32
        return torch.where(half(d) <= lim, (last + zig(d)) & MASK32, esc)

    return signed if cfg.xmin != 0 else unsigned


def unpredict_rsis_scan(cfg, deltas, lanes=SCAN_LANES, per_lane=SCAN_V,
                        repairs=SCAN_REPAIRS, counts=None, slab=None):
    """`unpredict_rsis` by the kernels' algorithm: same contract, same
    samples.  Per group of lanes * per_lane consecutive samples of every
    RSI (deltas past the RSI's end count as 0): the guess is the carry
    (the last true sample before the group) plus the prefix sum of the
    residuals; the step on each guessed predecessor is compared with the
    guess; every guess before the first mismatch is true, the step's
    value at the mismatch is true, and the later guesses are all off by
    the same difference, which the repair adds.  An RSI's group takes at
    most `repairs` repairs, and none more once more lanes mismatch than
    it has repairs left; then every lane walks its per_lane samples from
    the last sample of the lane before, round after round, until no
    lane's last sample changes (`lanes` rounds at most).  `counts`, a
    dict, gets the repairs made, the groups walked and the rounds they
    took, summed over all RSIs.

    `slab` is kernel 6's geometry (csrc/decode_fused.cu): the row is cut
    into slabs of `slab` samples and the groups start anew in every slab,
    so that a slab's last group may be short as well as the RSI's.  The
    carry into the next group is the last real sample, whatever the zeros
    after it gave."""
    counts = {} if counts is None else counts
    counts.update(repairs=0, walked=0, rounds=0)
    if not cfg.preprocess:
        return deltas
    step = step_fn(cfg)
    n, S = deltas.shape
    group = lanes * per_lane
    ref = deltas[:, 0]
    if cfg.signed:
        m = (1 << (cfg.bits_per_sample - 1)) & MASK32
        ref = ((ref ^ m) - m) & MASK32
    out = torch.empty_like(deltas)
    carry = torch.zeros_like(ref)
    pos = torch.arange(group, device=deltas.device)[None, :]
    slab = S if slab is None else slab
    starts = [(s0, min(group, s1 + slab - s0, S - s0))
              for s1 in range(0, S, slab)
              for s0 in range(s1, min(s1 + slab, S), group)]
    for s0, g in starts:
        d = deltas[:, s0:s0 + g]
        d = torch.nn.functional.pad(d, (0, group - g))
        z = zig(d)
        fixed = torch.zeros_like(d, dtype=torch.bool)
        if s0 == 0:  # the reference is no step: it stands as it is
            z[:, 0] = ref
            fixed[:, 0] = True
        x = (torch.cumsum(z, 1) + carry[:, None]) & MASK32
        walk = torch.zeros(n, dtype=torch.bool, device=d.device)
        for rep in range(repairs + 1):
            pred = torch.cat([carry[:, None], x[:, :-1]], 1)
            want = step(pred, d)
            wrong = (want != x) & ~fixed & ~walk[:, None]
            bad_lanes = wrong.view(n, lanes, per_lane).any(2).sum(1)
            walk |= bad_lanes > repairs - rep
            mend = (bad_lanes > 0) & ~walk
            if not mend.any():
                break
            counts["repairs"] += int(mend.sum())
            first = wrong.to(torch.int8).argmax(1, keepdim=True)
            diff = want.gather(1, first) - x.gather(1, first)
            x = torch.where(mend[:, None] & (pos >= first),
                            (x + diff) & MASK32, x)
        rows = walk.nonzero().squeeze(1)
        if rows.numel():
            xs = x[rows].view(-1, lanes, per_lane)
            ds = d[rows].view(-1, lanes, per_lane)
            keep = fixed[rows].view(-1, lanes, per_lane)
            counts["walked"] += rows.numel()
            for _ in range(lanes):
                counts["rounds"] += 1
                pred = torch.cat([carry[rows, None], xs[:, :-1, -1]], 1)
                cur, new = pred, torch.empty_like(xs)
                for k in range(per_lane):
                    cur = torch.where(keep[:, :, k], xs[:, :, k],
                                      step(cur, ds[:, :, k]))
                    new[:, :, k] = cur
                xs = new
                again = torch.cat([carry[rows, None], xs[:, :-1, -1]], 1)
                if torch.equal(again, pred):
                    break
            else:
                raise AssertionError("the walk did not settle")
            x[rows] = xs.view(-1, group)
        out[:, s0:s0 + g] = x[:, :g]
        carry = x[:, g - 1]
    return out


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
