#!/usr/bin/env python3
"""Smoke run of libaec_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the port's native host library (g++) and the CUDA kernels of
libaec_tpu_torch/csrc (nvcc), holds each of the six kernels bit-exactly
against its plain PyTorch version on the card at the chunk shape the main
path launches (kernels 4, 5 and 6 also on smooth, rough and random samples;
kernel 1 also at the shapes of its k chain, its launches timed apart;
kernel 2 on the words the stream occupies and its tail, on the windows of
samples of every kind, of `lowentropy` and of `midentropy` samples; kernels
2 and 3 also by the profiler's device time of a launch), then
drives the port's main paths: at two configs, 16-bit samples (the bench
config) and 24-bit samples stored in 3 bytes,
libaec_tpu_torch.encode_buffer over two 256 MiB buffers, held against the
native encoder and a native decode round trip, and
libaec_tpu_torch.decode_buffer_status over the two streams it made, held
against the input and the native decoder; the 16-bit streams once more on
the one-kernel route (fused=True); and libaec_tpu_torch.decode_buffers
over 256 streams of 1 MiB on both routes.  Then the surfaces users call,
each phase holding its launch counts to the kernels of its route: the SZ
layer (libaec_tpu_torch.szip) on an HDF5-shaped dataset of 128 chunks of
1 MiB, compressed chunk by chunk and as one 64 MiB buffer on the card,
decompressed by sz_decompress_batch, held against the C szlib surface of
the native library, the input and the per-chunk decompress, with padded
scanlines and 32-bit pixels besides; the streaming calls
(libaec_tpu_torch.stream) on 32 MiB fed in uneven pieces and drained
through 64 KiB, held against native.encode, and drip-fed back; the `aec`
tool (`python -m libaec_tpu_torch.cli`) encoding and decoding a 64 MiB
file and a 48 MiB file of 3-byte samples.  Imports neither JAX nor the
JAX package: the bit-exact reference is libaec_tpu_torch.native.  Exits
non-zero, and prints no result line, on any failure or when no CUDA device
is present.

The last two lines of standard output are JSON: the kernels' summary,
then {"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SLICE_MIB = 256        # each main-path buffer: a full climate-model field
BENCH_CHUNK_RSIS = 512  # bench.py:59, the JAX package's kernel bench chunk


def timed(fn, reps, warmup=3):
    """fn()'s result and its median CUDA-event milliseconds over reps
    runs, after `warmup` untimed runs."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return out, statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_abs_err(a, b):
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's data sheet for the SXM part
H100_OPS_PER_S = 67e12      # float32 rate outside the tensor cores: the
#                             sheet's nearest rate for 32-bit integer work


def bound_ms(nbytes, ops):
    """The least milliseconds an H100 could take: `nbytes` moved once
    (inputs read, outputs written) at the memory's rate, or `ops`
    arithmetic operations at the peak rate, whichever is longer; and
    which of the two it is."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def pack_samples(vals, bps, flags):
    """uint32 sample values in the byte layout the flags select (the
    port's own tests/gen.pack_samples, which reads the JAX package's
    constants)."""
    from libaec_tpu_torch import AEC_DATA_3BYTE, AEC_DATA_MSB

    msb = bool(flags & AEC_DATA_MSB)
    vals = np.asarray(vals, dtype=np.uint32)
    if 16 < bps <= 24 and flags & AEC_DATA_3BYTE:
        shifts = (16, 8, 0) if msb else (0, 8, 16)
        return np.stack([(vals >> s) & 0xFF for s in shifts],
                        axis=1).astype(np.uint8).tobytes()
    width = 4 if bps > 16 else 2 if bps > 8 else 1
    return vals.astype(f"{'>' if msb else '<'}u{width}").tobytes()


def chunk_data(cfg, n_rsi, seed, dirty=False):
    """n_rsi RSIs of stream bytes: one segment per tests/gen.py kind."""
    import gen

    rng = np.random.default_rng(seed)
    S = cfg.samples_per_rsi
    bps, signed = cfg.bits_per_sample, cfg.signed
    per = -(-n_rsi // len(gen.KINDS))
    vals = np.concatenate([gen.gen_values(rng, per * S, bps, signed, kind)
                           for kind in gen.KINDS])[: n_rsi * S]
    if dirty and bps < 8 * cfg.bytes_per_sample:
        # storage bits above bits_per_sample must be masked at ingest
        junk = rng.integers(0, 1 << 32, vals.size, dtype=np.uint64)
        hi = np.uint64(((1 << (8 * cfg.bytes_per_sample)) - 1)
                       ^ ((1 << bps) - 1))
        vals = vals | (junk & hi).astype(np.uint32)
    return pack_samples(vals, bps, cfg.flags)


def check_encode_kernel(name, cfg, n_rsi, device, dirty=False, k_init=3,
                        passes=False):
    """Kernel 1 against its plain version on n_rsi RSIs of every
    tests/gen.py kind; with `passes`, also the device time of each of its
    launches."""
    from libaec_tpu_torch.kernels import encode_cuda

    raw = torch.from_numpy(np.frombuffer(
        chunk_data(cfg, n_rsi, seed=n_rsi + cfg.bits_per_sample, dirty=dirty),
        np.uint8).copy()).to(device)
    k0 = torch.tensor([min(k_init, cfg.kmax)], dtype=torch.int32,
                      device=device)
    got, ms = timed(lambda: encode_cuda.encode_fields(cfg, raw, k0), 20)
    if passes:
        pass_times(f"encode_fields {name}",
                   lambda: encode_cuda.encode_fields(cfg, raw, k0))
    want, plain_ms = timed(
        lambda: encode_cuda.encode_fields_plain(cfg, raw, k0), 3, warmup=1)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    print(f"kernel encode_fields [{name}] n_rsi={n_rsi} "
          f"NB={got[0].shape[0]} tiles={-(-got[0].shape[0] // 64)} "
          f"W0={got[0].shape[1]} k_init={int(k0)} k_final={int(got[2])} "
          f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    if err:
        raise AssertionError(f"encode kernel differs from plain ({name})")
    return got, err, ms, plain_ms


def check_merge_kernel(name, cfg, win, block_bits, device):
    """Kernel 2 against its plain version at bit0 0..7: the tail and the
    used prefix of the word buffer (the kernel writes no word past it).
    Returns (max_abs_err, the median over bit0 of each bit0's median ms,
    the same of the plain version, the profiler's mean device ms of a
    call (both its launches) at bit0 5, the bound of the work the contract asks (the window
    words that hold bits and block_bits read, the used prefix written),
    the bound of the whole window array read and whole buffer written)."""
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda
    from libaec_tpu_torch.ops import bitpack

    NB, W = win.shape
    nwords = merge_cuda.word_count(cfg, NB, encode_cuda.window_words(cfg) - 1)
    worst, times, plain_times = 0, [], []
    for bit0 in range(8):
        b0 = torch.tensor([bit0], dtype=torch.int64, device=device)
        got, ms = timed(lambda: merge_cuda.merge_windows(
            win, block_bits, b0, nwords), 20)
        want, plain_ms = timed(lambda: bitpack.merge_windows(
            win, block_bits, b0, nwords), 3, warmup=1)
        used = merge_cuda.used_words(int(want[1][0]))
        err = max(max_abs_err(got[0][:used], want[0][:used]),
                  max_abs_err(got[1], want[1]))
        print(f"kernel merge_windows [{name}] NB={NB} bit0={bit0} "
              f"total_bits={int(got[1][0])} used_words={used} "
              f"buffer_words={nwords} max_abs_err={err} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if err:
            raise AssertionError(f"merge kernel differs from plain at {bit0}"
                                 f" ({name})")
        worst = max(worst, err)
        times.append(ms)
        plain_times.append(plain_ms)
    b0 = torch.tensor([5], dtype=torch.int64, device=device)
    device_ms = sum(pass_times(f"merge_windows {name} bit0=5", lambda: (
        merge_cuda.merge_windows(win, block_bits, b0, nwords))).values())
    # bytes: window words that hold bits, block_bits, bit0 read; the used
    # prefix and the tail written; a shift and an OR a window word read
    held = int(((block_bits.to(torch.int64) + 31) // 32).sum())
    bound = bound_ms(4 * (held + NB + used) + 8 + 16, 4 * held)
    whole = bound_ms(4 * NB * (W + 1) + 8 + 4 * nwords + 16, 4 * NB * W)
    ms, plain = statistics.median(times), statistics.median(plain_times)
    print(f"kernel merge_windows [{name}] NB={NB} median over bit0 "
          f"ms={ms:.4f} device_ms={device_ms:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bound[0]:.4f} ({bound[1]}; used prefix) "
          f"whole_buffer_bound_ms={whole[0]:.4f}")
    return worst, ms, plain, device_ms, bound, whole


def kind_windows(cfg, n_rsi, kind, seed, device):
    """Kernel 1's windows and bit lengths of n_rsi RSIs of one tests/gen.py
    kind of samples."""
    import gen

    from libaec_tpu_torch.kernels import encode_cuda

    rng = np.random.default_rng(seed)
    raw = torch.from_numpy(np.frombuffer(pack_samples(
        gen.gen_values(rng, n_rsi * cfg.samples_per_rsi, cfg.bits_per_sample,
                       cfg.signed, kind), cfg.bits_per_sample, cfg.flags),
        np.uint8).copy()).to(device)
    win, block_bits, _ = encode_cuda.encode_fields(
        cfg, raw, torch.tensor([3], dtype=torch.int32, device=device))
    return win, block_bits


def walk_data(cfg, n_rsi, seed, step):
    """n_rsi RSIs of 16-bit samples, each RSI a random walk from
    mid-range with steps uniform in [-step, step] (step 0: one sample in
    16 moves by one).  At the bench config steps 0, 2 and 8 make the
    decode path bucket the windows to 6, 10 and 18 words."""
    rng = np.random.default_rng(seed)
    shape = (n_rsi, cfg.samples_per_rsi)
    if step:
        steps = rng.integers(-step, step + 1, shape)
    else:
        steps = (rng.random(shape) < 1 / 16) * rng.choice([-1, 1], shape)
    vals = (32768 + np.cumsum(steps, axis=1)).clip(0, 65535)
    return pack_samples(vals.astype(np.uint32).ravel(), 16, cfg.flags)


def scanned_chunk(cfg, raw):
    """Whole RSIs of raw bytes, encoded by the native encoder and walked
    by the decode path's records-only scan: (stream, records, the decode
    path's bucket width)."""
    from libaec_tpu_torch import native
    from libaec_tpu_torch.ops import bitunpack

    n_rsi = len(raw) // cfg.rsi_len_bytes
    status, comp = native.encode(raw, cfg)
    if status != 0:
        raise AssertionError(f"native encoder failed with status {status}")
    recs, cnt, tail_bit = native.scan_blocks(
        comp, n_rsi, bitunpack.max_fs_bits(cfg), cfg, wf=0)
    if cnt != n_rsi:
        raise AssertionError(f"scan stopped after {cnt} of {n_rsi} RSIs")
    return comp, dict(recs), bitunpack.bucket_wf(cfg, recs, tail_bit)


def popcount32(v):
    """Set bits of each 32-bit value of an int64 tensor."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def parse_words(cfg, win, fs_bit, lsb_rel, meta, ref_sample):
    """Window words the payload parse of a chunk needs, summed over its
    blocks: none for a zero block; up to the fields' end for a split or
    an uncompressed block (the FS region ends where the fields start); up
    to the word that holds the (bs/2)-th set bit for a second-extension
    block, whose record carries no region end."""
    bs, m = cfg.block_size, meta.to(torch.int64)
    kind, k, ref = m & 3, (m >> 2) & 31, (m >> 7) & 1
    fsb = fs_bit.to(torch.int64)
    keff = torch.where(kind == 3, cfg.bits_per_sample,
                       torch.where(kind == 2, k, 0))
    need = (fsb + lsb_rel.to(torch.int64) + (bs - ref) * keff + 31) // 32
    w = win.to(torch.int64) & 0xFFFFFFFF   # stream bytes: big-endian words
    be = ((w & 0xFF) << 24) | (((w >> 8) & 0xFF) << 16) \
        | (((w >> 16) & 0xFF) << 8) | (w >> 24)
    be[:, 0] &= torch.full_like(fsb, 0xFFFFFFFF) >> fsb
    seen = torch.cumsum(popcount32(be), 1)
    need = torch.where(kind == 1, (seen < bs // 2).sum(1) + 1, need)
    return int(torch.where(kind == 0, 0, need).sum())


def check_decode_kernel(name, cfg, raw, device, profile=False):
    """Kernel 3 against its plain version on one chunk of whole RSIs, at
    the chunk's own bucket width and at every wider width the decode path
    can choose (WF_BUCKETS and the worst case); with `profile`, also the
    profiler's mean device time of a launch.  Returns [(wf, max_abs_err,
    ms, plain_ms, bound_ms, device ms or None, whole-window bound_ms)],
    the deltas at the chunk's own width, the stream and the kernel's
    device inputs by width.  bound_ms counts the window words the parse
    needs (parse_words); the whole-window bound counts every word."""
    from libaec_tpu_torch import native
    from libaec_tpu_torch.decode import WF_BUCKETS, scan_record_arrays
    from libaec_tpu_torch.kernels import decode_cuda
    from libaec_tpu_torch.ops import bitunpack
    from libaec_tpu_torch.ops.u32 import u32_to_bits

    comp, recs, bucket = scanned_chunk(cfg, raw)
    n_rsi = len(raw) // cfg.rsi_len_bytes
    wf_max = bitunpack.window_words(cfg)
    rows, deltas, args_by_wf = [], None, {}
    for wf in sorted({w for w in (*WF_BUCKETS, wf_max)
                      if bucket <= w <= wf_max}):
        recs["win"] = native.fill_windows(comp, recs["fs_off"],
                                          recs["meta"], wf)
        args = [u32_to_bits(a).to(device) for a in scan_record_arrays(recs)]
        args_by_wf[wf] = args
        got, ms = timed(lambda: decode_cuda.decode_blocks(cfg, *args), 20)
        want, plain_ms = timed(
            lambda: decode_cuda.decode_blocks_plain(cfg, *args), 3, warmup=1)
        err = max_abs_err(got, want)
        # records read, the window words the parse needs read, bs deltas
        # written; ~20 integer operations a sample of a block with a
        # payload (FS position, field, unmapping)
        NB, bs = got.shape
        live = int(((args[3] & 3) != 0).sum()) * bs
        bound = bound_ms(4 * (parse_words(cfg, *args) + 4 * NB + NB * bs),
                         20 * live)
        whole = bound_ms(4 * NB * (wf + 4 + bs), 20 * live)
        device_ms = sum(pass_times(
            f"decode_blocks {name} Wf={wf}",
            lambda: decode_cuda.decode_blocks(cfg, *args)).values()) \
            if profile else None
        print(f"kernel decode_blocks [{name}] n_rsi={n_rsi} NB={got.shape[0]}"
              f" Wf={wf} bucket={bucket} max_abs_err={err} ms={ms:.4f} "
              + (f"device_ms={device_ms:.4f} " if profile else "")
              + f"plain_ms={plain_ms:.4f} bound_ms={bound[0]:.4f} "
              f"({bound[1]}; words parsed) "
              f"whole_window_bound_ms={whole[0]:.4f}")
        if err:
            raise AssertionError(f"decode kernel differs from plain ({name}, "
                                 f"Wf {wf})")
        rows.append((wf, err, ms, plain_ms, bound, device_ms, whole))
        if deltas is None:
            deltas = got
    return rows, deltas, comp, args_by_wf


def check_fused_kernel(name, cfg, raw, comp, args_by_wf, device):
    """Kernel 6 against its plain version (kernel 3's, then kernel 4's: a
    loop over the RSI's samples, one timed run at the chunk's own bucket
    width; the bytes do not depend on the width, so every wider width is
    held against the same bytes) and against native.decode of the chunk's
    stream, beside kernels 3 + 4 on the same inputs.  Returns [(wf,
    max_abs_err, ms, plain_ms, two-kernel ms, window words the parse
    needs, blocks with a payload)]."""
    from libaec_tpu_torch import native
    from libaec_tpu_torch.kernels import (decode_cuda, decode_fused_cuda,
                                          unpredict_cuda)

    n_rsi = len(raw) // cfg.rsi_len_bytes
    S = cfg.samples_per_rsi
    status, ref = native.decode(comp, len(raw), cfg)
    rows, want, plain_ms = [], None, None
    for wf, args in sorted(args_by_wf.items()):
        if want is None:
            want, plain_ms = timed(
                lambda: decode_fused_cuda.decode_unpredict_swizzle_plain(
                    cfg, *args, n_rsi), 1, warmup=0)
        got, ms = timed(lambda: decode_fused_cuda.decode_unpredict_swizzle(
            cfg, *args, n_rsi), 20)
        two, two_ms = timed(lambda: unpredict_cuda.unpredict_swizzle(
            cfg, decode_cuda.decode_blocks(cfg, *args).view(n_rsi, S)), 20)
        err = max_abs_err(got, want)
        native_ok = status == 0 and got.cpu().numpy().tobytes() == ref
        print(f"kernel decode_fused [{name}] n_rsi={n_rsi} "
              f"NB={args[0].shape[0]} Wf={wf} max_abs_err={err} "
              f"identical_to_native={native_ok} "
              f"identical_to_kernels_3_4={torch.equal(got, two)} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"kernels_3_4_ms={two_ms:.4f}")
        if err or not native_ok or not torch.equal(got, two):
            raise AssertionError(f"fused kernel differs ({name}, Wf {wf})")
        rows.append((wf, err, ms, plain_ms, two_ms, parse_words(cfg, *args),
                     int(((args[3] & 3) != 0).sum())))
    return rows


def check_fused_inputs(name, cfg, n_rsi, device, seed):
    """Kernel 6 at the decode path's chunk on `midentropy` and `random`
    samples (tests/gen.py): rows whose scan takes repairs, and rows that
    end in the serial walk.  Each at the chunk's own window width,
    against the serial plain version (one timed run), the plain version
    that follows the kernel's scan over its slabs, the samples themselves
    and kernels 3 + 4.  Returns the max_abs_err."""
    import gen

    from libaec_tpu_torch import native
    from libaec_tpu_torch.decode import scan_record_arrays
    from libaec_tpu_torch.kernels import (decode_cuda, decode_fused_cuda,
                                          unpredict_cuda)
    from libaec_tpu_torch.ops.u32 import u32_to_bits

    rng = np.random.default_rng(seed)
    S = cfg.samples_per_rsi
    worst = 0
    for kind in ("midentropy", "random"):
        raw = pack_samples(gen.gen_values(
            rng, n_rsi * S, cfg.bits_per_sample, cfg.signed, kind),
            cfg.bits_per_sample, cfg.flags)
        comp, recs, wf = scanned_chunk(cfg, raw)
        recs["win"] = native.fill_windows(comp, recs["fs_off"], recs["meta"],
                                          wf)
        args = [u32_to_bits(a).to(device) for a in scan_record_arrays(recs)]
        got, ms = timed(lambda: decode_fused_cuda.decode_unpredict_swizzle(
            cfg, *args, n_rsi), 20)
        want, plain_ms = timed(
            lambda: decode_fused_cuda.decode_unpredict_swizzle_plain(
                cfg, *args, n_rsi), 1, warmup=0)
        scan, scan_ms = timed(
            lambda: decode_fused_cuda.decode_unpredict_swizzle_scan_plain(
                cfg, *args, n_rsi), 1, warmup=0)
        two, two_ms = timed(lambda: unpredict_cuda.unpredict_swizzle(
            cfg, decode_cuda.decode_blocks(cfg, *args).view(n_rsi, S)), 20)
        err = max_abs_err(got, want)
        input_ok = got.cpu().numpy().tobytes() == raw
        scan_ok = torch.equal(scan, want)
        print(f"kernel decode_fused inputs [{name} {kind}] n_rsi={n_rsi} "
              f"Wf={wf} max_abs_err={err} identical_to_input={input_ok} "
              f"identical_to_kernels_3_4={torch.equal(got, two)} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"kernels_3_4_ms={two_ms:.4f} | scan plain "
              f"identical={scan_ok} ms={scan_ms:.4f}")
        if err or not input_ok or not scan_ok or not torch.equal(got, two):
            raise AssertionError(f"fused kernel differs ({name} {kind})")
        worst = max(worst, err)
    return worst


def check_unpredict_kernel(name, cfg, raw, deltas, comp, device):
    """Kernel 4 against its plain version on one chunk's deltas (the
    plain version is a loop over the RSI's samples: one timed run); the
    kernel's bytes must also be native.decode's for the chunk."""
    from libaec_tpu_torch import native
    from libaec_tpu_torch.kernels import unpredict_cuda

    d = deltas.view(-1, cfg.samples_per_rsi)
    got, ms = timed(lambda: unpredict_cuda.unpredict_swizzle(cfg, d), 20)
    want, plain_ms = timed(
        lambda: unpredict_cuda.unpredict_swizzle_plain(cfg, d), 1, warmup=0)
    err = max_abs_err(got, want)
    status, ref = native.decode(comp, len(raw), cfg)
    native_ok = status == 0 and got.cpu().numpy().tobytes() == ref
    print(f"kernel unpredict_swizzle [{name}] n_rsi={d.shape[0]} "
          f"S={d.shape[1]} max_abs_err={err} identical_to_native={native_ok} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    if err or not native_ok:
        raise AssertionError(f"unpredict kernel differs ({name})")
    return err, ms, plain_ms


def check_unpredict_rsis_kernel(name, cfg, d, want_bytes=None):
    """Kernel 5 against its plain version on deltas d [n_rsi, S] (one
    timed plain run: a loop over the RSI's samples), then kernel 4's byte
    layout on its samples against the layout's plain version, then kernel
    4 in one pass (inverse predictor and layout) against the two.
    want_bytes, if given, are native.decode's bytes for the chunk.
    Returns (kernel 5's max_abs_err, ms, plain_ms, the layout's
    max_abs_err)."""
    from libaec_tpu_torch.kernels import unpredict_cuda

    got, ms = timed(lambda: unpredict_cuda.unpredict_rsis(cfg, d), 20)
    want, plain_ms = timed(
        lambda: unpredict_cuda.unpredict_rsis_plain(cfg, d), 1, warmup=0)
    err = max_abs_err(got, want)
    out, layout_ms = timed(lambda: unpredict_cuda.samples_to_bytes(cfg, got),
                           20)
    ref, layout_plain_ms = timed(
        lambda: unpredict_cuda.samples_to_bytes_plain(cfg, got), 3, warmup=1)
    layout_err = max_abs_err(out, ref)
    one, one_ms = timed(lambda: unpredict_cuda.unpredict_swizzle(cfg, d), 20)
    one_pass_ok = torch.equal(one, out)
    native_ok = (want_bytes is None
                 or out.cpu().numpy().tobytes() == want_bytes)
    print(f"kernel unpredict_rsis [{name}] n_rsi={d.shape[0]} S={d.shape[1]}"
          f" max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} | "
          f"samples_to_bytes max_abs_err={layout_err} ms={layout_ms:.4f} "
          f"plain_ms={layout_plain_ms:.4f} | two kernels "
          f"ms={ms + layout_ms:.4f}, unpredict_swizzle in one pass "
          f"ms={one_ms:.4f} identical={one_pass_ok} | "
          f"identical_to_native={native_ok if want_bytes else 'n/a'}")
    if err or layout_err or not one_pass_ok or not native_ok:
        raise AssertionError(f"unpredict_rsis / layout differ ({name})")
    return err, ms, plain_ms, layout_err


def check_unpredict_inputs(name, cfg, n_rsi, device, seed):
    """Kernels 4 and 5 at the decode path's chunk on three inputs, each on
    a line of its own: the deltas of `lowentropy`, `midentropy` and
    `random` samples (tests/gen.py; the last is the worst case, one delta
    in two escapes).  Kernel 5 is held against its serial plain version
    (one timed run), kernel 4 against the plain byte layout of those
    samples, and the plain version that follows the kernels' scan against
    the serial one.  Returns (kernel 4's, kernel 5's max_abs_err)."""
    import gen

    from libaec_tpu_torch.kernels import unpredict_cuda
    from libaec_tpu_torch.ops import preprocess
    from libaec_tpu_torch.ops.u32 import from_bits, to_bits
    from libaec_tpu_torch.ops.unpredict import zig

    rng = np.random.default_rng(seed)
    S = cfg.samples_per_rsi
    err4 = err5 = 0
    for kind in ("lowentropy", "midentropy", "random"):
        raw = torch.from_numpy(gen.gen_values(
            rng, n_rsi * S, cfg.bits_per_sample, cfg.signed, kind).astype(
                np.int64)).view(n_rsi, S).to(device)
        d64, ref = preprocess.delta_map(raw, cfg)
        d64[:, 0] = ref
        d = to_bits(d64)
        got5, ms5 = timed(lambda: unpredict_cuda.unpredict_rsis(cfg, d), 20)
        want5, plain_ms = timed(
            lambda: unpredict_cuda.unpredict_rsis_plain(cfg, d), 1, warmup=0)
        scan5, scan_ms = timed(
            lambda: unpredict_cuda.unpredict_rsis_scan_plain(cfg, d), 1,
            warmup=0)
        got4, ms4 = timed(lambda: unpredict_cuda.unpredict_swizzle(cfg, d),
                          20)
        e5 = max_abs_err(got5, want5)
        e4 = max_abs_err(got4,
                         unpredict_cuda.samples_to_bytes_plain(cfg, want5))
        x = from_bits(want5)
        escapes = int((x[:, 1:] != ((x[:, :-1] + zig(d64[:, 1:]))
                                    & 0xFFFFFFFF)).sum())
        scan_ok = torch.equal(scan5, want5)
        print(f"kernel unpredict inputs [{name} {kind}] n_rsi={n_rsi} S={S} "
              f"escapes_per_rsi={escapes / n_rsi:.2f} | unpredict_swizzle "
              f"max_abs_err={e4} ms={ms4:.4f} | unpredict_rsis "
              f"max_abs_err={e5} ms={ms5:.4f} plain_ms={plain_ms:.4f} | "
              f"scan plain identical={scan_ok} ms={scan_ms:.4f}")
        if e4 or e5 or not scan_ok:
            raise AssertionError(f"unpredict kernels differ ({name} {kind})")
        err4, err5 = max(err4, e4), max(err5, e5)
    return err4, err5


def run_slice(cfg, mib, device, seed):
    """The encode main path on `mib` MiB buffers of cfg's samples."""
    import gen

    import libaec_tpu_torch as lt
    from libaec_tpu_torch import native
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda

    bps, bsz = cfg.bits_per_sample, cfg.bytes_per_sample
    rng = np.random.default_rng(seed)
    n = (mib << 20) // bsz + 12345        # odd tail: a partial RSI
    buffers = []
    for kind in ("lowentropy", "midentropy"):
        data = pack_samples(gen.gen_values(rng, n, bps, cfg.signed, kind),
                                bps, cfg.flags) + b"\x5a"  # short of a sample
        buffers.append((kind, data))
    # warm-up: pinned staging buffers, the allocator's pools
    lt.encode_buffer(buffers[0][1][: 64 << 20], cfg, device=device)

    encode_cuda.launches = merge_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    results = []
    for kind, data in buffers:
        t0 = time.perf_counter()
        comp = lt.encode_buffer(data, cfg, device=device)
        secs = time.perf_counter() - t0
        results.append((kind, data, comp, secs))
    launches = {"encode_fields": encode_cuda.launches,
                "merge_windows": merge_cuda.launches}
    peak = torch.cuda.max_memory_allocated(device)

    for kind, data, comp, secs in results:
        status, want = native.encode(data, cfg)
        if status != 0 or comp != want:
            raise AssertionError(f"{kind}: stream differs from native.encode")
        body = data[: len(data) // bsz * bsz]
        status, back = native.decode(comp, len(body), cfg)
        if status != 0 or back != body:
            raise AssertionError(f"{kind}: native decode round trip failed")
        print(f"slice encode_buffer [{bps}-bit {kind}] bytes={len(data)} "
              f"seconds={secs:.4f} MiB/s={len(data) / secs / 2**20:.2f} "
              f"ratio={len(data) / len(comp):.4f} "
              f"peak_device_MiB={peak / 2**20:.1f} "
              f"identical_to_native=True round_trip=True")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")
    print(f"slice launches [{bps}-bit encode] {json.dumps(launches)}")
    for kind, data, _, _ in results:
        with encode_timers() as spent:
            host_breakdown(f"{bps}-bit {kind}", lambda: lt.encode_buffer(
                data, cfg, device=device), spent)
    profile_call(f"encode_buffer {bps}-bit", lambda: lt.encode_buffer(
        results[0][1], cfg, device=device))
    return launches, results


def decode_counters():
    """The decode wrappers' launch counters: {wrapper: (module, name)}."""
    from libaec_tpu_torch.kernels import (decode_cuda, decode_fused_cuda,
                                          unpredict_cuda)

    return {"decode_blocks": (decode_cuda, "launches"),
            "unpredict_swizzle": (unpredict_cuda, "launches"),
            "unpredict_rsis": (unpredict_cuda, "rsis_launches"),
            "samples_to_bytes": (unpredict_cuda, "layout_launches"),
            "decode_fused": (decode_fused_cuda, "launches")}


def decode_route(cfg, fused):
    """The wrappers the decode path launches for cfg, once per chunk."""
    if fused and cfg.bytes_per_sample != 3:
        return ["decode_fused"]
    return ["decode_blocks"] + (["unpredict_rsis", "samples_to_bytes"]
                                if cfg.bytes_per_sample == 3
                                else ["unpredict_swizzle"])


def check_route(label, launches, route, chunks):
    """Every wrapper of the route launched once per chunk, and no other
    decode wrapper launched at all."""
    print(f"slice launches [{label}] chunks={chunks} {json.dumps(launches)}")
    for name, count in launches.items():
        want = chunks if name in route else 0
        if count != want:
            raise AssertionError(f"{label}: {name} launched {count} times, "
                                 f"expected {want}")


def run_decode_slice(results, cfg, device, fused=False):
    """The decode main path on the streams run_slice made, on the route
    of kernels 3 and 4 (3, 5 and 4 for 3-byte samples) or, with fused, of
    kernel 6: identical to the input and to native.decode; a truncated
    stream and an out_size short of a whole sample give native.decode's
    (status, bytes).  Every kernel of the route must have launched once
    per chunk, and no other."""
    import libaec_tpu_torch as lt
    from libaec_tpu_torch import native

    counters = decode_counters()
    bps, bsz = cfg.bits_per_sample, cfg.bytes_per_sample
    tag = f"{bps}-bit fused" if fused else f"{bps}-bit"

    def decode(comp, out_size):
        return lt.decode_buffer_status(comp, cfg, out_size, device=device,
                                       fused=fused)

    # warm-up: pinned slots, the allocator's pools, the worker threads
    decode(results[0][2], 64 << 20)

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runs = []
    for kind, data, comp, _ in results:
        body = data[: len(data) // bsz * bsz]
        t0 = time.perf_counter()
        status, out = decode(comp, len(body))
        runs.append((kind, body, comp, status, out,
                     time.perf_counter() - t0))
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)

    for kind, body, comp, status, out, secs in runs:
        if status != 0 or out != body:
            raise AssertionError(f"{kind}: decode differs from the input "
                                 f"(status {status})")
        t0 = time.perf_counter()
        want = native.decode(comp, len(body), cfg)
        native_secs = time.perf_counter() - t0
        if want != (status, out):
            raise AssertionError(f"{kind}: decode differs from native")
        print(f"slice decode_buffer_status [{tag} {kind}] "
              f"stream_bytes={len(comp)}"
              f" bytes={len(body)} seconds={secs:.4f} "
              f"MiB/s={len(body) / secs / 2**20:.2f} "
              f"native_MiB/s={len(body) / native_secs / 2**20:.2f} "
              f"peak_device_MiB={peak / 2**20:.1f} identical_to_input=True "
              f"identical_to_native=True")
    chunk_rsis = max(1, (8 << 20) // cfg.samples_per_rsi)
    check_route(f"{tag} decode", launches, decode_route(cfg, fused),
                sum(-(-(len(run[1]) // cfg.rsi_len_bytes) // chunk_rsis)
                    for run in runs))

    _, body, comp, _, _, _ = runs[0]
    for label, stream, out_size in (
            ("truncated mid-RSI", comp[: len(comp) // 2 + 7], len(body)),
            ("out_size not whole samples", comp, len(body) - 1)):
        got = decode(stream, out_size)
        want = native.decode(stream, out_size, cfg)
        if got != want:
            raise AssertionError(f"{label}: status {got[0]} and "
                                 f"{len(got[1])} bytes, native {want[0]} "
                                 f"and {len(want[1])}")
        print(f"slice decode_buffer_status [{tag} {label}] "
              f"status={got[0]} "
              f"bytes={len(got[1])} identical_to_native=True")

    for kind, body, comp, _, _, _ in runs:
        with decode_timers() as spent:
            host_breakdown(f"decode {tag} {kind}",
                           lambda: decode(comp, len(body)), spent)
    profile_call(f"decode_buffer_status {tag}",
                 lambda: decode(runs[0][2], len(runs[0][1])))
    return launches


def run_many(cfg, device, seed, n_streams=256, mib=1):
    """The many-streams path: n_streams streams of `mib` MiB each (one
    stream per HDF5 chunk), `lowentropy` and `midentropy` alternating, one
    truncated to half, one with an odd out_size, one of a single RSI,
    through libaec_tpu_torch.decode_buffers on the route of kernels 3 and
    4 and on kernel 6's.  Each result must be native.decode's for that
    stream; streams must share device chunks.  Returns the launches of
    both runs."""
    import gen

    import libaec_tpu_torch as lt
    from libaec_tpu_torch import native

    rng = np.random.default_rng(seed)
    n = (mib << 20) // cfg.bytes_per_sample
    comps, sizes, raws = [], [], []
    for i in range(n_streams):
        kind = ("lowentropy", "midentropy")[i % 2]
        count = cfg.samples_per_rsi if i == 5 else n  # one of a single RSI
        raw = pack_samples(gen.gen_values(
            rng, count, cfg.bits_per_sample, cfg.signed, kind),
            cfg.bits_per_sample, cfg.flags)
        status, comp = native.encode(raw, cfg)
        if status != 0:
            raise AssertionError(f"native encoder failed on stream {i}")
        comps.append(comp)
        sizes.append(len(raw))
        raws.append(raw)
    comps[3] = comps[3][: len(comps[3]) // 2]  # truncated to half
    sizes[4] -= 1                              # not a whole sample
    total = sum(sizes)

    t0 = time.perf_counter()
    want = [native.decode(c, s, cfg) for c, s in zip(comps, sizes)]
    native_secs = time.perf_counter() - t0
    if (want[0] != (0, raws[0]) or len(want[3][1]) >= sizes[3]
            or want[4][0] == 0 or len(want[5][1]) != cfg.rsi_len_bytes):
        raise AssertionError("native.decode: unexpected reference results")

    counters = decode_counters()
    lt.decode_buffers(comps[:16], cfg, sizes[:16], device=device)  # warm-up
    out = {}
    # each route twice, in turn: the first call of a route also pays for
    # pinned slots and heap growth that the second finds ready, so the
    # host split and the profile are taken on the second
    for fused, again in ((False, False), (True, False), (False, True),
                         (True, True)):
        tag = ("fused" if fused else "kernels 3+4") \
            + (", second call" if again else "")

        def decode():
            return lt.decode_buffers(comps, cfg, sizes, device=device,
                                     fused=fused)

        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = decode()
        secs = time.perf_counter() - t0
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                raise AssertionError(
                    f"decode_buffers [{tag}]: stream {i} gives status "
                    f"{g[0]} and {len(g[1])} bytes, native {w[0]} and "
                    f"{len(w[1])}")
        route = decode_route(cfg, fused)
        chunks = launches[route[0]]
        print(f"slice decode_buffers [{tag}] streams={n_streams} "
              f"bytes={total} seconds={secs:.4f} "
              f"MiB/s={total / secs / 2**20:.2f} "
              f"native_loop_MiB/s={total / native_secs / 2**20:.2f} "
              f"device_chunks={chunks} identical_to_native=True")
        if not 0 < chunks < n_streams:
            raise AssertionError(f"{chunks} device chunks for {n_streams} "
                                 f"streams: streams do not share chunks")
        check_route(f"decode_buffers {tag}", launches, route, chunks)
        if again:
            with decode_timers() as spent:
                host_breakdown(f"decode_buffers {tag}", decode, spent)
            profile_call(f"decode_buffers {tag}", decode)
        out[fused] = launches
    return out


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda

    encode_cuda.launches = merge_cuda.launches = 0
    for mod, attr in decode_counters().values():
        setattr(mod, attr, 0)


def check_launched(label, counts, route):
    """Every wrapper of the route launched, and no other."""
    print(f"slice launches [{label}] {json.dumps(counts)}")
    for name, count in counts.items():
        if (count > 0) != (name in route):
            raise AssertionError(f"{label}: {name} launched {count} times; "
                                 f"the route is {route}")


ENCODE_ROUTE = ["encode_fields", "merge_windows"]


def c_sz_compress(src, param):
    """SZ_BufftoBuffCompress of the port's native library (the szlib
    surface in C, libaec_abi.cpp): its stream, or an error."""
    import ctypes

    from libaec_tpu_torch import native

    class SZCom(ctypes.Structure):
        _fields_ = [(name, ctypes.c_int) for name in (
            "options_mask", "bits_per_pixel", "pixels_per_block",
            "pixels_per_scanline")]

    native.get_lib()
    lib = ctypes.CDLL(str(native.library_path()))
    dest = ctypes.create_string_buffer(len(src) * 2 + 4096)
    dlen = ctypes.c_size_t(len(dest))
    status = lib.SZ_BufftoBuffCompress(
        dest, ctypes.byref(dlen), src, len(src), ctypes.byref(SZCom(
            param.options_mask, param.bits_per_pixel,
            param.pixels_per_block, param.pixels_per_scanline)))
    if status != 0:
        raise AssertionError(f"SZ_BufftoBuffCompress failed ({status})")
    return dest.raw[:dlen.value]


def sz_chunks(rng, n_chunks, bpp, msb):
    """n_chunks HDF5 chunks of 1 MiB of bpp-bit pixels, `lowentropy` and
    `midentropy` alternating (64-bit pixels: 8-bit planes of them)."""
    import gen

    from libaec_tpu_torch import AEC_DATA_MSB

    size = 4 if bpp > 16 else 2 if bpp > 8 else 1
    flags = AEC_DATA_MSB if msb else 0
    return [pack_samples(gen.gen_values(
        rng, (1 << 20) // size, bpp, False,
        ("lowentropy", "midentropy")[i % 2]), bpp, flags)
        for i in range(n_chunks)]


def run_sz(device, seed):
    """The SZ layer on an HDF5-shaped dataset: 128 chunks of 1 MiB of
    16-bit pixels, SZ_MSB | SZ_NN, 32 pixels a block, 1024 a scanline
    (H5Pset_szip's shapes).  Each chunk compressed by
    sz_buffto_buff_compress (native: under 4 MiB), 64 of them once as one
    64 MiB buffer (kernels 1 and 2), both held against the C szlib
    surface; all 128 decompressed by sz_decompress_batch (kernels 3 and
    4), held against per-chunk sz_buffto_buff_decompress and the input;
    the 64 MiB stream by sz_buffto_buff_decompress on the card.  Then 32
    chunks with 1000 pixels a scanline (the padding path) and 32 of
    32-bit pixels (the interleave path), compressed natively and
    decompressed by sz_decompress_batch."""
    from libaec_tpu_torch import szip
    from libaec_tpu_torch.cli import launch_counts

    rng = np.random.default_rng(seed)
    mask = szip.SZ_MSB_OPTION_MASK | szip.SZ_NN_OPTION_MASK
    param = szip.SZCom(mask, 16, 32, 1024)
    chunks = sz_chunks(rng, 128, 16, True)
    total = sum(len(c) for c in chunks)

    t0 = time.perf_counter()
    comps = [szip.sz_buffto_buff_compress(c, param, device=device)
             for c in chunks]
    native_secs = time.perf_counter() - t0
    if any(c != c_sz_compress(d, param) for c, d in zip(comps, chunks)):
        raise AssertionError("SZ chunk streams differ from the C surface")

    big = b"".join(chunks[:64])
    szip.sz_buffto_buff_compress(big[: 8 << 20], param, device=device)
    reset_counts()
    t0 = time.perf_counter()
    big_comp = szip.sz_buffto_buff_compress(big, param, device=device)
    big_secs = time.perf_counter() - t0
    check_launched("sz compress 64 MiB", launch_counts(), ENCODE_ROUTE)
    if big_comp != c_sz_compress(big, param):
        raise AssertionError("SZ 64 MiB stream differs from the C surface")
    print(f"slice sz_buffto_buff_compress [64 MiB, 16-bit ppb 32 pps 1024] "
          f"bytes={len(big)} seconds={big_secs:.4f} "
          f"MiB/s={len(big) / big_secs / 2**20:.2f} "
          f"per_chunk_native_MiB/s={total / native_secs / 2**20:.2f} "
          f"ratio={len(big) / len(big_comp):.4f} identical_to_c_szlib=True")

    sizes = [len(c) for c in chunks]
    t0 = time.perf_counter()
    singles = [szip.sz_buffto_buff_decompress(c, param, n, device=device)
               for c, n in zip(comps, sizes)]
    single_secs = time.perf_counter() - t0
    if singles != chunks:
        raise AssertionError("sz_buffto_buff_decompress differs from input")
    szip.sz_decompress_batch(comps[:8], param, sizes[:8], device=device)
    for again in (False, True):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = szip.sz_decompress_batch(comps, param, sizes, device=device)
        secs = time.perf_counter() - t0
        if batch != singles:
            raise AssertionError("sz_decompress_batch differs from the "
                                 "per-chunk decompress")
        tag = "second call" if again else "first call"
        print(f"slice sz_decompress_batch [128 x 1 MiB, {tag}] "
              f"bytes={total} seconds={secs:.4f} "
              f"MiB/s={total / secs / 2**20:.2f} "
              f"per_chunk_native_MiB/s={total / single_secs / 2**20:.2f} "
              f"identical_to_single_and_input=True")
        check_launched(f"sz batch, {tag}", launch_counts(),
                       decode_route(param_cfg(param), False))
    with decode_timers() as spent:
        host_breakdown("sz_decompress_batch 128 x 1 MiB",
                       lambda: szip.sz_decompress_batch(
                           comps, param, sizes, device=device), spent)
    sz_batch_split("128 x 1 MiB", comps, param, sizes, device)

    reset_counts()
    t0 = time.perf_counter()
    back = szip.sz_buffto_buff_decompress(big_comp, param, len(big),
                                          device=device)
    secs = time.perf_counter() - t0
    if back != big:
        raise AssertionError("64 MiB SZ stream does not decompress to input")
    check_launched("sz decompress 64 MiB", launch_counts(),
                   decode_route(param_cfg(param), False))
    print(f"slice sz_buffto_buff_decompress [64 MiB] bytes={len(big)} "
          f"seconds={secs:.4f} MiB/s={len(big) / secs / 2**20:.2f} "
          f"identical_to_input=True")

    for label, param, bpp in (
            ("pps 1000, padded scanlines", szip.SZCom(mask, 16, 32, 1000),
             16),
            ("32-bit pixels, interleaved", szip.SZCom(mask, 32, 32, 1024),
             32)):
        chunks = sz_chunks(rng, 32, bpp, True)
        comps = [szip.sz_buffto_buff_compress(c, param, device=device)
                 for c in chunks]
        if any(c != c_sz_compress(d, param) for c, d in zip(comps, chunks)):
            raise AssertionError(f"{label}: streams differ from the C "
                                 f"surface")
        sizes = [len(c) for c in chunks]
        singles = [szip.sz_buffto_buff_decompress(c, param, n, device=device)
                   for c, n in zip(comps, sizes)]
        reset_counts()
        t0 = time.perf_counter()
        batch = szip.sz_decompress_batch(comps, param, sizes, device=device)
        secs = time.perf_counter() - t0
        if not batch == singles == chunks:
            raise AssertionError(f"{label}: sz_decompress_batch differs")
        print(f"slice sz_decompress_batch [{label}, 32 x 1 MiB] "
              f"bytes={sum(sizes)} seconds={secs:.4f} "
              f"MiB/s={sum(sizes) / secs / 2**20:.2f} "
              f"identical_to_single_and_input=True")
        check_launched(f"sz batch, {label}", launch_counts(),
                       decode_route(param_cfg(param), False))
        with decode_timers() as spent:
            host_breakdown(f"sz_decompress_batch {label}",
                           lambda: szip.sz_decompress_batch(
                               comps, param, sizes, device=device), spent)
        sz_batch_split(label, comps, param, sizes, device)


def sz_batch_split(label, comps, param, sizes, device):
    """Where an sz_decompress_batch call's time goes: decode_buffers on
    the padded sizes, then the SZ layer's per-stream post-processing
    (scanline unpadding, byte-plane de-interleave, copies)."""
    import libaec_tpu_torch as lt
    from libaec_tpu_torch import szip

    plans = [szip._decompress_plan(param, n) for n in sizes]
    t0 = time.perf_counter()
    raw = lt.decode_buffers(comps, plans[0][0], [p[1] for p in plans],
                            device=device)
    t1 = time.perf_counter()
    for (_, buf), (_, _, post) in zip(raw, plans):
        post(buf)
    t2 = time.perf_counter()
    print(f"split [sz_decompress_batch {label}] "
          f"decode_buffers_ms={(t1 - t0) * 1e3:.3f} "
          f"sz_post_ms={(t2 - t1) * 1e3:.3f}")


def param_cfg(param):
    """The codec Config an SZ parameter set decodes with."""
    from libaec_tpu_torch import szip

    return szip._decompress_plan(param, 0)[0]


def run_stream(cfg, device, seed, mib=32):
    """The streaming surface at the bench config: `mib` MiB fed to
    aec_encode in seeded uneven pieces of 1 KiB to 4 MiB, the output
    drained through avail_out caps of 64 KiB after each piece; the result
    must be native.encode's of the whole buffer, and kernels 1 and 2 must
    have launched.  Then the stream drip-fed back through aec_decode in
    64 KiB pieces (the host decode)."""
    import gen

    from libaec_tpu_torch import AEC_FLUSH, AEC_NO_FLUSH, native, stream
    from libaec_tpu_torch.cli import launch_counts

    rng = np.random.default_rng(seed)
    data = pack_samples(gen.gen_values(
        rng, (mib << 20) // cfg.bytes_per_sample + 777, cfg.bits_per_sample,
        False, "lowentropy"), cfg.bits_per_sample, cfg.flags)
    cap = 64 << 10
    pieces = []
    pos = 0
    while pos < len(data):
        n = int(rng.integers(1 << 10, 4 << 20))
        pieces.append(data[pos:pos + n])
        pos += n

    def encode():
        s = stream.AecStream(cfg.bits_per_sample, cfg.block_size, cfg.rsi,
                             cfg.flags, device=device)
        stream.aec_encode_init(s)
        out = bytearray()
        for i, piece in enumerate(pieces + [b""]):
            s.next_in, s.avail_in = piece, None
            flush = AEC_FLUSH if i == len(pieces) else AEC_NO_FLUSH
            while True:
                s.next_out, s.avail_out = out, cap
                stream.aec_encode(s, flush)
                s.next_in = b""
                if s.avail_out:  # the cap was not filled: drained
                    break
        if stream.aec_encode_end(s) != 0:
            raise AssertionError("aec_encode_end: stream not drained")
        return bytes(out)

    encode()  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = encode()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    if comp != native.encode(data, cfg)[1]:
        raise AssertionError("stream encode differs from native.encode")
    print(f"slice aec_encode [{cfg.bits_per_sample}-bit stream, "
          f"{len(pieces)} pieces 1 KiB-4 MiB, drained by 64 KiB] "
          f"bytes={len(data)} seconds={secs:.4f} "
          f"MiB/s={len(data) / secs / 2**20:.2f} "
          f"identical_to_native=True")
    check_launched("stream encode", counts, ENCODE_ROUTE)
    with encode_timers() as spent:
        host_breakdown("stream encode", encode, spent)
    profile_call("stream encode", encode)

    s = stream.AecStream(cfg.bits_per_sample, cfg.block_size, cfg.rsi,
                         cfg.flags, device=device)
    stream.aec_decode_init(s)
    out = bytearray()
    t0 = time.perf_counter()
    for i in range(0, len(comp) + cap, cap):
        s.next_in, s.avail_in = comp[i:i + cap], None
        s.next_out, s.avail_out = out, 1 << 40
        stream.aec_decode(s, AEC_FLUSH if i >= len(comp) else AEC_NO_FLUSH)
    secs = time.perf_counter() - t0
    body = data[: len(data) // cfg.bytes_per_sample * cfg.bytes_per_sample]
    if bytes(out[:len(body)]) != body or \
            (0, bytes(out)) != native.decode(
                comp, len(out) + cfg.rsi_len_bytes, cfg):
        raise AssertionError("stream decode differs from the input")
    print(f"slice aec_decode [{cfg.bits_per_sample}-bit stream, 64 KiB "
          f"pieces, host] bytes={len(out)} seconds={secs:.4f} "
          f"MiB/s={len(out) / secs / 2**20:.2f} identical_to_native=True")


def run_cli(device, seed):
    """The `aec` tool of the port, `python -m libaec_tpu_torch.cli`, on a
    64 MiB file at the bench config and a 48 MiB file of 24-bit samples
    in 3 bytes: encode (kernels 1 and 2) and decode (kernels 3 and 4; 3, 5
    and the layout for 3 bytes), each file held against native.encode /
    native.decode.  The four runs are subprocesses started together (the
    decodes read native.encode's stream, which the encodes must match),
    each printing its launch counts on stderr (LIBAEC_TPU_PRINT_LAUNCHES);
    their wall time is mostly interpreter, torch and CUDA start.  Each
    call is timed again in this process, cli.main on the same files."""
    import os

    import gen

    from libaec_tpu_torch import Config, cli, native

    rng = np.random.default_rng(seed)
    env = dict(os.environ, LIBAEC_TPU_PRINT_LAUNCHES="1")
    for knob in ("LIBAEC_TPU_ENCODE", "LIBAEC_TPU_DECODE",
                 "LIBAEC_TPU_FUSED_DECODE"):
        env.pop(knob, None)
    files = (("16-bit bench", ["-n", "16", "-j", "64", "-r", "256", "-m"],
              Config(16, 64, 256, 0x0C), 64),
             ("24-bit 3-byte", ["-n", "24", "-j", "64", "-r", "256", "-m",
                                "-3"], Config(24, 64, 256, 0x0E), 48))
    with tempfile.TemporaryDirectory() as tmp:
        runs = []  # (label, op, arguments, output, route, expected bytes)
        for label, flags, cfg, mib in files:
            n = (mib << 20) // cfg.bytes_per_sample + 99
            data = pack_samples(gen.gen_values(
                rng, n, cfg.bits_per_sample, False, "lowentropy"),
                cfg.bits_per_sample, cfg.flags)
            src, rz, enc, dec = (str(Path(tmp) / f"{cfg.bits_per_sample}"
                                     f".{ext}") for ext in
                                 ("dat", "native.rz", "rz", "out"))
            Path(src).write_bytes(data)
            comp = native.encode(data, cfg)[1]
            Path(rz).write_bytes(comp)
            status, back = native.decode(
                comp, len(data) + cfg.rsi_len_bytes, cfg)
            if status != 0:
                raise AssertionError(f"native.decode failed ({label})")
            runs += [(label, "encode", flags + [src, enc], enc, ENCODE_ROUTE,
                      comp, len(data)),
                     (label, "decode", ["-d"] + flags + [rz, dec], dec,
                      decode_route(cfg, False), back, len(data))]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "libaec_tpu_torch.cli", *run[2]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for run in runs]
        results = []
        for proc in procs:
            _, err = proc.communicate(timeout=300)
            results.append((proc.returncode, err,
                            time.perf_counter() - t0))
        for (label, op, args, out, route, expect, nbytes), (rc, err, secs) \
                in zip(runs, results):
            if rc != 0:
                raise AssertionError(f"cli {op} [{label}] exit {rc}: {err}")
            line = [ln for ln in err.splitlines()
                    if ln.startswith("launches ")][-1]
            if Path(out).read_bytes() != expect:
                raise AssertionError(f"cli {op} [{label}]: file differs "
                                     f"from native")
            check_launched(f"cli {op} [{label}]",
                           json.loads(line[len("launches "):]), route)
            t1 = time.perf_counter()
            if cli.main(args) != 0:
                raise AssertionError(f"cli.main {op} [{label}] failed")
            in_secs = time.perf_counter() - t1
            if Path(out).read_bytes() != expect:
                raise AssertionError(f"cli.main {op} [{label}]: file "
                                     f"differs from native")
            print(f"slice cli {op} [{label}] bytes={nbytes} "
                  f"process_seconds={secs:.4f} (4 processes at once) "
                  f"in_process_seconds={in_secs:.4f} "
                  f"in_process_MiB/s={nbytes / in_secs / 2**20:.2f} "
                  f"identical_to_native=True")
            timers = encode_timers if op == "encode" else decode_timers
            with timers() as spent:
                host_breakdown(f"cli.main {op} {label}",
                               lambda: cli.main(args), spent)
    # what a CLI process pays before its first byte: the interpreter, the
    # imports, the CUDA context and the kernels' library, one process alone
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-c", "import torch, libaec_tpu_torch.cli; "
         "from libaec_tpu_torch.kernels import _build; _build.load(); "
         "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"],
        cwd=ROOT, check=True, timeout=300)
    print(f"split [cli process start, alone] "
          f"seconds={time.perf_counter() - t0:.4f}")


def _step_timer(spent, lock):
    def wrap(step, fn):
        def timed_step(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    spent[step] += time.perf_counter() - t0
        return timed_step
    return wrap


@contextmanager
def encode_timers():
    """Seconds the encode path spends in each host step, summed per step.

    Wraps the names encode_buffer looks up in libaec_tpu_torch.encode and
    puts them back on exit.  Steps tagged (main) run on the calling
    thread, (fetch) on the FIFO fetch thread, so the two sums overlap."""
    from libaec_tpu_torch import encode as mod

    spent = defaultdict(float)
    wrap = _step_timer(spent, threading.Lock())

    class Stager(mod._Stager):
        stage = wrap("stage_main", mod._Stager.stage)

    class Assembler(mod._OutputAssembler):
        append = wrap("assemble_fetch", mod._OutputAssembler.append)
        finish = wrap("finish_main", mod._OutputAssembler.finish)

    saved = {name: getattr(mod, name) for name in (
        "_Stager", "_OutputAssembler", "encode_chunk",
        "words_to_stream_bytes", "encode_tail")}
    mod._Stager, mod._OutputAssembler = Stager, Assembler
    mod.encode_chunk = wrap("dispatch_main", saved["encode_chunk"])
    mod.words_to_stream_bytes = wrap("d2h_fetch",
                                     saved["words_to_stream_bytes"])
    mod.encode_tail = wrap("tail_main", saved["encode_tail"])
    try:
        yield spent
    finally:
        for name, value in saved.items():
            setattr(mod, name, value)


@contextmanager
def decode_timers():
    """Seconds the decode path spends in each host step, summed per step,
    as encode_timers: (main) the calling thread, (fill) the fill worker,
    (fetch) the FIFO fetch thread, (pool) the scan and fill pools of
    decode_buffers, summed over their threads."""
    from libaec_tpu_torch import decode as mod

    spent = defaultdict(float)
    wrap = _step_timer(spent, threading.Lock())
    steps = {"scan_chunk": "scan_main", "fill_chunk": "fill_fill",
             "stage_chunk": "h2d_main", "decode_chunk": "dispatch_main",
             "fetch_chunk": "d2h_fetch", "store_part": "store_fetch",
             "finish": "tail_finish", "scan_stream": "scan_pool",
             "fill_part": "fill_pool"}
    saved = {name: getattr(mod, name) for name in steps}
    for name, step in steps.items():
        setattr(mod, name, wrap(step, saved[name]))
    try:
        yield spent
    finally:
        for name, value in saved.items():
            setattr(mod, name, value)


def host_breakdown(label, fn, spent):
    """One main-path call, fn(), inside a timers context whose sums are
    `spent`."""
    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = " ".join(f"{k}_ms={v * 1e3:.3f}" for k, v in sorted(spent.items()))
    print(f"host [{label}] wall_ms={wall_ms:.3f} {steps}")


def device_spans(fn):
    """fn() under torch.profiler: its wall milliseconds and the (start,
    end, name) of every kernel, copy and memset on the device, in
    microseconds, sorted by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return wall_ms, sorted(
        (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
        if e.get("ph") == "X" and e.get("cat") in
        ("kernel", "gpu_memcpy", "gpu_memset"))


def profile_call(label, fn):
    """Device time of one main-path call, fn(), under torch.profiler: the
    union of the intervals of kernels, copies and memsets over all
    streams, and the device's idle share of the call's wall time."""
    wall_ms, spans = device_spans(fn)
    if not spans:
        print(f"profile [{label}] wall_ms={wall_ms:.3f} "
              f"device time: not measured")
        return
    by_name = defaultdict(lambda: [0.0, 0])
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][0]
    for start, end, name in spans:
        by_name[name][0] += end - start
        by_name[name][1] += 1
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy_ms = (busy_us + cur_end - cur_start) / 1e3
    top = "; ".join(f"{name[:48]} x{n} {us / 1e3:.3f}ms" for name, (us, n)
                    in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8])
    print(f"profile [{label}] wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / wall_ms:.4f} | {top}")


def pass_times(label, fn, reps=20):
    """Mean device milliseconds of each kernel fn() launches, by the
    kernel's name, over `reps` calls in one torch.profiler trace (after
    one untimed call), in launch order; prints them and returns
    {name: ms}."""
    def many():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    _, spans = device_spans(many)
    by_name = defaultdict(float)
    for start, end, name in spans:
        short = name.replace("(anonymous namespace)::", "").split("(")[0]
        by_name[short.replace("void ", "").split("<")[0]] += end - start
    out = {name: us / 1e3 / reps for name, us in by_name.items()}
    print(f"passes [{label}] reps={reps} "
          + (" ".join(f"{name}_ms={ms:.4f}" for name, ms in out.items())
             or "device time: not measured")
          + f" sum_ms={sum(out.values()):.4f}")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import libaec_tpu_torch  # noqa: F401  (fails outside the repository)
    from libaec_tpu_torch import (AEC_DATA_3BYTE, AEC_DATA_MSB,
                                  AEC_DATA_PREPROCESS, AEC_DATA_SIGNED,
                                  AEC_NOT_ENFORCE, Config)
    from libaec_tpu_torch import native
    from libaec_tpu_torch.encode import default_rsis_per_chunk
    from libaec_tpu_torch.kernels import _build, encode_cuda
    from libaec_tpu_torch.ops.u32 import u32_to_bits

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"card {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
          f" | cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    # 2. build: the native host library (g++), then the kernels (nvcc)
    t0 = time.perf_counter()
    native.get_lib()
    print(f"build {native.library_path().name} "
          f"seconds={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    _build.load()
    print(f"build {_build.library_path().name} "
          f"seconds={time.perf_counter() - t0:.2f}")

    # 3. kernel 1 against its plain version, each config at the chunk the
    #    main path gives it (encode.default_rsis_per_chunk)
    pp, msb, sgn = AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED
    b3, ne = AEC_DATA_3BYTE, AEC_NOT_ENFORCE
    bench_cfg = Config(16, 64, 256, msb | pp)
    cfg24 = Config(24, 64, 256, msb | pp | b3)  # 24-bit samples in 3 bytes
    bench, err1, ms1, plain1 = check_encode_kernel(
        "bench 16-bit MSB pp bs64 rsi256", bench_cfg,
        default_rsis_per_chunk(bench_cfg), device, passes=True)
    bs10_cfg = Config(16, 10, 256, msb | pp | ne)
    checks = [  # (name, config, RSIs or None for the path's chunk, dirty,
        #          k_init, time the passes apart)
        ("bench 16-bit MSB pp bs64 rsi256, bench.py chunk", bench_cfg,
         BENCH_CHUNK_RSIS, False, 3, False),
        ("8-bit no-pp bs16 rsi128", Config(8, 16, 128, 0), None, False, 3,
         False),
        ("13-bit signed bs32 rsi64 dirty", Config(13, 32, 64, sgn | pp | msb),
         None, True, 3, False),
        ("32-bit signed bs64 rsi256", Config(32, 64, 256, sgn | pp), None,
         False, 3, False),
        ("16-bit MSB pp NOT_ENFORCE bs10 rsi256", bs10_cfg, None, False, 3,
         True),
        ("24-bit MSB pp 3-byte NOT_ENFORCE bs48 rsi256",
         Config(24, 48, 256, msb | pp | b3 | ne), None, False, 3, False),
        # the k chain's shapes: one tile (a short one); 33 tiles, one more
        # than the chain's runs, the last of 27 blocks; 31 tiles
        ("one short tile, NB 40", Config(16, 64, 8, msb | pp), 5, False, 0,
         False),
        ("33 tiles, the last of 27 blocks", Config(16, 16, 25, msb | pp), 83,
         False, 13, False),
        ("31 tiles, the last of 40 blocks", Config(32, 8, 7, sgn | pp), 280,
         False, 29, False),
    ]
    for name, cfg, n_rsi, dirty, k_init, passes in checks:
        _, e, _, _ = check_encode_kernel(
            name, cfg, n_rsi or default_rsis_per_chunk(cfg), device, dirty,
            k_init, passes)
        err1 = max(err1, e)

    # raw bytes and k read, windows, bit lengths and k written; per sample
    # ~28 integer operations and two for each of the kmax + 1 split options
    nb1, w0 = bench[0].shape
    bound1 = bound_ms(
        nb1 * bench_cfg.block_size * bench_cfg.bytes_per_sample + 4
        + 4 * nb1 * (w0 + 1) + 4,
        nb1 * bench_cfg.block_size * (28 + 2 * (bench_cfg.kmax + 1)))

    # 4. kernel 2 against its plain version on the main path's chunk: the
    #    windows of every tests/gen.py kind (its ms, bound and plain ms go
    #    to the kernels' line), then of `lowentropy` and of `midentropy`
    #    samples alone
    err2, ms2, plain2, _, bound2, _ = check_merge_kernel(
        "all kinds", bench_cfg, bench[0], bench[1], device)
    n_enc = default_rsis_per_chunk(bench_cfg)
    for seed, kind in enumerate(("lowentropy", "midentropy")):
        win, block_bits = kind_windows(bench_cfg, n_enc, kind, 40 + seed,
                                       device)
        err2 = max(err2, check_merge_kernel(kind, bench_cfg, win, block_bits,
                                            device)[0])
        del win, block_bits

    # 5. the encode main path
    launches, streams = run_slice(bench_cfg, SLICE_MIB, device,
                                  seed=20261016)

    # 6. kernel 3 against its plain version, each config at the chunk the
    #    decode path gives it (8 Mi samples: 512 RSIs, NB 131072 at the
    #    bench config), at every window width that path can choose
    def decode_chunk_rsis(cfg):
        return max(1, (8 << 20) // cfg.samples_per_rsi)

    n_bench = decode_chunk_rsis(bench_cfg)
    dec_checks = [  # (name, config, whole RSIs of raw bytes)
        ("bench walk flat", bench_cfg, walk_data(bench_cfg, n_bench, 60, 0)),
        ("bench walk 2", bench_cfg, walk_data(bench_cfg, n_bench, 62, 2)),
        ("bench walk 8", bench_cfg, walk_data(bench_cfg, n_bench, 68, 8)),
        ("bench all kinds", bench_cfg,
         chunk_data(bench_cfg, n_bench, 16)),          # the worst case, 34
    ] + [(name, cfg, chunk_data(cfg, decode_chunk_rsis(cfg),
                                cfg.bits_per_sample)) for name, cfg in (
        ("8-bit no-pp bs16 rsi128", Config(8, 16, 128, 0)),
        ("13-bit signed MSB bs32 rsi64", Config(13, 32, 64, sgn | pp | msb)),
        ("32-bit signed bs64 rsi256", Config(32, 64, 256, sgn | pp)),
        ("bench no-pp", Config(16, 64, 256, msb)),
    )]
    err3, bench3, chunks = 0, [], {}
    for name, cfg, raw in dec_checks:
        rows, deltas, comp, args_by_wf = check_decode_kernel(
            name, cfg, raw, device, profile=cfg == bench_cfg)
        err3 = max(err3, *(r[1] for r in rows))
        if cfg == bench_cfg:
            bench3 += rows
        chunks[name] = (cfg, raw, deltas, comp, args_by_wf)
    ms3 = statistics.median(r[2] for r in bench3)
    plain3 = statistics.median(r[3] for r in bench3)
    bounds3 = sorted(r[4] for r in bench3)
    bound3 = bounds3[len(bounds3) // 2]
    print(f"kernel decode_blocks at the bench chunk (NB {n_bench * 256}), "
          f"median over widths {sorted({r[0] for r in bench3})}: "
          f"ms={ms3:.4f} device_ms="
          f"{statistics.median(r[5] for r in bench3):.4f} "
          f"bound_ms={bound3[0]:.4f} ({bound3[1]}; words parsed) "
          f"whole_window_bound_ms="
          f"{statistics.median(r[6][0] for r in bench3):.4f}")

    # 7. kernel 4 against its plain version on those chunks' deltas, then
    #    kernels 4 and 5 on three inputs at the bench chunk
    err4 = 0
    for name in ("bench walk 2", "8-bit no-pp bs16 rsi128",
                 "13-bit signed MSB bs32 rsi64", "32-bit signed bs64 rsi256",
                 "bench no-pp"):
        e, ms, plain = check_unpredict_kernel(name, *chunks[name][:4], device)
        err4 = max(err4, e)
        if name == "bench walk 2":
            ms4, plain4 = ms, plain
    e4, e5 = check_unpredict_inputs("bench 16-bit", bench_cfg, n_bench,
                                    device, seed=74)
    err4 = max(err4, e4)
    # deltas read, bytes written; ~12 integer operations a sample and one
    # for each byte laid out
    n4 = n_bench * bench_cfg.samples_per_rsi
    bound4 = bound_ms(n4 * (4 + bench_cfg.bytes_per_sample),
                      n4 * (12 + bench_cfg.bytes_per_sample))

    # 7b. kernel 6 against its plain version on the same chunks, at every
    #     window width the path can choose, beside kernels 3 + 4; then on
    #     block sizes that do not divide a scan group, on an odd RSI
    #     count, and on rough and random samples at the bench chunk
    fused_checks = {name: (cfg, raw, comp, args_by_wf)
                    for name, (cfg, raw, _, comp, args_by_wf)
                    in chunks.items()}
    for name, cfg, n_rsi in (
            ("16-bit MSB pp NOT_ENFORCE bs10 rsi256",
             Config(16, 10, 256, msb | pp | ne), None),
            ("8-bit NOT_ENFORCE bs10 rsi3, rows of 30 bytes",
             Config(8, 10, 3, ne | pp), 1001),
            ("bench, 77 RSIs", bench_cfg, 77)):
        raw = chunk_data(cfg, n_rsi or decode_chunk_rsis(cfg),
                         cfg.bits_per_sample + 1)
        rows, _, comp, args_by_wf = check_decode_kernel(name, cfg, raw, device)
        err3 = max(err3, *(r[1] for r in rows))
        fused_checks[name] = (cfg, raw, comp, args_by_wf)
    err6, bench6 = 0, []
    for name, (cfg, raw, comp, args_by_wf) in fused_checks.items():
        rows = check_fused_kernel(name, cfg, raw, comp, args_by_wf, device)
        err6 = max(err6, *(r[1] for r in rows))
        if cfg == bench_cfg and len(raw) == n_bench * cfg.rsi_len_bytes:
            bench6 += rows
    err6 = max(err6, check_fused_inputs("bench 16-bit", bench_cfg, n_bench,
                                        device, seed=96))
    ms6 = statistics.median(r[2] for r in bench6)
    plain6 = statistics.median(r[3] for r in bench6)
    two6 = statistics.median(r[4] for r in bench6)
    print(f"kernel decode_fused at the bench chunk (NB {n_bench * 256}), "
          f"median over widths {sorted({r[0] for r in bench6})}: "
          f"ms={ms6:.4f} kernels_3_4_ms={two6:.4f}")
    # records and the window words the parse needs read, bytes written;
    # kernel 3's operations on blocks with a payload and kernel 4's on
    # every sample
    nb6 = n_bench * bench_cfg.rsi
    bounds6 = sorted(bound_ms(
        4 * (r[5] + 4 * nb6) + n4 * bench_cfg.bytes_per_sample,
        20 * bench_cfg.block_size * r[6]
        + n4 * (12 + bench_cfg.bytes_per_sample)) for r in bench6)
    bound6 = bounds6[len(bounds6) // 2]
    whole6 = statistics.median(bound_ms(
        4 * nb6 * (r[0] + 4) + n4 * bench_cfg.bytes_per_sample, 0)[0]
        for r in bench6)
    print(f"kernel decode_fused at the bench chunk: bound_ms="
          f"{bound6[0]:.4f} ({bound6[1]}; words parsed) "
          f"whole_window_bound_ms={whole6:.4f}")

    # 8. kernel 5, the byte layout (kernel 4 without preprocessing) and
    #    kernel 4 in one pass, on the 3-byte decode path's chunk: deltas
    #    from kernel 3 on a scanned stream (kernel 3 checked there too),
    #    and deltas from all of u32; then both kernels on three inputs
    err5, rng = 0, np.random.default_rng(24)
    for name, cfg in (("24-bit MSB pp 3-byte bs64 rsi256", cfg24),
                      ("17-bit signed pp 3-byte bs32 rsi64",
                       Config(17, 32, 64, sgn | pp | b3))):
        raw = chunk_data(cfg, decode_chunk_rsis(cfg), cfg.bits_per_sample)
        rows, deltas, comp, _ = check_decode_kernel(name, cfg, raw, device)
        err3 = max(err3, *(r[1] for r in rows))
        status, want = native.decode(comp, len(raw), cfg)
        if status != 0:
            raise AssertionError(f"native decode failed ({name})")
        d = deltas.view(-1, cfg.samples_per_rsi)
        e, ms, plain, le = check_unpredict_rsis_kernel(
            f"{name} scanned", cfg, d, want)
        if cfg == cfg24:
            ms5, plain5 = ms, plain
            # deltas read, samples written; ~12 operations a sample
            bound5 = bound_ms(8 * d.numel(), 12 * d.numel())
        full = u32_to_bits(rng.integers(0, 1 << 32, tuple(d.shape),
                                        dtype=np.uint64).astype(np.uint32))
        e2, _, _, le2 = check_unpredict_rsis_kernel(
            f"{name} all of u32", cfg, full.to(device))
        err5, err4 = max(err5, e, e2), max(err4, le, le2)
    e4, e5b = check_unpredict_inputs("24-bit 3-byte", cfg24,
                                     decode_chunk_rsis(cfg24), device, seed=85)
    err4, err5 = max(err4, e4), max(err5, e5, e5b)

    # 9. the decode main path on the streams of phase 5
    dec_launches = run_decode_slice(streams, bench_cfg, device)

    # 10. both main paths on 24-bit samples stored in 3 bytes
    _, streams24 = run_slice(cfg24, SLICE_MIB, device, seed=20261017)
    dec24_launches = run_decode_slice(streams24, cfg24, device)

    # 11. the one-kernel decode path on the streams of phase 5
    fused_launches = run_decode_slice(streams, bench_cfg, device, fused=True)

    # 12. many streams: 256 of 1 MiB each at the bench config, on both
    #     routes
    many_launches = run_many(bench_cfg, device, seed=20261018)

    # 13-15. the surfaces users call: the SZ layer on an HDF5-shaped
    #        dataset, the streaming calls, the `aec` tool on files
    print(f"surfaces on {smi}")
    run_sz(device, seed=20261019)
    run_stream(bench_cfg, device, seed=20261020)
    run_cli(device, seed=20261021)
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "libaec_tpu"))
    if foreign:
        raise AssertionError(f"imported from outside the port: {foreign}")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        # no single PyTorch call computes any of these functions
        return {"name": name, "route": "cuda",
                "source": f"libaec_tpu_torch/csrc/{source}",
                "replaces": f"libaec_tpu/kernels/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}

    kernels = [
        entry("encode_fields", "encode.cu", "encode_pallas.py:83",
              launches["encode_fields"], err1, ms1, plain1, bound1),
        entry("merge_windows", "merge.cu", "merge_pallas.py:77",
              launches["merge_windows"], err2, ms2, plain2, bound2),
        entry("decode_blocks", "decode.cu", "decode_pallas.py:53",
              dec_launches["decode_blocks"], err3, ms3, plain3, bound3),
        entry("unpredict_swizzle", "unpredict.cu", "unpredict_pallas.py:83",
              dec_launches["unpredict_swizzle"], err4, ms4, plain4, bound4),
        entry("unpredict_rsis", "unpredict.cu", "unpredict_pallas.py:22",
              dec24_launches["unpredict_rsis"], err5, ms5, plain5, bound5),
        entry("decode_fused", "decode_fused.cu", "decode_fused_pallas.py:48",
              fused_launches["decode_fused"], err6, ms6, plain6, bound6),
    ]
    print(f"launches on the many-streams path: "
          f"{json.dumps({str(k): v for k, v in many_launches.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
