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
against the input and the native decoder, with one line a route of the
walk, fill, store and touch ms of each stream's traced call and the
pipeline's thread counts (`slice decode pipeline`); the 16-bit streams
once more on the one-kernel route (fused=True); and
libaec_tpu_torch.decode_buffers over 256 streams of 1 MiB on both
routes.  Then the surfaces users call,
each phase holding its launch counts to the kernels of its route: the SZ
layer (libaec_tpu_torch.szip) on an HDF5-shaped dataset of 128 chunks of
1 MiB, compressed chunk by chunk and as one 64 MiB buffer on the card,
decompressed by sz_decompress_batch, held against the C szlib surface of
the native library, the input and the per-chunk decompress, with padded
scanlines and 32-bit pixels besides; the streaming calls
(libaec_tpu_torch.stream) on 32 MiB fed in uneven pieces and drained
through 64 KiB, held against native.encode, and drip-fed back; the `aec`
tool (`python -m libaec_tpu_torch.cli`) encoding and decoding a 64 MiB
file and a 48 MiB file of 3-byte samples.  Last, the multi-GPU path
(libaec_tpu_torch.parallel): 256 MiB split over NCCL ranks, one a card,
and over 2 and 4 gloo ranks sharing the card, each run's stream held
against native.encode and its decode against the input (kernel 1's two
phases and kernel 2 at every bit0 a shard merges at are held against
their plain versions first), once for the bench config, once for
sar32bit (CCSDS 121.0-B-2's ExtendedParameters, AEC_PAD_RSI, at 64 MiB)
and once for blocks of 128 samples (at 64 MiB).
Then further configs of up to 64 samples (phase 17): AEC_PAD_RSI,
the restricted set of 1- and 2-bit samples and SZIP's blocks of 2, 4 and
6 pixels, kernels 1, 3 and (at blocks of 2) 4 held against their plain
versions at each config's chunk, then 256 MiB of sar32bit samples and 64
MiB of restricted 2-bit samples through encode_buffer and
decode_buffer_status, and 128 chunks of 1 MiB through the SZ layer at 4
pixels a block, each beside the native codec on the same buffers.
Last, blocks over 64 samples (phase 18, AEC_NOT_ENFORCE: the wide paths
of kernels 1 and 3): kernels 1 (and its two phases), 2, 3 and 4 held
against their plain versions at 128, 1024 and 16384 samples a block, and
kernel 4 on RSIs of 4 Mi samples against native.decode; then 256 MiB of
the benchmark's field data at 128 and at 1024 samples a block through
encode_buffer, decode_buffer_status and (as 64 streams) decode_buffers,
each held against the native codec on the same buffer, and one RSI of
64 Mi samples (256 MiB) through both entry points with the device memory
each takes.
Last, a stream's short last RSI (phase 19): kernels 1 and 2 on one of nb
1, 2 and rsi - 1 blocks at five configs (the bench config, 3-byte
samples, sar32bit's AEC_PAD_RSI, SZIP's blocks of 4 and blocks of 1024)
against their plain versions, then encode_buffer, encode_buffer_status,
the stream and the SZ compress over buffers that end in one, each held
against the native codec, the C szlib surface and its launch counts.
Every kernel's plain version is wrapped in a counter (count_plain_versions)
and every main path's run, phase 16's ranks too, is held to no call of
one.
Imports neither JAX nor the JAX package:
the bit-exact reference is libaec_tpu_torch.native.  Exits non-zero, and
prints no result line, on any failure or when no CUDA device is present.

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


def decode_chunk_rsis(cfg):
    """RSIs of the decode path's chunk: 8 Mi samples."""
    return max(1, (8 << 20) // cfg.samples_per_rsi)


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
    k0 = torch.tensor([min(k_init, max(cfg.kmax, 0))], dtype=torch.int32,
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


def check_encode_phases(name, cfg, raw, device, k_init=3):
    """Kernel 1's two phases for a shard, `raw` its whole RSIs on the
    card: encode_kmap against its plain version (the shard's map from
    ops/options.shard_kmap), then encode_fields_resume from k_init against
    encode_fields_plain.  Returns (max_abs_err, kmap ms, resume ms, plain
    kmap ms)."""
    from libaec_tpu_torch.kernels import encode_cuda

    n_rsi = raw.numel() // cfg.rsi_len_bytes
    k0 = torch.tensor([min(k_init, max(cfg.kmax, 0))], dtype=torch.int32,
                      device=device)
    (kmap, scratch), kmap_ms = timed(
        lambda: encode_cuda.encode_kmap(cfg, raw), 20)
    want_map, plain_ms = timed(
        lambda: encode_cuda.encode_kmap_plain(cfg, raw), 3, warmup=1)
    got, resume_ms = timed(
        lambda: encode_cuda.encode_fields_resume(cfg, scratch, k0), 20)
    want = encode_cuda.encode_fields_plain(cfg, raw, k0)
    err = max(max_abs_err(kmap, want_map),
              *(max_abs_err(g, w) for g, w in zip(got, want)))
    if torch.equal(want_map.cpu(), torch.arange(32, dtype=want_map.dtype)):
        raise AssertionError(f"encode phases [{name}]: the data's map is "
                             "the identity, so a wrong map would not show")
    print(f"kernel encode_kmap + encode_fields_resume [{name}] "
          f"n_rsi={n_rsi} NB={got[0].shape[0]} k_init={int(k0)} "
          f"map={kmap.tolist()} k_final={int(got[2])} max_abs_err={err} "
          f"kmap_ms={kmap_ms:.4f} resume_ms={resume_ms:.4f} "
          f"plain_kmap_ms={plain_ms:.4f}")
    if err:
        raise AssertionError(f"encode phases differ from plain ({name})")
    return err, kmap_ms, resume_ms, plain_ms


def check_merge_kernel(name, cfg, win, block_bits, device):
    """Kernel 2 against its plain version at bit0 0..31 (a chunk merges
    at 0..7, a shard of the multi-GPU path at its offset modulo 32): the
    tail and the used prefix of the word buffer (the kernel writes no word
    past it).  Returns (max_abs_err, the median over bit0 0..7 of each
    bit0's median ms, the same of the plain version, the profiler's mean
    device ms of a call (both its launches) at bit0 5, the bound of the
    work the contract asks (the window words that hold bits and block_bits
    read, the used prefix written), the bound of the whole window array
    read and whole buffer written)."""
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda
    from libaec_tpu_torch.ops import bitpack

    NB, W = win.shape
    nwords = merge_cuda.word_count(cfg, NB, encode_cuda.window_words(cfg) - 1)
    worst, times, plain_times = 0, [], []
    for bit0 in range(32):
        b0 = torch.tensor([bit0], dtype=torch.int64, device=device)
        got, ms = timed(lambda: merge_cuda.merge_windows(
            win, block_bits, b0, nwords), 20)
        want, plain_ms = timed(lambda: bitpack.merge_windows(
            win, block_bits, b0, nwords), 3, warmup=1)
        used = merge_cuda.used_words(int(want[1][0]))
        err = max(max_abs_err(got[0][:used], want[0][:used]),
                  max_abs_err(got[1], want[1]))
        if bit0 < 8:
            print(f"kernel merge_windows [{name}] NB={NB} bit0={bit0} "
                  f"total_bits={int(got[1][0])} used_words={used} "
                  f"buffer_words={nwords} max_abs_err={err} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
            times.append(ms)
            plain_times.append(plain_ms)
        if err:
            raise AssertionError(f"merge kernel differs from plain at {bit0}"
                                 f" ({name})")
        worst = max(worst, err)
    print(f"kernel merge_windows [{name}] NB={NB} bit0=8..31 "
          f"max_abs_err={worst}")
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

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    results = []
    for kind, data in buffers:
        t0 = time.perf_counter()
        comp = lt.encode_buffer(data, cfg, device=device)
        secs = time.perf_counter() - t0
        results.append((kind, data, comp, secs))
    launches = read_counts()
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
    check_launched(f"{bps}-bit encode", launches, ENCODE_ROUTE)
    check_encode_launches(f"{bps}-bit encode", cfg, launches,
                          [len(data) for _, data in buffers])
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
    decode wrapper (nor a plain version) at all."""
    print(f"slice launches [{label}] chunks={chunks} {json.dumps(launches)}")
    if "plain_versions" in launches:
        PLAIN_CHECKS.append(label)
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

    bps, bsz = cfg.bits_per_sample, cfg.bytes_per_sample
    tag = f"{bps}-bit fused" if fused else f"{bps}-bit"

    def decode(comp, out_size):
        return lt.decode_buffer_status(comp, cfg, out_size, device=device,
                                       fused=fused)

    # warm-up: pinned slots, the allocator's pools, the worker threads
    decode(results[0][2], 64 << 20)

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    runs = []
    for kind, data, comp, _ in results:
        body = data[: len(data) // bsz * bsz]
        t0 = time.perf_counter()
        status, out = decode(comp, len(body))
        runs.append((kind, body, comp, status, out,
                     time.perf_counter() - t0))
    launches = read_decode_counts()
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
    chunk_rsis = decode_chunk_rsis(cfg)
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

    from libaec_tpu_torch import decode as decode_mod

    paces = []
    for kind, body, comp, _, _, _ in runs:
        with decode_timers() as spent:
            host_breakdown(f"decode {tag} {kind}",
                           lambda: decode(comp, len(body)), spent)
        paces.append(f"{kind} MiB={len(body) / 2**20:.0f} " + " ".join(
            f"{name}_ms={spent[step] * 1e3:.3f}" for name, step in (
                ("walk", "scan_main"), ("fill", "fill_fill"),
                ("store", "store_fetch"), ("touch", "touch_touch"))))
    # which host step sets the pipeline's pace (the walk, ideally)
    print(f"slice decode pipeline [{tag}] fill_threads="
          f"{decode_mod.FILL_THREADS} store_threads="
          f"{decode_mod.STORE_THREADS} | " + " | ".join(paces))
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

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = decode()
        secs = time.perf_counter() - t0
        launches = read_decode_counts()
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


# each kernel's plain version, (module, attribute) where its wrapper looks
# it up: on the card nothing of the main paths may call one
PLAIN_VERSIONS = [
    ("libaec_tpu_torch.kernels.encode_cuda", "encode_fields_plain"),
    ("libaec_tpu_torch.kernels.encode_cuda", "encode_kmap_plain"),
    ("libaec_tpu_torch.ops.bitpack", "merge_windows"),
    ("libaec_tpu_torch.kernels.decode_cuda", "decode_blocks_plain"),
    ("libaec_tpu_torch.kernels.unpredict_cuda", "unpredict_swizzle_plain"),
    ("libaec_tpu_torch.kernels.unpredict_cuda", "unpredict_rsis_plain"),
    ("libaec_tpu_torch.kernels.unpredict_cuda", "samples_to_bytes_plain"),
    ("libaec_tpu_torch.kernels.decode_fused_cuda",
     "decode_unpredict_swizzle_plain"),
]
PLAIN_CALLS = {}   # "module.attribute" -> calls since reset_counts
PLAIN_CHECKS = []  # the labels of the runs checked for plain calls


def count_plain_versions():
    """Wrap each of PLAIN_VERSIONS in a counter of its calls (once a
    process).  From then on read_counts reports their sum as
    "plain_versions", which check_launched and check_route hold to 0."""
    import importlib

    for mod_name, attr in PLAIN_VERSIONS:
        key = f"{mod_name.rsplit('.', 1)[1]}.{attr}"
        if key in PLAIN_CALLS:
            continue
        mod = importlib.import_module(mod_name)

        def counted(*args, _fn=getattr(mod, attr), _key=key, **kwargs):
            PLAIN_CALLS[_key] += 1
            return _fn(*args, **kwargs)

        PLAIN_CALLS[key] = 0
        setattr(mod, attr, counted)


def reset_counts():
    """Every kernel wrapper's launch count, and every plain version's
    call count, to 0."""
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda

    encode_cuda.launches = merge_cuda.launches = 0
    encode_cuda.kmap_launches = encode_cuda.resume_launches = 0
    for mod, attr in decode_counters().values():
        setattr(mod, attr, 0)
    for key in PLAIN_CALLS:
        PLAIN_CALLS[key] = 0


def read_counts():
    """Every kernel wrapper's launch count: {wrapper: count}; once
    count_plain_versions ran, also the plain versions' calls summed
    ("plain_versions")."""
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda

    counts = {"encode_fields": encode_cuda.launches,
              "encode_kmap": encode_cuda.kmap_launches,
              "encode_fields_resume": encode_cuda.resume_launches,
              "merge_windows": merge_cuda.launches,
              **{name: getattr(mod, attr)
                 for name, (mod, attr) in decode_counters().items()}}
    if PLAIN_CALLS:
        counts["plain_versions"] = sum(PLAIN_CALLS.values())
    return counts


def check_launched(label, counts, route):
    """Every wrapper of the route launched, and no other (no plain
    version either)."""
    print(f"slice launches [{label}] {json.dumps(counts)}")
    if "plain_versions" in counts:
        PLAIN_CHECKS.append(label)
    for name, count in counts.items():
        if (count > 0) != (name in route):
            raise AssertionError(f"{label}: {name} launched {count} times; "
                                 f"the route is {route}")


ENCODE_ROUTE = ["encode_fields", "merge_windows"]


def read_decode_counts():
    """read_counts of the decode wrappers (and of the plain versions)."""
    counts = read_counts()
    return {name: counts[name] for name in (*decode_counters(),
                                            "plain_versions")
            if name in counts}


def encode_chunks(cfg, n_bytes, rsis_per_chunk=None):
    """Launches of each of kernels 1 and 2 in one encode_buffer call on
    n_bytes on the card: one a chunk of whole RSIs, one for the short last
    RSI."""
    from libaec_tpu_torch.encode import default_rsis_per_chunk

    n_full, rem = divmod(n_bytes // cfg.bytes_per_sample,
                         cfg.samples_per_rsi)
    per = rsis_per_chunk or default_rsis_per_chunk(cfg)
    return -(-n_full // per) + (rem > 0)


def check_encode_launches(label, cfg, counts, sizes, rsis_per_chunk=None):
    """Each of kernels 1 and 2 launched once for each chunk and each short
    last RSI of encode_buffer calls on buffers of `sizes` bytes."""
    want = sum(encode_chunks(cfg, n, rsis_per_chunk) for n in sizes)
    for name in ENCODE_ROUTE:
        if counts[name] != want:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, expected {want} (the chunks and "
                                 f"the short last RSIs)")


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
    check_launched("sz compress 64 MiB", read_counts(), ENCODE_ROUTE)
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
        check_launched(f"sz batch, {tag}", read_counts(),
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
    check_launched("sz decompress 64 MiB", read_counts(),
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
        check_launched(f"sz batch, {label}", read_counts(),
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
    counts = read_counts()
    if comp != native.encode(data, cfg)[1]:
        raise AssertionError("stream encode differs from native.encode")
    print(f"slice aec_encode [{cfg.bits_per_sample}-bit stream, "
          f"{len(pieces)} pieces 1 KiB-4 MiB, drained by 64 KiB] "
          f"bytes={len(data)} seconds={secs:.4f} "
          f"MiB/s={len(data) / secs / 2**20:.2f} "
          f"identical_to_native=True")
    check_launched("stream encode", counts, ENCODE_ROUTE)
    # one launch a call that completes an RSI, one for the short last RSI
    held, calls = 0, 0
    for piece in pieces:
        held += len(piece)
        calls += held >= cfg.rsi_len_bytes
        held %= cfg.rsi_len_bytes
    calls += held >= cfg.bytes_per_sample
    for name in ENCODE_ROUTE:
        if counts[name] != calls:
            raise AssertionError(f"stream encode: {name} launched "
                                 f"{counts[name]} times, expected {calls}")
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
            reset_counts()
            t1 = time.perf_counter()
            if cli.main(args) != 0:
                raise AssertionError(f"cli.main {op} [{label}] failed")
            in_secs = time.perf_counter() - t1
            check_launched(f"cli.main {op} [{label}]", read_counts(), route)
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


def mesh_worlds():
    """Phase 16's runs, (backend, ranks): NCCL over the cards (at most 8;
    one rank on a single card, where the collectives still run), then 2
    and 4 gloo ranks sharing card 0 (NCCL refuses two ranks on one
    card)."""
    return [("nccl", min(torch.cuda.device_count(), 8)), ("gloo", 2),
            ("gloo", 4)]


# each rank's launches on phase 16: kernel 1's two phases and kernel 2
# once (two CUDA launches each), kernels 3 and 4 once on its one chunk
MESH_ROUTE = {"encode_kmap": 1, "encode_fields_resume": 1,
              "merge_windows": 1, "decode_blocks": 1,
              "unpredict_swizzle": 1}


def mesh_rank(device, path, cfg_args, per, launched):
    """One rank of phase 16, started by dryrun.run_ranks at time.time()
    `launched`: the sharded encode of its shard of the stream bytes in
    `path` and the assembly (on the device, held against assemble_host),
    then its decode (held against its shard).  Returns its times (with
    the seconds from `launched` to the rank's start, process group joined,
    and those of its warm-up, to its first kernels done), its launch
    counts on each part and the stream's digest."""
    import hashlib

    import torch.distributed as dist

    from libaec_tpu_torch import Config
    from libaec_tpu_torch.parallel import dist as mesh
    from libaec_tpu_torch.parallel import dryrun

    start_s = time.time() - launched
    count_plain_versions()
    cfg = Config(*cfg_args)
    world = dist.get_world_size()
    raw = np.fromfile(path, np.uint8, world * per * cfg.rsi_len_bytes)
    # warm-up: the communicator, the kernels' module, the allocator
    t0 = time.time()
    small = raw[:world * cfg.rsi_len_bytes]
    stream = dryrun.mesh_encode_case(cfg, small, 1, device,
                                     reference=False)["stream"]
    dryrun.mesh_decode_case(cfg, stream, small, 1, device)
    warmup_s = time.time() - t0

    reset_counts()
    enc = dryrun.mesh_encode_case(cfg, raw, per, device, reference=False)
    enc_counts = read_counts()
    reset_counts()
    c0 = mesh.collective_seconds
    _, decode_s = dryrun.mesh_decode_case(cfg, enc["stream"], raw, per,
                                          device)
    return {"start_s": start_s, "warmup_s": warmup_s,
            "encode_s": enc["encode_s"], "assemble_s": enc["assemble_s"],
            "encode_collective_s": enc["encode_collective_s"],
            "assemble_collective_s": enc["assemble_collective_s"],
            "decode_s": decode_s,
            "decode_collective_s": mesh.collective_seconds - c0,
            "counts": {name: enc_counts[name] + count
                       for name, count in read_counts().items()},
            "digest": hashlib.sha256(enc["stream"]).hexdigest(),
            "stream_bytes": len(enc["stream"])}


def run_mesh(cfg, device, seed, smi, mib=SLICE_MIB):
    """16. The multi-GPU path (libaec_tpu_torch.parallel) on `mib` MiB of
    `lowentropy` samples split over the ranks, under NCCL and under gloo
    at 2 and 4 ranks sharing the card (mesh_worlds): each run's stream
    identical to native.encode of the buffer and its decode to the input,
    each rank's launches as MESH_ROUTE; beside them one-device
    encode_buffer and decode_buffer_status on the same buffer.  Returns
    the launches summed over the runs and ranks."""
    import hashlib
    from functools import partial

    import gen

    import libaec_tpu_torch as lt
    from libaec_tpu_torch import native
    from libaec_tpu_torch.parallel import dryrun

    bps = cfg.bits_per_sample
    rng = np.random.default_rng(seed)
    raw = pack_samples(gen.gen_values(rng, (mib << 20) // cfg.bytes_per_sample,
                                      bps, cfg.signed, "lowentropy"),
                       bps, cfg.flags)
    n_rsi = len(raw) // cfg.rsi_len_bytes
    mib_of = len(raw) / 2**20
    lt.encode_buffer(raw[: 64 << 20], cfg, device=device)  # warm-up
    t0 = time.perf_counter()
    comp = lt.encode_buffer(raw, cfg, device=device)
    one_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    status, back = lt.decode_buffer_status(comp, cfg, len(raw), device=device)
    one_dec = time.perf_counter() - t0
    want = native.encode(raw, cfg)[1]
    if comp != want or status or back != raw:
        raise AssertionError("one-device round trip differs from native")
    print(f"mesh one-device [{bps}-bit lowentropy] bytes={len(raw)} "
          f"encode_buffer MiB/s={mib_of / one_enc:.2f} "
          f"decode_buffer_status MiB/s={mib_of / one_dec:.2f} "
          f"ratio={len(raw) / len(comp):.4f} on {smi}")
    del comp, back
    torch.cuda.empty_cache()

    totals = defaultdict(int)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        path = Path(tmp) / "raw.bin"
        path.write_bytes(raw)
        for backend, world in mesh_worlds():
            per = n_rsi // world
            size = world * per * cfg.rsi_len_bytes
            ref = want if size == len(raw) else native.encode(
                raw[:size], cfg)[1]
            t0 = time.perf_counter()
            ranks = dryrun.run_ranks(
                world, backend, "cuda",
                partial(mesh_rank, path=str(path), cfg_args=(
                    bps, cfg.block_size, cfg.rsi, cfg.flags), per=per,
                    launched=time.time()), 900)
            wall = time.perf_counter() - t0
            label = f"{backend} x{world}"
            digest = hashlib.sha256(ref).hexdigest()
            if any(r["digest"] != digest for r in ranks):
                raise AssertionError(f"mesh [{label}]: stream differs from "
                                     "native.encode")
            for rank, r in enumerate(ranks):
                want_counts = {name: MESH_ROUTE.get(name, 0)
                               for name in r["counts"]}
                if r["counts"] != want_counts:
                    raise AssertionError(
                        f"mesh [{label}] rank {rank}: launches "
                        f"{r['counts']}, expected {want_counts}")
                for name, count in r["counts"].items():
                    totals[name] += count
            enc = max(r["encode_s"] for r in ranks)
            asm = max(r["assemble_s"] for r in ranks)
            dec = max(r["decode_s"] for r in ranks)
            coll = max(r["encode_collective_s"] + r["assemble_collective_s"]
                       for r in ranks)
            dec_coll = max(r["decode_collective_s"] for r in ranks)
            print(f"mesh [{label}] bytes={size} "
                  f"stream_bytes={ranks[0]['stream_bytes']} "
                  f"RSIs_per_rank={per} encode_seconds={enc:.4f} "
                  f"encode MiB/s={size / 2**20 / enc:.2f} "
                  f"assemble_seconds={asm:.4f} "
                  f"encode+assemble MiB/s={size / 2**20 / (enc + asm):.2f} "
                  f"collectives_seconds={coll:.4f} "
                  f"collectives_share={coll / (enc + asm):.4f} "
                  f"decode_seconds={dec:.4f} "
                  f"decode MiB/s={size / 2**20 / dec:.2f} "
                  f"decode_collectives_seconds={dec_coll:.4f} "
                  f"ranks_wall_seconds={wall:.2f} "
                  f"rank_start_seconds={max(r['start_s'] for r in ranks):.4f} "
                  f"rank_warmup_seconds="
                  f"{max(r['warmup_s'] for r in ranks):.4f} "
                  f"identical_to_native=True "
                  f"decode_identical_to_input=True on {smi}")
            print(f"slice launches [mesh {label}, each rank] "
                  f"{json.dumps(ranks[0]['counts'])}")
    return dict(totals)


def sar32bit_config():
    """CCSDS 121.0-B-2's ExtendedParameters sar32bit, `aec -n32 -j64
    -r4096 -p` (libaec's tests/sampledata.sh): 32-bit samples, blocks of
    64, RSIs of 4096 blocks (1 MiB), preprocessing and AEC_PAD_RSI; MSB
    first, as tests/test_pad_rsi.py takes it."""
    from libaec_tpu_torch import (AEC_DATA_MSB, AEC_DATA_PREPROCESS,
                                  AEC_PAD_RSI, Config)

    return Config(32, 64, 4096, AEC_DATA_MSB | AEC_DATA_PREPROCESS
                  | AEC_PAD_RSI)


def restricted_config(bps=2):
    """CCSDS AllOptions n = 1, 2 restricted (`aec -n2 -j16 -r64 -t`, as
    tests/test_conformance.py codes it): id_len 1, no split option."""
    from libaec_tpu_torch import AEC_DATA_PREPROCESS, AEC_RESTRICTED, Config

    return Config(bps, 16, 64, AEC_RESTRICTED | AEC_DATA_PREPROCESS)


def sz_small_param(ppb):
    """H5Pset_szip(NN, ppb) on rows of 1024 16-bit pixels, MSB first: the
    scanline is cut to szlib's SZ_MAX_BLOCKS_PER_SCANLINE blocks (512
    pixels at 4 a block)."""
    from libaec_tpu_torch import szip

    return szip.SZCom(szip.SZ_MSB_OPTION_MASK | szip.SZ_NN_OPTION_MASK, 16,
                      ppb, min(1024, szip.SZ_MAX_BLOCKS_PER_SCANLINE * ppb))


def wide_kernel_configs():
    """Phase 17's kernel checks: (name, config, hold kernel 4 too, or for
    3-byte samples kernel 5 and kernel 4's byte layout)."""
    from libaec_tpu_torch import (AEC_DATA_3BYTE, AEC_DATA_PREPROCESS,
                                  AEC_NOT_ENFORCE, Config)

    return [
        ("sar32bit 32-bit MSB pp PAD_RSI bs64 rsi4096", sar32bit_config(),
         False),
        ("restricted 2-bit pp bs16 rsi64", restricted_config(2), False),
        ("restricted 1-bit pp bs16 rsi64", restricted_config(1), False),
        *((f"SZ ppb {ppb} 16-bit MSB NN pps "
           f"{sz_small_param(ppb).pixels_per_scanline}",
           param_cfg(sz_small_param(ppb)), ppb == 2) for ppb in (2, 4, 6)),
        ("8-bit pp NOT_ENFORCE bs2 rsi1, RSIs of 2 samples",
         Config(8, 2, 1, AEC_NOT_ENFORCE | AEC_DATA_PREPROCESS), True),
        ("24-bit 3-byte pp NOT_ENFORCE bs2 rsi1, RSIs of 2 samples",
         Config(24, 2, 1, AEC_NOT_ENFORCE | AEC_DATA_PREPROCESS
                | AEC_DATA_3BYTE), True),
    ]


def run_wide_kernels(device):
    """17a. Kernel 1 (and, for sar32bit, its two phases), kernel 3 and at
    blocks of 2 samples kernel 4 against their plain versions on data of
    every tests/gen.py kind, at the chunks the main paths give each of
    wide_kernel_configs (for 3-byte samples kernel 5, kernel 4's byte
    layout and kernel 4 in one pass).  Prints each config's kernel 1 and 3
    ms beside their bounds (bytes once over the card's memory rate).
    Returns (kernel 1's, 3's, 4's and 5's max_abs_err)."""
    from libaec_tpu_torch import native
    from libaec_tpu_torch.encode import default_rsis_per_chunk

    err1 = err3 = err4 = err5 = 0
    for name, cfg, hold4 in wide_kernel_configs():
        n_enc = default_rsis_per_chunk(cfg)
        got, e1, ms1, plain1 = check_encode_kernel(name, cfg, n_enc, device,
                                                   passes=True)
        NB, W0 = got[0].shape
        bytes1 = n_enc * cfg.rsi_len_bytes + 4 * NB * (W0 + 1) + 8
        err1 = max(err1, e1)
        if cfg.pad_rsi:
            raw = torch.from_numpy(np.frombuffer(chunk_data(
                cfg, n_enc, seed=n_enc + 1), np.uint8).copy()).to(device)
            err1 = max(err1, check_encode_phases(name, cfg, raw, device)[0])
            del raw
        del got
        raw = chunk_data(cfg, decode_chunk_rsis(cfg),
                         cfg.bits_per_sample + 2)
        rows, deltas, comp, _ = check_decode_kernel(name, cfg, raw, device,
                                                    profile=True)
        err3 = max(err3, *(r[1] for r in rows))
        wf, _, ms3, plain3, bound3, device3, _ = rows[0]
        if hold4 and cfg.bytes_per_sample == 3:
            e5, _, _, le = check_unpredict_rsis_kernel(
                name, cfg, deltas.view(-1, cfg.samples_per_rsi),
                native.decode(comp, len(raw), cfg)[1])
            err4, err5 = max(err4, le), max(err5, e5)
        elif hold4:
            e4, _, _ = check_unpredict_kernel(name, cfg, raw, deltas, comp,
                                              device)
            err4 = max(err4, e4)
        print(f"wide kernels [{name}] encode_fields NB={NB} ms={ms1:.4f} "
              f"plain_ms={plain1:.4f} bound_ms={bound_ms(bytes1, 0)[0]:.4f}"
              f" (bytes) | decode_blocks NB={deltas.shape[0]} Wf={wf} "
              f"ms={ms3:.4f} device_ms={device3:.4f} plain_ms={plain3:.4f}"
              f" bound_ms={bound3[0]:.4f} ({bound3[1]}; words parsed)")
        del deltas
        torch.cuda.empty_cache()
    return err1, err3, err4, err5


def run_wide_path(label, cfg, data, device, smi):
    """17b. encode_buffer and decode_buffer_status on the card over
    `data`, held against native.encode, native.decode and the input, each
    beside the native codec's MiB/s on the same buffer; each direction's
    launches held to its route.  Returns the launches of both."""
    import libaec_tpu_torch as lt
    from libaec_tpu_torch import native

    body = data[: len(data) // cfg.bytes_per_sample * cfg.bytes_per_sample]
    mib = len(data) / 2**20
    warm = data[: 8 * cfg.rsi_len_bytes]  # the pools, pinned buffers
    lt.decode_buffer_status(lt.encode_buffer(warm, cfg, device=device,
                                             force_device=True),
                            cfg, len(warm), device=device, force_device=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = lt.encode_buffer(data, cfg, device=device)
    enc_s = time.perf_counter() - t0
    enc_counts = read_counts()
    t0 = time.perf_counter()
    status, want = native.encode(data, cfg)
    native_enc_s = time.perf_counter() - t0
    if status or comp != want:
        raise AssertionError(f"{label}: stream differs from native.encode")
    reset_counts()
    t0 = time.perf_counter()
    got = lt.decode_buffer_status(comp, cfg, len(body), device=device)
    dec_s = time.perf_counter() - t0
    dec_counts = read_counts()
    t0 = time.perf_counter()
    want = native.decode(comp, len(body), cfg)
    native_dec_s = time.perf_counter() - t0
    if got != want or got != (0, body):
        raise AssertionError(f"{label}: decode differs from native.decode "
                             "or the input")
    check_launched(f"{label} encode", enc_counts, ENCODE_ROUTE)
    check_encode_launches(f"{label} encode", cfg, enc_counts, [len(data)])
    check_launched(f"{label} decode", dec_counts, decode_route(cfg, False))
    print(f"slice wide [{label}] bytes={len(data)} stream_bytes={len(comp)} "
          f"ratio={len(data) / len(comp):.4f} "
          f"encode_buffer MiB/s={mib / enc_s:.2f} "
          f"native.encode MiB/s={mib / native_enc_s:.2f} "
          f"decode_buffer_status MiB/s={mib / dec_s:.2f} "
          f"native.decode MiB/s={mib / native_dec_s:.2f} "
          f"identical_to_native=True identical_to_input=True on {smi}")
    return {name: enc_counts[name] + dec_counts[name] for name in enc_counts}


def run_sz_small_blocks(device, seed, smi, ppb=4, n_chunks=128):
    """17c. The SZ layer at `ppb` pixels a block (H5Pset_szip's smallest
    even sizes, AEC_NOT_ENFORCE blocks under 8): n_chunks HDF5 chunks of
    1 MiB of 16-bit pixels, each compressed on the card (force_device:
    a chunk is under the 4 MiB threshold) and held against the C szlib
    surface, then all decompressed by sz_decompress_batch on the card and
    held against the input; beside the C surface's compress and the
    per-chunk native decompress.  Returns the launches of both."""
    from libaec_tpu_torch import szip

    param = sz_small_param(ppb)
    cfg = param_cfg(param)
    rng = np.random.default_rng(seed)
    chunks = sz_chunks(rng, n_chunks, 16, True)
    mib = sum(len(c) for c in chunks) / 2**20
    t0 = time.perf_counter()
    want = [c_sz_compress(c, param) for c in chunks]
    native_enc_s = time.perf_counter() - t0
    szip.sz_buffto_buff_compress(chunks[0], param, device=device,
                                 force_device=True)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = [szip.sz_buffto_buff_compress(c, param, device=device,
                                          force_device=True) for c in chunks]
    enc_s = time.perf_counter() - t0
    enc_counts = read_counts()
    if comps != want:
        raise AssertionError(f"SZ ppb {ppb}: streams differ from the C "
                             "surface")
    sizes = [len(c) for c in chunks]
    t0 = time.perf_counter()
    singles = [szip.sz_buffto_buff_decompress(c, param, n, device=device)
               for c, n in zip(comps, sizes)]  # native: under 16 MiB
    native_dec_s = time.perf_counter() - t0
    szip.sz_decompress_batch(comps[:8], param, sizes[:8], device=device)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = szip.sz_decompress_batch(comps, param, sizes, device=device)
    dec_s = time.perf_counter() - t0
    dec_counts = read_counts()
    if not batch == singles == chunks:
        raise AssertionError(f"SZ ppb {ppb}: sz_decompress_batch differs "
                             "from the per-chunk decompress or the input")
    check_launched(f"sz ppb {ppb} compress", enc_counts, ENCODE_ROUTE)
    check_encode_launches(f"sz ppb {ppb} compress", cfg, enc_counts,
                          [len(c) for c in chunks])
    check_launched(f"sz ppb {ppb} batch", dec_counts,
                   decode_route(cfg, False))
    print(f"slice wide [SZ ppb {ppb} pps {param.pixels_per_scanline}, "
          f"{n_chunks} x 1 MiB] bytes={sum(sizes)} "
          f"ratio={sum(sizes) / sum(len(c) for c in comps):.4f} "
          f"sz_buffto_buff_compress (card, per chunk) MiB/s="
          f"{mib / enc_s:.2f} C SZ_BufftoBuffCompress MiB/s="
          f"{mib / native_enc_s:.2f} sz_decompress_batch MiB/s="
          f"{mib / dec_s:.2f} per_chunk_native_decompress MiB/s="
          f"{mib / native_dec_s:.2f} identical_to_c_szlib=True "
          f"identical_to_input=True on {smi}")
    return {name: enc_counts[name] + dec_counts[name] for name in enc_counts}


def large_block_configs():
    """Phase 18's configs, blocks over 64 samples (AEC_NOT_ENFORCE, the
    kernels' wide paths): 16-bit MSB samples with preprocessing at 128
    samples a block and RSIs of 128 blocks, and at 1024 and RSIs of 16
    (16 Ki samples an RSI, as the bench config); 32-bit samples with
    preprocessing at 16384 samples a block, an RSI of one block (the shape
    of VERDICT.md's repro)."""
    from libaec_tpu_torch import (AEC_DATA_MSB, AEC_DATA_PREPROCESS,
                                  AEC_NOT_ENFORCE, Config)

    ne, pp, msb = AEC_NOT_ENFORCE, AEC_DATA_PREPROCESS, AEC_DATA_MSB
    return [("16-bit MSB pp bs128 rsi128",
             Config(16, 128, 128, ne | pp | msb)),
            ("16-bit MSB pp bs1024 rsi16",
             Config(16, 1024, 16, ne | pp | msb)),
            ("32-bit pp bs16384 rsi1", Config(32, 16384, 1, ne | pp))]


def encode_bound(cfg, nb, w0):
    """Kernel 1's bound on nb blocks: raw bytes and k read, windows, bit
    lengths and k written; per sample ~28 integer operations and two for
    each of the kmax + 1 split options."""
    samples = nb * cfg.block_size
    return bound_ms(samples * cfg.bytes_per_sample + 4 + 4 * nb * (w0 + 1)
                    + 4, samples * (28 + 2 * max(cfg.kmax + 1, 0)))


def unpredict_bound(cfg, n):
    """Kernel 4's bound on n samples: deltas read, bytes written; ~12
    integer operations a sample and one for each byte laid out."""
    bsz = cfg.bytes_per_sample
    return bound_ms(n * (4 + bsz), n * (12 + bsz))


def run_large_kernels(device):
    """18a. Kernels 1 (and its two phases), 2, 3 and 4 against their plain
    versions at the main paths' chunks of each of large_block_configs, on
    data of every tests/gen.py kind, each kernel's ms beside its plain ms
    and its bound (one `large blocks` line a config); then kernel 4 on
    RSIs of 4 Mi samples (1024 samples a block, RSIs of 4096 blocks: a
    warp an RSI), held against native.decode (its plain version, a loop
    over each RSI's samples, would take minutes).  Returns each kernel's
    max_abs_err."""
    from libaec_tpu_torch import (AEC_DATA_MSB, AEC_DATA_PREPROCESS,
                                  AEC_NOT_ENFORCE, Config, native)
    from libaec_tpu_torch.encode import default_rsis_per_chunk
    from libaec_tpu_torch.kernels import unpredict_cuda

    errs = defaultdict(int)
    for name, cfg in large_block_configs():
        n_enc = default_rsis_per_chunk(cfg)
        got, e1, ms1, plain1 = check_encode_kernel(name, cfg, n_enc, device,
                                                   passes=True)
        NB, W0 = got[0].shape
        bound1 = encode_bound(cfg, NB, W0)
        e2, ms2, plain2, _, bound2, _ = check_merge_kernel(
            name, cfg, got[0], got[1], device)
        del got
        raw = torch.from_numpy(np.frombuffer(chunk_data(
            cfg, max(2, n_enc // 4), seed=n_enc + 1), np.uint8).copy()).to(
            device)
        e1 = max(e1, check_encode_phases(name, cfg, raw, device)[0])
        del raw
        raw = chunk_data(cfg, decode_chunk_rsis(cfg), cfg.bits_per_sample + 2)
        rows, deltas, comp, _ = check_decode_kernel(name, cfg, raw, device,
                                                    profile=True)
        wf, _, ms3, plain3, bound3, device3, _ = rows[0]
        e4, ms4, plain4 = check_unpredict_kernel(name, cfg, raw, deltas, comp,
                                                 device)
        bound4 = unpredict_bound(cfg, deltas.numel())
        for kernel, err in (("encode_fields", e1), ("merge_windows", e2),
                            ("decode_blocks", max(r[1] for r in rows)),
                            ("unpredict_swizzle", e4)):
            errs[kernel] = max(errs[kernel], err)
        print(f"large blocks [{name}] encode_fields NB={NB} W0={W0} "
              f"ms={ms1:.4f} plain_ms={plain1:.4f} "
              f"bound_ms={bound1[0]:.4f} ({bound1[1]}) | merge_windows "
              f"ms={ms2:.4f} plain_ms={plain2:.4f} bound_ms={bound2[0]:.4f}"
              f" ({bound2[1]}) | decode_blocks NB={deltas.shape[0]} Wf={wf} "
              f"ms={ms3:.4f} device_ms={device3:.4f} plain_ms={plain3:.4f}"
              f" bound_ms={bound3[0]:.4f} ({bound3[1]}) | unpredict_swizzle"
              f" S={cfg.samples_per_rsi} ms={ms4:.4f} plain_ms={plain4:.4f}"
              f" bound_ms={bound4[0]:.4f} ({bound4[1]})")
        del deltas
        torch.cuda.empty_cache()

    cfg = Config(16, 1024, 4096, AEC_NOT_ENFORCE | AEC_DATA_MSB
                 | AEC_DATA_PREPROCESS)
    raw = chunk_data(cfg, 2, 19)
    rows, deltas, comp, _ = check_decode_kernel(
        "16-bit MSB pp bs1024 rsi4096", cfg, raw, device)
    errs["decode_blocks"] = max(errs["decode_blocks"], *(r[1] for r in rows))
    d = deltas.view(-1, cfg.samples_per_rsi)
    got, ms = timed(lambda: unpredict_cuda.unpredict_swizzle(cfg, d), 5)
    status, want = native.decode(comp, len(raw), cfg)
    if status or got.cpu().numpy().tobytes() != want:
        raise AssertionError("kernel 4 on RSIs of 4 Mi samples differs from "
                             "native.decode")
    bound = unpredict_bound(cfg, d.numel())
    print(f"kernel unpredict_swizzle [16-bit MSB pp bs1024 rsi4096] "
          f"n_rsi={d.shape[0]} S={d.shape[1]} identical_to_native=True "
          f"ms={ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]})")
    return errs


def run_large_rsi(device, smi):
    """18c. One RSI of 64 Mi samples (32-bit samples, 16384 a block, RSIs
    of 4096 blocks: 256 MiB, so that a chunk of each path is one RSI)
    through encode_buffer and decode_buffer_status, held against
    native.encode and the input, with the device memory each call takes
    at its peak.  Returns the launches."""
    import libaec_tpu_torch as lt
    from libaec_tpu_torch import (AEC_DATA_PREPROCESS, AEC_NOT_ENFORCE,
                                  Config, native)

    cfg = Config(32, 16384, 4096, AEC_NOT_ENFORCE | AEC_DATA_PREPROCESS)
    data = wide_data(cfg, cfg.samples_per_rsi, 20261030,
                     ("lowentropy", "midentropy", "random"))
    want = native.encode(data, cfg)[1]
    counts = defaultdict(int)
    for step in ("encode", "decode"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        if step == "encode":
            ok = lt.encode_buffer(data, cfg, device=device) == want
        else:
            ok = lt.decode_buffer_status(want, cfg, len(data),
                                         device=device) == (0, data)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) - base
        for name, count in read_counts().items():
            counts[name] += count
        if not ok:
            raise AssertionError(f"one RSI of 64 Mi samples: {step} differs "
                                 "from native or the input")
        print(f"slice large [one RSI of {cfg.samples_per_rsi} samples, "
              f"32-bit bs16384 rsi4096] {step} bytes={len(data)} "
              f"seconds={secs:.4f} peak_device_MiB={peak / 2**20:.1f} "
              f"identical=True on {smi}")
    check_launched("one RSI of 64 Mi samples", counts,
                   ENCODE_ROUTE + decode_route(cfg, False))
    return counts


def short_rsi_configs():
    """Phase 19's configs: the bench config, 24-bit samples in 3 bytes,
    sar32bit (AEC_PAD_RSI), SZIP's blocks of 4 pixels and blocks of 1024
    samples (kernel 1's wide path)."""
    from libaec_tpu_torch import (AEC_DATA_3BYTE, AEC_DATA_MSB,
                                  AEC_DATA_PREPROCESS, Config)

    msb, pp = AEC_DATA_MSB, AEC_DATA_PREPROCESS
    return [("bench 16-bit MSB pp bs64 rsi256", Config(16, 64, 256, msb | pp)),
            ("24-bit MSB pp 3-byte bs64 rsi256",
             Config(24, 64, 256, msb | pp | AEC_DATA_3BYTE)),
            ("sar32bit 32-bit MSB pp PAD_RSI bs64 rsi4096",
             sar32bit_config()),
            ("SZ ppb 4 16-bit MSB NN pps 512", param_cfg(sz_small_param(4))),
            large_block_configs()[1]]


def short_rsi_data(cfg, nb, seed):
    """Stream bytes of a short last RSI of nb blocks: its last block short
    of a random number of samples (at nb 1, of all but one: a tail of one
    sample), every tests/gen.py kind in turn."""
    import gen

    rng = np.random.default_rng(seed)
    bs = cfg.block_size
    n = 1 if nb == 1 else nb * bs - int(rng.integers(0, bs))
    per = -(-n // len(gen.KINDS))
    vals = np.concatenate([gen.gen_values(rng, per, cfg.bits_per_sample,
                                          cfg.signed, kind)
                           for kind in gen.KINDS])[:n]
    return np.frombuffer(pack_samples(vals, cfg.bits_per_sample, cfg.flags),
                         np.uint8)


def run_short_rsi_kernels(device):
    """19a. Kernels 1 and 2 on a stream's short last RSI as encode_tail
    gives it to them (encode.pad_tail: nb blocks, the last filled with
    repeats of the last sample; to kernel 1 a chunk of one RSI of nb
    blocks), at nb 1, 2 and rsi - 1 of each of short_rsi_configs, from k
    3 (kmax where lower) and at bit cursor 5, against their plain
    versions on the same inputs.  Returns (kernel 1's and 2's max_abs_err,
    the median ms of each over the cases)."""
    from libaec_tpu_torch.encode import pad_tail
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda
    from libaec_tpu_torch.ops import bitpack

    err1 = err2 = 0
    times1, times2 = [], []
    for i, (name, cfg) in enumerate(short_rsi_configs()):
        for nb in sorted({1, 2, cfg.rsi - 1}):
            raw, got_nb = pad_tail(cfg, short_rsi_data(cfg, nb, 19 * i + nb))
            assert got_nb == nb
            raw = torch.from_numpy(raw).to(device)
            k0 = torch.tensor([min(3, max(cfg.kmax, 0))], dtype=torch.int32,
                              device=device)
            got, ms1 = timed(lambda: encode_cuda.encode_fields(
                cfg, raw, k0, nb=nb), 20)
            want, plain1 = timed(lambda: encode_cuda.encode_fields_plain(
                cfg, raw, k0, nb=nb), 3, warmup=1)
            e1 = max(max_abs_err(g, w) for g, w in zip(got, want))
            win, block_bits, _ = got
            W0 = win.shape[1]
            nwords = merge_cuda.word_count(cfg, nb, W0 - 1)
            b0 = torch.tensor([5], dtype=torch.int64, device=device)
            (words, tail), ms2 = timed(lambda: merge_cuda.merge_windows(
                win, block_bits, b0, nwords), 20)
            (pwords, ptail), plain2 = timed(lambda: bitpack.merge_windows(
                win, block_bits, b0, nwords), 3, warmup=1)
            used = merge_cuda.used_words(int(ptail[0]))
            e2 = max(max_abs_err(words[:used], pwords[:used]),
                     max_abs_err(tail, ptail))
            bound1 = encode_bound(cfg, nb, W0)
            held = int(((block_bits.to(torch.int64) + 31) // 32).sum())
            bound2 = bound_ms(4 * (held + nb + used) + 8 + 16, 4 * held)
            print(f"short rsi [{name}] nb={nb} samples_padded="
                  f"{nb * cfg.block_size} k_init={int(k0)} "
                  f"k_final={int(got[2])} total_bits={int(tail[0])} | "
                  f"encode_fields max_abs_err={e1} ms={ms1:.4f} "
                  f"plain_ms={plain1:.4f} bound_ms={bound1[0]:.3e} "
                  f"({bound1[1]}) | merge_windows bit0=5 max_abs_err={e2} "
                  f"ms={ms2:.4f} plain_ms={plain2:.4f} "
                  f"bound_ms={bound2[0]:.3e} ({bound2[1]})")
            if e1 or e2:
                raise AssertionError(f"short rsi [{name}] nb={nb}: kernels "
                                     "differ from their plain versions")
            err1, err2 = max(err1, e1), max(err2, e2)
            times1.append(ms1)
            times2.append(ms2)
    return err1, err2, statistics.median(times1), statistics.median(times2)


def run_short_rsi_paths(device, smi, seed, mib=8):
    """19b. The encode entry points on the card over buffers that end in a
    short last RSI of one sample, of one block less a sample and of rsi -
    1 blocks, after several chunks of `mib` MiB in all, at each of
    short_rsi_configs:
    encode_buffer (held against native.encode; its launches one a chunk
    and one for the tail), encode_buffer_status, the stream in uneven
    pieces (a launch a call that completes an RSI and one at AEC_FLUSH);
    and the SZ compress of chunks of 1 MiB less a scanline and a half,
    held against the C szlib surface (the SZ layer pads every scanline to
    a whole RSI, sz_compat.c:71-94, so its buffer ends in none: a launch
    a chunk).  No plain version runs.  Returns the launches."""
    import libaec_tpu_torch as lt
    from libaec_tpu_torch import AEC_FLUSH, AEC_NO_FLUSH, native, stream
    from libaec_tpu_torch import szip

    rng = np.random.default_rng(seed)
    totals = defaultdict(int)

    def add(counts):
        for name, count in counts.items():
            totals[name] += count

    for name, cfg in short_rsi_configs():
        L, bsz = cfg.rsi_len_bytes, cfg.bytes_per_sample
        n_full = max(6, (mib << 20) // L)
        per = n_full // 3
        body = wide_data(cfg, n_full * cfg.samples_per_rsi,
                         int(rng.integers(1 << 30)),
                         ("lowentropy", "midentropy", "zero_runs", "random"))
        for tail, rem in (("one sample", 1),
                          ("a block less a sample", cfg.block_size - 1),
                          ("rsi - 1 blocks", (cfg.rsi - 1) * cfg.block_size)):
            data = body + body[L:L + rem * bsz] + b"\x01"[:bsz - 1]
            want = native.encode(data, cfg)[1]
            label = f"{name}, tail of {tail}"
            reset_counts()
            t0 = time.perf_counter()
            got = lt.encode_buffer(data, cfg, device=device,
                                   force_device=True, rsis_per_chunk=per)
            secs = time.perf_counter() - t0
            counts = read_counts()
            if got != want:
                raise AssertionError(f"short rsi [{label}]: encode_buffer "
                                     "differs from native.encode")
            check_launched(f"short rsi encode_buffer [{label}]", counts,
                           ENCODE_ROUTE)
            check_encode_launches(label, cfg, counts, [len(data)], per)
            add(counts)
            print(f"slice short rsi [encode_buffer {label}] "
                  f"bytes={len(data)} chunks={-(-n_full // per)} "
                  f"seconds={secs:.4f} identical_to_native=True on {smi}")
        reset_counts()
        status, got = lt.encode_buffer_status(data, cfg, len(want),
                                              device=device,
                                              force_device=True)
        counts = read_counts()
        if (status, got) != (0, want):
            raise AssertionError(f"short rsi [{name}]: encode_buffer_status "
                                 "differs from native.encode")
        check_launched(f"short rsi encode_buffer_status [{name}]", counts,
                       ENCODE_ROUTE)
        add(counts)

        s = stream.AecStream(cfg.bits_per_sample, cfg.block_size, cfg.rsi,
                             cfg.flags, device=device)
        stream.aec_encode_init(s)
        reset_counts()
        cuts = sorted(int(c) for c in rng.integers(0, len(data), 5))
        calls, held = 0, 0
        for a, b in zip([0] + cuts, cuts + [len(data)]):
            s.next_in, s.avail_in = data[a:b], None
            stream.aec_encode(s, AEC_NO_FLUSH)
            held += b - a
            calls += held >= L
            held %= L
        s.next_in, s.avail_in = b"", None
        stream.aec_encode(s, AEC_FLUSH)
        counts = read_counts()
        if stream.aec_encode_end(s) != 0 or bytes(s.next_out) != want:
            raise AssertionError(f"short rsi [{name}]: the stream differs "
                                 "from native.encode")
        check_launched(f"short rsi stream [{name}]", counts, ENCODE_ROUTE)
        if counts["encode_fields"] != calls + 1:
            raise AssertionError(f"short rsi stream [{name}]: "
                                 f"{counts['encode_fields']} launches, "
                                 f"expected {calls + 1}")
        add(counts)
        print(f"slice short rsi [stream {name}] bytes={len(data)} "
              f"pieces={len(cuts) + 1} identical_to_native=True on {smi}")

    param = sz_small_param(4)
    cfg = param_cfg(param)
    chunks = [c[:len(c) - 3 * param.pixels_per_scanline]
              for c in sz_chunks(rng, 8, 16, True)]
    reset_counts()
    comps = [szip.sz_buffto_buff_compress(c, param, device=device,
                                          force_device=True) for c in chunks]
    counts = read_counts()
    if comps != [c_sz_compress(c, param) for c in chunks]:
        raise AssertionError("short rsi [SZ ppb 4]: streams differ from the "
                             "C surface")
    check_launched("short rsi sz compress [SZ ppb 4]", counts, ENCODE_ROUTE)
    check_encode_launches("short rsi sz compress", cfg, counts,
                          [-(-len(c) // cfg.rsi_len_bytes) * cfg.rsi_len_bytes
                           for c in chunks])
    add(counts)
    print(f"slice short rsi [sz_buffto_buff_compress SZ ppb 4, "
          f"{len(chunks)} chunks of 1 MiB less a scanline and a half] "
          f"identical_to_c_szlib=True on {smi}")
    return dict(totals)


def run_large_many(label, cfg, data, device, smi, n_streams=64):
    """18b. decode_buffers on the card over `data` cut into n_streams
    streams of whole RSIs (one a chunk of an HDF5 dataset), each encoded by
    native.encode: each result held against native.decode of its stream,
    beside the loop of native.decode.  Returns the launches."""
    import libaec_tpu_torch as lt
    from libaec_tpu_torch import native

    piece = len(data) // n_streams // cfg.rsi_len_bytes * cfg.rsi_len_bytes
    raws = [data[i * piece:(i + 1) * piece] for i in range(n_streams)]
    comps = [native.encode(r, cfg)[1] for r in raws]
    sizes = [len(r) for r in raws]
    mib = sum(sizes) / 2**20
    lt.decode_buffers(comps[:4], cfg, sizes[:4], device=device)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = lt.decode_buffers(comps, cfg, sizes, device=device)
    secs = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    want = [native.decode(c, s, cfg) for c, s in zip(comps, sizes)]
    native_secs = time.perf_counter() - t0
    if got != want or any(w != (0, r) for w, r in zip(want, raws)):
        raise AssertionError(f"{label}: decode_buffers differs from "
                             "native.decode or the input")
    check_launched(f"{label} decode_buffers", counts,
                   decode_route(cfg, False))
    print(f"slice large [{label}, {n_streams} streams] bytes={sum(sizes)} "
          f"decode_buffers MiB/s={mib / secs:.2f} "
          f"native.decode_loop MiB/s={mib / native_secs:.2f} "
          f"identical_to_native=True identical_to_input=True on {smi}")
    return counts


def wide_data(cfg, n_samples, seed, kinds):
    """n_samples of cfg's samples, the kinds in equal runs, as stream
    bytes."""
    import gen

    rng = np.random.default_rng(seed)
    per = -(-n_samples // len(kinds))
    vals = np.concatenate([gen.gen_values(rng, per, cfg.bits_per_sample,
                                          cfg.signed, kind)
                           for kind in kinds])[:n_samples]
    return pack_samples(vals, cfg.bits_per_sample, cfg.flags)


def _step_timer(spent, lock):
    def wrap(step, fn):
        def timed_step(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                # a range of the step's name in a torch.profiler trace
                with torch.profiler.record_function(step):
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
    (fetch) the FIFO fetch thread, (touch) the touch worker, (pool) the
    scan and fill pools of decode_buffers, summed over their threads."""
    from libaec_tpu_torch import decode as mod

    spent = defaultdict(float)
    wrap = _step_timer(spent, threading.Lock())
    steps = {"scan_chunk": "scan_main", "fill_chunk": "fill_fill",
             "stage_chunk": "h2d_main", "decode_chunk": "dispatch_main",
             "fetch_chunk": "d2h_fetch", "store_part": "store_fetch",
             "finish": "tail_finish", "scan_stream": "scan_pool",
             "fill_part": "fill_pool", "touch_pages": "touch_touch"}
    # a step the decode module lacks (an older tree's) is not timed
    saved = {name: getattr(mod, name) for name in steps if hasattr(mod, name)}
    for name, value in saved.items():
        setattr(mod, name, wrap(steps[name], value))
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
    count_plain_versions()  # every main path below is held to no calls

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

    # 3b. kernel 1's two phases (multi-GPU path, phase 16) against their
    #     plain versions: at the main path's chunk, and at the shard of
    #     each run of phase 16, each size on its own data of every
    #     tests/gen.py kind (as 3's encode_fields)
    n_enc = default_rsis_per_chunk(bench_cfg)
    shard_rsis = sorted({(SLICE_MIB << 20) // bench_cfg.rsi_len_bytes // w
                         for _, w in mesh_worlds()} | {n_enc})
    phase_ms = {}
    for n_rsi in shard_rsis:
        raw = torch.from_numpy(np.frombuffer(chunk_data(
            bench_cfg, n_rsi, seed=n_rsi + bench_cfg.bits_per_sample),
            np.uint8).copy()).to(device)
        e, kmap_ms, resume_ms, _ = check_encode_phases(
            f"bench, {n_rsi} RSIs", bench_cfg, raw, device)
        err1 = max(err1, e)
        if n_rsi == n_enc:
            phase_ms = {"encode_kmap": kmap_ms,
                        "encode_fields_resume": resume_ms}
        del raw
    torch.cuda.empty_cache()

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

    # 16. the multi-GPU path: 256 MiB split over NCCL ranks on the cards,
    #     and over 2 and 4 gloo ranks sharing card 0; then 64 MiB of
    #     sar32bit (AEC_PAD_RSI) over the same ranks
    torch.cuda.empty_cache()
    mesh_launches = run_mesh(bench_cfg, device, 20261022, smi)
    torch.cuda.empty_cache()
    for name, count in run_mesh(sar32bit_config(), device, 20261023, smi,
                                mib=64).items():
        mesh_launches[name] += count
    # and 64 MiB at 128 samples a block (the kernels' wide paths)
    torch.cuda.empty_cache()
    for name, count in run_mesh(large_block_configs()[0][1], device,
                                20261029, smi, mib=64).items():
        mesh_launches[name] += count

    # 17. the configs kernels 1 and 3 took in last: AEC_PAD_RSI, the
    #     restricted set, SZIP's blocks of 2-6 pixels; the kernels at each
    #     config's chunk, then the main paths beside the native codec
    print(f"wide configs on {smi}")
    e1, e3, e4, e5 = run_wide_kernels(device)
    err1, err3 = max(err1, e1), max(err3, e3)
    err4, err5 = max(err4, e4), max(err5, e5)
    wide_launches = defaultdict(int)
    sar, res = sar32bit_config(), restricted_config(2)
    for label, cfg, data in (
            ("sar32bit 256 RSIs of 1 MiB and a short one", sar, wide_data(
                sar, 256 * sar.samples_per_rsi + 12345, 20261024,
                ("lowentropy", "midentropy", "random", "zero_runs"))),
            ("restricted 2-bit 64 MiB", res, wide_data(
                res, (64 << 20) + 777, 20261025,
                ("zero_runs", "lowentropy", "random")))):
        for name, count in run_wide_path(label, cfg, data, device,
                                         smi).items():
            wide_launches[name] += count
        del data
    for name, count in run_sz_small_blocks(device, 20261026, smi).items():
        wide_launches[name] += count

    # 18. blocks over 64 samples (AEC_NOT_ENFORCE, the kernels' wide
    #     paths): kernels 1-4 at each config's chunk, then 256 MiB of the
    #     benchmark's field data at 128 and at 1024 samples a block through
    #     encode_buffer, decode_buffer_status and decode_buffers, beside the
    #     native codec on the same buffers
    from bench_torch import data as bench_data

    print(f"large blocks on {smi}")
    errs = run_large_kernels(device)
    err1 = max(err1, errs["encode_fields"])
    err2 = max(err2, errs["merge_windows"])
    err3 = max(err3, errs["decode_blocks"])
    err4 = max(err4, errs["unpredict_swizzle"])
    large_launches = defaultdict(int)
    for (name, cfg), seed in zip(large_block_configs()[:2],
                                 (20261027, 20261028)):
        data = bench_data.field(cfg, SLICE_MIB << 20, seed)
        label = f"{name} field {SLICE_MIB} MiB"
        for launched in (run_wide_path(label, cfg, data, device, smi),
                         run_large_many(label, cfg, data, device, smi)):
            for kernel, count in launched.items():
                large_launches[kernel] += count
        del data
    for kernel, count in run_large_rsi(device, smi).items():
        large_launches[kernel] += count

    # 19. a stream's short last RSI: kernels 1 and 2 at nb 1, 2 and rsi - 1
    #     against their plain versions, then every encode entry point over
    #     buffers that end in one
    print(f"short last RSIs on {smi}")
    e1, e2, short_ms1, short_ms2 = run_short_rsi_kernels(device)
    err1, err2 = max(err1, e1), max(err2, e2)
    short_launches = run_short_rsi_paths(device, smi, 20261031)
    print(f"plain versions on the main paths: "
          f"{sum(PLAIN_CALLS.values())} calls in {len(PLAIN_CHECKS)} "
          f"checked runs (and in every rank of phase 16)")
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

    # the encode and decode paths' launches, phases 16's to 19's: kernel
    # 1's entry counts encode_fields, encode_kmap and encode_fields_resume
    kernels = [
        entry("encode_fields", "encode.cu", "encode_pallas.py:83",
              launches["encode_fields"] + mesh_launches["encode_kmap"]
              + mesh_launches["encode_fields_resume"]
              + wide_launches["encode_fields"]
              + large_launches["encode_fields"]
              + short_launches["encode_fields"], err1, ms1, plain1, bound1),
        entry("merge_windows", "merge.cu", "merge_pallas.py:77",
              launches["merge_windows"] + mesh_launches["merge_windows"]
              + wide_launches["merge_windows"]
              + large_launches["merge_windows"]
              + short_launches["merge_windows"], err2, ms2, plain2, bound2),
        entry("decode_blocks", "decode.cu", "decode_pallas.py:53",
              dec_launches["decode_blocks"] + mesh_launches["decode_blocks"]
              + wide_launches["decode_blocks"]
              + large_launches["decode_blocks"], err3, ms3, plain3, bound3),
        entry("unpredict_swizzle", "unpredict.cu", "unpredict_pallas.py:83",
              dec_launches["unpredict_swizzle"]
              + mesh_launches["unpredict_swizzle"]
              + wide_launches["unpredict_swizzle"]
              + large_launches["unpredict_swizzle"], err4, ms4, plain4,
              bound4),
        entry("unpredict_rsis", "unpredict.cu", "unpredict_pallas.py:22",
              dec24_launches["unpredict_rsis"], err5, ms5, plain5, bound5),
        entry("decode_fused", "decode_fused.cu", "decode_fused_pallas.py:48",
              fused_launches["decode_fused"], err6, ms6, plain6, bound6),
    ]
    kernels[0]["phases_ms"] = phase_ms  # the two-phase launches, 3b
    # phase 19's short last RSIs, the median over its cases
    kernels[0]["short_rsi_ms"], kernels[1]["short_rsi_ms"] = \
        short_ms1, short_ms2
    kernels[1]["note"] = ("bit0 in [0, 32): a shard merges at its offset "
                          "mod 32; held at every bit0")
    print(f"launches on the many-streams path: "
          f"{json.dumps({str(k): v for k, v in many_launches.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
