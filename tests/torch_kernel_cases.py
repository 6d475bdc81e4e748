"""Inputs for kernels 2 and 3 of libaec_tpu_torch, shared by the CPU tests
(tests/test_torch_merge_owned.py, tests/test_torch_decode_region.py) and
the card tests (tests/test_torch_cuda.py).  Imports neither JAX nor the
JAX package."""
import numpy as np
import torch

import gen
from chip_smoke import pack_samples
from libaec_tpu_torch import (
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
    Config,
    native,
)
from libaec_tpu_torch.kernels import encode_cuda, merge_cuda
from libaec_tpu_torch.ops import bitunpack

PP, MSB, SGN = AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED
NE, B3 = AEC_NOT_ENFORCE, AEC_DATA_3BYTE


def synthetic_windows(rng, NB, W, shape):
    """Windows int32 [NB, W] of random bits at window bits [32, 32 + bits)
    and block_bits int32 [NB].  shape: "full" (any length up to the
    window, a third of the blocks empty) or "runs" (runs of 0 to 63 empty
    blocks between blocks of 1 to 3 bits)."""
    if shape == "full":
        bb = rng.integers(0, 32 * (W - 1) + 1, NB)
        bb[rng.random(NB) < 1 / 3] = 0
    else:
        bb = np.zeros(NB, np.int64)
        i = 0
        while i < NB:
            i += int(rng.integers(0, 64))
            if i < NB:
                bb[i] = rng.integers(1, 4)
                i += 1
    words = rng.integers(0, 1 << 32, (NB, W), dtype=np.uint64)
    lo = np.maximum(32, 32 * np.arange(W))[None, :]           # bit ranges
    hi = np.minimum(32 + bb[:, None], 32 * np.arange(1, W + 1)[None, :])
    n = np.clip(hi - lo, 0, 32).astype(np.uint64)
    mask = (((np.uint64(1) << n) - np.uint64(1))
            << (32 * np.arange(1, W + 1)[None, :] - hi).clip(0)
            .astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    win = (words & mask).astype(np.uint32)
    return (torch.from_numpy(win.view(np.int32)),
            torch.from_numpy(bb.astype(np.int32)))


def encoded_windows(cfg, n_rsi, seed):
    """The encode kernel's plain windows of n_rsi RSIs of every
    tests/gen.py kind (zero runs among them)."""
    rng = np.random.default_rng(seed)
    S = cfg.samples_per_rsi
    per = -(-n_rsi // len(gen.KINDS))
    vals = np.concatenate([gen.gen_values(rng, per * S, cfg.bits_per_sample,
                                          cfg.signed, kind)
                           for kind in gen.KINDS])[: n_rsi * S]
    raw = torch.from_numpy(np.frombuffer(pack_samples(
        vals, cfg.bits_per_sample, cfg.flags), np.uint8).copy())
    win, bb, _ = encode_cuda.encode_fields_plain(
        cfg, raw, torch.tensor([3], dtype=torch.int32))
    return win, bb


# kernel 2: id -> () -> (windows, block_bits, tile of the tensor version)
MERGE_CASES = {
    "tile4-full": lambda: (*synthetic_windows(
        np.random.default_rng(1), 37, 5, "full"), 4),
    "tile16-runs": lambda: (*synthetic_windows(
        np.random.default_rng(2), 1000, 4, "runs"), 16),
    "tile4-runs": lambda: (*synthetic_windows(
        np.random.default_rng(3), 203, 3, "runs"), 4),
    "kernel-tile-full": lambda: (*synthetic_windows(
        np.random.default_rng(4), 600, 35, "full"), merge_cuda.TILE),
    "kernel-tile-runs": lambda: (*synthetic_windows(
        np.random.default_rng(5), 2000, 3, "runs"), merge_cuda.TILE),
    "bench-encoded": lambda: (*encoded_windows(
        Config(16, 64, 16, MSB | PP), 40, 7), merge_cuda.TILE),
    "bs10-encoded-tile16": lambda: (*encoded_windows(
        Config(16, 10, 8, MSB | PP | NE), 21, 8), 16),
}


def merge_buffer_words(NB, W):
    """A word buffer that holds any stream of NB windows of W words."""
    return (NB * 32 * (W - 1) + 8) // 32 + 64 * W + 4


# kernel 3: the parse's configs (block sizes 8 to 64, 3-byte samples)
DECODE_CONFIGS = {
    "bench16": Config(16, 64, 16, MSB | PP),
    "nopp16": Config(16, 64, 16, MSB),
    "u8bs8": Config(8, 8, 32, PP),
    "bs10": Config(16, 10, 32, MSB | PP | NE),
    "bs16": Config(12, 16, 16, PP),
    "s13bs32": Config(13, 32, 16, SGN | PP | MSB),
    "u24-3byte": Config(24, 64, 8, MSB | PP | B3),
    "s32": Config(32, 64, 4, SGN | PP),
}
DECODE_DATA = ["every kind", "lowentropy", "midentropy", "zero_runs"]


def blocks_of_every_kind(cfg, n_rsi, rng):
    """Samples whose blocks take, at random, the four codings: constant
    (zero blocks), steps of 0 and 1 (second extension), small steps
    (split), uniform noise (uncompressed)."""
    bs, bps = cfg.block_size, cfg.bits_per_sample
    top = (1 << bps) - 1
    vals, last = [], top // 3
    for t in rng.integers(0, 4, n_rsi * cfg.rsi):
        if t == 3:
            block = rng.integers(0, top + 1, bs)
        else:
            step = {0: np.zeros(bs, np.int64),
                    1: rng.choice([0, 0, 0, 0, 0, 1], bs),
                    2: rng.integers(-30, 31, bs)}[int(t)]
            if cfg.flags & PP:
                block = np.clip(last + np.cumsum(step), 0, top)
            else:  # the coder sees the samples themselves
                block = np.abs(step)
        vals.append(block)
        last = int(block[-1])
    return np.concatenate(vals).astype(np.uint32)


def chunk_records(cfg, data, seed, n_rsi=6):
    """(stream, records, bucket width) of n_rsi RSIs of `data` samples
    ("every kind" or a tests/gen.py kind)."""
    rng = np.random.default_rng(seed)
    if data == "every kind":
        vals = blocks_of_every_kind(cfg, n_rsi, rng)
    else:
        vals = gen.gen_values(rng, n_rsi * cfg.samples_per_rsi,
                              cfg.bits_per_sample, cfg.signed, data)
    status, comp = native.encode(
        pack_samples(vals, cfg.bits_per_sample, cfg.flags), cfg)
    assert status == 0
    recs, cnt, tail_bit = native.scan_blocks(
        comp, n_rsi, bitunpack.max_fs_bits(cfg), cfg, wf=0)
    assert cnt == n_rsi
    return comp, dict(recs), bitunpack.bucket_wf(cfg, recs, tail_bit)


def decode_widths(cfg, bucket):
    """The chunk's bucket width and every wider one the decode path can
    choose."""
    from libaec_tpu_torch.decode import WF_BUCKETS

    wf_max = bitunpack.window_words(cfg)
    return sorted({w for w in (*WF_BUCKETS, wf_max) if bucket <= w <= wf_max})
