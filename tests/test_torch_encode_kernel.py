"""Kernel 1 of libaec_tpu_torch against the Pallas encode kernel.

The plain version (kernels/encode_cuda.encode_fields_plain, the torch
field pipeline) must give the same block windows, block_bits and k_final
as encode_pallas.encode_chunk_fields_pallas run in interpret mode, on the
matrix of tests/test_pallas_encode.py (its signed third lives in
test_torch_encode_kernel_signed.py, to keep each file short) and at
AEC_NOT_ENFORCE block sizes that are not powers of two.  Tolerance
zero: the codec is lossless.  The CUDA kernel is held against the plain
version in test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from gen import pack_samples  # noqa: E402
from test_pallas_encode import FLAG_SETS, gen_data  # noqa: E402

from libaec_tpu import Config  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
)
from libaec_tpu.kernels import encode_pallas  # noqa: E402
from libaec_tpu_torch.kernels import encode_cuda  # noqa: E402

KINDS = ["random", "low", "zeros", "jump", "mixed"]


def raw_tensor(x, cfg):
    return torch.from_numpy(np.frombuffer(
        pack_samples(x.reshape(-1), cfg.bits_per_sample, cfg.flags),
        np.uint8).copy())


def assert_windows_equal(win_t, bb_t, win_p, bb_p):
    """Windows agree over each block's front pad word + block_bits bits."""
    bb = bb_t.numpy().view(np.uint32)
    assert np.array_equal(bb, np.asarray(bb_p))
    wt = win_t.numpy().view(np.uint32)
    wp = np.asarray(win_p)[:, : wt.shape[1]]
    nbits = 32 + bb.astype(np.int64)
    bit = np.arange(wt.shape[1], dtype=np.int64)[None, :] * 32
    keep = np.clip(nbits[:, None] - bit, 0, 32)
    mask = np.where(keep >= 32, 0xFFFFFFFF,
                    (0xFFFFFFFF << (32 - keep)) & 0xFFFFFFFF).astype(np.uint32)
    assert np.array_equal(wt & mask, wp & mask)
    # nothing of the block lies beyond its bits in the torch window
    assert not np.any(wt & ~mask)


def run_pair(cfg, x, k_init, raw=None):
    raw = raw_tensor(x, cfg) if raw is None else raw
    win_t, bb_t, kf_t = encode_cuda.encode_fields(
        cfg, raw, torch.tensor([k_init], dtype=torch.int32))
    win_p, bb_p, kf_p = encode_pallas.encode_chunk_fields_pallas(
        cfg, jnp.asarray(x), k_init, interpret=True)
    assert int(kf_t[0]) == int(kf_p)
    assert_windows_equal(win_t, bb_t, win_p, bb_p)


BPS = [4, 8, 13, 16, 24, 32]


def check_matrix_case(bps, flags):
    rng = np.random.default_rng(bps * 977 + flags)
    for kind in KINDS:
        bs = int(rng.choice([8, 16, 32, 64]))
        rsi = int(rng.choice([16, 32, 64, 128]))
        # odd widths also exercise the big-endian byte layout
        cfg = Config(bps, bs, rsi, flags | (AEC_DATA_MSB if bps & 1 else 0))
        assert encode_cuda.kernel_supported(cfg)
        # the same cases as test_pallas_encode's matrix
        if not encode_pallas.kernel_supported(cfg, 1):
            continue
        x = gen_data(rng, cfg, 8, kind)
        run_pair(cfg, x, int(rng.integers(0, max(1, cfg.kmax))))


@pytest.mark.parametrize("bps", BPS)
@pytest.mark.parametrize("flags", FLAG_SETS[:2])
def test_plain_kernel_matches_pallas(bps, flags):
    check_matrix_case(bps, flags)


@pytest.mark.parametrize("bs,bps,flags,kind", [
    (10, 16, AEC_DATA_MSB | AEC_DATA_PREPROCESS, "mixed"),
    (24, 24, AEC_DATA_MSB | AEC_DATA_PREPROCESS | AEC_DATA_3BYTE, "low"),
    (48, 13, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS, "random"),
])
def test_plain_kernel_matches_pallas_not_enforce(bs, bps, flags, kind):
    """AEC_NOT_ENFORCE block sizes that are not powers of two: the gate
    takes every even size from 8 to 64, as encode_pallas.kernel_supported
    does."""
    rng = np.random.default_rng(bs)
    cfg = Config(bps, bs, 64, flags | AEC_NOT_ENFORCE)
    assert encode_cuda.kernel_supported(cfg)
    assert encode_pallas.kernel_supported(cfg, 2)
    run_pair(cfg, gen_data(rng, cfg, 2, kind), int(rng.integers(0, cfg.kmax)))


def test_plain_kernel_masks_dirty_high_bits():
    """Storage bits above bits_per_sample are dropped at ingest: dirty
    bytes encode as their masked samples (the Pallas kernel masks its
    u32 input the same way, encode_pallas.py:112)."""
    cfg = Config(13, 32, 64, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS)
    rng = np.random.default_rng(13)
    x = gen_data(rng, cfg, 8, "mixed")
    dirty = x | (rng.integers(0, 8, x.shape).astype(np.uint32) << 13)
    raw = torch.from_numpy(dirty.reshape(-1).astype("<u2").view(np.uint8))
    run_pair(cfg, dirty, 5, raw=raw)


def test_kernel_gate():
    assert encode_cuda.kernel_supported(Config(16, 64, 256, 0))
    assert not encode_cuda.kernel_supported(
        Config(2, 64, 256, AEC_RESTRICTED))                 # id_len 1
    assert not encode_cuda.kernel_supported(
        Config(16, 64, 256, AEC_PAD_RSI))
    for bs in (10, 24, 48):                                 # NOT_ENFORCE
        assert encode_cuda.kernel_supported(
            Config(16, bs, 256, AEC_NOT_ENFORCE))
    assert not encode_cuda.kernel_supported(
        Config(16, 128, 256, AEC_NOT_ENFORCE))              # bs 128
