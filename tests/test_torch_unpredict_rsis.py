"""Kernel 5 of libaec_tpu_torch and the 3-byte byte layout against the JAX
package.

Kernel 5's plain version (unpredict_cuda.unpredict_rsis on a CPU tensor)
against unpredict_rsis_pallas in interpret mode, on 3-byte configs (the
route the decode path gives them), a 16-bit config and a config without
preprocessing (a passthrough), with deltas in range and from all of u32
(the signed path's int32 wrap-around).  The layout's plain version
(unpredict_cuda.samples_to_bytes on a CPU tensor) against the XLA
samples_to_bytes_device, MSB and LSB, on rows that are and are not
word-aligned.  The CUDA kernels are held against these plain versions in
test_torch_cuda.py.  Tolerance zero: the codec is lossless.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from libaec_tpu import Config  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
)
from libaec_tpu.kernels import unpredict_pallas  # noqa: E402
from libaec_tpu.ops.unpredict import samples_to_bytes_device  # noqa: E402
from libaec_tpu_torch.kernels import unpredict_cuda  # noqa: E402
from libaec_tpu_torch.ops.u32 import u32_to_bits  # noqa: E402

PP, MSB, SGN, B3 = (AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED,
                    AEC_DATA_3BYTE)

# n_rsi is a multiple of 8, the Pallas kernel's smallest lane tile
RSIS_CASES = {
    "u24-msb-3byte": (Config(24, 64, 4, MSB | PP | B3), 8),
    "s17-3byte": (Config(17, 32, 8, SGN | PP | B3), 16),
    "s24-lsb-3byte": (Config(24, 16, 8, SGN | PP | B3), 8),
    "u16": (Config(16, 64, 4, MSB | PP), 8),
    "u24-no-pp": (Config(24, 64, 4, MSB | B3), 8),
}


def counters():
    return (unpredict_cuda.launches, unpredict_cuda.rsis_launches,
            unpredict_cuda.layout_launches)


def random_u32(seed, shape, bps, full_range):
    rng = np.random.default_rng(seed)
    hi = 1 << (32 if full_range else min(bps, 31))
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("case", RSIS_CASES)
@pytest.mark.parametrize("full_range", [False, True])
def test_unpredict_rsis_plain_matches_pallas(case, full_range):
    cfg, n_rsi = RSIS_CASES[case]
    assert unpredict_pallas.kernel_supported(cfg, n_rsi)
    deltas = random_u32(len(case) + 3 * full_range,
                        (n_rsi, cfg.samples_per_rsi), cfg.bits_per_sample,
                        full_range)
    want = np.asarray(jax.jit(lambda d: unpredict_pallas.unpredict_rsis_pallas(
        cfg, d, interpret=True))(deltas))
    before = counters()
    got = unpredict_cuda.unpredict_rsis(cfg, u32_to_bits(deltas))
    assert counters() == before  # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == deltas.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)
    if not cfg.preprocess:
        assert np.array_equal(want, deltas)


@pytest.mark.parametrize("msb", [0, MSB])
@pytest.mark.parametrize("bps,bs,rsi,extra,n_rsi", [
    (24, 64, 4, B3, 3),                   # 768 samples: whole words
    (17, 10, 3, B3 | AEC_NOT_ENFORCE, 5),  # 150 samples: 450 bytes
    (20, 8, 1, B3, 1),                    # one 24-byte row
])
def test_samples_to_bytes_plain_matches_xla(msb, bps, bs, rsi, extra, n_rsi):
    """The 3-byte layout: samples_to_bytes_device returns little-endian
    words when the chunk's bytes fill whole words, bytes otherwise."""
    cfg = Config(bps, bs, rsi, extra | msb)
    assert cfg.bytes_per_sample == 3
    samples = random_u32(bps + msb, (n_rsi, cfg.samples_per_rsi), bps, True)
    want = np.asarray(samples_to_bytes_device(
        cfg, jnp.asarray(samples.reshape(-1)))).view(np.uint8)
    before = counters()
    got = unpredict_cuda.samples_to_bytes(cfg, u32_to_bits(samples))
    assert counters() == before
    assert got.dtype == torch.uint8
    assert got.shape == (n_rsi, cfg.samples_per_rsi * 3)
    assert np.array_equal(got.numpy().reshape(-1), want)


def test_wrappers_check_their_input():
    cfg = Config(24, 64, 4, MSB | PP | B3)
    with pytest.raises(ValueError):
        unpredict_cuda.unpredict_rsis(cfg, torch.zeros(2, 100,
                                                       dtype=torch.int32))
    with pytest.raises(ValueError):
        unpredict_cuda.samples_to_bytes(cfg, torch.zeros(256,
                                                         dtype=torch.int32))
