"""The plain versions of libaec_tpu_torch's decode kernels against the
JAX package's Pallas kernels in interpret mode.

Kernel 3's plain version (decode_cuda.decode_blocks on CPU tensors)
against decode_payload_pallas, at the worst-case window width and at the
bucketed widths the decode path chooses; kernel 4's
(unpredict_cuda.unpredict_swizzle on a CPU tensor) against
unpredict_swizzle_rsis_pallas, with preprocessing on and off, unsigned
and signed.  Configs as tests/test_pallas_decode.py.  Tolerance zero:
the codec is lossless.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import gen  # noqa: E402
from libaec_tpu import Config, native  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
)
from libaec_tpu.decode import (  # noqa: E402
    scan_chunk_bucketed,
    scan_record_arrays,
)
from libaec_tpu.kernels import unpredict_pallas  # noqa: E402
from libaec_tpu.kernels.decode_pallas import (  # noqa: E402
    decode_payload_pallas,
)
from libaec_tpu.ops import bitunpack as jax_bitunpack  # noqa: E402
from libaec_tpu_torch.kernels import decode_cuda, unpredict_cuda  # noqa: E402
from libaec_tpu_torch.ops import bitunpack  # noqa: E402
from libaec_tpu_torch.ops.u32 import u32_to_bits  # noqa: E402

CASES = [
    (8, 16, 8, 0),
    (16, 64, 32, AEC_DATA_MSB),
    (16, 64, 8, AEC_DATA_MSB | AEC_DATA_SIGNED),
    (32, 64, 4, AEC_DATA_MSB),
    (13, 32, 16, AEC_DATA_SIGNED),
]


def _stream(cfg, kind, seed, n_rsi=6):
    rng = np.random.default_rng(seed)
    vals = gen.gen_values(rng, n_rsi * cfg.samples_per_rsi,
                          cfg.bits_per_sample, cfg.signed, kind)
    status, comp = native.encode(
        gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags), cfg)
    assert status == 0
    return comp, n_rsi


def _check_payload(cfg, arrs):
    """Plain kernel 3 against the interpret-mode Pallas kernel."""
    want = np.asarray(jax.jit(lambda *a: decode_payload_pallas(
        cfg, *a, interpret=True))(*arrs))
    before = decode_cuda.launches
    got = decode_cuda.decode_blocks(cfg, *(u32_to_bits(a) for a in arrs))
    assert decode_cuda.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("bps,bs,rsi,extra", CASES)
@pytest.mark.parametrize("pp", [0, AEC_DATA_PREPROCESS])
def test_decode_plain_matches_pallas_worst_width(bps, bs, rsi, extra, pp):
    cfg = Config(bps, bs, rsi, extra | pp)
    comp, n_rsi = _stream(cfg, "midentropy", bps * 77 + bs + rsi + pp)
    wf = bitunpack.window_words(cfg)
    assert wf == jax_bitunpack.window_words(cfg)
    recs, cnt, _ = native.scan_blocks(comp, n_rsi, bitunpack.max_fs_bits(cfg),
                                      cfg, wf=wf)
    assert cnt == n_rsi
    _check_payload(cfg, scan_record_arrays(recs))


@pytest.mark.parametrize("bps,bs,rsi,extra", CASES)
@pytest.mark.parametrize("pp", [0, AEC_DATA_PREPROCESS])
def test_decode_plain_matches_pallas_bucketed_width(bps, bs, rsi, extra, pp):
    """Windows at the width the decode path buckets them to; the port's
    bucket_wf picks the JAX package's width."""
    cfg = Config(bps, bs, rsi, extra | pp)
    comp, n_rsi = _stream(cfg, "lowentropy", bps * 31 + bs + rsi + pp)
    recs, cnt, tail_bit, wf_b = scan_chunk_bucketed(comp, n_rsi, cfg)
    assert cnt == n_rsi
    assert bitunpack.bucket_wf(cfg, recs, tail_bit) == wf_b
    assert recs["win"].shape == (n_rsi * rsi, wf_b)
    _check_payload(cfg, scan_record_arrays(recs))


def test_decode_plain_matches_pallas_zero_runs():
    cfg = Config(16, 64, 64, AEC_DATA_MSB | AEC_DATA_PREPROCESS)
    samples = np.zeros(64 * 64 * 4, dtype=">u2")
    samples[::777] = 9
    status, comp = native.encode(samples.tobytes(), cfg)
    assert status == 0
    recs, cnt, _, wf_b = scan_chunk_bucketed(comp, 4, cfg)
    assert cnt == 4 and wf_b < bitunpack.window_words(cfg)
    _check_payload(cfg, scan_record_arrays(recs))


def _unpred_cases():
    pp, msb, sgn = AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED
    return [
        (Config(16, 64, 32, msb | pp), 16),
        (Config(16, 64, 32, msb | sgn | pp), 16),
        (Config(8, 8, 16, pp), 24),
        (Config(32, 64, 8, msb | pp), 8),
        (Config(32, 64, 8, msb), 8),        # no preprocessing: layout only
        (Config(32, 64, 8, sgn | pp), 8),   # signed 32-bit, LSB first
    ]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("full_range", [False, True])
def test_unpredict_plain_matches_pallas(case, full_range):
    """full_range draws deltas from all of u32, past what a conforming
    stream holds: the int32 wrap-around of the signed path must agree."""
    cfg, n_rsi = _unpred_cases()[case]
    assert unpredict_pallas.fused_supported(cfg, n_rsi)
    rng = np.random.default_rng(100 + case)
    hi = 1 << (32 if full_range else min(cfg.bits_per_sample, 31))
    deltas = rng.integers(0, hi, (n_rsi, cfg.samples_per_rsi),
                          dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.jit(
        lambda d: unpredict_pallas.unpredict_swizzle_rsis_pallas(
            cfg, d, interpret=True))(deltas))
    before = unpredict_cuda.launches
    got = unpredict_cuda.unpredict_swizzle(cfg, u32_to_bits(deltas))
    assert unpredict_cuda.launches == before
    assert got.dtype == torch.uint8
    assert got.shape == (n_rsi, cfg.samples_per_rsi * cfg.bytes_per_sample)
    assert np.array_equal(got.numpy().reshape(-1),
                          want.view(np.uint8).reshape(-1))


def test_kernel_gates():
    pp = AEC_DATA_PREPROCESS
    assert decode_cuda.kernel_supported(Config(16, 64, 32, pp))
    assert decode_cuda.kernel_supported(Config(8, 8, 32, pp))
    from libaec_tpu.constants import AEC_DATA_3BYTE, AEC_NOT_ENFORCE
    assert not decode_cuda.kernel_supported(
        Config(16, 128, 32, pp | AEC_NOT_ENFORCE))
    for bps, flags in ((8, pp), (16, pp), (24, pp | AEC_DATA_3BYTE),
                       (32, pp)):
        assert unpredict_cuda.kernel_supported(Config(bps, 64, 32, flags))
    assert unpredict_cuda.kernel_supported(
        Config(20, 10, 3, pp | AEC_DATA_3BYTE | AEC_NOT_ENFORCE))
