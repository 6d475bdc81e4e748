"""The plain version of libaec_tpu_torch's kernel 6 (the one-kernel
decode) against the JAX package's fused Pallas kernel in interpret mode,
and against the native decoder.

decode_fused_cuda.decode_unpredict_swizzle on CPU tensors takes the same
windows and records as decode_unpredict_swizzle_pallas (the five configs
of tests/test_pallas_decode.py's one-kernel test, 128 RSIs, the same
inputs from tests/gen.py with a numpy seed) and must give the same bytes.
Where the TPU kernel's tile geometry says no (an RSI count that is not a
multiple of 128, block sizes 10 and 48), the plain version is held
against native.decode.  Tolerance zero: integers, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gen  # noqa: E402
from libaec_tpu import Config, native  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
)
from libaec_tpu.decode import (  # noqa: E402
    scan_chunk_bucketed,
    scan_record_arrays,
)
from libaec_tpu.kernels import decode_fused_pallas  # noqa: E402
from libaec_tpu_torch import Config as TorchConfig  # noqa: E402
from libaec_tpu_torch.kernels import decode_fused_cuda  # noqa: E402
from libaec_tpu_torch.ops.u32 import u32_to_bits  # noqa: E402

PP, MSB, SGN = AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED
NE = AEC_NOT_ENFORCE

PALLAS_CASES = [
    (16, 64, 256, MSB | PP, "lowentropy"),
    (8, 16, 64, PP, "midentropy"),
    (13, 32, 128, SGN | MSB | PP, "lowentropy"),
    (32, 64, 16, MSB | PP, "lowentropy"),
    (16, 64, 256, MSB, "midentropy"),
]


def scanned(cfg, n_rsi, kind, seed):
    """n_rsi RSIs of `kind`, encoded natively and scanned as the decode
    path scans them: (stream, raw bytes, the kernel's five arrays)."""
    rng = np.random.default_rng(seed)
    vals = gen.gen_values(rng, n_rsi * cfg.samples_per_rsi,
                          cfg.bits_per_sample, cfg.signed, kind)
    raw = gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags)
    status, comp = native.encode(bytes(raw), cfg)
    assert status == 0
    recs, cnt, _, _ = scan_chunk_bucketed(comp, n_rsi, cfg)
    assert cnt == n_rsi
    return comp, bytes(raw), scan_record_arrays(recs)


def plain(cfg, arrs, n_rsi):
    before = decode_fused_cuda.launches
    out = decode_fused_cuda.decode_unpredict_swizzle(
        TorchConfig(cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags),
        *(u32_to_bits(a) for a in arrs), n_rsi)
    assert decode_fused_cuda.launches == before  # CPU tensors: plain
    assert out.dtype == torch.uint8
    assert out.shape == (n_rsi, cfg.rsi_len_bytes)
    return out.numpy().tobytes()


@pytest.mark.parametrize("bps,bs,rsi,flags,kind", PALLAS_CASES)
def test_plain_matches_pallas(bps, bs, rsi, flags, kind):
    cfg, n_rsi = Config(bps, bs, rsi, flags), 128
    assert decode_fused_pallas.fused_supported(cfg, n_rsi)
    assert decode_fused_cuda.fused_supported(cfg)
    comp, raw, arrs = scanned(cfg, n_rsi, kind, bps + rsi)
    want = np.asarray(decode_fused_pallas.decode_unpredict_swizzle_pallas(
        cfg, *map(np.asarray, arrs), n_rsi=n_rsi, interpret=True))
    got = plain(cfg, arrs, n_rsi)
    assert got == want.ravel().view(np.uint8).tobytes()
    if not cfg.signed:
        assert got == raw


@pytest.mark.parametrize("bps,bs,rsi,flags,n_rsi", [
    (16, 64, 32, MSB | PP, 1),
    (16, 64, 32, MSB | PP, 33),
    (16, 64, 8, MSB | PP, 130),
    (13, 32, 16, SGN | PP, 33),
    (16, 10, 32, MSB | PP | NE, 33),   # 12 blocks a slab, a short last one
    (8, 10, 3, NE, 5),                 # rows of 30 bytes: not word-aligned
    (32, 48, 8, SGN | PP | NE, 7),     # 2 blocks a slab
])
def test_plain_matches_native(bps, bs, rsi, flags, n_rsi):
    """Shapes the TPU kernel's gate refuses, against native.decode."""
    cfg = Config(bps, bs, rsi, flags)
    assert not decode_fused_pallas.fused_supported(cfg, n_rsi)
    assert decode_fused_cuda.fused_supported(cfg)
    for seed, kind in enumerate(["midentropy", "zero_runs", "edges"]):
        comp, raw, arrs = scanned(cfg, n_rsi, kind, seed + n_rsi)
        want = native.decode(comp, len(raw), cfg)
        assert want[0] == 0
        assert plain(cfg, arrs, n_rsi) == want[1], kind


def test_gate_and_shape_checks():
    pp = PP
    for bps in (8, 16, 32):
        assert decode_fused_cuda.fused_supported(TorchConfig(bps, 64, 32, pp))
    assert decode_fused_cuda.fused_supported(TorchConfig(16, 8, 1, 0))
    three = TorchConfig(24, 64, 16, pp | AEC_DATA_3BYTE)
    big = TorchConfig(16, 128, 16, pp | NE)
    assert not decode_fused_cuda.fused_supported(three)
    assert not decode_fused_cuda.fused_supported(big)
    cfg = TorchConfig(16, 64, 4, pp)
    win = torch.zeros(8, 6, dtype=torch.int32)
    rec = torch.zeros(8, dtype=torch.int32)
    out = decode_fused_cuda.decode_unpredict_swizzle(cfg, win, rec, rec, rec,
                                                     rec, 2)
    assert out.shape == (2, cfg.rsi_len_bytes) and not out.any()
    with pytest.raises(ValueError):  # 3 RSIs need 12 records
        decode_fused_cuda.decode_unpredict_swizzle(cfg, win, rec, rec, rec,
                                                   rec, 3)
    with pytest.raises(ValueError):
        decode_fused_cuda.decode_unpredict_swizzle(cfg, win, rec, rec[:4],
                                                   rec, rec, 2)
    with pytest.raises(ValueError):
        decode_fused_cuda.decode_unpredict_swizzle(three, win, rec, rec, rec,
                                                   rec, 2)
