"""The route libaec_tpu_torch takes for every config of the JAX package's
hardware matrix (tests/test_tpu_matrix.py) and for block size 128, with
its output held against the JAX package and the native codec.

For each config: which side encodes and which decodes (the card, through
the port's kernels, or the native codec), the stream against
libaec_tpu.encode_buffer on its numpy backend and against native.encode,
and the decode against decode_buffer_tpu and native.decode.  The device
routes run here on CPU tensors (the kernels' plain versions); the card
runs the same routes in tests/test_torch_cuda.py.  Signed data is held
against the native decoder, not the raw input: it decodes sign-extended
(ROADMAP C.4).  Tolerance zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gen  # noqa: E402

import libaec_tpu  # noqa: E402
import libaec_tpu_torch  # noqa: E402
from libaec_tpu import Config, native  # noqa: E402
from libaec_tpu.backend import NUMPY  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
    AEC_OK,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
)
from libaec_tpu.decode import decode_buffer_tpu  # noqa: E402
from libaec_tpu_torch import decode as torch_decode  # noqa: E402
from libaec_tpu_torch import encode as torch_encode  # noqa: E402

PP, MSB = AEC_DATA_PREPROCESS, AEC_DATA_MSB
DEV, NAT = "device", "native"

# (name, (bps, block_size, rsi, flags), n_rsi, encode route, decode route);
# n_rsi as test_tpu_matrix's, but 2 RSIs of the bench config keep the
# plain inverse predictor's loop over 16384 samples short
MATRIX = [
    ("bench16", (16, 64, 256, MSB | PP), 2, DEV, DEV),
    ("u8-lsb", (8, 16, 32, PP), 8, DEV, DEV),
    ("s13", (13, 32, 16, AEC_DATA_SIGNED | PP), 8, DEV, DEV),
    ("u32-msb", (32, 64, 8, MSB | PP), 8, DEV, DEV),
    ("u16-no-pp-bs8", (16, 8, 64, 0), 8, DEV, DEV),
    ("u24-3byte", (24, 64, 16, MSB | PP | AEC_DATA_3BYTE), 8, DEV, DEV),
    # restricted 2-bit: id_len 1, no splitting; the JAX package runs its
    # XLA field pipeline there, not a Pallas kernel (ROADMAP A.9)
    ("u2-restricted", (2, 8, 16, AEC_RESTRICTED | PP), 8, NAT, DEV),
    ("u16-bs10", (16, 10, 32, MSB | PP | AEC_NOT_ENFORCE), 8, DEV, DEV),
    ("u16-rsi1", (16, 64, 1, MSB | PP), 64, DEV, DEV),
    ("u16-pad-rsi", (16, 64, 32, MSB | PP | AEC_PAD_RSI), 8, NAT, DEV),
    # bs 128: past both kernels' one-warp blocks; the JAX package decodes
    # it with its XLA _decode_payload_xla (ROADMAP A.9)
    ("u16-bs128", (16, 128, 16, AEC_NOT_ENFORCE), 8, NAT, NAT),
]


def gen_raw(cfg, n_rsi, seed):
    """Mixed-entropy samples with zero runs and a partial last RSI, as
    test_tpu_matrix._gen_raw."""
    rng = np.random.default_rng(seed)
    n = n_rsi * cfg.samples_per_rsi + cfg.block_size + 3
    vals = gen.gen_values(rng, n, cfg.bits_per_sample, cfg.signed,
                          "midentropy")
    zmask = rng.random(-(-n // cfg.block_size)) < 0.3
    vals = np.where(np.repeat(zmask, cfg.block_size)[:n], 0, vals)
    return gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags)


@pytest.mark.parametrize("name,args,n_rsi,enc_route,dec_route", MATRIX,
                         ids=[row[0] for row in MATRIX])
def test_matrix_point(name, args, n_rsi, enc_route, dec_route):
    cfg = Config(*args)
    raw = gen_raw(cfg, n_rsi, seed=sum(args))
    assert torch_encode._use_device(cfg, len(raw), True) == (enc_route == DEV)
    assert torch_decode._use_device(cfg, len(raw), True) == (dec_route == DEV)

    comp = native.encode(raw, cfg)[1]
    assert libaec_tpu.encode_buffer(raw, cfg, backend=NUMPY) == comp
    assert libaec_tpu_torch.encode_buffer(raw, cfg, device="cpu",
                                          force_device=True) == comp

    want = native.decode(comp, len(raw), cfg)
    assert want[0] == AEC_OK
    if not cfg.signed:
        assert want[1] == raw
    assert decode_buffer_tpu(comp, cfg, len(raw)) == want
    assert libaec_tpu_torch.decode_buffer_status(
        comp, cfg, len(raw), device="cpu", force_device=True) == want
