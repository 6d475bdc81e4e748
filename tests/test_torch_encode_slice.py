"""The encode slice of libaec_tpu_torch against the JAX package.

libaec_tpu_torch.encode_buffer with the device path forced on CPU tensors
(the kernels' plain versions) must give the same bytes as
libaec_tpu.encode_buffer on its JAX backend and as the native encoder:
for every tests/gen.py kind, in one chunk and in many, with an odd tail,
empty input and dirty high bits.  Tolerance zero.

The codec has no weights to convert: both packages take the same Config
object and the same (k, bit0) carries.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gen import KINDS, gen_values, pack_samples  # noqa: E402

import libaec_tpu  # noqa: E402
import libaec_tpu_torch  # noqa: E402
from libaec_tpu import native  # noqa: E402
from libaec_tpu.backend import jax_backend  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_OK,
    AEC_PAD_RSI,
    AEC_STREAM_ERROR,
)
from libaec_tpu_torch import AecStreamError  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = libaec_tpu.Config(16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS)


def make_data(cfg, n_rsi, kind, seed, extra=1000):
    rng = np.random.default_rng(seed)
    n = n_rsi * cfg.samples_per_rsi + extra
    vals = gen_values(rng, n, cfg.bits_per_sample, cfg.signed, kind)
    return pack_samples(vals, cfg.bits_per_sample, cfg.flags) + b"\x01"


def torch_encode(data, cfg, **kw):
    return libaec_tpu_torch.encode_buffer(data, cfg, device="cpu",
                                          force_device=True, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_slice_matches_jax_and_native(kind):
    data = make_data(BENCH, 3, kind, seed=KINDS.index(kind))
    want = native.encode(data, BENCH)[1]
    assert libaec_tpu.encode_buffer(data, BENCH,
                                    backend=jax_backend()) == want
    assert torch_encode(data, BENCH) == want                     # one chunk
    assert torch_encode(data, BENCH, rsis_per_chunk=1) == want   # many


@pytest.mark.parametrize("bps,bs,rsi,flags", [
    (8, 16, 128, 0),
    (13, 32, 64, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS | AEC_DATA_MSB),
    (24, 8, 32, AEC_DATA_3BYTE | AEC_DATA_PREPROCESS),
    (32, 64, 16, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
    (4, 64, 1000, AEC_DATA_PREPROCESS),
])
def test_slice_other_configs_match_native(bps, bs, rsi, flags):
    cfg = libaec_tpu.Config(bps, bs, rsi, flags)
    for seed, kind in enumerate(["midentropy", "zero_runs", "edges"]):
        data = make_data(cfg, 2, kind, seed, extra=3 * bs + 1)
        want = native.encode(data, cfg)[1]
        assert torch_encode(data, cfg) == want, kind
        assert torch_encode(data, cfg, rsis_per_chunk=1) == want, kind


def test_slice_edges():
    assert torch_encode(b"", BENCH) == b"\x00"
    assert torch_encode(b"\x07", BENCH) == b"\x00"      # no whole sample
    # whole RSIs only, and a tail alone
    for data in (make_data(BENCH, 2, "lowentropy", 5, extra=0),
                 make_data(BENCH, 0, "lowentropy", 6, extra=333)):
        assert torch_encode(data, BENCH) == native.encode(data, BENCH)[1]


def test_slice_masks_dirty_high_bits():
    cfg = libaec_tpu.Config(13, 64, 256,
                            AEC_DATA_SIGNED | AEC_DATA_PREPROCESS)
    rng = np.random.default_rng(2)
    vals = gen_values(rng, 2 * cfg.samples_per_rsi + 77, 13, True,
                      "midentropy")
    dirty = vals | (rng.integers(0, 8, vals.size).astype(np.uint32) << 13)
    got = torch_encode(pack_samples(dirty, 13, cfg.flags), cfg)
    assert got == native.encode(pack_samples(vals, 13, cfg.flags), cfg)[1]


def test_out_size_status_parity():
    data = make_data(BENCH, 3, "random", 9)
    full = native.encode(data, BENCH)[1]
    for cap in (len(full), len(full) - 1, 10):
        want = libaec_tpu.encode_buffer_status(data, BENCH, cap,
                                               backend=jax_backend())
        got = libaec_tpu_torch.encode_buffer_status(
            data, BENCH, cap, device="cpu", force_device=True)
        assert got == want
        assert got[0] == (AEC_OK if cap >= len(full) else AEC_STREAM_ERROR)
    with pytest.raises(AecStreamError):
        torch_encode(data, BENCH, out_size=len(full) - 1)


def test_routing():
    """Small buffers and configs outside the kernel gate go to the native
    encoder; a large buffer on a missing CUDA device raises."""
    small = make_data(BENCH, 1, "lowentropy", 3)
    assert libaec_tpu_torch.encode_buffer(small, BENCH, device="cuda") == \
        native.encode(small, BENCH)[1]
    padded = libaec_tpu.Config(16, 64, 256, AEC_DATA_PREPROCESS | AEC_PAD_RSI)
    assert torch_encode(small, padded) == native.encode(small, padded)[1]
    if not torch.cuda.is_available():
        big = bytes(libaec_tpu.encode.AUTO_JAX_MIN_BYTES)
        with pytest.raises(RuntimeError):
            libaec_tpu_torch.encode_buffer(big, BENCH, device="cuda")


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import libaec_tpu_torch as lt\n"
        "cfg = lt.Config(16, 64, 256, lt.AEC_DATA_PREPROCESS)\n"
        "data = bytes(range(256)) * 300\n"
        "out = lt.encode_buffer(data, cfg, device='cpu',"
        " force_device=True)\n"
        "assert len(out) > 1\n"
        "back = lt.decode_buffer(out, cfg, len(data), device='cpu',"
        " force_device=True)\n"
        "assert back == data\n"
        "print('jax' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert res.stdout.strip() == "False"
