"""The bytes objects the port's entry points return, against the JAX
package and the native codec.

encode_buffer[_status], decode_buffer_status, decode_buffer_device and
decode_buffers write their result straight into the `bytes` they return
(libaec_tpu_torch/hostbytes.py): chunk by chunk, the boundary byte of
each encode chunk OR-merged, cut in place where the stream ends short.
Each case runs with the device path forced on CPU tensors (the kernels'
plain versions), in many chunks of RSIs of 2 KiB, and must give a plain
`bytes`, equal to libaec_tpu's device route and to native; the encode
chunks meet at every bit offset 0..7.  Each case runs twice on different
data: the first result must not change (no result shares memory with a
buffer that a later call reuses).  Tolerance zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gen import gen_values, pack_samples  # noqa: E402

import libaec_tpu  # noqa: E402
import libaec_tpu_torch  # noqa: E402
from libaec_tpu import Config, native  # noqa: E402
from libaec_tpu.backend import jax_backend  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_OK,
    AEC_STREAM_ERROR,
)
from libaec_tpu.decode import decode_buffer_tpu, decode_buffers_tpu  # noqa: E402
from libaec_tpu_torch import AecStreamError  # noqa: E402
from libaec_tpu_torch import encode as torch_encode  # noqa: E402

CFG = Config(16, 64, 16, AEC_DATA_MSB | AEC_DATA_PREPROCESS)
S = CFG.samples_per_rsi
EVERY_BIT0 = set(range(8))

# input: (whole RSIs, samples of a partial last RSI, a byte short of a
# sample?), or None for empty input
INPUTS = {"chunks": (40, 333, True), "whole-rsis": (8, 0, False),
          "tail-only": (0, 333, True), "empty": None}


def make_raw(name, seed):
    if INPUTS[name] is None:
        return b""
    n_rsi, extra, odd = INPUTS[name]
    rng = np.random.default_rng(seed)
    vals = gen_values(rng, n_rsi * S + extra, 16, False, "lowentropy")
    return pack_samples(vals, 16, CFG.flags) + (b"\x07" if odd else b"")


def stream(raw):
    status, comp = native.encode(raw, CFG)
    assert status == AEC_OK
    return comp


def run_encode(raw, entry, arg):
    """(port's result, native's, the JAX package's).  arg: for
    encode_buffer "out_size" (the stream's length passes, a byte short
    raises), for encode_buffer_status the capacity's distance from the
    stream's length."""
    want = native.encode(raw, CFG)[1] if raw else b"\x00"
    kw = dict(device="cpu", force_device=True, rsis_per_chunk=1)
    if entry == "encode_buffer_status":
        cap = len(want) + arg
        got = libaec_tpu_torch.encode_buffer_status(raw, CFG, cap, **kw)
        jax = libaec_tpu.encode_buffer_status(raw, CFG, cap,
                                              backend=jax_backend())
        status = AEC_OK if cap >= len(want) else AEC_STREAM_ERROR
        return got, (status, want[:cap]), jax
    jax = libaec_tpu.encode_buffer(raw, CFG, backend=jax_backend())
    if arg is None:
        return libaec_tpu_torch.encode_buffer(raw, CFG, **kw), want, jax
    with pytest.raises(AecStreamError):
        libaec_tpu_torch.encode_buffer(raw, CFG, out_size=len(want) - 1,
                                       **kw)
    got = libaec_tpu_torch.encode_buffer(raw, CFG, out_size=len(want), **kw)
    return got, want, jax


def decode_case(raw, cut, size):
    """(stream, out_size): the stream cut to `cut` of its length, the
    output size `size` bytes off the input's whole samples."""
    comp = stream(raw)
    return comp[:int(len(comp) * cut)], len(raw) // 2 * 2 + size


def run_decode(raw, entry, cut, size):
    comp, out_size = decode_case(raw, cut, size)
    want = native.decode(comp, out_size, CFG)
    jax = decode_buffer_tpu(comp, CFG, out_size, chunk_rsis=3)
    if entry == "decode_buffer_device":
        got = libaec_tpu_torch.decode_buffer_device(comp, CFG, out_size,
                                                    "cpu", chunk_rsis=3)
    else:
        got = libaec_tpu_torch.decode_buffer_status(
            comp, CFG, out_size, device="cpu", force_device=True,
            chunk_rsis=1)
    return got, want, jax


def run_decode_many(raws):
    """decode_buffers on the streams of raws (the second under one RSI):
    whole, cut, with an output size short of a sample."""
    cases = [decode_case(raws[0], 1, 0), decode_case(raws[0], 0.5, 0),
             decode_case(raws[1], 1, -1), decode_case(raws[1], 1, -2)]
    comps, sizes = [c for c, _ in cases], [s for _, s in cases]
    want = [native.decode(c, s, CFG) for c, s in cases]
    got = libaec_tpu_torch.decode_buffers(comps, CFG, sizes, device="cpu",
                                          scan_threads=2, chunk_rsis=2)
    jax = decode_buffers_tpu(comps, CFG, sizes, scan_threads=2, chunk_rsis=2)
    return got, want, jax


def results(got):
    """The bytes objects inside a result."""
    if isinstance(got, list):
        return [out for _, out in got]
    return [got[1] if isinstance(got, tuple) else got]


@pytest.mark.parametrize("entry,inp,arg", [
    ("encode_buffer", "chunks", None),
    ("encode_buffer", "whole-rsis", None),
    ("encode_buffer", "tail-only", None),
    ("encode_buffer", "empty", None),
    ("encode_buffer", "chunks", "out_size"),         # and a byte short
    ("encode_buffer_status", "chunks", -1),          # overflow
    ("encode_buffer_status", "chunks", 0),
    ("decode_buffer_status", "chunks", (1, 0)),
    ("decode_buffer_status", "chunks", (0.5, 0)),    # truncated
    ("decode_buffer_status", "chunks", (1, -1)),     # odd out_size
    ("decode_buffer_status", "whole-rsis", (1, 0)),
    ("decode_buffer_device", "chunks", (0.7, 0)),
    ("decode_buffer_device", "tail-only", (1, 0)),   # under one RSI
    ("decode_buffers", "chunks", None),
], ids=str)
def test_result_is_the_filled_bytes(entry, inp, arg, monkeypatch):
    bit0s = []

    class Recording(torch_encode._OutputAssembler):
        def append(self, chunk_bytes, total_bits):
            bit0s.append(self.bits % 8)
            super().append(chunk_bytes, total_bits)

    monkeypatch.setattr(torch_encode, "_OutputAssembler", Recording)
    calls = []
    for seed in (1, 2):  # two calls in a row on different data
        raw = make_raw(inp, seed)
        if entry.startswith("encode"):
            calls.append(run_encode(raw, entry, arg))
        elif entry == "decode_buffers":
            calls.append(run_decode_many([raw, make_raw("tail-only",
                                                        seed + 10)]))
        else:
            calls.append(run_decode(raw, entry, *arg))
    assert calls[0][1] != calls[1][1] or inp == "empty"
    # checked after both calls: the first call's results are unchanged
    for got, want, jax in calls:
        assert got == want == jax
        assert all(type(out) is bytes for out in results(got))
    if inp == "chunks" and entry.startswith("encode"):
        assert set(bit0s) == EVERY_BIT0   # chunks meet at every bit offset
