"""libaec_tpu_torch.stream against the JAX package's stream on the same
inputs.

The cases of tests/test_streaming.py (the byte dribble in and out for its
CASES, chunk sizes that must give the one-shot bytes, the incremental
large stream), configs outside the encode kernel's gate (the native
session, native.EncSession), device=None, dirty high bits, empty input,
and the Python half of tests/test_stream_memory.py at 32 MiB with its
bounds on the buffered state.  The port's encode runs on device="cpu"
(the kernels' plain versions); every aec_encode call is held against the
JAX stream's (the bytes handed out, total_in and total_out) and the
result against native.encode.  Tolerance: byte equality.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gen  # noqa: E402
from libaec_tpu import stream as jstream  # noqa: E402
from libaec_tpu_torch import native, stream  # noqa: E402
from libaec_tpu_torch.config import Config  # noqa: E402
from libaec_tpu_torch.constants import (  # noqa: E402
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_FLUSH,
    AEC_NO_FLUSH,
    AEC_NOT_ENFORCE,
    AEC_OK,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
    AEC_STREAM_ERROR,
)
from libaec_tpu_torch.kernels import encode_cuda  # noqa: E402

MSB, PP = AEC_DATA_MSB, AEC_DATA_PREPROCESS
CASES = [  # tests/test_streaming.py's
    (8, 8, 2, PP, "lowentropy"),
    (16, 16, 4, MSB | PP, "zero_runs"),
    (8, 8, 2, 0, "random"),
]
SESSION_CASES = [  # outside the encode kernel's gate: the native session
    (2, 8, 4, AEC_RESTRICTED | PP, "lowentropy"),   # id_len 1
    (16, 16, 4, MSB | PP | AEC_PAD_RSI, "midentropy"),
    (8, 4, 8, AEC_NOT_ENFORCE | PP, "lowentropy"),  # SZ's block of 4
]
IDS = [f"{c[0]}bit-bs{c[1]}-rsi{c[2]}-f{c[3]}-{c[4]}" for c in
       CASES + SESSION_CASES]


def make_data(bps, bs, rsi, flags, kind, seed):
    rng = np.random.default_rng(seed)
    vals = gen.gen_values(rng, 3 * rsi * bs + 5, bps, False, kind)
    return gen.pack_samples(vals, bps, flags)


class Pair:
    """A port stream and a JAX stream driven by the same calls."""

    def __init__(self, bps, bs, rsi, flags, device="cpu", decode=False):
        self.ours = stream.AecStream(bps, bs, rsi, flags, device=device)
        self.theirs = jstream.AecStream(bps, bs, rsi, flags)
        init = "aec_decode_init" if decode else "aec_encode_init"
        assert getattr(stream, init)(self.ours) == AEC_OK
        assert getattr(jstream, init)(self.theirs) == AEC_OK
        self.out, self.jout = bytearray(), bytearray()
        self.session = not decode and isinstance(self.ours._state,
                                                 stream._SessionState)

    def call(self, fn, data, avail_out, flush):
        """One call on both; the bytes it handed out by the port."""
        before = len(self.out)
        for s, mod, out in ((self.ours, stream, self.out),
                            (self.theirs, jstream, self.jout)):
            s.next_in = data
            s.avail_in = len(data)
            s.next_out = out
            s.avail_out = avail_out
            assert getattr(mod, fn)(s, flush) == AEC_OK
        assert self.ours.total_in == self.theirs.total_in
        if self.session:
            # the session holds back the bits of its last 32-bit word
            assert self.ours.total_out <= self.theirs.total_out
        else:
            assert self.ours.total_out == self.theirs.total_out
            assert self.out == self.jout
        return len(self.out) - before


def encode_dribble(args, data, device, in_step, out_cap):
    pair = Pair(*args[:4], device=device)
    for i in range(0, len(data), in_step):
        pair.call("aec_encode", data[i:i + in_step], out_cap, AEC_NO_FLUSH)
    while pair.call("aec_encode", b"", out_cap, AEC_FLUSH):
        pass
    # the JAX stream's output, drained the same way
    while True:
        pair.theirs.next_out = pair.jout
        pair.theirs.avail_out = out_cap
        before = len(pair.jout)
        jstream.aec_encode(pair.theirs, AEC_FLUSH)
        if len(pair.jout) == before:
            break
    assert bytes(pair.out) == bytes(pair.jout)
    assert stream.aec_encode_end(pair.ours) == AEC_OK
    assert jstream.aec_encode_end(pair.theirs) == AEC_OK
    return bytes(pair.out)


@pytest.mark.parametrize("args", CASES + SESSION_CASES, ids=IDS)
def test_encode_byte_dribble(args):
    """1 byte in, 1 byte out per call, as tests/test_streaming.py."""
    bps, bs, rsi, flags, kind = args
    data = make_data(*args, seed=bps)
    cfg = Config(bps, bs, rsi, flags)
    assert encode_cuda.kernel_supported(cfg) == (args in CASES)
    out = encode_dribble(args, data, "cpu", 1, 1)
    assert out == native.encode(data, cfg)[1]


@pytest.mark.parametrize("args", CASES, ids=IDS[:len(CASES)])
def test_encode_native_session_when_no_device(args):
    """device=None: the native session on a config inside the gate."""
    data = make_data(*args, seed=args[0] + 7)
    pair = Pair(*args[:4], device=None)
    assert pair.session
    out = encode_dribble(args, data, None, 5, 3)
    assert out == native.encode(data, Config(*args[:4]))[1]


@pytest.mark.parametrize("args", CASES + SESSION_CASES, ids=IDS)
def test_decode_byte_dribble(args):
    bps, bs, rsi, flags, kind = args
    data = make_data(*args, seed=bps + 1)
    cfg = Config(bps, bs, rsi, flags)
    enc = native.encode(data, cfg)[1]
    st, oneshot = native.decode(enc, len(data), cfg)
    assert st == AEC_OK
    pair = Pair(bps, bs, rsi, flags, decode=True)
    for i in range(len(enc)):
        pair.call("aec_decode", enc[i:i + 1],
                  max(0, len(data) - len(pair.out)), AEC_NO_FLUSH)
    assert bytes(pair.out) == oneshot


@pytest.mark.parametrize("chunk", [1 << 8, 1 << 12, 10 << 20])
def test_encode_chunk_sizes_equivalent(chunk):
    rng = np.random.default_rng(3)
    flags = MSB | PP
    cfg = Config(16, 64, 32, flags)
    vals = gen.gen_values(rng, 11 * cfg.samples_per_rsi + 19, 16, False,
                          "midentropy")
    data = gen.pack_samples(vals, 16, flags)
    out = encode_dribble((16, 64, 32, flags), data, "cpu", chunk, 1 << 30)
    assert out == native.encode(data, cfg)[1]


@pytest.mark.parametrize("device", ["cpu", None])
@pytest.mark.parametrize("tail", [1, 63, 64, 65, 1023],
                         ids=lambda t: f"tail{t}")
def test_encode_short_last_rsi(tail, device):
    """A last RSI of `tail` samples (1024 a whole one): the flush pads its
    last block with repeats of the last sample, also when it has as many
    blocks as a whole RSI."""
    flags = MSB | PP
    cfg = Config(16, 64, 16, flags)
    rng = np.random.default_rng(tail)
    data = gen.pack_samples(gen.gen_values(
        rng, 2 * cfg.samples_per_rsi + tail, 16, False, "midentropy"),
        16, flags) + b"\x07"  # and a byte short of a sample
    out = encode_dribble((16, 64, 16, flags), data, device, 1500, 1 << 20)
    assert out == native.encode(data, cfg)[1]


def test_encode_uneven_pieces_and_drain_caps():
    """Seeded uneven pieces in, output drained through small caps: the
    carries (k, the shared byte) cross calls that end mid-RSI, mid-byte."""
    rng = np.random.default_rng(11)
    flags = MSB | PP
    cfg = Config(16, 64, 16, flags)
    data = gen.pack_samples(gen.gen_values(
        rng, 37 * cfg.samples_per_rsi + 333, 16, False, "lowentropy"),
        16, flags)
    pair = Pair(16, 64, 16, flags)
    pos = 0
    while pos < len(data):
        n = int(rng.integers(1, 6 * cfg.rsi_len_bytes))
        pair.call("aec_encode", data[pos:pos + n], 1000, AEC_NO_FLUSH)
        pos += n
        while pair.call("aec_encode", b"", 1000, AEC_NO_FLUSH):
            pass
    while pair.call("aec_encode", b"", 1000, AEC_FLUSH):
        pass
    assert bytes(pair.out) == native.encode(data, cfg)[1]


@pytest.mark.parametrize("device", ["cpu", None])
@pytest.mark.parametrize("bps", [5, 12, 20])
def test_encode_dirty_high_bits_masked(bps, device):
    """Storage bits above bits_per_sample encode as the masked sample, on
    the kernels' route and on the native session."""
    rng = np.random.default_rng(bps)
    flags = MSB | PP
    cfg = Config(bps, 16, 8, flags)
    vals = gen.gen_values(rng, 4 * cfg.samples_per_rsi + 7, bps, False,
                          "midentropy")
    size = cfg.bytes_per_sample
    junk = rng.integers(0, 1 << (8 * size), vals.size, dtype=np.uint64)
    hi = np.uint64(((1 << 8 * size) - 1) ^ ((1 << bps) - 1))
    dirty = (vals.astype(np.uint64) | (junk & hi)).astype(np.uint32)
    out = encode_dribble((bps, 16, 8, flags), gen.pack_samples(dirty, bps,
                                                                flags),
                         device, 777, 1 << 20)
    assert out == native.encode(gen.pack_samples(vals, bps, flags), cfg)[1]


@pytest.mark.parametrize("device", ["cpu", None])
def test_encode_empty_input_flushes_one_zero_byte(device):
    pair = Pair(16, 16, 4, MSB | PP, device=device)
    pair.call("aec_encode", b"", 1 << 10, AEC_NO_FLUSH)
    pair.call("aec_encode", b"", 1 << 10, AEC_FLUSH)
    assert bytes(pair.out) == bytes(pair.jout) == b"\x00"
    assert stream.aec_encode_end(pair.ours) == AEC_OK


@pytest.mark.parametrize("device", ["cpu", None])
def test_encode_end_before_drain_is_a_stream_error(device):
    data = make_data(8, 8, 2, PP, "lowentropy", seed=4)
    pair = Pair(8, 8, 2, PP, device=device)
    pair.call("aec_encode", data, 2, AEC_FLUSH)
    assert stream.aec_encode_end(pair.ours) \
        == jstream.aec_encode_end(pair.theirs) == AEC_STREAM_ERROR


def test_encode_device_route_without_a_card_raises(monkeypatch):
    """No fallback hides the device: a config inside the gate on
    device="cuda" raises without a card; one outside it needs none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = stream.AecStream(16, 64, 16, MSB | PP)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream.aec_encode_init(s)
    s = stream.AecStream(16, 64, 16, MSB | PP | AEC_PAD_RSI)
    assert stream.aec_encode_init(s) == AEC_OK


def test_decode_incremental_large_stream():
    """Complete RSIs decode exactly once as input accumulates; output
    equals one-shot and the buffered state stays bounded."""
    rng = np.random.default_rng(5)
    flags = MSB | PP
    cfg = Config(16, 64, 64, flags)
    vals = gen.gen_values(rng, 64 * cfg.samples_per_rsi, 16, False,
                          "lowentropy")
    data = gen.pack_samples(vals, 16, flags)
    enc = native.encode(data, cfg)[1]
    pair = Pair(16, 64, 64, flags, decode=True)
    chunk = 8192
    for i in range(0, len(enc), chunk):
        pair.call("aec_decode", enc[i:i + chunk], 1 << 30, AEC_NO_FLUSH)
        st = pair.ours._state
        assert 8 * len(st.inbuf) - st.pos_bit < 2 * 8 * cfg.rsi_len_bytes
        assert len(st.inbuf) < chunk + 2 * cfg.rsi_len_bytes
        assert len(st.done_out) == 0
    assert bytes(pair.out) == data


def test_decode_sticky_error_matches_jax():
    """A stream that fails stops producing, as the JAX package's (which
    drops buffered output with it)."""
    cfg = Config(16, 16, 4, MSB | PP)
    data = make_data(16, 16, 4, MSB | PP, "midentropy", seed=8)
    enc = bytearray(native.encode(data, cfg)[1])
    enc[len(enc) // 2:] = b"\xff" * (len(enc) - len(enc) // 2)
    pair = Pair(16, 16, 4, MSB | PP, decode=True)
    for i in range(0, len(enc), 7):
        pair.call("aec_decode", bytes(enc[i:i + 7]), 50, AEC_NO_FLUSH)
    pair.call("aec_decode", b"", 1 << 20, AEC_FLUSH)
    assert bytes(pair.out) == bytes(pair.jout)


STREAM_MIB = 32  # tests/test_stream_memory.py decodes 112
CHUNK = 64 * 1024


def test_stream_decode_bounded_memory():
    """tests/test_stream_memory.py's Python half at 32 MiB: drip-fed
    through 64 KiB buffers, byte-identical to the JAX stream call by call,
    the buffered state below one chunk + two RSIs."""
    flags = MSB | PP
    cfg = Config(16, 64, 256, flags)
    rng = np.random.default_rng(7)
    vals = gen.gen_values(rng, STREAM_MIB * (1 << 20) // 2, 16, False,
                          "lowentropy")
    raw = gen.pack_samples(vals, 16, flags)
    st, enc = native.encode(raw, cfg)
    assert st == AEC_OK
    pair = Pair(16, 64, 256, flags, decode=True)
    h, total = hashlib.sha256(), 0
    for i in range(0, len(enc) + CHUNK, CHUNK):
        flush = AEC_FLUSH if i >= len(enc) else AEC_NO_FLUSH
        pair.out, pair.jout = bytearray(), bytearray()
        pair.call("aec_decode", enc[i:i + CHUNK], 1 << 30, flush)
        h.update(pair.out)
        total += len(pair.out)
        s = pair.ours._state
        assert len(s.inbuf) < CHUNK + 2 * cfg.rsi_len_bytes
        assert len(s.done_out) == 0
    assert total == len(raw)
    assert h.hexdigest() == hashlib.sha256(raw).hexdigest()
