"""The port's C ABI (libaec_tpu_torch/native/libaec_abi.cpp, compiled into
native.library_path()) against the JAX package's library.

A twin of tests/test_c_abi.py: the libaec.h / szlib.h entry points driven
through ctypes as a C program calls them -- aec_buffer_encode/decode with
their capacity semantics, the streaming aec_* calls through the
aec_stream structure of tests/test_stream_memory.py (chunked, one byte at
a time, and a 16 MiB stream drip-fed in 64 KiB buffers with bounded
output), SZ_BufftoBuffCompress/Decompress -- each on both libraries,
which must give the same bytes and status; and examples/c_consumer.c
linked against the port's library where gcc is present.
"""
import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gen  # noqa: E402
from libaec_tpu import native as jnative  # noqa: E402
from libaec_tpu_torch import native  # noqa: E402
from libaec_tpu_torch.config import Config  # noqa: E402
from libaec_tpu_torch.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_FLUSH,
    AEC_NO_FLUSH,
    AEC_OK,
    AEC_STREAM_ERROR,
)

REPO = Path(__file__).resolve().parent.parent
MSB, PP = AEC_DATA_MSB, AEC_DATA_PREPROCESS


class AecStream(ctypes.Structure):
    """struct aec_stream (libaec_compat.h), as tests/test_stream_memory.py"""
    _fields_ = [
        ("next_in", ctypes.c_void_p),
        ("avail_in", ctypes.c_size_t),
        ("total_in", ctypes.c_size_t),
        ("next_out", ctypes.c_void_p),
        ("avail_out", ctypes.c_size_t),
        ("total_out", ctypes.c_size_t),
        ("bits_per_sample", ctypes.c_uint),
        ("block_size", ctypes.c_uint),
        ("rsi", ctypes.c_uint),
        ("flags", ctypes.c_uint),
        ("state", ctypes.c_void_p),
    ]


class SZCom(ctypes.Structure):
    _fields_ = [
        ("options_mask", ctypes.c_int),
        ("bits_per_pixel", ctypes.c_int),
        ("pixels_per_block", ctypes.c_int),
        ("pixels_per_scanline", ctypes.c_int),
    ]


def libs():
    """(the port's library, the JAX package's), as a C program loads
    them."""
    native.get_lib()
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")
    return (ctypes.CDLL(str(native.library_path())),
            ctypes.CDLL(str(jnative._SO)))


def both(fn):
    """fn(lib) on the port's library and on the JAX package's; the two
    results must be equal.  Returns the port's."""
    ours, theirs = (fn(lib) for lib in libs())
    assert ours == theirs
    return ours


def sample_bytes(cfg, n, seed):
    rng = np.random.default_rng(seed)
    vals = gen.gen_values(rng, n, cfg.bits_per_sample, cfg.signed,
                          "midentropy")
    return gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags)


def stream_for(cfg, src=None, src_len=0, dst=None, dst_len=0):
    return AecStream(
        ctypes.cast(src, ctypes.c_void_p) if src is not None else None,
        src_len, 0, ctypes.cast(dst, ctypes.c_void_p)
        if dst is not None else None, dst_len, 0, cfg.bits_per_sample,
        cfg.block_size, cfg.rsi, cfg.flags, None)


def buffer_call(lib, name, cfg, data, cap):
    """aec_buffer_encode/decode: (status, total_out, the output buffer)."""
    inb = ctypes.create_string_buffer(data, len(data))
    outb = ctypes.create_string_buffer(max(cap, 1))
    s = stream_for(cfg, inb, len(data), outb, cap)
    status = getattr(lib, name)(ctypes.byref(s))
    return status, s.total_out, outb.raw[:cap]


@pytest.mark.parametrize("cfg_args,n", [
    ((16, 64, 64, MSB | PP), 5 * 4096 + 123),
    ((8, 16, 8, PP), 20 * 128 + 13),
    ((24, 32, 16, MSB | PP | AEC_DATA_3BYTE), 7 * 512 + 1),
    ((16, 64, 256, MSB | PP), (9 << 20) // 2),        # the parallel route
], ids=["16bit", "8bit", "24bit-3byte", "9MiB-parallel"])
def test_buffer_encode_decode(cfg_args, n):
    cfg = Config(*cfg_args)
    raw = sample_bytes(cfg, n, seed=n % 97)
    want = native.encode(raw, cfg)[1]
    st, total, out = both(lambda lib: buffer_call(
        lib, "aec_buffer_encode", cfg, raw, len(want) + 64))
    assert (st, total, out[:total]) == (AEC_OK, len(want), want)
    # a too-small output reports AEC_STREAM_ERROR with the buffer filled
    st, _, out = both(lambda lib: buffer_call(
        lib, "aec_buffer_encode", cfg, raw, len(want) // 2))
    assert st == AEC_STREAM_ERROR and out == want[: len(want) // 2]
    st, total, out = both(lambda lib: buffer_call(
        lib, "aec_buffer_decode", cfg, want, len(raw)))
    assert (st, total, out) == (AEC_OK, len(raw), raw)
    # truncated input and a short output: the same status and bytes
    both(lambda lib: buffer_call(lib, "aec_buffer_decode", cfg,
                                 want[: len(want) // 3], len(raw)))
    both(lambda lib: buffer_call(lib, "aec_buffer_decode", cfg, want,
                                 len(raw) // 2 + 1))


def streaming(lib, fn, cfg, data, in_sizes, out_cap):
    """The aec_<fn>_init / aec_<fn> / aec_<fn>_end calls of a C program:
    data in pieces of in_sizes (a generator), output drained through a
    buffer of out_cap bytes until a flush call gives nothing.  Returns
    (statuses of init and end, the output's sha256, its length)."""
    s = stream_for(cfg)
    st_init = getattr(lib, f"aec_{fn}_init")(ctypes.byref(s))
    outb = ctypes.create_string_buffer(out_cap)
    h, total, pos = hashlib.sha256(), 0, 0

    def call(flush):
        nonlocal total
        s.next_out = ctypes.cast(outb, ctypes.c_void_p)
        s.avail_out = out_cap
        status = getattr(lib, f"aec_{fn}")(ctypes.byref(s), flush)
        n = out_cap - s.avail_out
        h.update(outb.raw[:n])
        total += n
        return status, n

    for size in in_sizes:
        if pos >= len(data):
            break
        piece = ctypes.create_string_buffer(data[pos:pos + size], size)
        s.next_in = ctypes.cast(piece, ctypes.c_void_p)
        s.avail_in = len(data[pos:pos + size])
        pos += size
        while True:  # drain what this piece produced
            status, n = call(AEC_NO_FLUSH)
            assert status == AEC_OK
            if n < out_cap:
                break
    s.next_in, s.avail_in = None, 0
    while call(AEC_FLUSH)[1]:
        pass
    return st_init, getattr(lib, f"aec_{fn}_end")(ctypes.byref(s)), \
        h.hexdigest(), total


def uneven(seed, hi):
    rng = np.random.default_rng(seed)
    while True:
        yield int(rng.integers(1, hi))


@pytest.mark.parametrize("in_hi,out_cap", [(5000, 777), (2, 1)],
                         ids=["chunked", "one-byte"])
def test_streaming_encode(in_hi, out_cap):
    cfg = Config(16, 32, 16, MSB | PP) if in_hi > 2 else Config(8, 8, 4, PP)
    raw = sample_bytes(cfg, 9 * cfg.samples_per_rsi + 77, seed=2)
    want = native.encode(raw, cfg)[1]
    assert both(lambda lib: streaming(lib, "encode", cfg, raw,
                                      uneven(3, in_hi), out_cap)) \
        == (AEC_OK, AEC_OK, hashlib.sha256(want).hexdigest(), len(want))


@pytest.mark.parametrize("in_hi,out_cap", [(900, 501), (2, 1)],
                         ids=["chunked", "one-byte"])
def test_streaming_decode(in_hi, out_cap):
    cfg = Config(8, 16, 8, PP)
    raw = sample_bytes(cfg, 20 * cfg.samples_per_rsi + 13, seed=4)
    comp = native.encode(raw, cfg)[1]
    st, want = native.decode(comp, len(raw) + 64, cfg)
    assert st == AEC_OK
    assert both(lambda lib: streaming(lib, "decode", cfg, comp,
                                      uneven(5, in_hi), out_cap)) \
        == (AEC_OK, AEC_OK, hashlib.sha256(want).hexdigest(), len(want))


def test_streaming_decode_bounded_drip_feed():
    """tests/test_stream_memory.py's C-ABI half at 16 MiB: 64 KiB pieces
    in, 64 KiB buffers out, the decoded bytes those of the input."""
    cfg = Config(16, 64, 256, MSB | PP)
    rng = np.random.default_rng(7)
    raw = gen.pack_samples(gen.gen_values(rng, 8 << 20, 16, False,
                                          "lowentropy"), 16, cfg.flags)
    comp = native.encode(raw, cfg)[1]

    def pieces():
        while True:
            yield 64 * 1024
    assert both(lambda lib: streaming(lib, "decode", cfg, comp, pieces(),
                                      64 * 1024)) \
        == (AEC_OK, AEC_OK, hashlib.sha256(raw).hexdigest(), len(raw))


@pytest.mark.parametrize("bpp,ppb,pps", [(16, 16, 256), (8, 8, 100),
                                         (64, 8, 64), (32, 16, 250),
                                         (16, 10, 130), (16, 4, 64)])
def test_sz_compress_decompress(bpp, ppb, pps):
    rng = np.random.default_rng(bpp + ppb)
    n_pixels = pps * 7 + (0 if pps % ppb == 0 else 3)
    pixel_bytes = {8: 1, 16: 2, 32: 4, 64: 8}[bpp]
    src = rng.integers(0, 200, n_pixels * pixel_bytes,
                       dtype=np.uint32).astype(np.uint8).tobytes()
    cparam = SZCom(16 | 32, bpp, ppb, pps)  # SZ_MSB | SZ_NN

    def compress(lib, cap):
        dest = ctypes.create_string_buffer(cap)
        dlen = ctypes.c_size_t(cap)
        st = lib.SZ_BufftoBuffCompress(dest, ctypes.byref(dlen), src,
                                       len(src), ctypes.byref(cparam))
        return st, dest.raw[: dlen.value] if st == 0 else dlen.value

    st, comp = both(lambda lib: compress(lib, len(src) * 2 + 1024))
    assert st == 0
    both(lambda lib: compress(lib, 8))  # SZ_OUTBUFF_FULL

    def decompress(lib, data, cap):
        back = ctypes.create_string_buffer(cap)
        blen = ctypes.c_size_t(cap)
        st = lib.SZ_BufftoBuffDecompress(back, ctypes.byref(blen), data,
                                         len(data), ctypes.byref(cparam))
        return st, back.raw[: blen.value]

    assert both(lambda lib: decompress(lib, comp, len(src))) == (0, src)
    both(lambda lib: decompress(lib, comp[: len(comp) // 2], len(src)))
    assert both(lambda lib: lib.SZ_encoder_enabled()) == 1


def test_c_consumer_compiles_and_runs(tmp_path):
    """examples/c_consumer.c, a C program linking libaec_compat.h's entry
    points, built against the port's library."""
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler")
    native.get_lib()
    so = native.library_path()
    exe = tmp_path / "c_consumer"
    subprocess.run(
        ["gcc", "-I", str(REPO / "libaec_tpu_torch" / "native"),
         str(REPO / "examples" / "c_consumer.c"), "-L", str(so.parent),
         f"-l:{so.name}", "-o", str(exe)], check=True, timeout=300)
    out = subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True, timeout=300,
        env={"LD_LIBRARY_PATH": str(so.parent)})
    assert "roundtrips OK" in out.stdout
