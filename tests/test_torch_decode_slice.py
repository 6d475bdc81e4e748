"""The decode slice of libaec_tpu_torch against the JAX package.

libaec_tpu_torch.decode_buffer_status with the device path forced on CPU
tensors (the kernels' plain versions) must give the same status and
bytes as libaec_tpu.decode.decode_buffer_tpu and as the native decoder:
for every tests/gen.py kind, in one chunk and in many, on truncated
streams, on an output size short of a whole sample, on zero runs, on
3-byte samples, and through part_sink.  Signed data is held against the
native decoder: it
decodes sign-extended, so it need not round-trip byte for byte (ROADMAP
C.4); tests/test_decode_tpu.py holds decode_buffer_tpu against the
native decoder on the same configs.  Every case runs once more on the
one-kernel route (kernel 6's plain version), opted into through
LIBAEC_TPU_FUSED_DECODE.  Tolerance zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gen import KINDS, gen_values, pack_samples  # noqa: E402

import libaec_tpu_torch  # noqa: E402
from libaec_tpu import Config, native  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_MEM_ERROR,
    AEC_NOT_ENFORCE,
    AEC_OK,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
)
from libaec_tpu.decode import DEVICE_DECODE_MIN_BYTES  # noqa: E402
from libaec_tpu.decode import decode_buffer_tpu  # noqa: E402
from libaec_tpu_torch import AecMemError  # noqa: E402
from libaec_tpu_torch.kernels import (  # noqa: E402
    decode_cuda,
    decode_fused_cuda,
    unpredict_cuda,
)

PP, MSB, SGN = AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED
SMALL = Config(16, 64, 32, MSB | PP)  # the bench layout, 32-block RSIs


def make_raw(cfg, n_samples, kind="lowentropy", seed=0):
    rng = np.random.default_rng(seed)
    vals = gen_values(rng, n_samples, cfg.bits_per_sample, cfg.signed, kind)
    return pack_samples(vals, cfg.bits_per_sample, cfg.flags)


def encode(raw, cfg):
    status, comp = native.encode(raw, cfg)
    assert status == AEC_OK
    return comp


def torch_decode(comp, cfg, out_size, **kw):
    return libaec_tpu_torch.decode_buffer_status(
        comp, cfg, out_size, device="cpu", force_device=True, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_slice_matches_jax_and_native(kind):
    raw = make_raw(SMALL, 5 * SMALL.samples_per_rsi + 777, kind,
                   KINDS.index(kind))
    comp = encode(raw, SMALL)
    want = native.decode(comp, len(raw), SMALL)
    assert want == (AEC_OK, raw)
    assert decode_buffer_tpu(comp, SMALL, len(raw)) == want
    assert torch_decode(comp, SMALL, len(raw)) == want               # one
    assert torch_decode(comp, SMALL, len(raw), chunk_rsis=2) == want  # many


@pytest.mark.parametrize("bps,bs,rsi,extra", [
    (8, 16, 8, 0),
    (16, 64, 32, MSB),
    (16, 64, 32, MSB | SGN),
    (32, 16, 7, MSB),
    (13, 32, 16, SGN),
])
@pytest.mark.parametrize("pp", [0, PP])
def test_slice_configs_match_native(bps, bs, rsi, extra, pp):
    """tests/test_decode_tpu.py's config matrix."""
    cfg = Config(bps, bs, rsi, extra | pp)
    raw = make_raw(cfg, rsi * bs * 9 + bs * 3, seed=bps * 1000 + bs + pp)
    comp = encode(raw, cfg)
    want = native.decode(comp, len(raw), cfg)
    assert want[0] == AEC_OK
    if not cfg.signed:
        assert want[1] == raw
    assert torch_decode(comp, cfg, len(raw)) == want
    assert torch_decode(comp, cfg, len(raw), chunk_rsis=4) == want


@pytest.mark.parametrize("bps,bs,rsi,flags", [
    (16, 10, 32, MSB | PP | AEC_NOT_ENFORCE),  # even bs = 10
    (8, 10, 3, AEC_NOT_ENFORCE),                # rows not word-aligned
    (16, 64, 32, MSB | PP | AEC_PAD_RSI),
    (2, 8, 16, AEC_RESTRICTED | PP),
    (1, 8, 16, SGN | PP),                       # xmax quirk of 1-bit signed
])
def test_slice_other_layouts_match_native(bps, bs, rsi, flags):
    cfg = Config(bps, bs, rsi, flags)
    for seed, kind in enumerate(["midentropy", "zero_runs", "edges"]):
        raw = make_raw(cfg, cfg.samples_per_rsi * 7 + bs + 2, kind, seed)
        comp = encode(raw, cfg)
        want = native.decode(comp, len(raw), cfg)
        assert torch_decode(comp, cfg, len(raw)) == want, kind
        assert torch_decode(comp, cfg, len(raw), chunk_rsis=3) == want, kind


B3 = AEC_DATA_3BYTE


@pytest.mark.parametrize("bps,bs,rsi,flags", [
    (24, 64, 16, MSB | PP | B3),
    (17, 32, 8, SGN | PP | B3),
    (24, 8, 16, B3),
    (20, 10, 3, AEC_NOT_ENFORCE | PP | B3),  # rows of 90 bytes
])
def test_slice_3byte_matches_jax_and_native(bps, bs, rsi, flags):
    """3-byte samples take the device path: kernels 3 and 5, then kernel
    4's byte layout, as decode_buffer_tpu runs its Pallas kernels and
    samples_to_bytes_device."""
    cfg = Config(bps, bs, rsi, flags)
    for seed, kind in enumerate(["midentropy", "zero_runs", "edges"]):
        raw = make_raw(cfg, cfg.samples_per_rsi * 7 + bs + 2, kind, seed)
        comp = encode(raw, cfg)
        want = native.decode(comp, len(raw), cfg)
        assert want[0] == AEC_OK
        if not cfg.signed:
            assert want[1] == raw
        assert decode_buffer_tpu(comp, cfg, len(raw)) == want, kind
        assert torch_decode(comp, cfg, len(raw)) == want, kind           # one
        assert torch_decode(comp, cfg, len(raw), chunk_rsis=3) == want, kind


def test_3byte_truncated_and_mem_error():
    """A truncated 3-byte stream, and output sizes 1 and 2 bytes short of
    a whole sample (MEM_ERROR), as decode_buffer_tpu and native.decode."""
    cfg = Config(24, 64, 16, MSB | PP | B3)
    raw = make_raw(cfg, cfg.samples_per_rsi * 6, seed=13)
    comp = encode(raw, cfg)
    for stream, out_size, status in ((comp[: len(comp) // 2], len(raw), None),
                                     (comp, len(raw) - 1, AEC_MEM_ERROR),
                                     (comp, len(raw) - 2, AEC_MEM_ERROR)):
        want = native.decode(stream, out_size, cfg)
        assert status is None or want[0] == status
        assert decode_buffer_tpu(stream, cfg, out_size) == want
        assert torch_decode(stream, cfg, out_size) == want
        assert torch_decode(stream, cfg, out_size, chunk_rsis=2) == want
    assert len(native.decode(comp[: len(comp) // 2], len(raw), cfg)[1]) \
        < len(raw)


def test_truncated_stream():
    raw = make_raw(SMALL, 64 * 32 * 4, seed=7)
    comp = encode(raw, SMALL)
    cut = comp[: len(comp) // 2]
    want = native.decode(cut, len(raw), SMALL)
    assert decode_buffer_tpu(cut, SMALL, len(raw)) == want
    assert torch_decode(cut, SMALL, len(raw)) == want
    assert len(want[1]) < len(raw)


def test_mem_error_parity():
    """out_size not a whole number of samples: MEM_ERROR and the same
    partial output as the native decoder (decode.c:821-825)."""
    raw = make_raw(SMALL, 64 * 32 * 4, seed=11)
    comp = encode(raw, SMALL)
    out_size = len(raw) - 3
    want = native.decode(comp, out_size, SMALL)
    assert want[0] == AEC_MEM_ERROR
    assert decode_buffer_tpu(comp, SMALL, out_size) == want
    assert torch_decode(comp, SMALL, out_size) == want
    with pytest.raises(AecMemError):
        libaec_tpu_torch.decode_buffer(comp, SMALL, out_size, device="cpu",
                                       force_device=True)
    assert libaec_tpu_torch.decode_buffer(
        comp, SMALL, len(raw), device="cpu", force_device=True) == raw


def test_chunked_scan_resume():
    """Many resumable scan slices, and a truncation inside the last one:
    the serial tail resumes at its last complete RSI."""
    cfg = Config(16, 64, 16, MSB | PP)
    raw = make_raw(cfg, cfg.samples_per_rsi * 13, seed=23)
    comp = encode(raw, cfg)
    want = native.decode(comp, len(raw), cfg)
    for chunk_rsis in (1, 3, 4):
        assert torch_decode(comp, cfg, len(raw), chunk_rsis=chunk_rsis) \
            == want, chunk_rsis
    cut = comp[: 2 * len(comp) // 3]
    want = native.decode(cut, len(raw), cfg)
    assert decode_buffer_tpu(cut, cfg, len(raw), chunk_rsis=3) == want
    assert torch_decode(cut, cfg, len(raw), chunk_rsis=3) == want


def test_zero_runs():
    cfg = Config(16, 64, 64, MSB | PP)
    samples = np.zeros(64 * 64 * 4, dtype=">u2")
    samples[::777] = 9
    raw = samples.tobytes()
    comp = encode(raw, cfg)
    want = native.decode(comp, len(raw), cfg)
    assert want == (AEC_OK, raw)
    assert decode_buffer_tpu(comp, cfg, len(raw)) == want
    assert torch_decode(comp, cfg, len(raw)) == want


def test_part_sink():
    raw = make_raw(SMALL, 7 * SMALL.samples_per_rsi + 99, "midentropy", 3)
    comp = encode(raw, SMALL)
    for stream, n_parts in ((comp, 5), (comp[: len(comp) // 2], 1)):
        want = native.decode(stream, len(raw), SMALL)
        parts = []
        got = libaec_tpu_torch.decode.decode_buffer_device(
            stream, SMALL, len(raw), "cpu", chunk_rsis=2,
            part_sink=parts.append)
        assert got == (want[0], b"")
        assert b"".join(parts) == want[1]
        assert len(parts) == n_parts  # 4 chunks of 2 RSIs or fewer, tail


def test_routing(monkeypatch):
    """Small outputs and block sizes over 64 go to the native decoder;
    3-byte samples take the device path (kernels 3 and 5, then kernel 4's
    byte layout), other widths kernels 3 and 4; a large output on a
    missing CUDA device raises."""
    calls = []

    def record(name, fn):
        def recorded(*args):
            calls.append(name)
            return fn(*args)
        return recorded

    raw = make_raw(SMALL, 3 * SMALL.samples_per_rsi, seed=5)
    comp = encode(raw, SMALL)
    kernels = [(decode_cuda, "decode_blocks"),
               (unpredict_cuda, "unpredict_swizzle"),
               (unpredict_cuda, "unpredict_rsis"),
               (unpredict_cuda, "samples_to_bytes")]
    with monkeypatch.context() as m:
        for mod, name in kernels:
            m.setattr(mod, name, record(name, getattr(mod, name)))
        # under 16 MiB: native, whatever the device
        assert libaec_tpu_torch.decode_buffer_status(
            comp, SMALL, len(raw), device="cuda") == (AEC_OK, raw)
        assert calls == []
        three = ["decode_blocks", "unpredict_rsis", "samples_to_bytes"]
        for cfg, route in (
                (Config(16, 128, 16, MSB | PP | AEC_NOT_ENFORCE), []),
                (Config(24, 64, 16, MSB | PP | AEC_DATA_3BYTE), three),
                (Config(24, 64, 16, MSB | AEC_DATA_3BYTE), three),
                (SMALL, ["decode_blocks", "unpredict_swizzle"])):
            calls.clear()
            r = make_raw(cfg, 3 * cfg.samples_per_rsi + 5, seed=6)
            c = encode(r, cfg)
            assert torch_decode(c, cfg, len(r)) == native.decode(c, len(r),
                                                                 cfg)
            assert calls == route, cfg  # one chunk
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            libaec_tpu_torch.decode_buffer_status(
                comp, SMALL, DEVICE_DECODE_MIN_BYTES, device="cuda")
        with pytest.raises(RuntimeError):
            libaec_tpu_torch.decode_buffer_status(
                comp, SMALL, len(raw), device="cuda", force_device=True)


def _cases(fn):
    """The keyword arguments of every case of a parametrised test."""
    cases = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            names = [n.strip() for n in mark.args[0].split(",")]
            cases = [{**c, **dict(zip(names, v if len(names) > 1 else (v,)))}
                     for c in cases for v in mark.args[1]]
    return cases


FUSED_CASES = [(fn, kwargs) for fn in (
    test_slice_matches_jax_and_native, test_slice_configs_match_native,
    test_slice_other_layouts_match_native,
    test_slice_3byte_matches_jax_and_native,
    test_3byte_truncated_and_mem_error, test_truncated_stream,
    test_mem_error_parity, test_chunked_scan_resume, test_zero_runs,
    test_part_sink) for kwargs in _cases(fn)]
THREE_BYTE = (test_slice_3byte_matches_jax_and_native,
              test_3byte_truncated_and_mem_error)


@pytest.mark.parametrize(
    "fn,kwargs", FUSED_CASES,
    ids=["-".join([fn.__name__[5:], *map(str, kwargs.values())])
         for fn, kwargs in FUSED_CASES])
def test_fused_route(monkeypatch, fn, kwargs):
    """Every case above on the one-kernel route: kernel 6 replaces
    kernels 3 and 4 wherever its gate passes; 3-byte samples keep the
    route of kernels 3, 5 and 4."""
    calls = []
    inner = decode_fused_cuda.decode_unpredict_swizzle

    def counted(*a):
        calls.append(a[0])
        return inner(*a)

    monkeypatch.setattr(decode_fused_cuda, "decode_unpredict_swizzle",
                        counted)
    monkeypatch.setattr(unpredict_cuda, "unpredict_swizzle", None)
    monkeypatch.setenv("LIBAEC_TPU_FUSED_DECODE", "1")
    fn(**kwargs)
    assert bool(calls) == (fn not in THREE_BYTE)


def test_fused_argument(monkeypatch):
    """fused=True and fused=False override the environment; a config
    outside kernel 6's gate takes the route of kernels 3, 5 and 4."""
    raw = make_raw(SMALL, 3 * SMALL.samples_per_rsi + 5, seed=6)
    comp = encode(raw, SMALL)
    want = native.decode(comp, len(raw), SMALL)
    calls = []
    for mod, name in ((decode_fused_cuda, "decode_unpredict_swizzle"),
                      (decode_cuda, "decode_blocks")):
        def recorded(*a, _name=name, _fn=getattr(mod, name)):
            calls.append(_name)
            return _fn(*a)
        monkeypatch.setattr(mod, name, recorded)
    assert torch_decode(comp, SMALL, len(raw), fused=True) == want
    assert calls == ["decode_unpredict_swizzle"]
    calls.clear()
    monkeypatch.setenv("LIBAEC_TPU_FUSED_DECODE", "1")
    assert torch_decode(comp, SMALL, len(raw), fused=False) == want
    assert calls == ["decode_blocks"]
    calls.clear()
    cfg = Config(24, 64, 16, MSB | PP | AEC_DATA_3BYTE)
    assert not decode_fused_cuda.fused_supported(cfg)
    r = make_raw(cfg, 3 * cfg.samples_per_rsi, seed=6)
    c = encode(r, cfg)
    assert torch_decode(c, cfg, len(r), fused=True) == native.decode(
        c, len(r), cfg)
    assert calls == ["decode_blocks"]
