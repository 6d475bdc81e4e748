"""libaec_tpu_torch.szip against the JAX package's szip on the same inputs.

The cases of tests/test_szip.py that need no reference build (parameter
validation, the status-code API, the stubs, batch against single with
padded scanlines and the 32/64-bpp interleave), the SZ cases of
tests/test_fuzz_diff.py held against the JAX package and the C ABI in
place of the reference, and the port's own edges: dirty high bits, a
batch that holds empty and sub-RSI chunks, and no card.  The port runs on
device="cpu": its native routes as they are, its device routes with
force_device=True (the kernels' plain versions on CPU tensors), once more
with LIBAEC_TPU_FUSED_DECODE=1.  Tolerance: byte equality and the same
status.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libaec_tpu import szip as jszip  # noqa: E402
from libaec_tpu_torch import native, szip  # noqa: E402

MSB, NN = szip.SZ_MSB_OPTION_MASK, szip.SZ_NN_OPTION_MASK
ROUTES = {  # name: (force_device, LIBAEC_TPU_FUSED_DECODE)
    "native": (False, None), "device": (True, None),
    "device-fused": (True, "1")}


@pytest.fixture(params=list(ROUTES))
def route(request, monkeypatch):
    """keyword arguments of the port's calls for one route"""
    force, fused = ROUTES[request.param]
    if fused:
        monkeypatch.setenv("LIBAEC_TPU_FUSED_DECODE", fused)
    else:
        monkeypatch.delenv("LIBAEC_TPU_FUSED_DECODE", raising=False)
    return {"device": "cpu", "force_device": force}


def pixels(rng, n_pixels, bpp, mask, hi=None):
    """n_pixels pixels of bpp bits in the byte order the mask selects."""
    size = 8 if bpp == 64 else 4 if bpp > 16 else 2 if bpp > 8 else 1
    if bpp == 64:
        return rng.integers(0, 256, n_pixels * 8, dtype=np.uint16) \
            .astype(np.uint8).tobytes()
    vals = rng.integers(0, hi or 1 << min(bpp, 31), n_pixels, dtype=np.uint64)
    order = ">" if mask & MSB else "<"
    return vals.astype(f"{order}u{size}" if size > 1 else "u1").tobytes()


def test_sz_encoder_enabled_and_stub():
    assert szip.sz_encoder_enabled() == jszip.sz_encoder_enabled() == 1
    assert szip.SZ_encoder_enabled() == 1
    assert szip.SZ_Compress() == jszip.SZ_Compress() == szip.SZ_OK
    for name in ("SZ_OK", "SZ_OUTBUFF_FULL", "SZ_PARAM_ERROR", "SZ_MEM_ERROR",
                 "SZ_NO_ENCODER_ERROR", "SZ_RAW_OPTION_MASK",
                 "SZ_MAX_PIXELS_PER_SCANLINE", "SZ_ALLOW_K13_OPTION_MASK",
                 "SZ_CHIP_OPTION_MASK", "SZ_EC_OPTION_MASK",
                 "SZ_LSB_OPTION_MASK"):
        assert getattr(szip, name) == getattr(jszip, name), name


@pytest.mark.parametrize("args", [
    (MSB, 16, 64, 512),      # ppb > 32
    (MSB, 16, 7, 512),       # odd ppb
    (MSB, 16, 8, 8 * 200),   # > 128 blocks a scanline
    (MSB, 40, 8, 512),       # bad bpp
    (MSB, 16, 0, 512),       # no pixels a block
    (MSB, 16, 8, 0),         # no pixels a scanline
], ids=["ppb>32", "odd-ppb", "blocks>128", "bpp40", "ppb0", "pps0"])
def test_sz_param_validation(args):
    param, jparam = szip.SZCom(*args), jszip.SZCom(*args)
    assert szip.sz_check_params(param) == jszip.sz_check_params(jparam) \
        == szip.SZ_PARAM_ERROR
    for api in ("SZ_BufftoBuffCompress", "SZ_BufftoBuffDecompress"):
        extra = () if api.endswith("Compress") else (64,)
        ours = getattr(szip, api)(b"\0" * 64, param, *extra, device="cpu")
        assert ours == getattr(jszip, api)(b"\0" * 64, jparam, *extra) \
            == (szip.SZ_PARAM_ERROR, b"")
    with pytest.raises(szip.AecError):
        szip.sz_decompress_batch([b"\0"], param, [64], device="cpu")
    assert szip.sz_check_params(szip.SZCom(MSB, 16, 16, 512)) == szip.SZ_OK


def test_sz_status_code_api_roundtrip(route):
    """C-style entry points return (status, bytes) instead of raising;
    output-buffer-full surfaces as SZ_OUTBUFF_FULL."""
    args = (MSB | NN, 16, 16, 256)
    param, jparam = szip.SZCom(*args), jszip.SZCom(*args)
    data = np.arange(2048, dtype=">u2").tobytes()
    st, comp = szip.SZ_BufftoBuffCompress(data, param, **route)
    assert (st, comp) == jszip.SZ_BufftoBuffCompress(data, jparam)
    assert st == szip.SZ_OK
    st, out = szip.SZ_BufftoBuffDecompress(comp, param, len(data), **route)
    assert st == szip.SZ_OK and out == data
    assert (st, out) == jszip.SZ_BufftoBuffDecompress(comp, jparam, len(data))
    full = szip.SZ_BufftoBuffCompress(data, param, dest_len=4, **route)
    assert full == jszip.SZ_BufftoBuffCompress(data, jparam, dest_len=4) \
        == (szip.SZ_OUTBUFF_FULL, b"")
    with pytest.raises(szip.AecError) as err:
        szip.sz_buffto_buff_compress(data, param, 4, **route)
    assert err.value.status == szip.SZ_OUTBUFF_FULL
    # a truncated stream: the decode's own status, as the JAX package's
    cut = comp[: len(comp) // 3]
    assert szip.SZ_BufftoBuffDecompress(cut, param, len(data), **route) \
        == jszip.SZ_BufftoBuffDecompress(cut, jparam, len(data))


BATCH_CASES = {  # (mask, bpp, ppb, pps), numpy dtype, pixels a chunk
    "padded scanlines": ((MSB | NN, 16, 16, 250), ">u2", 250 * 7),
    "padded, ragged": ((MSB | NN, 16, 16, 250), ">u2", 250 * 3 + 17),
    "64-bpp interleave": ((MSB | NN, 64, 8, 64), ">u8", 64 * 9 + 5),
    "32-bpp interleave": ((NN, 32, 32, 1024), "<u4", 1024 * 3),
    "ppb 4 (native)": ((MSB | NN, 16, 4, 100), ">u2", 100 * 5 + 1),
    "8-bit no NN": ((0, 8, 8, 100), "u1", 100 * 6 + 3),
}


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_sz_decompress_batch_matches_single(name, monkeypatch):
    """Batch decompress (decode_buffers: shared chunks of the kernels'
    plain versions) equals the per-buffer path and the JAX package's, for
    chunks of several sizes, one of them shorter than one RSI and one
    empty; every route once more with LIBAEC_TPU_FUSED_DECODE=1."""
    args, dt, n = BATCH_CASES[name]
    param, jparam = szip.SZCom(*args), jszip.SZCom(*args)
    rng = np.random.default_rng(3)
    hi = 3000 if dt.endswith("2") else 200
    datas = [rng.integers(0, hi, n + k).astype(dt).tobytes()
             for k in range(4)]
    datas += [rng.integers(0, hi, 3).astype(dt).tobytes(), b""]
    comps = [szip.sz_buffto_buff_compress(d, param, device="cpu",
                                          force_device=True) for d in datas]
    assert comps == [jszip.sz_buffto_buff_compress(d, jparam) for d in datas]
    sizes = [len(d) for d in datas]
    singles = [jszip.sz_buffto_buff_decompress(c, jparam, s)
               for c, s in zip(comps, sizes)]
    assert singles == datas
    for fused in (None, "1"):
        if fused:
            monkeypatch.setenv("LIBAEC_TPU_FUSED_DECODE", fused)
        batch = szip.sz_decompress_batch(comps, param, sizes, device="cpu")
        assert batch == singles
        for force in (False, True):
            assert [szip.sz_buffto_buff_decompress(
                c, param, s, device="cpu", force_device=force)
                for c, s in zip(comps, sizes)] == singles


def test_sz_decompress_batch_matches_jax_batch():
    args, dt, n = BATCH_CASES["padded, ragged"]
    param, jparam = szip.SZCom(*args), jszip.SZCom(*args)
    rng = np.random.default_rng(5)
    datas = [rng.integers(0, 3000, n + k).astype(dt).tobytes()
             for k in range(3)]
    comps = [jszip.sz_buffto_buff_compress(d, jparam) for d in datas]
    sizes = [len(d) for d in datas]
    assert szip.sz_decompress_batch(comps, param, sizes, device="cpu") \
        == jszip.sz_decompress_batch(comps, jparam, sizes) == datas
    assert szip.sz_decompress_batch([], param, [], device="cpu") == []


def test_sz_decompress_batch_raises_first_failing_status():
    args = (MSB | NN, 16, 16, 256)
    param, jparam = szip.SZCom(*args), jszip.SZCom(*args)
    data = np.arange(4096, dtype=">u2").tobytes()
    comp = szip.sz_buffto_buff_compress(data, param, device="cpu")
    streams = [comp, comp[: len(comp) // 2], comp]
    sizes = [len(data), len(data), len(data) - 1]  # the last: MEM_ERROR
    with pytest.raises(szip.AecError) as ours:
        szip.sz_decompress_batch(streams, param, sizes, device="cpu")
    with pytest.raises(jszip.AecError) as theirs:
        jszip.sz_decompress_batch(streams, jparam, sizes)
    assert ours.value.status == theirs.value.status != szip.SZ_OK
    # a stream truncated to half decodes what it holds, status OK
    assert szip.sz_decompress_batch(streams[:2], param, sizes[:2],
                                    device="cpu") \
        == jszip.sz_decompress_batch(streams[:2], jparam, sizes[:2])


@pytest.mark.parametrize("route_name", ["native", "device"])
@pytest.mark.parametrize("bpp", [4, 13, 24])
def test_sz_dirty_high_bits_encode_masked(bpp, route_name):
    """Storage bits above bits_per_pixel are masked at ingest on every
    route, as in the JAX package."""
    rng = np.random.default_rng(bpp)
    args = (MSB | NN, bpp, 16, 256)
    param, jparam = szip.SZCom(*args), jszip.SZCom(*args)
    size = 4 if bpp > 16 else 2 if bpp > 8 else 1
    vals = rng.integers(0, 1 << bpp, 256 * 5 + 9, dtype=np.uint64)
    junk = rng.integers(0, 1 << (8 * size), vals.size, dtype=np.uint64)
    dirty = vals | (junk & np.uint64(((1 << 8 * size) - 1) ^ ((1 << bpp) - 1)))
    dt = f">u{size}" if size > 1 else "u1"
    clean_b, dirty_b = vals.astype(dt).tobytes(), dirty.astype(dt).tobytes()
    force = ROUTES[route_name][0]
    comp = szip.sz_buffto_buff_compress(dirty_b, param, device="cpu",
                                        force_device=force)
    assert comp == jszip.sz_buffto_buff_compress(dirty_b, jparam) \
        == jszip.sz_buffto_buff_compress(clean_b, jparam)
    assert szip.sz_buffto_buff_decompress(comp, param, len(clean_b),
                                          device="cpu") == clean_b


class CSZCom(ctypes.Structure):
    _fields_ = [("options_mask", ctypes.c_int),
                ("bits_per_pixel", ctypes.c_int),
                ("pixels_per_block", ctypes.c_int),
                ("pixels_per_scanline", ctypes.c_int)]


def fuzz_case(case):
    """tests/test_fuzz_diff.py's SZ parameter draw: (args, source), or
    None when the parameters are invalid."""
    rng = np.random.default_rng(424242 + case)
    ppb = int(rng.choice([2, 4, 8, 10, 16, 32]))
    pps = int(rng.integers(1, min(ppb * 128, 2048) + 1))
    bpp = int(rng.choice([4, 8, 13, 16, 24, 32, 64]))
    mask = (MSB if rng.random() < 0.7 else 0) | (NN if rng.random() < 0.7
                                                 else 0)
    args = (mask, bpp, ppb, pps)
    if jszip.sz_check_params(jszip.SZCom(*args)) != jszip.SZ_OK:
        return None
    return args, pixels(rng, int(rng.integers(1, 4 * pps + 1)), bpp, mask)


@pytest.mark.parametrize("case", range(24))
def test_sz_fuzz_matches_jax_and_c_abi(case, monkeypatch):
    """Random SZ parameter sets and pixel buffers: the port's compress on
    its native and device routes equals the JAX package's and the port's
    C ABI (SZ_BufftoBuffCompress in native.library_path()); its
    decompress, single and batch, equals the JAX package's."""
    drawn = fuzz_case(case)
    if drawn is None:
        args = (MSB | NN, 16, 8, 64)  # an invalid draw: a fixed valid set
        drawn = args, pixels(np.random.default_rng(case), 300, 16, MSB)
    args, src = drawn
    param, jparam = szip.SZCom(*args), jszip.SZCom(*args)
    want = jszip.sz_buffto_buff_compress(src, jparam)
    for force in (False, True):
        assert szip.sz_buffto_buff_compress(
            src, param, device="cpu", force_device=force) == want, force

    lib = native.get_lib()
    dest = ctypes.create_string_buffer(2 * len(src) + 4096)
    dlen = ctypes.c_size_t(len(dest))
    st = lib.SZ_BufftoBuffCompress(dest, ctypes.byref(dlen), src, len(src),
                                   ctypes.byref(CSZCom(*args)))
    assert st == 0 and dest.raw[: dlen.value] == want

    back = jszip.sz_buffto_buff_decompress(want, jparam, len(src))
    if args[1] in (8, 16, 32, 64):
        assert back == src
    monkeypatch.setenv("LIBAEC_TPU_FUSED_DECODE", "1" if case % 2 else "")
    for force in (False, True):
        assert szip.sz_buffto_buff_decompress(
            want, param, len(src), device="cpu", force_device=force) == back
    assert szip.sz_decompress_batch([want, want], param, [len(src)] * 2,
                                    device="cpu") == [back, back]


def test_sz_device_route_without_a_card_raises(monkeypatch):
    """No fallback hides the device: inside the kernel gates, a missing
    card raises on the device routes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    param = szip.SZCom(MSB | NN, 16, 16, 256)
    data = np.arange(4096, dtype=">u2").tobytes()
    with pytest.raises(RuntimeError, match="CUDA"):
        szip.sz_buffto_buff_compress(data, param, device="cuda",
                                     force_device=True)
    comp = szip.sz_buffto_buff_compress(data, param, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        szip.sz_buffto_buff_decompress(comp, param, len(data),
                                       device="cuda", force_device=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        szip.sz_decompress_batch([comp], param, [len(data)], device="cuda")
    # below the thresholds the native routes need no card
    assert szip.sz_buffto_buff_decompress(comp, param, len(data)) == data
