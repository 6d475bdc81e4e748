"""libaec_tpu_torch.decode_buffers (many streams, shared device chunks)
against the JAX package's decode_buffers_tpu and the per-stream decode.

The streams of tests/test_decode_tpu.py's batch test (5, 1, 9 and 3 RSIs
with ragged tails, and one truncated), with chunk_rsis=2 so that streams
both share a device chunk and span several, on the two-kernel route and
on the one-kernel route, on CPU tensors (the kernels' plain versions).
Tolerance zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gen import gen_values, pack_samples  # noqa: E402

import libaec_tpu_torch  # noqa: E402
from libaec_tpu import Config, native  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_NOT_ENFORCE,
)
from libaec_tpu.decode import decode_buffers_tpu  # noqa: E402
from libaec_tpu_torch import decode as torch_decode  # noqa: E402
from libaec_tpu_torch.kernels import decode_fused_cuda  # noqa: E402

PP, MSB = AEC_DATA_PREPROCESS, AEC_DATA_MSB
CFG = Config(16, 64, 16, MSB | PP)


def make_streams(cfg, seed=31):
    """(streams, out_sizes): 5, 1, 9, 3 RSIs + 0, 64, 128, 192 bytes, then
    the third stream cut in half."""
    rng = np.random.default_rng(seed)
    raws, comps = [], []
    for k, n_rsi in enumerate([5, 1, 9, 3]):
        n = (cfg.rsi_len_bytes * n_rsi + k * 64) // cfg.bytes_per_sample
        raw = pack_samples(gen_values(rng, n, cfg.bits_per_sample, cfg.signed,
                                      "lowentropy"),
                           cfg.bits_per_sample, cfg.flags)
        raws.append(raw)
        comps.append(native.encode(raw, cfg)[1])
    comps.append(comps[2][: len(comps[2]) // 2])
    raws.append(raws[2])
    return comps, [len(r) for r in raws]


@pytest.mark.parametrize("fused", [False, True], ids=["two-kernel", "fused"])
@pytest.mark.parametrize("chunk_rsis", [2, 4, None])
def test_many_matches_jax_and_single(fused, chunk_rsis, monkeypatch):
    comps, sizes = make_streams(CFG)
    chunks = []
    inner = torch_decode.decode_chunk

    def counted(cfg, win, rec, n_rsi, use_fused):
        assert use_fused == fused
        chunks.append(n_rsi)
        return inner(cfg, win, rec, n_rsi, use_fused)

    monkeypatch.setattr(torch_decode, "decode_chunk", counted)
    got = libaec_tpu_torch.decode_buffers(
        comps, CFG, sizes, device="cpu", scan_threads=2,
        chunk_rsis=chunk_rsis, fused=fused)
    monkeypatch.undo()
    assert got == decode_buffers_tpu(comps, CFG, sizes, scan_threads=2,
                                     chunk_rsis=2)
    for i, (comp, size) in enumerate(zip(comps, sizes)):
        assert got[i] == torch_decode.decode_buffer_device(
            comp, CFG, size, "cpu"), i
        assert got[i] == native.decode(comp, size, CFG), i
    total = sum(chunks)
    assert 18 < total <= 18 + 9     # whole streams, part of the cut one
    if chunk_rsis == 2:
        # 5 = 2+2+1, then 1 shares the odd RSI's chunk; 9 = 2+2+2+2+1 ...
        assert max(chunks) == 2 and len(chunks) < total
    elif chunk_rsis is None:
        assert chunks == [total]    # every stream in one device chunk


@pytest.mark.parametrize("fused", [False, True], ids=["two-kernel", "fused"])
def test_many_edges(fused):
    """No stream, an empty stream, an empty output, a stream shorter than
    one RSI and an output size short of a whole sample: what the
    per-stream decode gives."""
    assert libaec_tpu_torch.decode_buffers([], CFG, [], device="cpu") == []
    comps, sizes = make_streams(CFG, seed=5)
    rng = np.random.default_rng(9)
    short = pack_samples(gen_values(rng, 100, 16, False, "lowentropy"), 16,
                         CFG.flags)
    comps += [b"", comps[0], native.encode(short, CFG)[1], comps[3]]
    sizes += [CFG.rsi_len_bytes, 0, len(short), sizes[3] - 1]
    got = libaec_tpu_torch.decode_buffers(
        comps, CFG, sizes, device="cpu", chunk_rsis=2, fused=fused)
    assert len(got) == len(comps)
    for i, (comp, size) in enumerate(zip(comps, sizes)):
        assert got[i] == native.decode(comp, size, CFG), i
        assert got[i] == torch_decode.decode_buffer_device(
            comp, CFG, size, "cpu", fused=fused), i
    assert got[-2] == (0, short)


@pytest.mark.parametrize("bps,bs,rsi,flags", [
    (24, 64, 8, MSB | PP | AEC_DATA_3BYTE),   # kernels 3, 5 and 4
    (8, 10, 3, AEC_NOT_ENFORCE),              # rows not word-aligned
    (32, 16, 7, MSB | PP),
])
def test_many_other_configs(bps, bs, rsi, flags):
    cfg = Config(bps, bs, rsi, flags)
    comps, sizes = make_streams(cfg, seed=bps)
    want = [native.decode(c, s, cfg) for c, s in zip(comps, sizes)]
    for fused in (False, True):
        assert libaec_tpu_torch.decode_buffers(
            comps, cfg, sizes, device="cpu", chunk_rsis=3,
            fused=fused) == want
    assert decode_buffers_tpu(comps, cfg, sizes, chunk_rsis=3) == want


def test_many_env_and_refusals(monkeypatch):
    comps, sizes = make_streams(CFG)
    calls = []
    inner = decode_fused_cuda.decode_unpredict_swizzle
    monkeypatch.setattr(
        decode_fused_cuda, "decode_unpredict_swizzle",
        lambda *a: calls.append(a[-1]) or inner(*a))
    monkeypatch.setenv("LIBAEC_TPU_FUSED_DECODE", "1")
    got = libaec_tpu_torch.decode_buffers(comps, CFG, sizes, device="cpu")
    assert calls and got[0] == native.decode(comps[0], sizes[0], CFG)
    big = Config(16, 128, 16, AEC_NOT_ENFORCE)
    with pytest.raises(ValueError):
        libaec_tpu_torch.decode_buffers(comps, big, sizes, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            libaec_tpu_torch.decode_buffers(comps, CFG, sizes)
