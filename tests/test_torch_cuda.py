"""libaec_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (`cuda` marker) and skips without
one: a CUDA kernel has no CPU mode.  The file imports neither JAX nor the
JAX package (the bit-exact reference is libaec_tpu_torch.native), so it
also runs on a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -q

The plain versions are held against the JAX package by the other
tests/test_torch_*.py files.  Tolerance zero: the codec is lossless.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gen import KINDS, gen_values  # noqa: E402

import libaec_tpu_torch  # noqa: E402
from chip_smoke import pack_samples  # noqa: E402
from libaec_tpu_torch import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
    Config,
    native,
)
from libaec_tpu_torch.decode import WF_BUCKETS, scan_record_arrays  # noqa: E402
from libaec_tpu_torch.kernels import (  # noqa: E402
    decode_cuda,
    decode_fused_cuda,
    encode_cuda,
    merge_cuda,
    unpredict_cuda,
)
from libaec_tpu_torch.ops import bitpack, bitunpack  # noqa: E402
from libaec_tpu_torch.ops.u32 import u32_to_bits  # noqa: E402

pytestmark = pytest.mark.cuda

BENCH = Config(16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def chunk(cfg, n_rsi, seed):
    """n_rsi RSIs of stream bytes, one segment per tests/gen.py kind."""
    rng = np.random.default_rng(seed)
    S = cfg.samples_per_rsi
    per = -(-n_rsi // len(KINDS))
    vals = np.concatenate([
        gen_values(rng, per * S, cfg.bits_per_sample, cfg.signed, kind)
        for kind in KINDS])[: n_rsi * S]
    return torch.from_numpy(np.frombuffer(
        pack_samples(vals, cfg.bits_per_sample, cfg.flags), np.uint8).copy())


@pytest.mark.parametrize("cfg", [
    BENCH,
    Config(8, 16, 128, 0),
    Config(13, 32, 64, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS | AEC_DATA_MSB),
    Config(32, 64, 256, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
    Config(16, 10, 32, AEC_DATA_MSB | AEC_DATA_PREPROCESS | AEC_NOT_ENFORCE),
    Config(24, 48, 16, AEC_DATA_MSB | AEC_DATA_PREPROCESS | AEC_DATA_3BYTE
           | AEC_NOT_ENFORCE),
], ids=["bench16", "u8", "s13", "s32", "bs10", "u24bs48"])
def test_encode_kernel_matches_plain(dev, cfg):
    raw = chunk(cfg, 24, cfg.bits_per_sample)
    k0 = torch.tensor([min(3, cfg.kmax)], dtype=torch.int32)
    want = encode_cuda.encode_fields_plain(cfg, raw, k0)
    got = encode_cuda.encode_fields(cfg, raw.to(dev), k0.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bit0", range(8))
def test_merge_kernel_matches_plain(dev, bit0):
    win, bb, _ = encode_cuda.encode_fields_plain(
        BENCH, chunk(BENCH, 24, 5), torch.tensor([0], dtype=torch.int32))
    nwords = merge_cuda.word_count(BENCH, win.shape[0], win.shape[1] - 1)
    b0 = torch.tensor([bit0], dtype=torch.int64)
    want = bitpack.merge_windows(win, bb, b0, nwords)
    got = merge_cuda.merge_windows(win.to(dev), bb.to(dev), b0.to(dev),
                                   nwords)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("kind", ["lowentropy", "zero_runs", "random"])
def test_encode_buffer_matches_native(dev, kind):
    rng = np.random.default_rng(11)
    vals = gen_values(rng, 40 * BENCH.samples_per_rsi + 999, 16, False, kind)
    data = pack_samples(vals, 16, BENCH.flags)
    want = native.encode(data, BENCH)[1]
    assert libaec_tpu_torch.encode_buffer(
        data, BENCH, device=dev, force_device=True, rsis_per_chunk=7) == want


@pytest.mark.parametrize("bps", range(1, 33))
def test_kernels_sweep_widths_and_layouts(dev, bps):
    """Every width with several flag sets, block sizes (AEC_NOT_ENFORCE
    sizes 10, 24 and 48 among them) and RSI lengths (RSIs of 1 block, of
    lengths that cut a 64-block segment, 3-byte samples): kernel 1
    against its plain version from a random k_init, and the whole slice,
    in several chunks with an odd tail, against the native encoder."""
    rng = np.random.default_rng(100 + bps)
    pp, sgn, msb = AEC_DATA_PREPROCESS, AEC_DATA_SIGNED, AEC_DATA_MSB
    for flags in (0, pp, pp | sgn, pp | msb | AEC_DATA_3BYTE, sgn | msb):
        bs = int(rng.choice([8, 16, 32, 64, 10, 24, 48]))
        if bs not in (8, 16, 32, 64):
            flags |= AEC_NOT_ENFORCE
        cfg = Config(bps, bs, int(rng.choice([1, 3, 64, 100, 257])), flags)
        if not encode_cuda.kernel_supported(cfg):
            continue
        n_rsi = max(2, 1024 // cfg.rsi)
        raw = chunk(cfg, n_rsi, bps * 31 + flags)
        k0 = torch.tensor([int(rng.integers(0, cfg.kmax + 1))],
                          dtype=torch.int32)
        want = encode_cuda.encode_fields_plain(cfg, raw, k0)
        got = encode_cuda.encode_fields(cfg, raw.to(dev), k0.to(dev))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), cfg
        data = raw.numpy().tobytes() + raw.numpy()[: 5 * cfg.block_size
                                                   * cfg.bytes_per_sample
                                                   + 1].tobytes()
        assert libaec_tpu_torch.encode_buffer(
            data, cfg, device=dev, force_device=True,
            rsis_per_chunk=max(1, n_rsi // 3)) == \
            native.encode(data, cfg)[1], cfg


U24 = Config(24, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS | AEC_DATA_3BYTE)
DECODE_CONFIGS = [
    BENCH,
    Config(8, 16, 128, 0),
    Config(13, 32, 64, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS | AEC_DATA_MSB),
    Config(32, 64, 256, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
    Config(16, 64, 256, AEC_DATA_MSB),
    U24,
]
DECODE_IDS = ["bench16", "u8", "s13", "s32", "nopp16", "u24"]


def scanned(cfg, raw):
    """(stream, scan records, the decode path's bucket width) of raw."""
    n_rsi = len(raw) // cfg.rsi_len_bytes
    comp = native.encode(raw, cfg)[1]
    recs, cnt, tail_bit = native.scan_blocks(
        comp, n_rsi, bitunpack.max_fs_bits(cfg), cfg, wf=0)
    assert cnt == n_rsi
    return comp, dict(recs), bitunpack.bucket_wf(cfg, recs, tail_bit)


@pytest.mark.parametrize("cfg", DECODE_CONFIGS, ids=DECODE_IDS)
@pytest.mark.parametrize("kind", ["lowentropy", "mixed"])
def test_decode_kernel_matches_plain(dev, cfg, kind):
    """Kernel 3 against its plain version at the chunk's bucket width and
    every wider width the decode path can choose."""
    if kind == "lowentropy":
        rng = np.random.default_rng(3)
        raw = pack_samples(gen_values(rng, 24 * cfg.samples_per_rsi,
                                      cfg.bits_per_sample, cfg.signed,
                                      kind), cfg.bits_per_sample, cfg.flags)
    else:  # one segment per tests/gen.py kind
        raw = chunk(cfg, 24, cfg.bits_per_sample).numpy().tobytes()
    comp, recs, bucket = scanned(cfg, raw)
    wf_max = bitunpack.window_words(cfg)
    widths = sorted({w for w in (*WF_BUCKETS, wf_max)
                     if bucket <= w <= wf_max})
    for wf in widths:
        recs["win"] = native.fill_windows(comp, recs["fs_off"],
                                          recs["meta"], wf)
        args = [u32_to_bits(a) for a in scan_record_arrays(recs)]
        want = decode_cuda.decode_blocks_plain(cfg, *args)
        got = decode_cuda.decode_blocks(cfg, *(a.to(dev) for a in args))
        assert torch.equal(got.cpu(), want), wf


@pytest.mark.parametrize("cfg", DECODE_CONFIGS + [
    Config(1, 8, 16, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
    Config(8, 10, 3, AEC_NOT_ENFORCE),  # rows of 30 bytes
], ids=DECODE_IDS + ["s1", "u8bs10"])
@pytest.mark.parametrize("full_range", [False, True])
def test_unpredict_kernel_matches_plain(dev, cfg, full_range):
    """Kernel 4 against its plain version on random deltas; full_range
    draws them from all of u32 (the signed path's int32 wrap-around)."""
    n_rsi = 40
    rng = np.random.default_rng(cfg.bits_per_sample + 7 * full_range)
    hi = 1 << (32 if full_range else min(cfg.bits_per_sample, 31))
    deltas = u32_to_bits(rng.integers(
        0, hi, (n_rsi, cfg.samples_per_rsi), dtype=np.uint64).astype(
            np.uint32))
    want = unpredict_cuda.unpredict_swizzle_plain(cfg, deltas)
    got = unpredict_cuda.unpredict_swizzle(cfg, deltas.to(dev))
    assert torch.equal(got.cpu(), want)


# kernel 5's configs: 3-byte samples (the decode path's), and others
RSIS_CONFIGS = [
    U24,
    Config(17, 32, 64, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS | AEC_DATA_3BYTE),
    Config(24, 16, 8, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS | AEC_DATA_3BYTE),
    Config(20, 10, 3, AEC_DATA_PREPROCESS | AEC_DATA_3BYTE
           | AEC_NOT_ENFORCE),  # 3-byte rows of 90 bytes
    BENCH,
    Config(32, 64, 8, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
]
RSIS_IDS = ["u24", "s17", "s24", "u20bs10", "bench16", "s32"]


def random_deltas(cfg, n_rsi, seed, full_range):
    """Random deltas (int32 bits), in range or from all of u32."""
    rng = np.random.default_rng(seed)
    hi = 1 << (32 if full_range else min(cfg.bits_per_sample, 31))
    return u32_to_bits(rng.integers(
        0, hi, (n_rsi, cfg.samples_per_rsi), dtype=np.uint64).astype(
            np.uint32))


@pytest.mark.parametrize("cfg", RSIS_CONFIGS, ids=RSIS_IDS)
@pytest.mark.parametrize("full_range", [False, True])
def test_unpredict_rsis_kernel_matches_plain(dev, cfg, full_range):
    """Kernel 5 against its plain version; then the byte layout (kernel 4
    without preprocessing) on its samples against the layout's plain
    version, and kernel 4 in one pass against the two."""
    deltas = random_deltas(cfg, 40, cfg.bits_per_sample + 5 * full_range,
                           full_range)
    before = unpredict_cuda.rsis_launches, unpredict_cuda.layout_launches
    want = unpredict_cuda.unpredict_rsis_plain(cfg, deltas)
    got = unpredict_cuda.unpredict_rsis(cfg, deltas.to(dev))
    assert torch.equal(got.cpu(), want)
    layout = unpredict_cuda.samples_to_bytes(cfg, got)
    assert torch.equal(layout.cpu(),
                       unpredict_cuda.samples_to_bytes_plain(cfg, want))
    assert (unpredict_cuda.rsis_launches - before[0],
            unpredict_cuda.layout_launches - before[1]) == (1, 1)
    one_pass = unpredict_cuda.unpredict_swizzle(cfg, deltas.to(dev))
    assert torch.equal(one_pass, layout)


@pytest.mark.parametrize("msb", [0, AEC_DATA_MSB])
@pytest.mark.parametrize("bps,bs,rsi,extra", [
    (24, 64, 4, AEC_DATA_3BYTE),                    # word-aligned rows
    (17, 10, 3, AEC_DATA_3BYTE | AEC_NOT_ENFORCE),  # rows of 90 bytes
    (16, 8, 5, 0),
    (8, 10, 1, AEC_NOT_ENFORCE),                    # rows of 10 bytes
])
def test_samples_to_bytes_kernel_matches_plain(dev, msb, bps, bs, rsi,
                                               extra):
    cfg = Config(bps, bs, rsi, extra | msb)
    samples = random_deltas(cfg, 37, bps + bs + msb, True)
    want = unpredict_cuda.samples_to_bytes_plain(cfg, samples)
    assert want.shape == (37, cfg.samples_per_rsi * cfg.bytes_per_sample)
    got = unpredict_cuda.samples_to_bytes(cfg, samples.to(dev))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["lowentropy", "midentropy", "zero_runs",
                                  "random"])
def test_decode_buffer_3byte_matches_native(dev, kind):
    """The 3-byte decode slice (kernels 3, 5 and the byte layout) in
    several chunks, whole and truncated, and with an output size short
    of a whole sample."""
    cfg = Config(24, 64, 16, U24.flags)
    rng = np.random.default_rng(19)
    vals = gen_values(rng, 40 * cfg.samples_per_rsi + 999, 24, False, kind)
    data = pack_samples(vals, 24, cfg.flags)
    comp = native.encode(data, cfg)[1]

    def decode(stream, out_size):
        return libaec_tpu_torch.decode_buffer_status(
            stream, cfg, out_size, device=dev, force_device=True,
            chunk_rsis=7)

    counters = ("launches", "rsis_launches", "layout_launches")
    before = [getattr(unpredict_cuda, c) for c in counters]
    assert decode(comp, len(data)) == (0, data)
    moved = [getattr(unpredict_cuda, c) - b for c, b in zip(counters, before)]
    assert moved == [0, 6, 6]  # 40 RSIs in 7-RSI chunks
    for stream, out_size in ((comp[: len(comp) // 2 + 3], len(data)),
                             (comp, len(data) - 1), (comp, len(data) - 2)):
        assert decode(stream, out_size) == native.decode(stream, out_size,
                                                         cfg)


@pytest.mark.parametrize("kind", ["lowentropy", "midentropy", "zero_runs",
                                  "random"])
def test_decode_buffer_matches_native(dev, kind):
    """The decode slice in several chunks, whole and truncated, and with
    an output size short of a whole sample."""
    rng = np.random.default_rng(17)
    vals = gen_values(rng, 40 * BENCH.samples_per_rsi + 999, 16, False, kind)
    data = pack_samples(vals, 16, BENCH.flags)
    comp = native.encode(data, BENCH)[1]

    def decode(stream, out_size):
        return libaec_tpu_torch.decode_buffer_status(
            stream, BENCH, out_size, device=dev, force_device=True,
            chunk_rsis=7)

    before = decode_cuda.launches, unpredict_cuda.launches
    assert decode(comp, len(data)) == (0, data)
    assert decode_cuda.launches - before[0] == 6  # 40 RSIs in 7-RSI chunks
    assert unpredict_cuda.launches - before[1] == 6
    for stream, out_size in ((comp[: len(comp) // 2 + 3], len(data)),
                             (comp, len(data) - 1)):
        assert decode(stream, out_size) == native.decode(stream, out_size,
                                                         BENCH)


@pytest.mark.parametrize("bps", range(1, 33))
def test_decode_sweep_widths_and_layouts(dev, bps):
    """The decode slice on every width with several flag sets, block sizes
    and RSI lengths, in several chunks, against the native decoder.  Every
    config reaches the card; 3-byte samples with preprocessing go through
    kernel 5."""
    rng = np.random.default_rng(200 + bps)
    pp, sgn, msb = AEC_DATA_PREPROCESS, AEC_DATA_SIGNED, AEC_DATA_MSB
    for flags in (0, pp, pp | sgn, pp | msb | AEC_DATA_3BYTE, sgn | msb):
        cfg = Config(bps, int(rng.choice([8, 16, 32, 64])),
                     int(rng.choice([1, 3, 64, 100, 257])), flags)
        n_rsi = max(2, 1024 // cfg.rsi)
        raw = chunk(cfg, n_rsi, bps * 37 + flags).numpy().tobytes()
        data = raw + raw[: 5 * cfg.block_size * cfg.bytes_per_sample]
        comp = native.encode(data, cfg)[1]
        before = decode_cuda.launches, unpredict_cuda.rsis_launches
        assert libaec_tpu_torch.decode_buffer_status(
            comp, cfg, len(data), device=dev, force_device=True,
            chunk_rsis=max(1, n_rsi // 3)) == \
            native.decode(comp, len(data), cfg), cfg
        assert decode_cuda.launches > before[0], cfg
        assert (unpredict_cuda.rsis_launches > before[1]) == (
            cfg.bytes_per_sample == 3 and cfg.preprocess), cfg


FUSED_CONFIGS = [cfg for cfg in DECODE_CONFIGS if cfg is not U24] + [
    Config(16, 10, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS
           | AEC_NOT_ENFORCE),                 # 12 blocks a slab
    Config(8, 10, 3, AEC_NOT_ENFORCE),         # rows of 30 bytes
    Config(32, 48, 8, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS
           | AEC_NOT_ENFORCE),                 # 2 blocks a slab
    Config(1, 8, 16, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
]
FUSED_IDS = DECODE_IDS[:-1] + ["bs10", "u8bs10", "s32bs48", "s1"]


@pytest.mark.parametrize("cfg", FUSED_CONFIGS, ids=FUSED_IDS)
@pytest.mark.parametrize("n_rsi", [1, 24, 33, 77])
def test_fused_kernel_matches_plain(dev, cfg, n_rsi):
    """Kernel 6 against its plain version, kernels 3 + 4 and native.decode,
    at the chunk's bucket width and every wider width the decode path can
    choose; RSI counts below, at and across the 32-RSI group."""
    raw = chunk(cfg, n_rsi, cfg.bits_per_sample + n_rsi).numpy().tobytes()
    comp, recs, bucket = scanned(cfg, raw)
    wf_max = bitunpack.window_words(cfg)
    want = None
    for wf in sorted({w for w in (*WF_BUCKETS, wf_max)
                      if bucket <= w <= wf_max}):
        recs["win"] = native.fill_windows(comp, recs["fs_off"],
                                          recs["meta"], wf)
        args = [u32_to_bits(a) for a in scan_record_arrays(recs)]
        if want is None:
            want = decode_fused_cuda.decode_unpredict_swizzle_plain(
                cfg, *args, n_rsi)
            assert want.numpy().tobytes() == native.decode(
                comp, len(raw), cfg)[1]
        before = decode_fused_cuda.launches
        on_dev = [a.to(dev) for a in args]
        got = decode_fused_cuda.decode_unpredict_swizzle(cfg, *on_dev, n_rsi)
        assert decode_fused_cuda.launches == before + 1
        assert torch.equal(got.cpu(), want), wf
        two = unpredict_cuda.unpredict_swizzle(
            cfg, decode_cuda.decode_blocks(cfg, *on_dev).view(
                n_rsi, cfg.samples_per_rsi))
        assert torch.equal(got, two), wf


@pytest.mark.parametrize("n_rsi", [3000, 5000, 10000])
def test_fused_kernel_group_sizes(dev, n_rsi):
    """Many short RSIs: kernel 6 gives a thread block 8, 16 or 32 of them
    instead of 4 once the chunk has more than the card holds at once."""
    cfg = Config(8, 8, 2, AEC_DATA_PREPROCESS)
    raw = chunk(cfg, n_rsi, n_rsi).numpy().tobytes()
    comp, recs, wf = scanned(cfg, raw)
    recs["win"] = native.fill_windows(comp, recs["fs_off"], recs["meta"], wf)
    args = [u32_to_bits(a).to(dev) for a in scan_record_arrays(recs)]
    got = decode_fused_cuda.decode_unpredict_swizzle(cfg, *args, n_rsi)
    assert got.cpu().numpy().tobytes() == native.decode(comp, len(raw),
                                                        cfg)[1]
    want = decode_fused_cuda.decode_unpredict_swizzle_plain(
        cfg, *(a.cpu() for a in args), n_rsi)
    assert torch.equal(got.cpu(), want)


def test_fused_kernel_refuses(dev):
    """Outside its gate, and on tensors it does not take, kernel 6's
    wrapper raises; nothing falls back."""
    win = torch.zeros(8, 6, dtype=torch.int32, device=dev)
    rec = torch.zeros(8, dtype=torch.int32, device=dev)
    cfg = Config(16, 64, 4, AEC_DATA_PREPROCESS)
    out = decode_fused_cuda.decode_unpredict_swizzle(cfg, win, rec, rec, rec,
                                                     rec, 2)
    assert out.shape == (2, cfg.rsi_len_bytes) and not out.any()
    with pytest.raises(ValueError):
        decode_fused_cuda.decode_unpredict_swizzle(
            Config(24, 64, 4, AEC_DATA_3BYTE), win, rec, rec, rec, rec, 2)
    with pytest.raises(ValueError):
        decode_fused_cuda.decode_unpredict_swizzle(
            cfg, win, rec.cpu(), rec, rec, rec, 2)
    with pytest.raises(ValueError):
        decode_fused_cuda.decode_unpredict_swizzle(
            cfg, win.to(torch.int64), rec, rec, rec, rec, 2)
    with pytest.raises(ValueError):
        decode_fused_cuda.decode_unpredict_swizzle(
            cfg, win.t().contiguous().t(), rec, rec, rec, rec, 2)


@pytest.mark.parametrize("kind", ["lowentropy", "midentropy", "zero_runs",
                                  "random"])
def test_decode_buffer_fused_matches_native(dev, kind):
    """The decode slice on the one-kernel route, in several chunks, whole
    and truncated, and with an output size short of a whole sample:
    kernel 6 once per chunk, kernels 3 and 4 not at all."""
    rng = np.random.default_rng(23)
    vals = gen_values(rng, 40 * BENCH.samples_per_rsi + 999, 16, False, kind)
    data = pack_samples(vals, 16, BENCH.flags)
    comp = native.encode(data, BENCH)[1]

    def decode(stream, out_size):
        return libaec_tpu_torch.decode_buffer_status(
            stream, BENCH, out_size, device=dev, force_device=True,
            chunk_rsis=7, fused=True)

    before = (decode_fused_cuda.launches, decode_cuda.launches,
              unpredict_cuda.launches)
    assert decode(comp, len(data)) == (0, data)
    assert (decode_fused_cuda.launches - before[0], decode_cuda.launches,
            unpredict_cuda.launches) == (6, *before[1:])
    for stream, out_size in ((comp[: len(comp) // 2 + 3], len(data)),
                             (comp, len(data) - 1)):
        assert decode(stream, out_size) == native.decode(stream, out_size,
                                                         BENCH)


@pytest.mark.parametrize("fused", [False, True], ids=["two-kernel", "fused"])
@pytest.mark.parametrize("cfg", [BENCH, Config(24, 64, 16, U24.flags),
                                 Config(8, 10, 3, AEC_NOT_ENFORCE)],
                         ids=["bench16", "u24", "u8bs10"])
def test_decode_buffers_matches_native(dev, cfg, fused):
    """Many streams through shared device chunks: whole, empty, shorter
    than one RSI, truncated, with an odd out_size; each result is
    native.decode's, and the launches are fewer than the streams."""
    rng = np.random.default_rng(29 + cfg.bits_per_sample)
    comps, sizes = [], []
    for i in range(24):
        n = rng.integers(1, 6) * cfg.samples_per_rsi + int(rng.integers(0, 99))
        kind = ("lowentropy", "midentropy", "zero_runs")[i % 3]
        raw = pack_samples(gen_values(rng, int(n), cfg.bits_per_sample,
                                      cfg.signed, kind),
                           cfg.bits_per_sample, cfg.flags)
        comps.append(native.encode(raw, cfg)[1])
        sizes.append(len(raw))
    comps[2] = comps[2][: len(comps[2]) // 2]
    sizes[3] -= 1
    comps += [b"", comps[0]]
    sizes += [cfg.rsi_len_bytes, cfg.rsi_len_bytes // 2]
    counters = [(decode_cuda, "launches"), (decode_fused_cuda, "launches")]
    before = [getattr(m, a) for m, a in counters]
    got = libaec_tpu_torch.decode_buffers(comps, cfg, sizes, device=dev,
                                          chunk_rsis=16, fused=fused)
    moved = [getattr(m, a) - b for (m, a), b in zip(counters, before)]
    for i, (comp, size) in enumerate(zip(comps, sizes)):
        assert got[i] == native.decode(comp, size, cfg), i
    one_kernel = fused and cfg.bytes_per_sample != 3
    assert 0 < moved[one_kernel] < len(comps)
    assert moved[not one_kernel] == 0
