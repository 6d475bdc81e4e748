"""libaec_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (`cuda` marker) and skips without
one: a CUDA kernel has no CPU mode.  The file imports neither JAX nor the
JAX package (the bit-exact reference is libaec_tpu_torch.native), so it
also runs on a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -q

The plain versions are held against the JAX package by the other
tests/test_torch_*.py files.  Tolerance zero: the codec is lossless.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gen import KINDS, gen_values  # noqa: E402
from torch_kernel_cases import (  # noqa: E402
    DECODE_DATA,
    MERGE_CASES,
    chunk_records,
    decode_widths,
    merge_buffer_words,
    synthetic_windows,
)
from torch_kernel_cases import DECODE_CONFIGS as KIND_CONFIGS  # noqa: E402

import libaec_tpu_torch  # noqa: E402
from chip_smoke import pack_samples  # noqa: E402
from libaec_tpu_torch import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
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
from libaec_tpu_torch.ops import bitpack, bitunpack, preprocess  # noqa: E402
from libaec_tpu_torch.ops.u32 import u32_to_bits  # noqa: E402

pytestmark = pytest.mark.cuda

BENCH = Config(16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS)
WARPS = encode_cuda.WARPS


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


ENCODE_CASES = [  # (id, config, RSIs, k_init)
    ("bench16", BENCH, 24, 3),
    ("u8", Config(8, 16, 128, 0), 24, 3),
    ("s13", Config(13, 32, 64, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS
                   | AEC_DATA_MSB), 24, 3),
    ("s32", Config(32, 64, 256, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS), 24,
     3),
    ("bs10", Config(16, 10, 32, AEC_DATA_MSB | AEC_DATA_PREPROCESS
                    | AEC_NOT_ENFORCE), 24, 3),
    ("u24bs48", Config(24, 48, 16, AEC_DATA_MSB | AEC_DATA_PREPROCESS
                       | AEC_DATA_3BYTE | AEC_NOT_ENFORCE), 24, 3),
] + [
    # the k chain's shapes: one tile, a short one (NB 40); 33 tiles, one
    # more than the chain's runs, the last of 27 blocks (NB 2075); 31
    # tiles, the last of 40 blocks (NB 1960): each from the lowest, a
    # middle and the highest incoming k (capped at the config's kmax)
    (f"{name}-k{k_init}", cfg, n_rsi, k_init)
    for name, cfg, n_rsi in (
        ("one-tile", Config(16, 64, 8, AEC_DATA_MSB | AEC_DATA_PREPROCESS), 5),
        ("33-tiles", Config(16, 16, 25, AEC_DATA_MSB | AEC_DATA_PREPROCESS),
         83),
        ("31-tiles", Config(32, 8, 7, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
         280))
    for k_init in (0, 13, 31)
]


@pytest.mark.parametrize("cfg,n_rsi,k_init", [c[1:] for c in ENCODE_CASES],
                         ids=[c[0] for c in ENCODE_CASES])
def test_encode_kernel_matches_plain(dev, cfg, n_rsi, k_init):
    raw = chunk(cfg, n_rsi, cfg.bits_per_sample)
    k0 = torch.tensor([min(k_init, cfg.kmax)], dtype=torch.int32)
    want = encode_cuda.encode_fields_plain(cfg, raw, k0)
    got = encode_cuda.encode_fields(cfg, raw.to(dev), k0.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("cfg", [c[1] for c in ENCODE_CASES[:6]],
                         ids=[c[0] for c in ENCODE_CASES[:6]])
def test_encode_kernel_unaligned_input(dev, cfg, offset):
    """A chunk that does not start on an 8-byte boundary comes in byte by
    byte; the windows are the same."""
    raw = chunk(cfg, 7, cfg.bits_per_sample + offset)
    k0 = torch.tensor([min(5, cfg.kmax)], dtype=torch.int32)
    want = encode_cuda.encode_fields_plain(cfg, raw, k0)
    shifted = torch.cat([raw[:offset], raw]).to(dev)[offset:]
    assert shifted.data_ptr() % 8 == offset and shifted.is_contiguous()
    got = encode_cuda.encode_fields(cfg, shifted, k0.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def hold_merge(dev, win, bb, bit0, nwords):
    """Kernel 2 against the plain merge: the tail and the words of the
    used prefix (the kernel leaves the rest of the buffer unwritten)."""
    b0 = torch.tensor([bit0], dtype=torch.int64)
    want, want_tail = bitpack.merge_windows(win, bb, b0, nwords)
    got, tail = merge_cuda.merge_windows(win.to(dev), bb.to(dev), b0.to(dev),
                                         nwords)
    assert got.shape == want.shape
    assert torch.equal(tail.cpu(), want_tail)
    used = merge_cuda.used_words(int(want_tail[0]))
    assert torch.equal(got[:used].cpu(), want[:used])


@pytest.mark.parametrize("bit0", range(32))
def test_merge_kernel_matches_plain(dev, bit0):
    win, bb, _ = encode_cuda.encode_fields_plain(
        BENCH, chunk(BENCH, 24, 5), torch.tensor([0], dtype=torch.int32))
    nwords = merge_cuda.word_count(BENCH, win.shape[0], win.shape[1] - 1)
    hold_merge(dev, win, bb, bit0, nwords)


@pytest.mark.parametrize("bit0", range(32))
@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_merge_kernel_edges(dev, name, bit0):
    """Runs of up to 63 zero-bit blocks, many blocks in one word, words
    that reach past a tile's bits into the next tiles', block counts that
    are not a multiple of the tile (tests/torch_kernel_cases.py); at every
    bit0 a chunk (0-7) or a shard of a sharded stream (0-31) merges at."""
    win, bb, _ = MERGE_CASES[name]()
    hold_merge(dev, win, bb, bit0, merge_buffer_words(*win.shape))


@pytest.mark.parametrize("bit0", [0, 7])
@pytest.mark.parametrize("shape", ["full", "runs"])
def test_merge_kernel_many_tiles(dev, shape, bit0):
    """More tiles than a thread block has threads: a tile sums the sums
    of the tiles before it in several rounds."""
    NB = 300 * merge_cuda.TILE + 17
    win, bb = synthetic_windows(np.random.default_rng(6), NB, 3, shape)
    hold_merge(dev, win, bb, bit0, merge_buffer_words(*win.shape))


KMAP_CASES = [  # (tiles of 64 blocks, config, RSIs): the k chain's shapes
    (1, Config(16, 64, 8, AEC_DATA_MSB | AEC_DATA_PREPROCESS), 5),
    (31, Config(32, 8, 7, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS), 280),
    (33, Config(16, 16, 25, AEC_DATA_MSB | AEC_DATA_PREPROCESS), 83),
    (4096, BENCH, 1024),
]
KMAP_IDS = [f"{c[0]}-tiles" for c in KMAP_CASES]


@pytest.mark.parametrize("tiles,cfg,n_rsi", KMAP_CASES, ids=KMAP_IDS)
def test_encode_kmap_matches_plain(dev, tiles, cfg, n_rsi):
    """Kernel 1's map phase (pass A, the chain scan in map mode) against
    ops/options.shard_kmap of the block maps: every one of the 32
    entries."""
    assert -(-n_rsi * cfg.rsi // 64) == tiles
    raw = chunk(cfg, n_rsi, cfg.bits_per_sample + 1)
    got, _ = encode_cuda.encode_kmap(cfg, raw.to(dev))
    assert torch.equal(got.cpu(), encode_cuda.encode_kmap_plain(cfg, raw))


@pytest.mark.parametrize("k", [0, 5, 13])
@pytest.mark.parametrize("tiles,cfg,n_rsi", KMAP_CASES, ids=KMAP_IDS)
def test_encode_kmap_then_resume_is_encode_fields(dev, tiles, cfg, n_rsi, k):
    """The two phases give encode_fields' windows, bit lengths and k from
    the same incoming k, and the map sends that k where the chain does."""
    raw = chunk(cfg, n_rsi, cfg.bits_per_sample + 2).to(dev)
    k0 = torch.tensor([min(k, cfg.kmax)], dtype=torch.int32, device=dev)
    kmap, scratch = encode_cuda.encode_kmap(cfg, raw)
    got = encode_cuda.encode_fields_resume(cfg, scratch, k0)
    want = encode_cuda.encode_fields(cfg, raw, k0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2]) == int(kmap[int(k0)])


def mesh_run(n, backend, cases):
    from libaec_tpu_torch.parallel import dryrun

    return dryrun.run_ranks(n, backend, "cuda",
                            partial(dryrun.mesh_cases, cases=cases), 300)


MESH_CASES = [  # (config, RSIs a shard, samples below, seed, k_init)
    ((16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS), 16, 3000, 1, 0),
    ((16, 8, 4, AEC_DATA_MSB | AEC_DATA_PREPROCESS), 2, 500, 0, 7),
    # AEC_PAD_RSI (sar32bit's shape, its RSI cut to 16 blocks), the
    # restricted set, SZIP's blocks of 4
    ((32, 64, 16, AEC_DATA_MSB | AEC_DATA_PREPROCESS | AEC_PAD_RSI), 2,
     1 << 20, 2, 0),
    ((2, 8, 16, AEC_RESTRICTED | AEC_DATA_PREPROCESS), 2, 4, 3, 0),
    ((16, 4, 64, AEC_NOT_ENFORCE | AEC_DATA_PREPROCESS), 2, 3000, 4, 3),
]


@pytest.mark.parametrize("n,backend", [(2, "gloo"), (1, "nccl")])
def test_mesh_ranks_on_the_card(dev, n, backend):
    """Two gloo ranks sharing the card, and one NCCL rank (its
    collectives still run): the kernels' two phases, the merge at each
    shard's offset, the assembly and the decode on the card; each case
    holds the device assembly to assemble_host and the decode to the
    input, and from k 0 the stream to encode_buffer."""
    from libaec_tpu_torch.parallel import dryrun

    got = mesh_run(n, backend, MESH_CASES)
    for i in (0, 2, 3):  # the cases from k 0
        args, per, hi, seed, _ = MESH_CASES[i]
        cfg = Config(*args)
        raw = dryrun.uniform_input(cfg, n * per, hi, seed)
        assert {r[i]["stream"] for r in got} == {native.encode(raw, cfg)[1]}
        assert b"".join(r[i]["decoded"].tobytes() for r in got) == raw


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


@pytest.mark.parametrize("data", DECODE_DATA)
@pytest.mark.parametrize("name", list(KIND_CONFIGS))
def test_decode_kernel_kinds(dev, name, data):
    """Kernel 3 on blocks of every kind (zero, second extension, split,
    uncompressed; with and without a reference) and on tests/gen.py data,
    block sizes 8 to 64 and 3-byte samples, at every width the decode path
    can choose."""
    cfg = KIND_CONFIGS[name]
    comp, recs, bucket = chunk_records(cfg, data, len(name) + len(data))
    for wf in decode_widths(cfg, bucket):
        recs["win"] = native.fill_windows(comp, recs["fs_off"],
                                          recs["meta"], wf)
        args = [u32_to_bits(a) for a in scan_record_arrays(recs)]
        want = decode_cuda.decode_blocks_plain(cfg, *args)
        got = decode_cuda.decode_blocks(cfg, *(a.to(dev) for a in args))
        assert torch.equal(got.cpu(), want), wf


@pytest.mark.parametrize("cfg", DECODE_CONFIGS + [
    Config(1, 8, 16, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS),
    Config(8, 10, 3, AEC_NOT_ENFORCE),  # rows of 30 bytes
    Config(8, 2, 1, AEC_NOT_ENFORCE | AEC_DATA_PREPROCESS),  # RSIs of 2
], ids=DECODE_IDS + ["s1", "u8bs10", "u8bs2rsi1"])
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
    Config(24, 2, 1, AEC_DATA_PREPROCESS | AEC_DATA_3BYTE
           | AEC_NOT_ENFORCE),  # RSIs of 2 samples
]
RSIS_IDS = ["u24", "s17", "s24", "u20bs10", "bench16", "s32", "u24bs2rsi1"]


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


PP_, SGN_, MSB_, B3_ = (AEC_DATA_PREPROCESS, AEC_DATA_SIGNED, AEC_DATA_MSB,
                        AEC_DATA_3BYTE)
# S = 400: a group of 256 samples and a short one
SCAN_CONFIGS = {
    "u8": Config(8, 16, 25, PP_),
    "s13": Config(13, 16, 25, PP_ | SGN_ | MSB_),
    "u16": Config(16, 16, 25, PP_ | MSB_),
    "u24-3byte": Config(24, 16, 25, PP_ | MSB_ | B3_),
    "u32": Config(32, 16, 25, PP_),
    "s32": Config(32, 16, 25, PP_ | SGN_),
}


def kind_deltas(cfg, n_rsi, kind, sort, seed):
    """int32-bit deltas [n_rsi, S]: the deltas of the kind's samples, or
    the kind's values taken as deltas with one row from all of u32."""
    rng = np.random.default_rng(seed)
    shape = (n_rsi, cfg.samples_per_rsi)
    vals = gen_values(rng, shape[0] * shape[1], cfg.bits_per_sample,
                      cfg.signed, kind).reshape(shape).astype(np.int64)
    if sort == "arbitrary":
        vals[0] = rng.integers(0, 1 << 32, shape[1], dtype=np.uint64)
        return u32_to_bits(vals.astype(np.uint32))
    d, ref = preprocess.delta_map(torch.from_numpy(vals), cfg)
    d[:, 0] = ref
    return u32_to_bits(d.numpy().astype(np.uint32))


def hold_scan_kernels(cfg, deltas, dev):
    """Kernels 5 and 4 on deltas against the serial plain version."""
    want = unpredict_cuda.unpredict_rsis_plain(cfg, deltas)
    got = unpredict_cuda.unpredict_rsis(cfg, deltas.to(dev))
    assert torch.equal(got.cpu(), want)
    out = unpredict_cuda.unpredict_swizzle(cfg, deltas.to(dev))
    assert torch.equal(out.cpu(),
                       unpredict_cuda.samples_to_bytes_plain(cfg, want))


@pytest.mark.parametrize("sort", ["of-samples", "arbitrary"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", SCAN_CONFIGS)
def test_scan_kernels_match_plain(dev, case, kind, sort):
    """The verified scan on every kind of data: no escape at all, a few
    (one or more repairs), and one in two (the serial remainder)."""
    cfg = SCAN_CONFIGS[case]
    hold_scan_kernels(cfg, kind_deltas(cfg, 33, kind, sort,
                                       len(case) + KINDS.index(kind)), dev)


@pytest.mark.parametrize("n_rsi", [1, 31, 33, 77])
@pytest.mark.parametrize("kind", ["random", "edges", "zero_runs",
                                  "midentropy"])
@pytest.mark.parametrize("cfg", [
    Config(16, 64, 40, PP_ | MSB_),        # 2560 samples: ten groups
    Config(24, 64, 17, PP_ | B3_),         # 1088: four groups and 64
    Config(32, 8, 1, PP_ | SGN_),          # the shortest RSI
    Config(16, 10, 3, PP_ | AEC_NOT_ENFORCE),         # rows of 30 samples
    Config(8, 10, 5, PP_ | SGN_ | AEC_NOT_ENFORCE),   # rows of 50 bytes
    Config(24, 10, 27, PP_ | MSB_ | B3_ | AEC_NOT_ENFORCE),  # 270 samples
    Config(32, 10, 1, PP_ | AEC_NOT_ENFORCE),
], ids=["u16", "u24-3byte", "s32-rsi1", "u16bs10", "s8bs10", "u24bs10",
        "u32bs10"])
def test_scan_kernels_rows_and_counts(dev, cfg, kind, n_rsi):
    """RSI counts below, at and across a warp's and a thread block's
    worth; rows that do and do not start on a 16-byte boundary."""
    for sort in ("of-samples", "arbitrary"):
        hold_scan_kernels(cfg, kind_deltas(cfg, n_rsi, kind, sort,
                                           n_rsi + cfg.block_size), dev)


@pytest.mark.parametrize("n_rsi", [2500, 9000])
def test_scan_kernels_many_short_rsis(dev, n_rsi):
    """More RSIs than the card holds blocks of one warp: the launch gives
    a thread block several warps."""
    cfg = Config(16, 8, 2, PP_ | MSB_)
    hold_scan_kernels(cfg, kind_deltas(cfg, n_rsi, "midentropy",
                                       "of-samples", n_rsi), dev)


@pytest.mark.parametrize("msb", [0, AEC_DATA_MSB])
@pytest.mark.parametrize("bps,flags", [(8, 0), (16, 0), (24, B3_), (32, 0)],
                         ids=["bsz1", "bsz2", "bsz3", "bsz4"])
@pytest.mark.parametrize("n_rsi,bs,rsi", [(3, 10, 3), (77, 8, 25), (1, 10, 1)],
                         ids=["90", "15400", "10"])
def test_layout_kernel_flat(dev, n_rsi, bs, rsi, bps, flags, msb):
    """The flat byte-layout kernel at each sample size, on totals that
    are not a multiple of 4 samples or of 16 bytes."""
    cfg = Config(bps, bs, rsi, flags | msb | AEC_NOT_ENFORCE)
    samples = random_deltas(cfg, n_rsi, bps + n_rsi + msb, True)
    want = unpredict_cuda.samples_to_bytes_plain(cfg, samples)
    assert want.numel() % 16 or n_rsi == 77
    before = unpredict_cuda.layout_launches
    got = unpredict_cuda.samples_to_bytes(cfg, samples.to(dev))
    assert unpredict_cuda.layout_launches == before + 1
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
    Config(32, 64, 16, AEC_DATA_PREPROCESS),   # unsigned, deltas of all u32
]
FUSED_IDS = DECODE_IDS[:-1] + ["bs10", "u8bs10", "s32bs48", "s1", "u32"]


@pytest.mark.parametrize("kind", ["mixed", "midentropy", "random"])
@pytest.mark.parametrize("cfg", FUSED_CONFIGS, ids=FUSED_IDS)
@pytest.mark.parametrize("n_rsi", [1, 24, 33, 77])
def test_fused_kernel_matches_plain(dev, cfg, n_rsi, kind):
    """Kernel 6 against its plain version, kernels 3 + 4 and native.decode,
    at the chunk's bucket width and every wider width the decode path can
    choose; RSI counts of one thread block's row and of many.  `mixed` is
    one segment per tests/gen.py kind; `midentropy` rows take repairs,
    `random` rows (at 32 bits their deltas span all of u32, on both
    predictor paths) end in the serial walk."""
    if kind == "mixed":
        raw = chunk(cfg, n_rsi, cfg.bits_per_sample + n_rsi).numpy().tobytes()
    else:
        rng = np.random.default_rng(cfg.bits_per_sample + n_rsi)
        raw = pack_samples(gen_values(
            rng, n_rsi * cfg.samples_per_rsi, cfg.bits_per_sample,
            cfg.signed, kind), cfg.bits_per_sample, cfg.flags)
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
            assert torch.equal(
                decode_fused_cuda.decode_unpredict_swizzle_scan_plain(
                    cfg, *args, n_rsi), want)
        before = decode_fused_cuda.launches
        on_dev = [a.to(dev) for a in args]
        got = decode_fused_cuda.decode_unpredict_swizzle(cfg, *on_dev, n_rsi)
        assert decode_fused_cuda.launches == before + 1
        assert torch.equal(got.cpu(), want), wf
        two = unpredict_cuda.unpredict_swizzle(
            cfg, decode_cuda.decode_blocks(cfg, *on_dev).view(
                n_rsi, cfg.samples_per_rsi))
        assert torch.equal(got, two), wf


@pytest.mark.parametrize("kind", ["mixed", "midentropy", "random"])
@pytest.mark.parametrize("n_rsi", [300, 600, 1500, 3000, 5000, 10000])
def test_fused_kernel_group_sizes(dev, n_rsi, kind):
    """Many short RSIs: kernel 6 gives a thread block 2, 4, 8, 16 or 32 of
    them instead of one once the chunk has more than the card holds
    thread blocks at once; its chain warps then take several rows each."""
    cfg = Config(8, 8, 2, AEC_DATA_PREPROCESS)
    if kind == "mixed":
        raw = chunk(cfg, n_rsi, n_rsi).numpy().tobytes()
    else:
        raw = pack_samples(gen_values(
            np.random.default_rng(n_rsi), n_rsi * cfg.samples_per_rsi, 8,
            False, kind), 8, cfg.flags)
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


# -- the surfaces (szip, stream, cli) on the card ----------------------------

@pytest.mark.parametrize("cfg", [BENCH, Config(24, 64, 16, U24.flags),
                                 Config(13, 32, 8, AEC_DATA_SIGNED
                                        | AEC_DATA_PREPROCESS)],
                         ids=["bench16", "u24", "s13bs32"])
def test_stream_encode_on_the_card(dev, cfg):
    """aec_encode in uneven pieces on the card: native.encode's stream,
    one launch of kernels 1 and 2 for each call that completes an RSI and
    one for the short last RSI at AEC_FLUSH; dirty bits above
    bits_per_sample are masked."""
    from libaec_tpu_torch import AEC_FLUSH, AEC_NO_FLUSH, stream

    rng = np.random.default_rng(cfg.bits_per_sample)
    vals = gen_values(rng, 9 * cfg.samples_per_rsi + 77,
                      cfg.bits_per_sample, cfg.signed, "midentropy")
    clean = pack_samples(vals, cfg.bits_per_sample, cfg.flags)
    hi = (1 << 8 * cfg.bytes_per_sample) - (1 << cfg.bits_per_sample)
    dirty = pack_samples(vals | (rng.integers(0, 1 << 32, vals.size,
                                              dtype=np.uint64)
                                 & hi).astype(np.uint32),
                         cfg.bits_per_sample, cfg.flags)
    s = stream.AecStream(cfg.bits_per_sample, cfg.block_size, cfg.rsi,
                         cfg.flags, device=dev)
    stream.aec_encode_init(s)
    before = encode_cuda.launches
    pos, calls = 0, 0
    while pos < len(dirty):
        end = min(pos + int(rng.integers(1, 3 * cfg.rsi_len_bytes)),
                  len(dirty))
        s.next_in, s.avail_in = dirty[pos:end], None
        stream.aec_encode(s, AEC_NO_FLUSH)
        calls += end // cfg.rsi_len_bytes > pos // cfg.rsi_len_bytes
        pos = end
    stream.aec_encode(s, AEC_FLUSH)
    assert stream.aec_encode_end(s) == 0
    assert bytes(s.next_out) == native.encode(clean, cfg)[1]
    assert encode_cuda.launches - before == calls + 1


@pytest.mark.parametrize("args", [(48, 16, 32, 1024), (48, 16, 32, 1000),
                                  (48, 32, 32, 1024), (16, 8, 16, 256)],
                         ids=["pps1024", "pps1000", "bpp32", "8bit-noNN"])
def test_szip_on_the_card(dev, args):
    """SZ compress forced onto the card and a batch of chunks decoded
    there: the C szlib surface's stream, the input back."""
    from chip_smoke import c_sz_compress, sz_chunks

    from libaec_tpu_torch import szip

    param = szip.SZCom(*args)
    chunks = sz_chunks(np.random.default_rng(args[3]), 6, args[1],
                       bool(args[0] & 16))
    chunks[-1] = chunks[-1][:3008]  # a chunk of one or two RSIs
    comps = [szip.sz_buffto_buff_compress(c, param, device=dev,
                                          force_device=True) for c in chunks]
    assert comps == [c_sz_compress(c, param) for c in chunks]
    assert szip.sz_decompress_batch(comps, param, [len(c) for c in chunks],
                                    device=dev) == chunks


@pytest.mark.parametrize("cfg", [BENCH, Config(24, 64, 16, U24.flags)],
                         ids=["bench16", "u24"])
def test_cli_card_routes(dev, tmp_path, cfg):
    from libaec_tpu_torch import cli

    rng = np.random.default_rng(5)
    data = pack_samples(gen_values(rng, 7 * cfg.samples_per_rsi + 5,
                                   cfg.bits_per_sample, False, "lowentropy"),
                        cfg.bits_per_sample, cfg.flags)
    rz, out = str(tmp_path / "f.rz"), str(tmp_path / "f.out")
    assert cli._encode_to_file(data, cfg, rz, device=dev,
                               force_device=True) == 0
    comp = native.encode(data, cfg)[1]
    assert open(rz, "rb").read() == comp
    assert cli._decode_to_file(comp, cfg, out, device=dev,
                               force_device=True) == 0
    assert open(out, "rb").read() == native.decode(
        comp, len(data) + cfg.rsi_len_bytes, cfg)[1]


# The configs the gates of kernels 1 and 3 took in last: AEC_PAD_RSI
# (sar32bit, CCSDS 121.0-B-2's ExtendedParameters -n32 -j64 -r4096 -p, at
# its full RSI), the restricted set of 1- and 2-bit samples (id_len 1), and
# SZIP's pixels_per_block 2, 4 and 6 (AEC_NOT_ENFORCE), RSIs of one block
# among them; (id, config, RSIs)
PP_, MSB_, SGN_ = AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED
WIDE_CASES = [
    ("sar32bit", Config(32, 64, 4096, MSB_ | PP_ | AEC_PAD_RSI), 2),
    ("pad16-s", Config(16, 16, 7, SGN_ | PP_ | AEC_PAD_RSI), 300),
    ("res1", Config(1, 8, 16, AEC_RESTRICTED | PP_), 130),
    ("res2", Config(2, 8, 16, AEC_RESTRICTED | PP_), 130),
    ("res2-pad-nopp", Config(2, 16, 5, AEC_RESTRICTED | AEC_PAD_RSI), 400),
    ("sz-bs2", Config(8, 2, 256, AEC_NOT_ENFORCE | MSB_ | PP_), 9),
    ("sz-bs4", Config(16, 4, 128, AEC_NOT_ENFORCE | MSB_ | PP_), 17),
    ("sz-bs6", Config(32, 6, 128, AEC_NOT_ENFORCE | SGN_ | PP_), 17),
    ("bs2-rsi1", Config(16, 2, 1, AEC_NOT_ENFORCE | PP_), 2100),
    ("bs4-pad-nopp", Config(16, 4, 9, AEC_NOT_ENFORCE | AEC_PAD_RSI), 250),
    # blocks over 64 samples: the wide paths of kernels 1 and 3 (kernel 1
    # in encode_cuda.wide_layout's layout: at these sizes a block a thread
    # block, its window in shared memory up to bs 16384 x 32 bits, in
    # device memory at bs 65536 x 32)
    ("bs66-res2", Config(2, 66, 64, AEC_NOT_ENFORCE | AEC_RESTRICTED | PP_),
     40),
    ("bs128", Config(16, 128, 128, AEC_NOT_ENFORCE | MSB_ | PP_), 20),
    ("bs130-s24", Config(24, 130, 33, AEC_NOT_ENFORCE | SGN_ | PP_), 30),
    ("bs256-pad", Config(32, 256, 32, AEC_NOT_ENFORCE | PP_ | AEC_PAD_RSI),
     20),
    ("bs1024", Config(16, 1024, 16, AEC_NOT_ENFORCE | PP_), 20),
    ("bs4096-u8", Config(8, 4096, 2, AEC_NOT_ENFORCE), 20),
    ("bs16384-u32", Config(32, 16384, 1, AEC_NOT_ENFORCE | MSB_ | PP_), 40),
    ("bs65536-u32", Config(32, 65536, 1, AEC_NOT_ENFORCE | PP_), 3),
]
WIDE_IDS = [c[0] for c in WIDE_CASES]


@pytest.mark.parametrize("cfg,n_rsi", [c[1:] for c in WIDE_CASES],
                         ids=WIDE_IDS)
def test_wide_encode_kernel_matches_plain(dev, cfg, n_rsi):
    """Kernel 1 (its pad launch under AEC_PAD_RSI) against its plain
    version, from the lowest and the highest incoming k; then its two
    phases against it."""
    raw = chunk(cfg, n_rsi, cfg.bits_per_sample + cfg.block_size)
    for k in sorted({0, max(cfg.kmax, 0)}):
        k0 = torch.tensor([k], dtype=torch.int32)
        want = encode_cuda.encode_fields_plain(cfg, raw, k0)
        got = encode_cuda.encode_fields(cfg, raw.to(dev), k0.to(dev))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), k
        kmap, scratch = encode_cuda.encode_kmap(cfg, raw.to(dev))
        assert torch.equal(kmap.cpu(), encode_cuda.encode_kmap_plain(cfg, raw))
        resumed = encode_cuda.encode_fields_resume(cfg, scratch, k0.to(dev))
        for g, w in zip(resumed, want):
            assert torch.equal(g.cpu(), w), k


@pytest.mark.parametrize("smem", [True, False], ids=["smem", "global"])
@pytest.mark.parametrize("per_group", [1, 3])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["bs66-res2", "bs130-s24", "bs256-pad",
                                  "bs1024", "bs16384-u32"])
def test_wide_encode_layouts_match_plain(dev, monkeypatch, case, group,
                                         per_group, smem):
    """Kernel 1's wide path in every layout, whichever
    encode_cuda.wide_layout picks: members past the block's segments, a
    zero block's one field, a short last tile, windows in shared or in
    device memory, and both phases."""
    _, cfg, n_rsi = next(c for c in WIDE_CASES if c[0] == case)
    fits = WARPS // group * 4 * encode_cuda.window_words(cfg) \
        <= encode_cuda.SMEM_OPTIN
    monkeypatch.setattr(encode_cuda, "wide_layout", lambda cfg, NB: (
        encode_cuda.WideLayout(group, per_group, smem and fits)))
    raw = chunk(cfg, n_rsi, cfg.bits_per_sample + group)
    k0 = torch.tensor([max(cfg.kmax, 0) // 2], dtype=torch.int32)
    want = encode_cuda.encode_fields_plain(cfg, raw, k0)
    got = encode_cuda.encode_fields(cfg, raw.to(dev), k0.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    kmap, scratch = encode_cuda.encode_kmap(cfg, raw.to(dev))
    assert torch.equal(kmap.cpu(), encode_cuda.encode_kmap_plain(cfg, raw))
    resumed = encode_cuda.encode_fields_resume(cfg, scratch, k0.to(dev))
    for g, w in zip(resumed, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("cfg,n_rsi", [c[1:] for c in WIDE_CASES],
                         ids=WIDE_IDS)
def test_wide_decode_kernels_match_plain(dev, cfg, n_rsi):
    """Kernel 3 against its plain version at the decode path's bucket
    width and every wider one; kernel 4 on its deltas against its plain
    version and native.decode."""
    raw = chunk(cfg, n_rsi, cfg.bits_per_sample + 3).numpy().tobytes()
    comp, recs, bucket = scanned(cfg, raw)
    wf_max = bitunpack.window_words(cfg)
    for wf in sorted({w for w in (*WF_BUCKETS, wf_max, bucket)
                      if bucket <= w <= wf_max}):
        recs["win"] = native.fill_windows(comp, recs["fs_off"],
                                          recs["meta"], wf)
        args = [u32_to_bits(a) for a in scan_record_arrays(recs)]
        want = decode_cuda.decode_blocks_plain(cfg, *args)
        got = decode_cuda.decode_blocks(cfg, *(a.to(dev) for a in args))
        assert torch.equal(got.cpu(), want), wf
    d = got.view(n_rsi, cfg.samples_per_rsi)
    out = unpredict_cuda.unpredict_swizzle(cfg, d)
    assert torch.equal(out.cpu(), unpredict_cuda.unpredict_swizzle_plain(
        cfg, d.cpu()))
    assert out.cpu().numpy().tobytes() == native.decode(comp, len(raw),
                                                        cfg)[1]


@pytest.mark.parametrize("cfg,n_rsi", [c[1:] for c in WIDE_CASES],
                         ids=WIDE_IDS)
def test_wide_buffers_match_native(dev, cfg, n_rsi):
    """encode_buffer and decode_buffer_status on the card, in several
    chunks with a short last RSI: native.encode's stream, the input back."""
    data = chunk(cfg, n_rsi, cfg.bits_per_sample + 5).numpy().tobytes()
    data += data[: cfg.rsi_len_bytes // 2 + cfg.bytes_per_sample]
    want = native.encode(data, cfg)[1]
    assert libaec_tpu_torch.encode_buffer(
        data, cfg, device=dev, force_device=True,
        rsis_per_chunk=max(1, n_rsi // 3)) == want
    got = libaec_tpu_torch.decode_buffer_status(
        want, cfg, len(data), device=dev, force_device=True,
        chunk_rsis=max(1, n_rsi // 3))
    assert got == native.decode(want, len(data), cfg)
    if not cfg.signed:
        assert got[1] == data


# -- the entry points' results on the host -----------------------------------

def _bench_data(n_rsi, seed):
    """n_rsi RSIs of the bench config, a partial RSI and a byte short of a
    sample."""
    rng = np.random.default_rng(seed)
    vals = gen_values(rng, n_rsi * BENCH.samples_per_rsi + 999, 16, False,
                      "lowentropy")
    return pack_samples(vals, 16, BENCH.flags) + b"\x5a"


@pytest.mark.parametrize("entry", ["encode_buffer", "decode_buffer_status",
                                   "decode_buffers"])
def test_results_do_not_alias(dev, entry):
    """Two calls in a row on different data, in many chunks: each result
    a plain bytes, native's, and the first unchanged after the second (no
    result shares memory with pinned staging, a pinned part or a slot)."""
    calls = []
    for seed in (3, 4):
        data = _bench_data(40, seed)
        comp = native.encode(data, BENCH)[1]
        size = len(data) - 1
        if entry == "encode_buffer":
            got = [libaec_tpu_torch.encode_buffer(
                data, BENCH, device=dev, force_device=True,
                rsis_per_chunk=7)]
            want = [comp]
        elif entry == "decode_buffer_status":
            got = [libaec_tpu_torch.decode_buffer_status(
                comp, BENCH, size, device=dev, force_device=True,
                chunk_rsis=7)]
            want = [native.decode(comp, size, BENCH)]
        else:
            comps = [comp, comp[: len(comp) // 2], comp]
            sizes = [size, size, size - 1]
            got = libaec_tpu_torch.decode_buffers(comps, BENCH, sizes,
                                                  device=dev, chunk_rsis=16)
            want = [native.decode(c, s, BENCH) for c, s in zip(comps, sizes)]
        calls.append((got, want))
    assert calls[0][1] != calls[1][1]
    for got, want in calls:
        assert got == want
        assert all(type(r if entry == "encode_buffer" else r[1]) is bytes
                   for r in got)


def test_64mib_results_are_natives_bytes(dev):
    """64 MiB through encode_buffer and decode_buffer_status at their
    default chunks (and so the default routes): plain bytes, byte for
    byte native's, the input back."""
    n_rsi = (64 << 20) // BENCH.rsi_len_bytes
    data = _bench_data(n_rsi, 5)
    want = native.encode(data, BENCH)[1]
    got = libaec_tpu_torch.encode_buffer(data, BENCH, device=dev)
    assert type(got) is bytes and got == want
    status, out = libaec_tpu_torch.decode_buffer_status(
        want, BENCH, len(data) - 1, device=dev)
    assert type(out) is bytes
    assert (status, out) == native.decode(want, len(data) - 1, BENCH)
    assert out == data[:-1]


# -- a stream's short last RSI on the card ------------------------------------
# The short last RSI (fewer samples than an RSI, its last block filled with
# repeats of its last sample, encode.pad_tail) is a chunk of one RSI of nb
# blocks to kernels 1 and 2 (encode.encode_tail); (id, config)
SHORT_RSI_CASES = [
    ("bench16", BENCH),
    ("u24", Config(24, 64, 16, U24.flags)),
    ("s13", Config(13, 32, 64, SGN_ | PP_ | MSB_)),
    ("sar32bit", Config(32, 64, 4096, MSB_ | PP_ | AEC_PAD_RSI)),
    ("res2", Config(2, 16, 64, AEC_RESTRICTED | PP_)),
    ("res1-pad", Config(1, 8, 16, AEC_RESTRICTED | AEC_PAD_RSI)),
    ("sz-bs2", Config(16, 2, 128, AEC_NOT_ENFORCE | MSB_ | PP_)),
    ("sz-bs4", Config(16, 4, 128, AEC_NOT_ENFORCE | MSB_ | PP_)),
    ("sz-bs6", Config(32, 6, 128, AEC_NOT_ENFORCE | SGN_ | PP_)),
    ("bs128", Config(16, 128, 128, AEC_NOT_ENFORCE | MSB_ | PP_)),
    ("bs1024", Config(16, 1024, 16, AEC_NOT_ENFORCE | PP_)),
    ("bs16384-u32", Config(32, 16384, 4, AEC_NOT_ENFORCE | MSB_ | PP_)),
]
SHORT_NB = {"1": lambda rsi: 1, "2": lambda rsi: 2,
            "half": lambda rsi: rsi // 2, "rsi-1": lambda rsi: rsi - 1}


def short_rsi_bytes(cfg, nb, seed):
    """Stream bytes of a short RSI of nb blocks, its last block short of
    0 to bs - 1 samples, every tests/gen.py kind in turn."""
    rng = np.random.default_rng(seed)
    n = nb * cfg.block_size - int(rng.integers(0, cfg.block_size))
    per = -(-n // len(KINDS))
    vals = np.concatenate([gen_values(rng, per, cfg.bits_per_sample,
                                      cfg.signed, kind)
                           for kind in KINDS])[:n]
    return np.frombuffer(pack_samples(vals, cfg.bits_per_sample, cfg.flags),
                         np.uint8)


@pytest.mark.parametrize("at", list(SHORT_NB))
@pytest.mark.parametrize("cfg", [c[1] for c in SHORT_RSI_CASES],
                         ids=[c[0] for c in SHORT_RSI_CASES])
def test_short_rsi_kernels_match_plain(dev, cfg, at):
    """Kernel 1 with nb < rsi (rsi = nb to the kernel: its zero-run
    segments, its reference sample and AEC_PAD_RSI's pad end with the
    short RSI) from k 0 and a k above 0, and kernel 2 on its windows at
    bit cursors 0, 1 and 7, against their plain versions."""
    from libaec_tpu_torch.encode import pad_tail

    nb = SHORT_NB[at](cfg.rsi)
    raw, got_nb = pad_tail(cfg, short_rsi_bytes(cfg, nb, nb + cfg.rsi))
    assert got_nb == nb
    raw = torch.from_numpy(raw)
    for k in sorted({0, max(cfg.kmax, 0) // 2 + (cfg.kmax > 0)}):
        k0 = torch.tensor([k], dtype=torch.int32)
        want = encode_cuda.encode_fields_plain(cfg, raw, k0, nb=nb)
        got = encode_cuda.encode_fields(cfg, raw.to(dev), k0.to(dev), nb=nb)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), k
        nwords = merge_cuda.word_count(cfg, nb, want[0].shape[1] - 1)
        for bit0 in (0, 1, 7):
            hold_merge(dev, want[0], want[1], bit0, nwords)


TAIL_SAMPLES = {"one-sample": lambda cfg: 1,
                "block-less-a-sample": lambda cfg: cfg.block_size - 1,
                "rsi-less-a-block": lambda cfg: (cfg.rsi - 1)
                * cfg.block_size}


def stream_on(dev, cfg, data, pieces):
    """The port's stream on `dev`: data in `pieces` pieces, then flushed."""
    from libaec_tpu_torch import AEC_FLUSH, AEC_NO_FLUSH, stream

    s = stream.AecStream(cfg.bits_per_sample, cfg.block_size, cfg.rsi,
                         cfg.flags, device=dev)
    stream.aec_encode_init(s)
    cuts = np.linspace(0, len(data), pieces + 1).astype(int)
    for a, b in zip(cuts[:-1], cuts[1:]):
        s.next_in, s.avail_in = data[a:b], None
        stream.aec_encode(s, AEC_NO_FLUSH)
    s.next_in, s.avail_in = b"", None
    stream.aec_encode(s, AEC_FLUSH)
    assert stream.aec_encode_end(s) == 0
    return bytes(s.next_out)


@pytest.mark.parametrize("tail", list(TAIL_SAMPLES))
@pytest.mark.parametrize("cfg", [BENCH, Config(24, 64, 16, U24.flags),
                                 Config(32, 64, 16, MSB_ | PP_ | AEC_PAD_RSI),
                                 Config(16, 1024, 16, AEC_NOT_ENFORCE | PP_)],
                         ids=["bench16", "u24", "pad32", "bs1024"])
def test_entry_points_with_tails_match_native(dev, cfg, tail):
    """encode_buffer, encode_buffer_status and the stream on the card, five
    RSIs and a tail: native.encode's stream, and encode_buffer launches
    kernels 1 and 2 once for each chunk of two RSIs and once for the
    tail."""
    data = chunk(cfg, 5, cfg.bits_per_sample + 9).numpy().tobytes()
    data += data[cfg.rsi_len_bytes:][:TAIL_SAMPLES[tail](cfg)
                                     * cfg.bytes_per_sample] + b"\x01"
    want = native.encode(data, cfg)[1]
    before = encode_cuda.launches, merge_cuda.launches
    assert libaec_tpu_torch.encode_buffer(
        data, cfg, device=dev, force_device=True, rsis_per_chunk=2) == want
    assert (encode_cuda.launches - before[0],
            merge_cuda.launches - before[1]) == (4, 4)
    assert libaec_tpu_torch.encode_buffer_status(
        data, cfg, len(want), device=dev, force_device=True,
        rsis_per_chunk=2) == (0, want)
    assert stream_on(dev, cfg, data, 3) == want


def test_encode_entry_points_run_no_plain_version(dev, monkeypatch,
                                                  tmp_path):
    """With kernel 1's and kernel 2's plain versions made to raise, every
    encode entry point runs to its end on the card over a buffer that ends
    in a short last RSI: encode_buffer, encode_buffer_status, the stream,
    the SZ compress (which pads every scanline to a whole RSI) and the
    CLI's encode."""
    from chip_smoke import c_sz_compress, sz_chunks

    from libaec_tpu_torch import cli, szip

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran with a card present")

    monkeypatch.setattr(encode_cuda, "encode_fields_plain", refuse)
    monkeypatch.setattr(bitpack, "merge_windows", refuse)
    data = _bench_data(9, 8)
    want = native.encode(data, BENCH)[1]
    assert libaec_tpu_torch.encode_buffer(
        data, BENCH, device=dev, force_device=True, rsis_per_chunk=4) == want
    assert libaec_tpu_torch.encode_buffer_status(
        data, BENCH, len(want), device=dev, force_device=True) == (0, want)
    assert stream_on(dev, BENCH, data, 4) == want

    param = szip.SZCom(szip.SZ_MSB_OPTION_MASK | szip.SZ_NN_OPTION_MASK, 16,
                       32, 1000)
    sz = sz_chunks(np.random.default_rng(9), 1, 16, True)[0][:300_000]
    assert szip.sz_buffto_buff_compress(sz, param, device=dev,
                                        force_device=True) \
        == c_sz_compress(sz, param)

    monkeypatch.setenv("LIBAEC_TPU_ENCODE", "jax")
    src, rz = tmp_path / "in.dat", tmp_path / "out.rz"
    src.write_bytes(data)
    assert cli.main(["-n", "16", "-j", "64", "-r", "256", "-m", str(src),
                     str(rz)]) == 0
    assert rz.read_bytes() == want
