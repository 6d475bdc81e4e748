"""A stream's short last RSI on the port's device route, against the JAX
package on the CPU.

The short last RSI (fewer samples than an RSI, its last block filled with
repeats of its last sample) goes through kernels 1 and 2 as a chunk of one
RSI of nb < rsi blocks (libaec_tpu_torch.encode.encode_tail).  Here, on
CPU tensors, those are the kernels' plain versions:

  - kernel 1's wrapper with nb (encode_cuda.encode_fields(..., nb=nb)),
    merged by kernel 2's wrapper at a bit cursor of 0-7, against the JAX
    package's numpy tail route (encode_blocks_core on its numpy backend,
    what libaec_tpu.encode_buffer codes its tail with) at every case, and
    against its XLA route (encode_blocks_jax, what its stream codes the
    final piece with on the device backend) at one nb of each of seven
    configs (XLA_CASES): nb 1, 2, rsi // 2 and rsi - 1, each from k 0 and from a k above 0, on 8-, 16-
    and 32-bit samples, 3-byte and signed samples, the restricted set,
    AEC_PAD_RSI, SZIP's blocks of 2, 4 and 6 samples and a block over 64
    samples;
  - encode_buffer(..., device="cpu", force_device=True) and the stream
    (AecStream(device="cpu")) with tails of one sample, of one block less
    a sample and of rsi - 1 blocks, after several chunks of two RSIs that
    leave every bit cursor from 1 to 7, against libaec_tpu.encode_buffer
    and the port's native.encode.

Tolerance: byte for byte.  The CUDA kernels at the same nb are held
against these plain versions in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gen  # noqa: E402
import libaec_tpu  # noqa: E402
import libaec_tpu_torch  # noqa: E402
from libaec_tpu import Config  # noqa: E402
from libaec_tpu.backend import NUMPY  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_FLUSH,
    AEC_NO_FLUSH,
    AEC_NOT_ENFORCE,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
)
from libaec_tpu.encode import (  # noqa: E402
    encode_blocks_core,
    encode_blocks_jax,
)
from libaec_tpu_torch import native, stream  # noqa: E402
from libaec_tpu_torch.encode import (  # noqa: E402
    pad_tail,
    words_to_stream_bytes,
)
from libaec_tpu_torch.kernels import encode_cuda, merge_cuda  # noqa: E402

MSB, PP, NE = AEC_DATA_MSB, AEC_DATA_PREPROCESS, AEC_NOT_ENFORCE
CONFIGS = {  # id -> (bits, block, rsi, flags)
    "u8": (8, 16, 32, 0),
    "u16-bench": (16, 64, 16, MSB | PP),
    "u32": (32, 32, 8, PP),
    "u24-3byte": (24, 16, 16, AEC_DATA_3BYTE | MSB | PP),
    "s13": (13, 32, 8, AEC_DATA_SIGNED | MSB | PP),
    "s32": (32, 64, 4, AEC_DATA_SIGNED | PP),
    "restricted2": (2, 16, 64, AEC_RESTRICTED | PP),
    "pad-rsi32": (32, 64, 16, MSB | PP | AEC_PAD_RSI),
    "sz-ppb2": (16, 2, 32, NE | MSB | PP),
    "sz-ppb4": (16, 4, 32, NE | MSB | PP),
    "sz-ppb6": (16, 6, 32, NE | MSB | PP),
    "bs128": (16, 128, 8, NE | MSB | PP),
}
KINDS = ["lowentropy", "zero_runs", "random", "edges"]


def short_rsis(rsi):
    return sorted({1, 2, rsi // 2, rsi - 1} - {0})


KERNEL_CASES = [(name, nb) for name, args in CONFIGS.items()
                for nb in short_rsis(args[2])]
# the XLA route compiles a program a shape (seconds each on the CPU): one
# nb of each of these configs, the four nb in turn
XLA_CASES = {name: short_rsis(CONFIGS[name][2])[i % 4] for i, name in
             enumerate(["u16-bench", "u24-3byte", "s13", "restricted2",
                        "pad-rsi32", "sz-ppb2", "bs128"])}


def tail_samples(cfg, nb, seed):
    """Samples of a short RSI of nb blocks, its last block missing some
    samples (one block of one sample at nb 1 for odd seeds)."""
    rng = np.random.default_rng(seed)
    bs = cfg.block_size
    missing = int(rng.integers(0, bs)) if not (nb == 1 and seed % 2) \
        else bs - 1
    kind = KINDS[seed % len(KINDS)]
    return gen.gen_values(rng, nb * bs - missing, cfg.bits_per_sample,
                          cfg.signed, kind)


def port_tail(cfg, raw, nb, k_init, bit0):
    """Kernels 1 (with nb) and 2 through their wrappers on CPU tensors:
    (stream bytes, total bits incl. bit0, k_final)."""
    win, block_bits, k_final = encode_cuda.encode_fields(
        cfg, torch.from_numpy(raw), torch.tensor([k_init], dtype=torch.int32),
        nb=nb)
    nwords = merge_cuda.word_count(cfg, nb, win.shape[1] - 1)
    words, tail = merge_cuda.merge_windows(
        win, block_bits, torch.tensor([bit0], dtype=torch.int64), nwords)
    total = int(tail[0])
    return (bytes(np.asarray(words_to_stream_bytes(words, total))), total,
            int(k_final[0]))


@pytest.mark.parametrize("k_above_0", [False, True], ids=["k0", "k>0"])
@pytest.mark.parametrize("name,nb", KERNEL_CASES,
                         ids=[f"{n}-nb{nb}" for n, nb in KERNEL_CASES])
def test_kernels_short_rsi_match_jax(name, nb, k_above_0):
    cfg = Config(*CONFIGS[name])
    seed = nb + 17 * list(CONFIGS).index(name)
    vals = tail_samples(cfg, nb, seed)
    k_init = max(cfg.kmax, 0) // 2 + 1 if k_above_0 and cfg.kmax > 0 else 0
    bit0 = seed % 8
    # the port pads the raw bytes; the JAX package pads the samples
    raw, got_nb = pad_tail(cfg, np.frombuffer(gen.pack_samples(
        vals, cfg.bits_per_sample, cfg.flags), np.uint8))
    assert got_nb == nb
    x = vals.astype(np.uint32) & np.uint32(cfg.mask)
    x = np.concatenate([x, np.full(nb * cfg.block_size - len(x), x[-1],
                                   np.uint32)]).reshape(1, -1)
    got = port_tail(cfg, raw, nb, k_init, bit0)

    packed, bits, k_final = encode_blocks_core(NUMPY, cfg, x, nb, k_init,
                                               bit0)
    assert got == (bytes(np.asarray(packed)), bits, k_final)
    if cfg.pad_rsi:  # the RSI's own bits end on a byte
        assert (got[1] - bit0) % 8 == 0
    if XLA_CASES.get(name) == nb:
        words, bits, k_final = encode_blocks_jax(cfg, x, nb, k_init, bit0)
        assert got == (bytes(np.asarray(words)), bits, k_final)


def test_kernel_refuses_an_nb_outside_the_rsi():
    cfg = Config(*CONFIGS["u16-bench"])
    raw = torch.zeros(cfg.rsi_len_bytes, dtype=torch.uint8)
    k0 = torch.zeros(1, dtype=torch.int32)
    for nb in (0, cfg.rsi + 1):
        with pytest.raises(ValueError):
            encode_cuda.encode_fields(cfg, raw, k0, nb=nb)
    with pytest.raises(ValueError):  # not whole RSIs of nb blocks
        encode_cuda.encode_fields(cfg, raw[:3 * cfg.block_size * 2 + 2], k0,
                                  nb=3)


# -- the stream level ---------------------------------------------------------

STREAM_CONFIGS = ["u16-bench", "u24-3byte", "s13", "bs128"]


def prefix_for_cursors(cfg, seed):
    """Stream bytes of up to 96 RSIs and, for each bit cursor 1-7, a count
    of at least 4 whole RSIs (two chunks of two) after which the stream
    stands at that cursor."""
    rng = np.random.default_rng(seed)
    S = cfg.samples_per_rsi
    vals = np.concatenate([gen.gen_values(rng, 8 * S, cfg.bits_per_sample,
                                          cfg.signed, KINDS[i % len(KINDS)])
                           for i in range(12)])
    data = gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags)
    _, block_bits, _ = encode_cuda.encode_fields_plain(
        cfg, torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
        torch.zeros(1, dtype=torch.int32))
    bits = np.cumsum(block_bits.numpy().astype(np.int64).reshape(
        -1, cfg.rsi).sum(axis=1))
    at = {}
    for n_rsi in range(4, len(bits) + 1):
        at.setdefault(int(bits[n_rsi - 1] % 8), n_rsi)
    missing = set(range(1, 8)) - set(at)
    assert not missing, f"no prefix ends at bit cursors {missing}"
    return data, at


TAILS = {"one-sample": lambda cfg: 1,
         "block-less-a-sample": lambda cfg: cfg.block_size - 1,
         "rsi-less-a-block": lambda cfg: (cfg.rsi - 1) * cfg.block_size}


def stream_encode(cfg, data, pieces):
    """The port's stream on the CPU: data fed in `pieces` pieces, then
    flushed and drained."""
    s = stream.AecStream(cfg.bits_per_sample, cfg.block_size, cfg.rsi,
                         cfg.flags, device="cpu")
    stream.aec_encode_init(s)
    out = bytearray()
    cuts = np.linspace(0, len(data), pieces + 1).astype(int)
    for a, b in zip(cuts[:-1], cuts[1:]):
        s.next_in, s.avail_in, s.next_out = data[a:b], None, out
        stream.aec_encode(s, AEC_NO_FLUSH)
    s.next_in, s.avail_in, s.next_out = b"", None, out
    stream.aec_encode(s, AEC_FLUSH)
    assert stream.aec_encode_end(s) == 0
    return bytes(out)


@pytest.mark.parametrize("tail", list(TAILS))
@pytest.mark.parametrize("name", STREAM_CONFIGS)
def test_entry_points_with_tails_match_jax_and_native(name, tail):
    """Every bit cursor 1-7 entering the short last RSI, after chunks of
    two RSIs: encode_buffer and the stream give libaec_tpu.encode_buffer's
    and native.encode's bytes."""
    cfg = Config(*CONFIGS[name])
    data, at = prefix_for_cursors(cfg, 5 + STREAM_CONFIGS.index(name))
    bsz = cfg.bytes_per_sample
    rem = TAILS[tail](cfg)
    for cursor in range(1, 8):
        n_rsi = at[cursor]
        start = (n_rsi - 1) * cfg.rsi_len_bytes  # an RSI's samples follow
        buf = data[:n_rsi * cfg.rsi_len_bytes] \
            + data[start:start + rem * bsz] + b"\x7f"[:bsz - 1]
        want = native.encode(buf, cfg)[1]
        assert libaec_tpu.encode_buffer(buf, cfg, backend=NUMPY,
                                        rsis_per_chunk=2) == want, cursor
        assert libaec_tpu_torch.encode_buffer(
            buf, cfg, device="cpu", force_device=True,
            rsis_per_chunk=2) == want, cursor
        assert stream_encode(cfg, buf, n_rsi // 2) == want, cursor


@pytest.mark.parametrize("name", ["pad-rsi32", "restricted2", "sz-ppb4"])
def test_entry_points_pad_rsi_restricted_sz_tails(name):
    """AEC_PAD_RSI (its short RSI padded to a byte on its own), the
    restricted set and SZIP's block of 4: every tail of TAILS after two
    chunks, through both entry points."""
    cfg = Config(*CONFIGS[name])
    rng = np.random.default_rng(31)
    S = cfg.samples_per_rsi
    for tail, rem in TAILS.items():
        vals = gen.gen_values(rng, 5 * S + rem(cfg), cfg.bits_per_sample,
                              cfg.signed, "lowentropy")
        buf = gen.pack_samples(vals, cfg.bits_per_sample, cfg.flags)
        want = native.encode(buf, cfg)[1]
        assert libaec_tpu.encode_buffer(buf, cfg, backend=NUMPY,
                                        rsis_per_chunk=2) == want, tail
        assert libaec_tpu_torch.encode_buffer(
            buf, cfg, device="cpu", force_device=True,
            rsis_per_chunk=2) == want, tail
        assert stream_encode(cfg, buf, 3) == want, tail
