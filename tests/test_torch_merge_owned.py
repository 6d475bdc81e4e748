"""Kernel 2's design as tensor code (ops/bitpack.merge_windows_owned)
against the JAX package's merge and the port's plain merge.

csrc/merge.cu gathers each stream word once, by the tile that owns the
word's first bit, from the blocks that overlap it, and writes only the
used prefix of the buffer.  Its tensor version must give the words of
libaec_tpu.ops.bitpack.merge_block_windows (XLA) and of the plain
ops/bitpack.merge_windows over that prefix, the same tail, and write
every word of the prefix exactly once, at every bit0 in 0..7, on windows
that exercise what the design has to get right: blocks of 0 bits in runs
of up to 63 (a zero run's code sits on its last block), many short
blocks in one word, words that cross a tile's end into the next tiles'
blocks, a block count that is not a multiple of the tile; and on the
windows the encode kernel's plain version makes from tests/gen.py data.
Tolerance zero.  The CUDA kernel is held against the plain merge in
test_torch_cuda.py and chip_smoke.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_kernel_cases import MERGE_CASES, merge_buffer_words  # noqa: E402

from libaec_tpu.backend import jax_backend  # noqa: E402
from libaec_tpu.ops import bitpack as jax_bitpack  # noqa: E402
from libaec_tpu_torch import encode as torch_encode  # noqa: E402
from libaec_tpu_torch.kernels import merge_cuda  # noqa: E402
from libaec_tpu_torch.ops import bitpack  # noqa: E402
from libaec_tpu_torch.ops.u32 import words_to_be_u32  # noqa: E402


@pytest.fixture(scope="module")
def cases():
    return {name: make() for name, make in MERGE_CASES.items()}


@pytest.mark.parametrize("bit0", range(8))
@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_owned_merge_matches_jax_and_plain(cases, name, bit0):
    win, bb, tile = cases[name]
    NB, W = win.shape
    b0 = torch.tensor([bit0], dtype=torch.int64)
    nwords = merge_buffer_words(NB, W)
    want, want_tail = bitpack.merge_windows(win, bb, b0, nwords)
    got, tail, writes = bitpack.merge_windows_owned(win, bb, b0, nwords,
                                                    tile=tile)
    total = int(tail[0])
    used = merge_cuda.used_words(total)
    assert torch.equal(tail, want_tail) and int(tail[1]) == total & 7
    assert torch.equal(got[:used], want[:used])
    assert writes.shape == (used,) and bool((writes == 1).all())
    assert not bool(got[used:].any())

    w_xla, tb_xla = jax_bitpack.merge_block_windows(
        jax_backend(), jnp.asarray(win.numpy().view(np.uint32)),
        jnp.asarray(bb.numpy().view(np.uint32)), bit0, W - 1, nwords, 64)
    assert int(tb_xla) == total
    assert np.array_equal(words_to_be_u32(got[:used]).astype(np.uint32),
                          np.asarray(w_xla)[:used])


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_owned_merge_crosses_tiles(cases, name):
    """The cases reach what they are for: words past a tile's bits (the
    spill that warp 0 gathers), and in the run cases words that take bits
    from more than one later tile or from many blocks."""
    win, bb, tile = cases[name]
    NB = win.shape[0]
    T = -(-NB // tile)
    rows = torch.cat([bb.long(), bb.new_zeros(T * tile - NB).long()])
    agg = rows.view(T, tile).sum(1)
    ends = 32 + torch.cumsum(agg, 0)
    assert NB % tile or name.endswith("encoded")
    assert bool((ends[:-1] % 32 != 0).any())  # a tile ends inside a word
    if "runs" in name:
        start = 32 + torch.cumsum(bb.long(), 0) - bb.long()
        per_word = torch.bincount(start[bb > 0] // 32)
        assert int(per_word.max()) >= 5       # many blocks in one word
        assert bool((agg < 32).any())         # a tile shorter than a word


def test_used_words_is_what_the_encoder_reads():
    """The used prefix is exactly the words words_to_stream_bytes copies,
    so the words past it, which the kernel leaves unwritten, are never
    read."""
    for total in range(0, 200):
        words = torch.arange(1000, dtype=torch.int32)
        nbytes = (total + 7) // 8
        got = torch_encode.words_to_stream_bytes(words, total)
        assert len(got) == nbytes
        read = (4 + nbytes + 3) // 4
        assert read == merge_cuda.used_words(total)


def test_constants_match_the_kernel():
    """The wrapper's tile is the kernel's, and the kernel writes its words
    with plain stores."""
    source = (Path(bitpack.__file__).resolve().parent.parent / "csrc"
              / "merge.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("TILE") == merge_cuda.TILE
    code = re.sub(r"//.*", "", source)
    assert "atomic" not in code  # each word is written once, by a store
