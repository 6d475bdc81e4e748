"""Kernel 3's parse as tensor code (ops/bitunpack.decode_blocks_region)
against the JAX package's payload parse and the port's plain version.

csrc/decode_block.cuh, the parse of kernels 3 and 6, finds the FS
positions only in the words up to the one that holds the payload's n_fs-th
set bit (a lane per bit, each set bit written at its rank), stages only
the window words it and the fields read, skips the window of a zero block
and the FS parse of an uncompressed one.
Its tensor version must give the mapped deltas of
libaec_tpu.ops.bitunpack.decode_blocks (XLA) and of
ops/bitunpack.decode_blocks on scanned streams of blocks of every kind --
zero, second extension, split and uncompressed, with and without a
reference sample -- at every window width the decode path can choose (the
buckets 6, 10 and 18 and the worst case), block sizes 8, 10, 16, 32 and 64
and 24-bit samples in 3 bytes.  Tolerance zero.  The CUDA kernel is held
against the plain version in test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_kernel_cases import (  # noqa: E402
    DECODE_CONFIGS,
    DECODE_DATA,
    PP,
    chunk_records,
    decode_widths,
)

from libaec_tpu.ops import bitunpack as jax_bitunpack  # noqa: E402
from libaec_tpu_torch import native  # noqa: E402
from libaec_tpu_torch.decode import scan_record_arrays  # noqa: E402
from libaec_tpu_torch.ops import bitunpack  # noqa: E402
from libaec_tpu_torch.ops.u32 import u32_to_bits  # noqa: E402


@pytest.mark.parametrize("data", DECODE_DATA)
@pytest.mark.parametrize("name", list(DECODE_CONFIGS))
def test_region_parse_matches_jax_and_plain(name, data):
    cfg = DECODE_CONFIGS[name]
    comp, recs, bucket = chunk_records(cfg, data, len(name) + len(data))
    xla = jax.jit(lambda *a: jax_bitunpack.decode_blocks(cfg, *a))
    for wf in decode_widths(cfg, bucket):
        recs["win"] = native.fill_windows(comp, recs["fs_off"],
                                          recs["meta"], wf)
        arrs = scan_record_arrays(recs)
        args = [u32_to_bits(a) for a in arrs]
        got = bitunpack.decode_blocks_region(cfg, *args)
        assert torch.equal(got, bitunpack.decode_blocks(cfg, *args)), wf
        want = np.asarray(xla(*(jnp.asarray(a) for a in arrs)))
        assert np.array_equal(got.numpy().view(np.uint32), want), wf


@pytest.mark.parametrize("name", list(DECODE_CONFIGS))
def test_region_is_the_fs_region(name):
    """On blocks of every kind: each of the four codings occurs, second
    extension and split blocks with and without a reference; the search
    of a split block stays inside the FS region that its record bounds
    (lsb_rel), and reaches no further than the first n_fs set bits; zero
    and uncompressed blocks search nothing, and zero blocks read no word."""
    cfg = DECODE_CONFIGS[name]
    comp, recs, bucket = chunk_records(cfg, "every kind", 3, n_rsi=8)
    recs["win"] = native.fill_windows(comp, recs["fs_off"], recs["meta"],
                                      bitunpack.window_words(cfg))
    win, fs_bit, lsb_rel, meta, _ = (u32_to_bits(a).long()
                                     for a in scan_record_arrays(recs))
    _, _, nsearch, nfield = bitunpack.decode_payload_region(
        cfg, *(u32_to_bits(a) for a in scan_record_arrays(recs)[:4]))
    kind, ref = meta & 3, (meta >> 7) & 1
    seen = {(int(k), int(r)) for k, r in zip(kind, ref)}
    want = {(0, 0), (1, 0), (2, 0), (3, 0)}  # (kind, reference)
    if cfg.flags & PP:
        want |= {(0, 1), (2, 1)} | ({(1, 1)} if name != "bs16" else set())
    assert want <= seen
    split = kind == 2
    region = ((fs_bit + lsb_rel - 1) >> 5) + 1
    assert bool((nsearch[split] <= region[split]).all())
    assert bool((nsearch[(kind == 1) | split] >= 1).all())
    assert not bool(nsearch[(kind == 0) | (kind == 3)].any())
    assert not bool(nfield[kind == 0].any())
    assert int(nsearch.max()) < bitunpack.window_words(cfg)
