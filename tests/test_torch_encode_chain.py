"""The algorithms of libaec_tpu_torch's redesigned encode kernel, on the CPU.

Kernel 1 (csrc/encode.cu) chains the warm-start k as a scan over tiles and
runs of tiles, and sums the split lengths a k to a lane, in 32 bits where
the samples are narrow enough.  A CUDA kernel cannot run here, so the
same algorithms on tensors (ops/options.chain_k_tiled,
ops/options.fs_tables_lanes) are held
against the port's straightforward versions (chain_k, fs_tables) and
against the JAX package's (chain_k, which is _chain_k_tiled on its JAX
backend, and fs_tables), on the same numpy-seeded inputs.  The kernel is
held against the plain version in test_torch_cuda.py.  Tolerance zero:
integers equal.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from libaec_tpu.backend import jax_backend  # noqa: E402
from libaec_tpu.config import KW  # noqa: E402
from libaec_tpu.ops import options as jax_options  # noqa: E402
from libaec_tpu_torch.ops import options  # noqa: E402

TILE, RUNS = 64, 32
# tiles: one, fewer than the runs, one more than the runs (runs of 2, the
# last ones empty), the bench chunk's count; each with a short last tile
TILE_COUNTS = [1, 31, 33, 4096]


@functools.lru_cache(maxsize=None)
def chain_inputs(nt):
    """(maps int64 [NB, 32], the prefix composition of all of them): NB
    blocks in nt tiles, the last of 27 blocks.  A third of the maps are
    identities (zero blocks), a third constant (a block that forgets the
    incoming k), a third arbitrary."""
    rng = np.random.default_rng(nt)
    nb = nt * TILE - 37
    maps = rng.integers(0, KW, (nb, KW))
    sort = rng.integers(0, 3, nb)
    maps[sort == 0] = np.arange(KW)
    maps[sort == 1] = maps[sort == 1][:, :1]
    maps = torch.from_numpy(maps.astype(np.int64))
    return maps, options.prefix_compose(maps)


@pytest.mark.parametrize("k_init", range(KW))
@pytest.mark.parametrize("nt", TILE_COUNTS)
def test_chain_k_tiled_matches_chain_k_and_jax(nt, k_init):
    maps, prefix = chain_inputs(nt)
    k0 = torch.tensor([k_init])
    chosen, k_final, comp, tile_kin = options.chain_k_tiled(maps, k0, TILE,
                                                            RUNS)
    want = prefix[:, k_init]
    assert chosen.dtype == torch.int64 and torch.equal(chosen, want)
    assert torch.equal(k_final, want[-1:])
    # what the kernel keeps in its scratch: the k that enters each tile,
    # and each tile's composite
    k_in = torch.cat([k0, want[:-1]])
    assert torch.equal(tile_kin, k_in[::TILE])
    assert comp.shape == (nt, KW)
    assert torch.equal(torch.gather(comp, 1, tile_kin[:, None])[:, 0],
                       torch.cat([k_in[TILE::TILE], want[-1:]]))
    # the JAX package: the k entering each block, and the last k
    jk_in, jk_final = jax_options.chain_k(
        jax_backend(), jnp.asarray(maps.numpy().astype(np.int32)), k_init)
    assert np.array_equal(np.asarray(jk_in), k_in.numpy())
    assert int(jk_final) == int(k_final)


@pytest.mark.parametrize("nt", TILE_COUNTS[:3])
def test_chain_k_tiled_agrees_with_chain_k_function(nt):
    maps, _ = chain_inputs(nt)
    for k_init in (0, 13, 31):
        k0 = torch.tensor([k_init])
        chosen, k_final = options.chain_k(maps, k0)
        got = options.chain_k_tiled(maps, k0)
        assert torch.equal(got[0], chosen) and torch.equal(got[1], k_final)


@pytest.mark.parametrize("k_init,clamped", [(-1, 0), (-40, 0), (32, 31),
                                            (1000, 31)])
def test_chain_k_tiled_clamps_k_init(k_init, clamped):
    """An incoming k outside the maps' domain enters as the nearest k in
    it, as the kernel's chain pass takes it."""
    maps, _ = chain_inputs(33)
    got = options.chain_k_tiled(maps, torch.tensor([k_init]))
    want = options.chain_k_tiled(maps, torch.tensor([clamped]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tile,runs", [(1, 1), (3, 2), (64, 1), (64, 7),
                                       (5, 32), (128, 64)])
def test_chain_k_tiled_other_tiles_and_runs(tile, runs):
    """The result does not depend on how the blocks are cut."""
    maps, prefix = chain_inputs(31)
    for k_init in (0, 5, 31):
        chosen, k_final, comp, tile_kin = options.chain_k_tiled(
            maps, torch.tensor([k_init]), tile, runs)
        assert torch.equal(chosen, prefix[:, k_init])
        assert int(k_final) == int(prefix[-1, k_init])
        assert comp.shape[0] == tile_kin.shape[0] == -(-maps.shape[0] // tile)


@pytest.mark.parametrize("bps", range(1, 33))
def test_fs_tables_lanes_matches_fs_tables_and_jax(bps):
    rng = np.random.default_rng(bps)
    for bs in (8, 10, 64):  # 64: the most deltas a sum can hold
        d = rng.integers(0, 1 << bps, (50, bs), dtype=np.uint64)
        d[0] = (1 << bps) - 1           # every bit of every plane
        d[1] = 0
        d[2, ::2] = 1 << (bps - 1)      # the top plane alone (bit 31 at 32)
        d_t = torch.from_numpy(d.astype(np.int64))
        want = options.fs_tables(d_t, KW)
        got = options.fs_tables_lanes(d_t, KW, bps)
        assert got.dtype == torch.int64 and torch.equal(got, want)
        if bps <= 25:  # the split lengths too fit 32 bits
            assert int(options.split_lengths(
                got, torch.full((50,), bs)).max()) < 1 << 32
        hi, lo = jax_options.fs_tables(jnp, jnp.asarray(d.astype(np.uint32)))
        jax_fs = (np.asarray(hi).astype(np.int64) << 16) + np.asarray(lo)
        assert np.array_equal(got.numpy(), jax_fs)
        # the kernel's domain: K = kmax + 1 columns
        for K in (1, 6, 14, 30):
            assert torch.equal(options.fs_tables_lanes(d_t, K, bps),
                               want[:, :K])


def test_constants_match_the_kernel():
    """The plain chain follows the kernel's tile and its count of runs."""
    source = (Path(options.__file__).resolve().parent.parent / "csrc"
              / "encode.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("TILE") == TILE
    assert constant("RUNS") == RUNS
    # the sums of fs_tables_lanes: 32 bits up to 25-bit samples, halves of
    # the samples up to 16 values of k
    assert "bps <= 25, xmax" in source and "K <= 16" in source
    assert KW == 32  # a warp's lanes: lane k follows entry k
