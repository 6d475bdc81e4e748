"""The verified scan of libaec_tpu_torch's inverse-predictor kernels, on
the CPU.

Kernels 4 and 5 (csrc/unpredict.cu) compute an RSI's samples by a prefix
sum per group of samples, check the guess with the predictor's step,
repair the first mismatch and walk serially after a bounded number of
repairs.  A CUDA kernel cannot run here, so the same algorithm on tensors
(ops/unpredict.unpredict_rsis_scan) is held against the port's serial
plain version and against the JAX package's unpredict_rsis: every
tests/gen.py kind, as the deltas of the kind's samples (which must also
give the samples back) and as arbitrary deltas, at six widths, with RSIs
that are not a whole number of groups, and with repair caps of 0, 1 and
the shipped value.  The kernels are held against the serial plain version
in test_torch_cuda.py.  Tolerance zero: integers equal.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from gen import KINDS, gen_values  # noqa: E402

import libaec_tpu  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_NOT_ENFORCE,
)
from libaec_tpu.ops.unpredict import unpredict_rsis as jax_unpredict  # noqa: E402
from libaec_tpu_torch import Config  # noqa: E402
from libaec_tpu_torch.kernels import decode_fused_cuda, unpredict_cuda  # noqa: E402
from libaec_tpu_torch.ops import preprocess, unpredict  # noqa: E402
from libaec_tpu_torch.ops.u32 import MASK32, u32_to_bits  # noqa: E402

PP, MSB, SGN, B3 = (AEC_DATA_PREPROCESS, AEC_DATA_MSB, AEC_DATA_SIGNED,
                    AEC_DATA_3BYTE)

# (bits, block size, RSI length, flags): S = 400 is a group of 256 and a
# short one of 144
CASES = {
    "u8": (8, 16, 25, PP),
    "s13": (13, 16, 25, PP | SGN | MSB),
    "u16": (16, 16, 25, PP | MSB),
    "u24-3byte": (24, 16, 25, PP | MSB | B3),
    "u32": (32, 16, 25, PP),
    "s32": (32, 16, 25, PP | SGN),
}
CAPS = {"cap0": 0, "cap1": 1, "shipped": unpredict.SCAN_REPAIRS}
N_RSI = 4


def config(case):
    return Config(*CASES[case])


def make_deltas(cfg, kind, sort, seed):
    """int64 u32 deltas [N_RSI, S] and, for deltas of real samples, the
    samples they must give back."""
    rng = np.random.default_rng(seed)
    shape = (N_RSI, cfg.samples_per_rsi)
    if sort == "arbitrary":
        # the kind's values taken as deltas; one row from all of u32
        d = gen_values(rng, shape[0] * shape[1], cfg.bits_per_sample,
                       cfg.signed, kind).reshape(shape).astype(np.int64)
        d[0] = rng.integers(0, 1 << 32, shape[1], dtype=np.uint64)
        return torch.from_numpy(d), None
    raw = torch.from_numpy(gen_values(
        rng, shape[0] * shape[1], cfg.bits_per_sample, cfg.signed,
        kind).reshape(shape).astype(np.int64))
    d, ref = preprocess.delta_map(raw, cfg)
    d[:, 0] = ref
    want = raw
    if cfg.signed:
        m = 1 << (cfg.bits_per_sample - 1)
        want = ((raw ^ m) - m) & MASK32
    return d, want


@functools.lru_cache(maxsize=None)
def references(case, kind, sort):
    """(deltas, the serial plain version's samples): the latter checked
    once against the JAX package and, where known, the original samples."""
    cfg = config(case)
    d, samples = make_deltas(cfg, kind, sort,
                             seed=len(case) + 17 * KINDS.index(kind))
    serial = unpredict.unpredict_rsis(cfg, d)
    jcfg = libaec_tpu.Config(*CASES[case])
    want = np.asarray(jax.jit(functools.partial(jax_unpredict, jcfg))(
        d.numpy().astype(np.uint32)))
    assert np.array_equal(serial.numpy().astype(np.uint32), want)
    if samples is not None:
        assert torch.equal(serial, samples)
    return d, serial


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("sort", ["of-samples", "arbitrary"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CASES)
def test_scan_matches_serial_and_jax(case, kind, sort, cap):
    d, serial = references(case, kind, sort)
    got = unpredict.unpredict_rsis_scan(config(case), d, repairs=CAPS[cap])
    assert got.dtype == torch.int64 and got.shape == d.shape
    assert torch.equal(got, serial)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("lanes,per_lane", [(1, 1), (3, 1), (4, 3), (32, 4),
                                            (32, 8), (16, 64)])
@pytest.mark.parametrize("case", ["u16", "s13", "s32"])
def test_scan_group_sizes(case, lanes, per_lane, cap):
    """Groups shorter than, equal to and longer than the RSI, on noise
    (every other delta escapes) and on a walk (none does)."""
    d, serial = references(case, "random", "arbitrary")
    cfg = config(case)
    got = unpredict.unpredict_rsis_scan(cfg, d, lanes, per_lane, CAPS[cap])
    assert torch.equal(got, serial)
    d, serial = references(case, "lowentropy", "of-samples")
    got = unpredict.unpredict_rsis_scan(cfg, d, lanes, per_lane, CAPS[cap])
    assert torch.equal(got, serial)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("bits,bs,rsi,flags", [
    (16, 8, 1, PP | MSB),                    # the shortest RSI, 8 samples
    (8, 8, 1, PP | SGN),
    (16, 10, 3, PP | AEC_NOT_ENFORCE),       # 30 samples: unaligned rows
    (32, 64, 9, PP | SGN),                   # 576 samples: 2 groups and 64
    (16, 64, 4, MSB),                        # no preprocessing: passthrough
], ids=["u16-rsi1", "s8-rsi1", "u16-bs10", "s32-576", "u16-no-pp"])
def test_scan_shapes(bits, bs, rsi, flags, cap):
    cfg = Config(bits, bs, rsi, flags)
    rng = np.random.default_rng(bits + bs + rsi)
    d = torch.from_numpy(rng.integers(
        0, 1 << 32, (7, cfg.samples_per_rsi), dtype=np.uint64).astype(
            np.int64))
    d[3:] &= cfg.xmax >> 3  # small deltas: runs without an escape
    got = unpredict.unpredict_rsis_scan(cfg, d, repairs=CAPS[cap])
    assert torch.equal(got, unpredict.unpredict_rsis(cfg, d))
    jcfg = libaec_tpu.Config(bits, bs, rsi, flags)
    want = np.asarray(jax_unpredict(jcfg, d.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


# kernel 6 scans slabs of whole blocks (decode_fused_cuda.slab_geometry):
# (bits, block size, RSI length, flags, RSIs in the chunk, the slab's
# samples that this geometry must give)
SLAB_CASES = {
    "bs64-two-slabs": (16, 64, 40, PP | MSB, 24, 2048),      # 2048 + 512
    "bs10-short-groups": (16, 10, 256, PP | MSB | AEC_NOT_ENFORCE, 512,
                          2040),                 # 7 * 256 + 248, then 520
    "bs48-one-slab": (32, 48, 11, PP | SGN | AEC_NOT_ENFORCE, 7, 768),
    "bs10-rsi3": (8, 10, 3, PP | AEC_NOT_ENFORCE, 1001, 240),  # rows of 30
    "bs24-group4": (13, 24, 100, PP | SGN | AEC_NOT_ENFORCE, 1000,
                    2040),                       # 85 blocks; then 360 samples
    "group16-two-groups": (16, 16, 100, PP, 3000, 512),       # 512 * 3 + 64
    "group32-one-group": (32, 8, 40, PP | SGN, 10000, 256),   # 256 + 64
}


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("kind", ["lowentropy", "midentropy", "random"])
@pytest.mark.parametrize("case", SLAB_CASES)
def test_scan_slab_geometry(case, kind, cap):
    """The scan cut into kernel 6's slabs: groups that end short of 256
    samples in the middle of an RSI, and the carry from slab to slab."""
    bits, bs, rsi, flags, n_rsi, slab = SLAB_CASES[case]
    cfg = Config(bits, bs, rsi, flags)
    assert decode_fused_cuda.slab_geometry(cfg, n_rsi)[1] * bs == slab
    d, samples = make_deltas(cfg, kind, "of-samples", seed=len(case))
    serial = unpredict.unpredict_rsis(cfg, d)
    assert torch.equal(serial, samples)
    counts = {}
    got = unpredict.unpredict_rsis_scan(cfg, d, repairs=CAPS[cap], slab=slab,
                                        counts=counts)
    assert torch.equal(got, serial)
    if kind == "lowentropy":
        assert counts == {"repairs": 0, "walked": 0, "rounds": 0}
    # arbitrary deltas, one row from all of u32
    d, _ = make_deltas(cfg, kind, "arbitrary", seed=len(case) + 1)
    got = unpredict.unpredict_rsis_scan(cfg, d, repairs=CAPS[cap], slab=slab)
    assert torch.equal(got, unpredict.unpredict_rsis(cfg, d))
    jcfg = libaec_tpu.Config(bits, bs, rsi, flags)
    want = np.asarray(jax_unpredict(jcfg, d.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("slab", [1, 7, 255, 256, 257, 300, 512, 5000])
def test_scan_any_slab(slab):
    """Whatever the slab, the samples are the serial version's."""
    cfg = config("s13")
    for kind in ("midentropy", "random"):
        d, serial = references("s13", kind, "of-samples")
        got = unpredict.unpredict_rsis_scan(cfg, d, slab=slab)
        assert torch.equal(got, serial)


@pytest.mark.parametrize("case", CASES)
def test_scan_plain_wrapper(case):
    """unpredict_cuda.unpredict_rsis_scan_plain has unpredict_rsis's
    contract (int32 bits in and out) and launches nothing."""
    cfg = config(case)
    d, serial = references(case, "midentropy", "of-samples")
    bits = u32_to_bits(d.numpy().astype(np.uint32))
    before = (unpredict_cuda.launches, unpredict_cuda.rsis_launches,
              unpredict_cuda.layout_launches)
    got = unpredict_cuda.unpredict_rsis_scan_plain(cfg, bits)
    assert got.dtype == torch.int32
    assert torch.equal(got, unpredict_cuda.unpredict_rsis(cfg, bits))
    assert np.array_equal(got.numpy().view(np.uint32),
                          serial.numpy().astype(np.uint32))
    assert before == (unpredict_cuda.launches, unpredict_cuda.rsis_launches,
                      unpredict_cuda.layout_launches)


def test_scan_takes_the_cheapest_route():
    """Smooth data needs neither repair nor walk; lone escapes cost one
    repair each and no walk; noise ends in the walk after few repairs."""
    cfg = config("u16")
    counts = {}
    d, serial = references("u16", "lowentropy", "of-samples")
    assert torch.equal(unpredict.unpredict_rsis_scan(cfg, d, counts=counts),
                       serial)
    assert counts == {"repairs": 0, "walked": 0, "rounds": 0}
    # one jump to the far end of the range in each group of each RSI
    raw = torch.full((N_RSI, cfg.samples_per_rsi), 100, dtype=torch.int64)
    raw[:, 57::256] = 65000
    d, ref = preprocess.delta_map(raw, cfg)
    d[:, 0] = ref
    assert torch.equal(unpredict.unpredict_rsis_scan(cfg, d, counts=counts),
                       raw)
    groups = N_RSI * 2
    assert counts == {"repairs": 2 * groups, "walked": 0, "rounds": 0}
    d, serial = references("u16", "random", "of-samples")
    assert torch.equal(unpredict.unpredict_rsis_scan(cfg, d, counts=counts),
                       serial)
    assert counts["walked"] == groups
    assert counts["repairs"] <= groups * unpredict.SCAN_REPAIRS
    assert 2 < counts["rounds"] <= 2 * 32


def test_constants_match_the_kernel():
    """The plain version follows the kernel's group and repair cap."""
    header = (Path(unpredict.__file__).resolve().parent.parent / "csrc"
              / "unpredict_step.cuh").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             header).group(1))

    assert constant("SCAN_V") == unpredict.SCAN_V
    assert unpredict.SCAN_LANES == 32
    assert constant("SCAN_REPAIRS") == unpredict.SCAN_REPAIRS
    # kernel 6's slab geometry
    fused = (Path(unpredict.__file__).resolve().parent.parent / "csrc"
             / "decode_fused.cu").read_text()
    for name in ("SLAB_GROUPS", "MAX_GROUP", "BLOCKS_PER_SM"):
        value = int(re.search(rf"constexpr int {name} = (\d+);",
                              fused).group(1))
        assert value == getattr(decode_fused_cuda, name)
    assert decode_fused_cuda.SCAN_G == 32 * constant("SCAN_V")
    assert "scan_guess(" in fused and "scan_verify<PATH>(" in fused
