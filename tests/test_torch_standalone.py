"""libaec_tpu_torch stands on its own: it imports neither jax nor
anything of libaec_tpu, and keeps its own copy of the host code.

A fresh interpreter imports the port, runs a small encode and decode on
CPU tensors and lists its modules; the port's native sources are the JAX
package's; the port's Config derives the same fields; and its native
loader survives six processes building at once into an empty directory
(the race that libaec_tpu's in-place build loses).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import libaec_tpu  # noqa: E402
import libaec_tpu_torch  # noqa: E402
from test_torch_matrix import MATRIX  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NATIVE_SOURCES = ("aectpu_native.cpp", "encoder.cpp", "libaec_abi.cpp",
                  "libaec_compat.h")


def run_python(code, *args):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code), *args], cwd=ROOT,
        capture_output=True, text=True, timeout=600)


def test_port_imports_no_jax_and_no_jax_package():
    res = run_python("""
        import sys
        import numpy as np
        import libaec_tpu_torch as lt
        from libaec_tpu_torch import native
        from libaec_tpu_torch.kernels import (  # every module of the port
            decode_cuda, decode_fused_cuda, encode_cuda, merge_cuda,
            unpredict_cuda)

        cfg = lt.Config(16, 64, 8, lt.AEC_DATA_MSB | lt.AEC_DATA_PREPROCESS)
        rng = np.random.default_rng(3)
        vals = (1000 + rng.integers(-3, 4, 5 * 512 + 77).cumsum())
        raw = vals.astype(">u2").tobytes()
        comp = lt.encode_buffer(raw, cfg, device="cpu", force_device=True)
        assert (0, comp) == native.encode(raw, cfg)
        for fused in (False, True):
            assert lt.decode_buffer(comp, cfg, len(raw), device="cpu",
                                    force_device=True, fused=fused) == raw
        assert lt.decode_buffers([comp, comp[:40]], cfg, [len(raw)] * 2,
                                 device="cpu")[0] == (0, raw)
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "jaxlib", "libaec_tpu")
                     or m.startswith(("jax.", "jaxlib.", "libaec_tpu.")))
        assert not bad, bad
        print("standalone ok")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "standalone ok"


def _code_lines(path):
    """A C++ source's lines, with the lines that are wholly comment
    dropped."""
    return [line for line in path.read_text().splitlines()
            if not line.lstrip().startswith(("//", "*", "/*"))]


@pytest.mark.parametrize("name", NATIVE_SOURCES)
def test_native_sources_are_the_jax_packages(name):
    """The port's copy compiles the same code: the files agree line for
    line, apart from comment lines (a copied comment may cite libaec's
    sources by another path)."""
    ours = ROOT / "libaec_tpu_torch" / "native" / name
    theirs = ROOT / "libaec_tpu" / "native" / name
    a, b = ours.read_text().splitlines(), theirs.read_text().splitlines()
    assert len(a) == len(b)
    assert _code_lines(ours) == _code_lines(theirs)
    differing = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    assert len(differing) <= 1, differing


DERIVED = ("signed", "msb", "preprocess", "restricted", "three_byte",
           "pad_rsi", "id_len", "bytes_per_sample", "kmax", "xmax", "xmin",
           "mask", "samples_per_rsi", "rsi_len_bytes", "uncomp_len",
           "slots_per_block")


@pytest.mark.parametrize("args", [row[1] for row in MATRIX],
                         ids=[row[0] for row in MATRIX])
def test_config_derives_the_same_fields(args):
    ours, theirs = libaec_tpu_torch.Config(*args), libaec_tpu.Config(*args)
    for name in DERIVED:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.bits_per_sample, ours.block_size, ours.rsi,
            ours.flags) == args


def test_config_and_constants_are_the_ports_own():
    assert libaec_tpu_torch.Config is not libaec_tpu.Config
    assert libaec_tpu_torch.AecError is not libaec_tpu.AecError
    for name in ("AEC_OK", "AEC_CONF_ERROR", "AEC_STREAM_ERROR",
                 "AEC_DATA_ERROR", "AEC_MEM_ERROR", "AEC_DATA_SIGNED",
                 "AEC_DATA_3BYTE", "AEC_DATA_MSB", "AEC_DATA_PREPROCESS",
                 "AEC_RESTRICTED", "AEC_PAD_RSI", "AEC_NOT_ENFORCE",
                 "AEC_NO_FLUSH", "AEC_FLUSH"):
        assert getattr(libaec_tpu_torch, name) == getattr(libaec_tpu, name)
    with pytest.raises(libaec_tpu_torch.AecConfError):
        libaec_tpu_torch.Config(16, 7, 8, 0)
    with pytest.raises(libaec_tpu_torch.AecConfError):
        libaec_tpu_torch.Config(33, 8, 8, 0)


def test_six_processes_build_the_native_library_at_once(tmp_path):
    """Six first calls of get_lib() on an empty build directory: every
    process gets a library that encodes."""
    code = """
        import sys
        from pathlib import Path
        import libaec_tpu_torch as lt
        from libaec_tpu_torch import native
        native.BUILD_DIR = Path(sys.argv[1])
        status, comp = native.encode(bytes(range(256)) * 8,
                                     lt.Config(8, 16, 4, 0))
        assert status == 0 and comp
        print(native.library_path().name, len(comp))
    """
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(tmp_path)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = [p.communicate(timeout=900) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert len({o for o, _ in outs}) == 1
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]  # no leftovers


def test_failed_native_build_raises_every_time(tmp_path, monkeypatch):
    from libaec_tpu_torch import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ["-no-such-flag"])
    for _ in range(2):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.get_lib()
    assert list(tmp_path.iterdir()) == []
