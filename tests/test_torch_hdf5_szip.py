"""HDF5 szip interop of the port: examples/hdf5_szip_torch.py, and twins
of tests/test_hdf5_szip.py on libaec_tpu_torch.szip and the port's
library.

  * the example, run as a user runs it, with --device cpu (the kernels'
    plain versions on CPU tensors);
  * foreign file -> the port: raw chunks of an szip dataset written by
    libhdf5 decode bit-identically through sz_decompress_batch, as
    through the JAX package's szip;
  * the port -> foreign reader: chunks compressed by
    sz_buffto_buff_compress (its device route on CPU tensors) and written
    with write_direct_chunk read back through libhdf5's filter;
  * the port's library LD_PRELOADed is a drop-in szlib for libhdf5.
"""
import os
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
torch = pytest.importorskip("torch")

from libaec_tpu import szip as jszip  # noqa: E402
from libaec_tpu_torch import native, szip  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
H5Z_FILTER_SZIP = 4

pytestmark = pytest.mark.skipif(
    not h5py.h5z.filter_avail(H5Z_FILTER_SZIP),
    reason="libhdf5 lacks the szip filter")


def szip_args(dset):
    """(options_mask, bits_per_pixel, pixels_per_block,
    pixels_per_scanline) of the dataset's szip filter, whose cd_values
    hold the block before the pixel width (H5Z_SZIP_PARM_PPB 1,
    H5Z_SZIP_PARM_BPP 2; tests/test_hdf5_szip.py reads them the other way
    round, and picks datasets where the two are equal)."""
    dcpl = dset.id.get_create_plist()
    for i in range(dcpl.get_nfilters()):
        fid, _flags, cd, _name = dcpl.get_filter(i)
        if fid == H5Z_FILTER_SZIP:
            return cd[0], cd[2], cd[1], cd[3]
    raise LookupError("no szip filter")


def make_data(shape, dtype):
    rng = np.random.default_rng(3)
    y = np.linspace(0, 2000, shape[0])[:, None]
    x = np.linspace(0, 300, shape[1])[None, :]
    return (y + x + rng.integers(0, 9, shape)).astype(dtype)


def test_example_runs_on_cpu_tensors():
    res = subprocess.run(
        [sys.executable, str(REPO / "examples" / "hdf5_szip_torch.py"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr
    assert "bit-identical to libhdf5's szip decode (device cpu)" \
        in res.stdout


@pytest.mark.parametrize("dtype,ppb", [("<u2", 16), ("<u4", 32), ("u1", 8),
                                       ("<u2", 4), ("<u2", 32), ("u1", 16)])
def test_decode_libhdf5_chunks(tmp_path, dtype, ppb):
    shape, chunks = (256, 256), (64, 256)
    data = make_data(shape, dtype)
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as h:
        d = h.create_dataset("x", shape, dtype=dtype, chunks=chunks,
                             compression="szip", compression_opts=("nn", ppb))
        d[:] = data
    with h5py.File(path, "r") as h:
        d = h["x"]
        args = szip_args(d)
        offs, sizes, streams = [], [], []
        for i in range(d.id.get_num_chunks()):
            info = d.id.get_chunk_info(i)
            _mask, raw = d.id.read_direct_chunk(info.chunk_offset)
            offs.append(info.chunk_offset)
            sizes.append(struct.unpack("<I", raw[:4])[0])
            streams.append(raw[4:])
    decoded = szip.sz_decompress_batch(streams, szip.SZCom(*args), sizes,
                                       device="cpu")
    assert decoded == [jszip.sz_buffto_buff_decompress(
        s, jszip.SZCom(*args), n) for s, n in zip(streams, sizes)]
    for off, buf in zip(offs, decoded):
        want = data[off[0]:off[0] + chunks[0], off[1]:off[1] + chunks[1]]
        got = np.frombuffer(buf, dtype).reshape(chunks)
        assert np.array_equal(got, want), off


@pytest.mark.parametrize("force_device", [False, True],
                         ids=["native", "device"])
def test_libhdf5_reads_our_chunks(tmp_path, force_device):
    shape, chunks = (128, 512), (32, 512)
    data = make_data(shape, "<u2")
    path = str(tmp_path / "g.h5")
    with h5py.File(path, "w") as h:
        d = h.create_dataset("x", shape, dtype="<u2", chunks=chunks,
                             compression="szip", compression_opts=("nn", 16))
        param = szip.SZCom(*szip_args(d))
        for r in range(0, shape[0], chunks[0]):
            block = data[r:r + chunks[0]].tobytes()
            comp = szip.sz_buffto_buff_compress(block, param, device="cpu",
                                                force_device=force_device)
            assert comp == jszip.sz_buffto_buff_compress(
                block, jszip.SZCom(*szip_args(d)))
            d.id.write_direct_chunk((r, 0),
                                    struct.pack("<I", len(block)) + comp)
    with h5py.File(path, "r") as h:
        assert np.array_equal(h["x"][:], data)


def test_ld_preload_drop_in(tmp_path):
    """The port's library is a drop-in szlib: LD_PRELOADed, libhdf5's szip
    filter binds SZ_BufftoBuffCompress/Decompress to it (LD_DEBUG
    bindings), and an szip dataset written and read under that binding
    round-trips."""
    native.get_lib()
    so = native.library_path()
    script = textwrap.dedent("""
        import h5py, numpy as np, os, sys
        f = sys.argv[1]
        data = (np.arange(128*256) % 3000).reshape(128, 256).astype('<u2')
        with h5py.File(f, 'w') as h:
            d = h.create_dataset('x', data.shape, dtype='<u2',
                                 chunks=(64, 256), compression='szip',
                                 compression_opts=('nn', 16))
            d[:] = data
        with h5py.File(f, 'r') as h:
            assert np.array_equal(h['x'][:], data)
        print('ROUNDTRIP_OK')
        os.remove(f)
    """)
    env = dict(os.environ)
    env["LD_PRELOAD"] = str(so)
    env["LD_DEBUG"] = "bindings"
    env["LD_DEBUG_OUTPUT"] = str(tmp_path / "ld")
    r = subprocess.run([sys.executable, "-c", script,
                        str(tmp_path / "x.h5")], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ROUNDTRIP_OK" in r.stdout, \
        (r.stdout, r.stderr[-500:])
    bound = [line for f in tmp_path.glob("ld.*")
             for line in f.read_text(errors="replace").splitlines()
             if "SZ_BufftoBuff" in line and so.name in line]
    assert bound, "libhdf5 did not bind SZ_* to the port's library"
