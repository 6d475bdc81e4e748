"""Decode an szip-compressed HDF5 dataset with libaec_tpu_torch.

The twin of examples/hdf5_szip.py on the PyTorch port.  Every chunk of an
szip-compressed dataset is an independent SZ stream, the shape that
`sz_decompress_batch` serves: the streams' structural scans run on host
threads and their payloads decode on the card, many chunks to a launch.

The example writes an szip dataset with h5py (whose libhdf5 carries its
own szip codec), then bypasses the HDF5 filter pipeline: it reads the RAW
stored chunks with `read_direct_chunk`, rebuilds the SZ parameters from
the dataset creation property list, decompresses every chunk through
libaec_tpu_torch.szip, and checks the result against what libhdf5 itself
decodes.

HDF5 filter wire format (H5Zszip.c, H5Z_SZIP_PARM_*): cd_values =
[options_mask, pixels_per_block, bits_per_pixel, pixels_per_scanline];
each stored chunk is a little-endian uint32 byte count followed by the
headerless SZ stream.  (examples/hdf5_szip.py reads the second and third
values the other way round; its dataset has 16 of both.)

Run: python examples/hdf5_szip_torch.py [--device cuda|cpu]
("cpu" runs the kernels' plain versions on CPU tensors).
"""
import argparse
import os
import struct
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import h5py  # noqa: E402

from libaec_tpu_torch.szip import SZCom, sz_decompress_batch  # noqa: E402

H5Z_FILTER_SZIP = 4


def write_szip_file(path, shape=(512, 512), chunks=(64, 512)):
    rng = np.random.default_rng(7)
    # climate-field-like: smooth ramp + low-amplitude noise (low entropy)
    y = np.linspace(0, 3000, shape[0])[:, None]
    x = np.linspace(0, 500, shape[1])[None, :]
    data = (y + x + rng.integers(0, 17, shape)).astype("<u2")
    with h5py.File(path, "w") as h:
        d = h.create_dataset("temperature", shape, dtype="<u2",
                             chunks=chunks, compression="szip",
                             compression_opts=("nn", 16))
        d[:] = data
    return data


def szip_params(dset):
    """SZCom from the dataset creation property list's szip filter."""
    dcpl = dset.id.get_create_plist()
    for i in range(dcpl.get_nfilters()):
        fid, _flags, cd, _name = dcpl.get_filter(i)
        if fid == H5Z_FILTER_SZIP:
            return SZCom(options_mask=cd[0], pixels_per_block=cd[1],
                         bits_per_pixel=cd[2], pixels_per_scanline=cd[3])
    raise LookupError("dataset has no szip filter")


def read_raw_chunks(dset):
    """[(chunk_offset, out_size, sz_stream), ...] for every stored chunk."""
    out = []
    for i in range(dset.id.get_num_chunks()):
        info = dset.id.get_chunk_info(i)
        _mask, raw = dset.id.read_direct_chunk(info.chunk_offset)
        (out_size,) = struct.unpack("<I", raw[:4])
        out.append((info.chunk_offset, out_size, raw[4:]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the payload decode (default cuda)")
    args = ap.parse_args(argv)

    fd, path = tempfile.mkstemp(suffix=".h5")
    os.close(fd)
    try:
        data = write_szip_file(path)
        with h5py.File(path, "r") as h:
            d = h["temperature"]
            param = szip_params(d)
            chunks = read_raw_chunks(d)
            print(f"{len(chunks)} szip chunks, params {param}")

            decoded = sz_decompress_batch([c[2] for c in chunks], param,
                                          [c[1] for c in chunks],
                                          device=args.device)

            ch = d.chunks
            ok = 0
            for (off, _, _), buf in zip(chunks, decoded):
                want = data[off[0]:off[0] + ch[0], off[1]:off[1] + ch[1]]
                got = np.frombuffer(buf, "<u2").reshape(ch)
                if not np.array_equal(got, want):
                    raise AssertionError(f"chunk {off}: mismatch")
                ok += 1
            # and libhdf5's own filter agrees with the source data
            if not np.array_equal(d[:], data):
                raise AssertionError("libhdf5's decode differs from the data")
    finally:
        os.remove(path)
    print(f"all {ok} chunks bit-identical to libhdf5's szip decode "
          f"(device {args.device})")


if __name__ == "__main__":
    main()
