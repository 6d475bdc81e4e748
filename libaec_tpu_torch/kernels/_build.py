"""Build and load the CUDA kernels of libaec_tpu_torch/csrc.

On first use, every `csrc/*.cu` (they share `csrc/*.cuh`) is compiled by
its own `nvcc` for sm_90a (all started together), and the objects are
linked into one shared library with a plain C interface, bound with
ctypes.  The sources include no PyTorch header, so a build takes seconds.
The library lands in `build/libaec_tpu_torch/` at the repository root,
named by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one loads at once.

Every C entry point returns `cudaGetLastError()` after its launches;
`check()` raises if that is not 0.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "libaec_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c"]
LINK_FLAGS = [*ARCH, "-shared"]

P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint

# C signatures of the entry points in csrc/*.cu
SIGNATURES = {
    # raw, win, block_bits, maps, zflag, comp, tile_kin, k_init, k_final,
    # nb, rsi, bs, bps, bsz, msb, pp, signed, id_len, kmax, w0, xmax, xmin,
    # mask, stream
    "aec_encode_fields": [P, P, P, P, P, P, P, P, P, LL,
                          I, I, I, I, I, I, I, I, I, I, U, U, U, P],
    # win, block_bits, bit0, words, tail, tile sums, nb, w, nwords, stream
    "aec_merge_windows": [P, P, P, P, P, P, LL, I, LL, P],
    # win, fs_bit, lsb_rel, meta, ref_sample, out, nb, wf, bs, bps, stream
    "aec_decode_blocks": [P, P, P, P, P, P, LL, I, I, I, P],
    # deltas, out, n_rsi, S, bsz, msb, pp, signed_path, sign_ext, xmax,
    # med, sign_bit, stream
    "aec_unpredict_swizzle": [P, P, LL, I, I, I, I, I, I, U, U, U, P],
    # deltas, out, n_rsi, S, signed_path, sign_ext, xmax, med, sign_bit,
    # stream
    "aec_unpredict_rsis": [P, P, LL, I, I, I, U, U, U, P],
    # win, fs_bit, lsb_rel, meta, ref_sample, out, n_rsi, rsi, wf, bs, bps,
    # bsz, msb, pp, signed_path, sign_ext, xmax, med, sign_bit, stream
    "aec_decode_fused": [P, P, P, P, P, P, LL, I, I, I, I, I, I, I, I, I,
                         U, U, U, P],
}

_lock = threading.Lock()
_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    # the headers too: an edited .cuh must not load a stale library
    for src in sorted((*_sources(), *CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaec_tpu_torch_{h.hexdigest()[:16]}.so"


def _build(so):
    tmp = BUILD_DIR / f"tmp.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        jobs = []
        for src in _sources():
            obj = tmp / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        out = tmp / so.name
        res = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(out), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(out, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(status, name):
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def stream_handle(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
