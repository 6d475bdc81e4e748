"""Native host runtime of the port: builds and loads the C++ codec.

The port's own copy of the host runtime (aectpu_native.cpp, encoder.cpp,
libaec_abi.cpp, libaec_compat.h are the sources of libaec_tpu/native):
the structural scan and window fill of the device decode, the scalar and
parallel encoders, the serial and parallel decoders.  The names are those
of libaec_tpu/native/__init__.py.

The shared library is compiled with g++ on first use into
`build/libaec_tpu_torch/` at the repository root, named by a hash of the
sources and flags, through a temporary file and `os.replace`: any number
of processes may build at once and none loads a half-written file.  A
build that fails raises with the compiler's stderr, the first time and
every time; no entry point returns None for a missing library.
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / "aectpu_native.cpp", _HERE / "encoder.cpp",
         _HERE / "libaec_abi.cpp"]
_HDRS = [_HERE / "libaec_compat.h"]
BUILD_DIR = _HERE.parent.parent / "build" / "libaec_tpu_torch"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None

_P, _Z, _I, _U = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                  ctypes.c_uint)
_U64 = ctypes.c_uint64
_PZ, _PU64 = ctypes.POINTER(_Z), ctypes.POINTER(_U64)
_CFG = [_U, _U, _U, _U]  # bits_per_sample, block_size, rsi, flags
_ONE_SHOT = [_P, _Z, _P, _Z, _PZ, *_CFG]  # in, n, out, cap, written, cfg

# C signatures of the entry points in aectpu_native.cpp and encoder.cpp
SIGNATURES = {
    "aectpu_encode": _ONE_SHOT,
    "aectpu_encode_parallel": [*_ONE_SHOT, _I],  # + threads
    "aectpu_decode": _ONE_SHOT,
    "aectpu_decode_deltas": _ONE_SHOT,
    # in, n, start_bit, out, cap, written, cfg (+ threads)
    "aectpu_decode_tail": [_P, _Z, _U64, _P, _Z, _PZ, *_CFG],
    "aectpu_decode_parallel": [_P, _Z, _U64, _P, _Z, _PZ, *_CFG, _I],
    # in, n, start_bit, max_rsis, n_rsis_out, end_bit_out, cfg
    "aectpu_scan_rsis": [_P, _Z, _U64, _Z, _PZ, _PU64, *_CFG],
    # in, n, fs_off, meta, win, wf, n_records, threads
    "aectpu_fill_windows": [_P, _Z, _P, _P, _P, _I, _Z, _I],
    # in, n, start_bit, max_rsis, max_fs_bits, fs_off, lsb_off, meta,
    # ref_sample, win, wf, n_rsis_out, tail_bit_out, cfg, threads
    "aectpu_scan_blocks": [_P, _Z, _U64, _Z, _I, _P, _P, _P, _P, _P, _I,
                           _PZ, _PU64, *_CFG, _I],
    # the streaming encode session (encoder.cpp): new(cfg) -> handle;
    # feed(handle, in, n_rsis); finish(handle, tail, tail_samples);
    # pending(handle); read(handle, out, cap); free(handle)
    "aectpu_enc_new": _CFG,
    "aectpu_enc_feed": [_P, _P, _Z],
    "aectpu_enc_finish": [_P, _P, _Z],
    "aectpu_enc_pending": [_P],
    "aectpu_enc_read": [_P, _P, _Z],
    "aectpu_enc_free": [_P],
}
# return types other than int
RESTYPES = {"aectpu_enc_new": _P, "aectpu_enc_pending": _Z,
            "aectpu_enc_read": _Z, "aectpu_enc_free": None}


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in (*_SRCS, *_HDRS):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaectpu_{h.hexdigest()[:16]}.so"


def _build(so):
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="tmp.", suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        res = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, *map(str, _SRCS)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) building the "
                               f"native library:\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded ctypes library, built first if needed; raises when it
    cannot be built."""
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
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
    return _lib


def _in(data):
    """Zero-copy view of the input (bytes/bytearray/memoryview/ndarray)
    as the (pointer, length) pair of the C calls."""
    view = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(1, np.uint8)
    return view, view.ctypes.data_as(_P), len(data)


def _ptr(a):
    return a.ctypes.data_as(_P)


def _cfg(cfg):
    return cfg.bits_per_sample, cfg.block_size, cfg.rsi, cfg.flags


def encode(data, cfg, out_cap=None, threads=None):
    """Native one-shot encode: (status, bytes).  With out_cap given,
    status is AEC_STREAM_ERROR when the stream exceeds it and the bytes
    are the first out_cap (aec_buffer_encode capacity semantics).

    threads > 1 routes to aectpu_encode_parallel (serial decision pass +
    worker emit + parallel stitch, bit-identical by construction);
    threads=None picks it automatically for multi-MiB buffers."""
    lib = get_lib()
    if threads is None:
        threads = min(os.cpu_count() or 1, 8) \
            if len(data) >= (4 << 20) else 1

    # worst case mirrors encode.worst_case_bits_per_block: id + reference
    # sample + max(uncompressed payload, one 64-bit zero-run FS) per block,
    # plus per-RSI byte pads and the final flush
    n_samples = len(data) // cfg.bytes_per_sample
    nb = -(-max(n_samples, 1) // cfg.block_size)
    per_block = cfg.id_len + 1 + cfg.bits_per_sample + max(
        cfg.block_size * cfg.bits_per_sample, 64)
    worst = (nb * per_block) // 8 + nb // max(cfg.rsi, 1) + 16
    cap = worst if out_cap is None else out_cap
    out = np.empty(max(cap, 1), np.uint8)
    written = ctypes.c_size_t(0)
    _keep, in_ptr, n = _in(data)
    args = (in_ptr, n, _ptr(out), cap, ctypes.byref(written), *_cfg(cfg))
    if threads > 1:
        status = lib.aectpu_encode_parallel(*args, threads)
    else:
        status = lib.aectpu_encode(*args)
    return status, out[:min(written.value, cap)].tobytes()


def decode(data, out_cap, cfg, threads=None, start_bit=0):
    """Native decode from an RSI-start bit offset: (status, bytes).

    Large buffers use the two-phase parallel path (structural scan +
    per-RSI worker threads, bit-identical to the scalar core by
    construction)."""
    lib = get_lib()
    out = np.empty(max(out_cap, 1), np.uint8)
    written = ctypes.c_size_t(0)
    _keep, in_ptr, n = _in(data)
    if threads is None:
        # 2x oversubscription overlaps the sequential structural scan with
        # payload workers (the scan thread spends its tail joining the
        # pool); never spawn more workers than there are RSIs to decode
        n_rsis = max(1, out_cap // cfg.rsi_len_bytes)
        threads = min(2 * (os.cpu_count() or 1), n_rsis) \
            if len(data) >= (1 << 20) else 1
    tail = (_ptr(out), out_cap, ctypes.byref(written), *_cfg(cfg))
    if threads > 1:
        status = lib.aectpu_decode_parallel(in_ptr, n, start_bit, *tail,
                                            threads)
    elif start_bit:
        status = lib.aectpu_decode_tail(in_ptr, n, start_bit, *tail)
    else:
        status = lib.aectpu_decode(in_ptr, n, *tail)
    return status, out[: written.value].tobytes()


def scan_rsis(data, start_bit, max_rsis, cfg):
    """Offsets-only scan: (n complete RSIs from start_bit, end_bit), or
    None when the scan refuses the config."""
    n_rsis = ctypes.c_size_t(0)
    end_bit = ctypes.c_uint64(0)
    _keep, in_ptr, n = _in(data)
    status = get_lib().aectpu_scan_rsis(
        in_ptr, n, start_bit, max_rsis, ctypes.byref(n_rsis),
        ctypes.byref(end_bit), *_cfg(cfg))
    if status != 0:
        return None
    return n_rsis.value, end_bit.value


class ScanArena:
    """Reusable record buffers for scan_blocks: fresh arrays per scan
    chunk cost page faults comparable to the structural walk itself.
    Callers that scan in a loop recycle an arena once the device has
    consumed the chunk built in it."""

    def __init__(self, nrec, wf):
        self.nrec = nrec
        self.wf = wf
        self.fs_off = np.empty(nrec, np.uint64)
        self.lsb_off = np.empty(nrec, np.uint64)
        self.meta = np.empty(nrec, np.uint32)
        self.ref_sample = np.empty(nrec, np.uint32)
        self.win = np.empty((nrec, wf), np.uint32) if wf else None

    def fits(self, nrec, wf):
        return nrec <= self.nrec and wf == self.wf


def fill_windows(data, fs_off, meta, wf, threads=None, win=None):
    """Materialise [n, wf] payload windows for records from a wf=0 scan.

    Decouples the window width from the walk: the decode path runs the
    scan records-only, buckets wf from the chunk's actual largest payload
    span, then fills here.  Returns the win array (the first n rows of
    the passed-in `win` buffer when given)."""
    n = len(fs_off)
    if win is None:
        win = np.empty((max(n, 1), wf), np.uint32)
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    _keep, in_ptr, nbytes = _in(data)
    get_lib().aectpu_fill_windows(in_ptr, nbytes, _ptr(fs_off), _ptr(meta),
                                  _ptr(win), wf, n, threads)
    return win[:n]


def scan_blocks(data, max_rsis, max_fs_bits, cfg, wf=0, threads=None,
                start_bit=0, arena=None):
    """Phase-1 structural scan for the device decoder.

    Walks the stream from start_bit (an RSI boundary; 0 for the head) and
    emits one payload record per output block for every complete RSI whose
    FS regions fit the device kernel's window -- once (popcount-bulk FS
    skipping, no sample reconstruction).  With wf > 0 it also
    materialises each block's wf-word payload window ("win", u32 [n, wf]);
    the window memcpys run on `threads-1` worker threads chasing the scan
    (the walk itself is serial).  The scan resumes from the previous
    call's tail_bit, so a caller can overlap scan chunks with device
    decodes in flight.

    Returns (records dict of numpy arrays sized n_rsis*rsi, n_rsis,
    tail_bit), or None when the scan refuses the config.  The serial tail
    (truncated / malformed / oversized-FS input) resumes at tail_bit."""
    if threads is None:
        threads = min(os.cpu_count() or 1, 8) \
            if wf and len(data) >= (1 << 20) else 1
    nrec = max(max_rsis * cfg.rsi, 1)
    if arena is None or not arena.fits(nrec, wf):
        arena = ScanArena(nrec, wf)
    n_rsis = ctypes.c_size_t(0)
    tail_bit = ctypes.c_uint64(0)
    _keep, in_ptr, nbytes = _in(data)
    status = get_lib().aectpu_scan_blocks(
        in_ptr, nbytes, start_bit, max_rsis, max_fs_bits,
        _ptr(arena.fs_off), _ptr(arena.lsb_off), _ptr(arena.meta),
        _ptr(arena.ref_sample), _ptr(arena.win) if wf else None, wf,
        ctypes.byref(n_rsis), ctypes.byref(tail_bit), *_cfg(cfg), threads)
    if status != 0:
        return None
    n = n_rsis.value * cfg.rsi
    recs = {"fs_off": arena.fs_off[:n], "lsb_off": arena.lsb_off[:n],
            "meta": arena.meta[:n], "ref_sample": arena.ref_sample[:n]}
    if wf:
        recs["win"] = arena.win[:n]
    return recs, n_rsis.value, tail_bit.value


def decode_tail(data, start_bit, out_cap, cfg):
    """Serial decode resuming at an RSI-start bit offset (status, bytes)."""
    out = np.empty(max(out_cap, 1), np.uint8)
    written = ctypes.c_size_t(0)
    _keep, in_ptr, n = _in(data)
    status = get_lib().aectpu_decode_tail(
        in_ptr, n, start_bit, _ptr(out), out_cap, ctypes.byref(written),
        *_cfg(cfg))
    return status, out[: written.value].tobytes()


def decode_deltas(data, max_samples, cfg):
    """Phase-1 decode: bitstream -> raw mapped deltas (u32 [n]), inverse
    predictor not applied.  Returns (status, np.uint32 array)."""
    out = np.empty(max(max_samples, 1), np.uint32)
    written = ctypes.c_size_t(0)
    _keep, in_ptr, n = _in(data)
    status = get_lib().aectpu_decode_deltas(
        in_ptr, n, _ptr(out), 4 * max_samples, ctypes.byref(written),
        *_cfg(cfg))
    return status, out[: written.value // 4]


class EncSession:
    """The native streaming encode session (aectpu_enc_*, encoder.cpp):
    whole RSIs in, then the short last RSI and the final flush; the coded
    bytes are read out as they are produced.  It holds back the bits of
    the last unfinished 32-bit word until finish(), so read() may lag the
    stream by up to four bytes before then.  Freed when the object is
    collected."""

    def __init__(self, cfg):
        self.cfg = cfg
        lib = get_lib()
        handle = lib.aectpu_enc_new(*_cfg(cfg))
        if not handle:
            raise ValueError(f"the native encoder refuses the config: {cfg}")
        self._handle = handle
        weakref.finalize(self, lib.aectpu_enc_free, handle)

    def feed(self, data):
        """Code the whole RSIs of stream bytes `data`."""
        n_rsis = len(data) // self.cfg.rsi_len_bytes
        if n_rsis:
            _keep, in_ptr, _ = _in(data)
            get_lib().aectpu_enc_feed(self._handle, in_ptr, n_rsis)

    def finish(self, tail):
        """Code the stream's last, short RSI (the whole samples of `tail`;
        may be empty) and flush to a byte boundary; an empty stream gives
        one zero byte."""
        n = len(tail) // self.cfg.bytes_per_sample
        _keep, in_ptr, _ = _in(tail)
        get_lib().aectpu_enc_finish(self._handle, in_ptr, n)

    def pending(self):
        """Coded bytes not yet read."""
        return get_lib().aectpu_enc_pending(self._handle)

    def read(self, cap):
        """Up to cap coded bytes, removed from the session."""
        n = min(cap, self.pending())
        if n <= 0:
            return b""
        out = np.empty(n, np.uint8)
        n = get_lib().aectpu_enc_read(self._handle, _ptr(out), n)
        return out[:n].tobytes()
