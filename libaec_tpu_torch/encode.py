"""Encoder orchestration on torch: byte buffer in -> CCSDS 121.0-B-2 stream.

Twin of libaec_tpu/encode.py's device route.  Whole-RSI chunks of raw
stream bytes go through two kernels (kernels/encode_cuda.py,
kernels/merge_cuda.py); the warm-start k and the bit cursor modulo 8 stay
in device tensors between chunks, so the host never waits between
chunks.  Small buffers and configs outside the kernel gate go to the
port's native encoder (native/); the stream's short last RSI goes through
the kernels' plain versions on the host (`encode_tail`).  Nothing here
imports the JAX package.
"""
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from . import native as _native
from .config import Config
from .constants import AEC_OK, AEC_STREAM_ERROR, AecStreamError
from .kernels import encode_cuda, merge_cuda
from .kernels.encode_cuda import worst_case_bits_per_block  # noqa: F401
from .ops import bitpack
from .ops.u32 import words_to_u8

MAX_INFLIGHT = 4  # chunks queued on the device before the oldest is fetched
# Buffers at least this large take the device route by default
# (libaec_tpu/encode.py:310).
AUTO_JAX_MIN_BYTES = 4 << 20


class _OutputAssembler:
    """Accumulates chunk outputs, OR-merging the shared boundary byte
    (libaec_tpu/encode.py:352)."""

    def __init__(self):
        self.buf = bytearray()
        self.bits = 0

    def append(self, chunk_bytes, total_bits):
        chunk = np.asarray(chunk_bytes)
        bit0 = self.bits % 8
        if bit0 and len(self.buf):
            self.buf[-1] |= int(chunk[0])
            self.buf += chunk[1:].tobytes()
        else:
            self.buf += chunk.tobytes()
        self.bits += total_bits - bit0

    def finish(self):
        if self.bits == 0:
            # empty input: the reference still flushes one zero byte
            # (encode.c:686-695, observed behaviour)
            return b"\x00"
        return bytes(self.buf)


def encode_chunk(cfg, raw_u8, k_dev, bit0_dev):
    """One chunk, twin of _jax_chunk_fn_bytes (libaec_tpu/encode.py:222).

    raw_u8: uint8 [n_rsi * rsi_len_bytes]; k_dev: int32 [1] incoming k;
    bit0_dev: int64 [1] incoming bit cursor modulo 8, all on one device.
    Returns (words int32 [nwords] in stream byte order with the front pad
    word, total_bits int64 [1] incl. bit0, k_final int32 [1],
    bit0_next int64 [1])."""
    win, block_bits, k_final = encode_cuda.encode_fields(cfg, raw_u8, k_dev)
    nwords = merge_cuda.word_count(cfg, win.shape[0],
                                   encode_cuda.window_words(cfg) - 1)
    words, tail = merge_cuda.merge_windows(win, block_bits, bit0_dev, nwords)
    return words, tail[0:1], k_final, tail[1:2]


def words_to_stream_bytes(words, total_bits):
    """The compressed bytes of a chunk: bytes [4, 4 + ceil(total_bits/8))
    of the word buffer (twin of encode.py:248-260); only that slice is
    copied to the host."""
    nbytes = (total_bits + 7) // 8
    nwords = (4 + nbytes + 3) // 4
    return words_to_u8(words[:nwords])[4:4 + nbytes]


def encode_tail(cfg, raw_tail, k_init, bit0):
    """The stream's short last RSI, on the host: (stream bytes as a numpy
    uint8 array, total_bits incl. bit0).

    raw_tail: numpy uint8 bytes of the rem < samples_per_rsi samples after
    the last whole RSI; the last block is filled with repeats of the last
    sample (encode.c:676-685).  k_init is the incoming warm-start k, bit0
    the stream's bit cursor modulo 8.  This runs the kernels' plain
    versions on CPU tensors (the field pipeline of
    encode_cuda.encode_fields_plain with nb < rsi blocks, then
    ops/bitpack.merge_windows): at most one RSI per stream, which the JAX
    package also encodes off the device (libaec_tpu/encode.py:476-488)."""
    bs, bsz = cfg.block_size, cfg.bytes_per_sample
    rem = len(raw_tail) // bsz
    nb = -(-rem // bs)
    last = raw_tail[(rem - 1) * bsz:rem * bsz]
    raw = np.concatenate([raw_tail[:rem * bsz], np.tile(last, nb * bs - rem)])
    win, block_bits, _ = encode_cuda.encode_fields_plain(
        cfg, torch.from_numpy(raw), torch.tensor([k_init]), nb=nb)
    nwords = merge_cuda.word_count(cfg, nb, encode_cuda.window_words(cfg) - 1)
    words, tail = bitpack.merge_windows(
        win, block_bits, torch.tensor([bit0]), nwords)
    total_bits = int(tail[0])
    return words_to_stream_bytes(words, total_bits), total_bits


class _Stager:
    """Pinned host staging ring for H2D copies that do not block the host
    on earlier chunks' kernels (a copy from pageable memory would)."""

    def __init__(self, device, slots):
        self.device = device
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.i = 0

    def stage(self, chunk):
        i = self.i
        self.i = (i + 1) % len(self.bufs)
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.bufs[i]
        if buf is None or buf.numel() < chunk.nbytes:
            buf = torch.empty(chunk.nbytes, dtype=torch.uint8,
                              pin_memory=True)
            self.bufs[i] = buf
        buf[:chunk.nbytes].numpy()[:] = chunk
        dev = buf[:chunk.nbytes].to(self.device, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()
        return dev


def encode_chunks_pipelined(cfg, chunks, on_chunk, device):
    """Dispatch whole-RSI chunks back to back (twin of
    encode_chunks_jax_pipelined, libaec_tpu/encode.py:271).

    chunks: iterable of numpy uint8 arrays of whole RSIs.  Each result is
    handed to on_chunk(words, total_bits_host, done_event) once
    MAX_INFLIGHT newer chunks are queued (or at the end); total_bits_host
    is a host tensor that is valid after done_event (None on the CPU).
    Returns the final k as an int32 [1] device tensor."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    k = torch.zeros(1, dtype=torch.int32, device=device)
    b0 = torch.zeros(1, dtype=torch.int64, device=device)
    stager = _Stager(device, MAX_INFLIGHT + 1) if cuda else None
    pending = []
    for chunk in chunks:
        raw = stager.stage(chunk) if cuda else torch.from_numpy(
            np.array(chunk))
        words, total_bits, k, b0 = encode_chunk(cfg, raw, k, b0)
        if cuda:
            tb_host = total_bits.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            tb_host, done = total_bits, None
        pending.append((words, tb_host, done))
        if len(pending) >= MAX_INFLIGHT:
            on_chunk(*pending.pop(0))
    for item in pending:
        on_chunk(*item)
    return k


def default_rsis_per_chunk(cfg):
    """RSIs per device chunk when the caller names none: 64 MiB of u32
    samples, as libaec_tpu.encode_buffer's device route (encode.py:427)."""
    return max(1, (64 << 20) // (cfg.samples_per_rsi * 4))


def _use_device(cfg, n_bytes, force_device):
    return encode_cuda.kernel_supported(cfg) and (
        force_device or n_bytes >= AUTO_JAX_MIN_BYTES)


def _check_capacity(result, out_size):
    if out_size is not None and len(result) > out_size:
        raise AecStreamError(
            f"encoded stream ({len(result)} bytes) exceeds the output "
            f"capacity ({out_size} bytes)")
    return result


def encode_buffer(data, cfg: Config, device="cuda", force_device=False,
                  rsis_per_chunk=None, out_size=None):
    """One-shot encode of a byte buffer (aec_buffer_encode parity), twin
    of libaec_tpu.encode_buffer.

    Buffers of at least 4 MiB whose config passes the kernel gate run on
    `device`; `force_device=True` drops the size threshold (the tests use
    it to reach the device path at small sizes, like the JAX package's
    backend=).  Everything else goes to the native encoder (a native
    library that cannot be built raises).  A device that is missing raises;
    nothing falls back from the device path.

    Trailing bytes short of a sample are ignored; a trailing partial RSI
    repeats its last sample (encode.c:676-685).  out_size, if given, is
    the caller's capacity: a longer stream raises AecStreamError."""
    if not _use_device(cfg, len(data), force_device):
        status, comp = _native.encode(bytes(data), cfg)
        if status != 0:
            raise RuntimeError(f"native encoder failed with status {status}")
        return _check_capacity(comp, out_size)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    bsz = cfg.bytes_per_sample
    n_samples = len(data) // bsz
    out = _OutputAssembler()
    if n_samples == 0:
        return out.finish()
    # a view, not a copy: copying 256 MiB cost ~0.1 s on the H100 host
    raw = np.frombuffer(data, dtype=np.uint8, count=n_samples * bsz)
    S = cfg.samples_per_rsi
    n_full = n_samples // S
    rem = n_samples - n_full * S
    if rsis_per_chunk is None:
        rsis_per_chunk = default_rsis_per_chunk(cfg)

    k_final = 0
    if n_full:
        chunk_bytes = rsis_per_chunk * S * bsz

        def gen_chunks():
            for s in range(0, n_full * S * bsz, chunk_bytes):
                yield raw[s:min(s + chunk_bytes, n_full * S * bsz)]

        side = torch.cuda.Stream(device) if device.type == "cuda" else None

        def materialise(words, tb_host, done):
            if done is not None:
                done.synchronize()
            with (torch.cuda.stream(side) if side is not None
                  else nullcontext()):
                tb = int(tb_host)
                out.append(words_to_stream_bytes(words, tb), tb)

        # one FIFO worker fetches the compressed slices (encode.py:444-466)
        with ThreadPoolExecutor(1) as ex:
            futs = []

            def on_chunk(words, tb_host, done):
                futs.append(ex.submit(materialise, words, tb_host, done))
                if len(futs) >= 5:  # bound device-buffer residency
                    futs[-5].result()

            k_dev = encode_chunks_pipelined(cfg, gen_chunks(), on_chunk,
                                            device)
            for f in futs:
                f.result()
        k_final = int(k_dev)
    if rem:
        out.append(*encode_tail(cfg, raw[n_full * S * bsz:], k_final,
                                out.bits % 8))
    return _check_capacity(out.finish(), out_size)


def encode_buffer_status(data, cfg: Config, out_size, device="cuda",
                         force_device=False, rsis_per_chunk=None):
    """C-style one-shot encode: (status, bytes) with caller-owned output
    capacity (libaec.h:154-166); on overflow the first out_size bytes come
    back with AEC_STREAM_ERROR, as libaec_tpu.encode_buffer_status."""
    result = encode_buffer(data, cfg, device=device,
                           force_device=force_device,
                           rsis_per_chunk=rsis_per_chunk)
    if len(result) > out_size:
        return AEC_STREAM_ERROR, result[:out_size]
    return AEC_OK, result
