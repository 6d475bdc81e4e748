"""Encoder orchestration on torch: byte buffer in -> CCSDS 121.0-B-2 stream.

Twin of libaec_tpu/encode.py's device route.  Whole-RSI chunks of raw
stream bytes go through two kernels (kernels/encode_cuda.py,
kernels/merge_cuda.py); the warm-start k and the bit cursor modulo 8 stay
in device tensors between chunks, so the host never waits between
chunks.  The stream's short last RSI (`encode_tail`) goes through the
same two kernels as a chunk of one RSI of fewer blocks, the last item of
the pipeline.  Small buffers go to the port's native encoder (native/).
The kernels' plain versions run only for device="cpu".  Nothing here
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
from .hostbytes import HostBytes
from .kernels.encode_cuda import worst_case_bits_per_block
from .ops.u32 import words_to_u8

MAX_INFLIGHT = 4  # chunks queued on the device before the oldest is fetched
# Buffers at least this large take the device route by default
# (libaec_tpu/encode.py:310).
AUTO_JAX_MIN_BYTES = 4 << 20


class _OutputAssembler:
    """Places chunk outputs straight into the bytes object encode_buffer
    returns, OR-merging the shared boundary byte (libaec_tpu/encode.py:352).
    The stream's length is known only after its last chunk and its tail,
    so the object is allocated at `capacity`, an upper bound
    (stream_capacity), and finish cuts it to the stream in place."""

    def __init__(self, capacity):
        self.out = HostBytes(capacity) if capacity else None
        self.bits = 0

    def append(self, chunk_bytes, total_bits):
        chunk = torch.from_numpy(np.asarray(chunk_bytes))
        start, bit0 = divmod(self.bits, 8)
        view = self.out.view
        if bit0:
            view[start] |= chunk[0]
            start, chunk = start + 1, chunk[1:]
        # out of range raises (a size mismatch), never writes past the end
        view[start:start + chunk.numel()].copy_(chunk)
        self.bits += total_bits - bit0

    def finish(self):
        if self.bits == 0:
            # empty input: the reference still flushes one zero byte
            # (encode.c:686-695, observed behaviour)
            return b"\x00"
        return self.out.take((self.bits + 7) // 8)


def stream_capacity(cfg, n_samples):
    """Bytes that bound the stream of n_samples samples: every block at
    its worst case and, under AEC_PAD_RSI, every RSI padded by 7 bits,
    and a byte to spare (0 for no samples)."""
    nb = -(-n_samples // cfg.block_size)
    bits = nb * worst_case_bits_per_block(cfg)
    if cfg.pad_rsi:
        bits += 7 * -(-nb // cfg.rsi)
    return -(-bits // 8) + 1 if nb else 0


def encode_chunk(cfg, raw_u8, k_dev, bit0_dev, nb=None):
    """One chunk, twin of _jax_chunk_fn_bytes (libaec_tpu/encode.py:222).

    raw_u8: uint8 whole RSIs of nb blocks (None: cfg.rsi); k_dev: int32
    [1] incoming k; bit0_dev: int64 [1] incoming bit cursor modulo 8, all
    on one device.  Returns (words int32 [nwords] in stream byte order
    with the front pad word, total_bits int64 [1] incl. bit0, k_final
    int32 [1], bit0_next int64 [1])."""
    win, block_bits, k_final = encode_cuda.encode_fields(cfg, raw_u8, k_dev,
                                                         nb)
    nwords = merge_cuda.word_count(cfg, win.shape[0],
                                   encode_cuda.window_words(cfg) - 1)
    words, tail = merge_cuda.merge_windows(win, block_bits, bit0_dev, nwords)
    return words, tail[0:1], k_final, tail[1:2]


def words_to_stream_bytes(words, total_bits):
    """The compressed bytes of a chunk: bytes [4, 4 + ceil(total_bits/8))
    of the word buffer (twin of encode.py:248-260); only that slice is
    copied to the host.  From the card it goes, on the current stream,
    into pinned memory from torch's caching host allocator (reused across
    calls: a copy to pageable memory runs at a fraction of the bus's
    rate); the result is a view of it, valid while it is referenced."""
    nbytes = (total_bits + 7) // 8
    nwords = (4 + nbytes + 3) // 4
    src = words[:nwords]
    if src.is_cuda:
        host = torch.empty(nwords, dtype=src.dtype, pin_memory=True)
        host.copy_(src, non_blocking=True)
        torch.cuda.current_stream(src.device).synchronize()
        src = host
    return words_to_u8(src)[4:4 + nbytes]


def pad_tail(cfg, raw_tail):
    """A stream's short last RSI as the kernels take it: (uint8 bytes of
    nb whole blocks, nb).  raw_tail: numpy uint8 bytes of the rem <
    samples_per_rsi samples after the last whole RSI; the last block is
    filled with repeats of the last sample (encode.c:676-685)."""
    bs, bsz = cfg.block_size, cfg.bytes_per_sample
    rem = len(raw_tail) // bsz
    nb = -(-rem // bs)
    raw = np.empty(nb * bs * bsz, dtype=np.uint8)
    raw[:rem * bsz] = raw_tail[:rem * bsz]
    raw.reshape(-1, bsz)[rem:] = raw_tail[(rem - 1) * bsz:rem * bsz]
    return raw, nb


def encode_tail(cfg, raw_tail, k_dev, bit0_dev, stager=None):
    """The stream's short last RSI, coded as a chunk of one RSI of nb
    blocks (nb <= cfg.rsi, fewer samples than an RSI): encode_chunk's
    outputs, on k_dev's device.

    raw_tail: numpy uint8 bytes of the samples after the last whole RSI;
    k_dev, bit0_dev: the k and the bit cursor modulo 8 the chunks before
    it left, device tensors as encode_chunk takes them.  The host only
    pads the last block (pad_tail); the bytes go to the device through
    `stager` (the pipeline's pinned ring) where one is given, and kernels
    1 and 2 code them on the card, their plain versions on the CPU, as
    the JAX package's stream codes its final piece on the device
    (libaec_tpu/stream.py:90-94)."""
    raw, nb = pad_tail(cfg, raw_tail)
    if stager is not None:
        x = stager.stage(raw)
    else:
        x = torch.from_numpy(raw).to(k_dev.device)
    return encode_chunk(cfg, x, k_dev, bit0_dev, nb)


def encode_blocks(cfg, raw_u8, nb, k, bit0, device):
    """One chunk with its carries held on the host, for callers that code
    a stream piece by piece (stream.AecStream): (stream bytes as a numpy
    uint8 array, total_bits incl. bit0, k_final); twin of
    encode_blocks_jax (libaec_tpu/encode.py:263).

    raw_u8: numpy uint8 stream bytes: with nb == cfg.rsi whole RSIs, any
    number of them in one launch of each kernel; otherwise the stream's
    last, short RSI (fewer samples than an RSI, nb = their blocks), coded
    by encode_tail.  Either runs on the kernels on `device`, their plain
    versions for "cpu"; k and bit0 go in as one-element tensors and k
    comes back with one `.item()`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    k_dev = torch.tensor([k], dtype=torch.int32, device=device)
    b0_dev = torch.tensor([bit0], dtype=torch.int64, device=device)
    if nb < cfg.rsi or len(raw_u8) % cfg.rsi_len_bytes:
        words, total_bits, k_final, _ = encode_tail(cfg, raw_u8, k_dev,
                                                    b0_dev)
    else:
        raw = torch.from_numpy(np.array(raw_u8, dtype=np.uint8)).to(device)
        words, total_bits, k_final, _ = encode_chunk(cfg, raw, k_dev, b0_dev)
    total_bits = int(total_bits)
    return (words_to_stream_bytes(words, total_bits), total_bits,
            int(k_final))


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


def encode_chunks_pipelined(cfg, chunks, on_chunk, device, tail=None):
    """Dispatch whole-RSI chunks back to back, then the stream's short
    last RSI (twin of encode_chunks_jax_pipelined,
    libaec_tpu/encode.py:271, with the tail as its last item).

    chunks: iterable of numpy uint8 arrays of whole RSIs; tail: numpy
    uint8 bytes of the samples after them (encode_tail), or None.  Each
    result is handed to on_chunk(words, total_bits_host, done_event) once
    MAX_INFLIGHT newer chunks are queued (or at the end);
    total_bits_host is a host tensor that is valid after done_event
    (None on the CPU).  Returns the final k (int32 [1]) and bit cursor
    modulo 8 (int64 [1]) as device tensors: the host never waits on
    them."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    k = torch.zeros(1, dtype=torch.int32, device=device)
    b0 = torch.zeros(1, dtype=torch.int64, device=device)
    stager = _Stager(device, MAX_INFLIGHT + 1) if cuda else None

    pending = []

    def queue(words, total_bits):
        if cuda:
            tb_host = total_bits.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            tb_host, done = total_bits, None
        pending.append((words, tb_host, done))
        if len(pending) >= MAX_INFLIGHT:
            on_chunk(*pending.pop(0))

    for chunk in chunks:
        raw = stager.stage(chunk) if cuda else torch.from_numpy(
            np.array(chunk))
        words, total_bits, k, b0 = encode_chunk(cfg, raw, k, b0)
        queue(words, total_bits)
    if tail is not None:
        words, total_bits, k, b0 = encode_tail(cfg, tail, k, b0, stager)
        queue(words, total_bits)
    for item in pending:
        on_chunk(*item)
    return k, b0


def default_rsis_per_chunk(cfg):
    """RSIs per device chunk when the caller names none: 64 MiB of u32
    samples, as libaec_tpu.encode_buffer's device route (encode.py:427)."""
    return max(1, (64 << 20) // (cfg.samples_per_rsi * 4))


def _use_device(n_bytes, force_device):
    return force_device or n_bytes >= AUTO_JAX_MIN_BYTES


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

    Buffers of at least 4 MiB run on `device`, whatever the config
    (every block size, every id_len, AEC_PAD_RSI or not);
    `force_device=True` drops the size threshold (the tests use it to
    reach the device path at small sizes, like the JAX package's
    backend=).  Smaller buffers go to the native encoder (a native
    library that cannot be built raises).  A device that is missing raises;
    nothing falls back from the device path.

    Trailing bytes short of a sample are ignored; a trailing partial RSI
    repeats its last sample (encode.c:676-685).  out_size, if given, is
    the caller's capacity: a longer stream raises AecStreamError."""
    if not _use_device(len(data), force_device):
        status, comp = _native.encode(bytes(data), cfg)
        if status != 0:
            raise RuntimeError(f"native encoder failed with status {status}")
        return _check_capacity(comp, out_size)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    bsz = cfg.bytes_per_sample
    n_samples = len(data) // bsz
    out = _OutputAssembler(stream_capacity(cfg, n_samples))
    if n_samples == 0:
        return out.finish()
    # a view, not a copy: copying 256 MiB cost ~0.1 s on the H100 host
    raw = np.frombuffer(data, dtype=np.uint8, count=n_samples * bsz)
    S = cfg.samples_per_rsi
    n_full = n_samples // S
    rem = n_samples - n_full * S
    if rsis_per_chunk is None:
        rsis_per_chunk = default_rsis_per_chunk(cfg)

    full = n_full * S * bsz
    chunk_bytes = rsis_per_chunk * S * bsz

    def gen_chunks():
        for s in range(0, full, chunk_bytes):
            yield raw[s:min(s + chunk_bytes, full)]

    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def materialise(words, tb_host, done):
        if done is not None:
            done.synchronize()
        with (torch.cuda.stream(side) if side is not None
              else nullcontext()):
            tb = int(tb_host)
            out.append(words_to_stream_bytes(words, tb), tb)

    # one FIFO worker fetches the compressed slices (encode.py:444-466),
    # the short last RSI's after the chunks'
    with ThreadPoolExecutor(1) as ex:
        futs = []

        def on_chunk(words, tb_host, done):
            futs.append(ex.submit(materialise, words, tb_host, done))
            if len(futs) >= 5:  # bound device-buffer residency
                futs[-5].result()

        encode_chunks_pipelined(cfg, gen_chunks(), on_chunk, device,
                                tail=raw[full:] if rem else None)
        for f in futs:
            f.result()
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
