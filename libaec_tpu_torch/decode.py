"""Decoder orchestration on torch: CCSDS 121.0-B-2 stream -> bytes.

Twin of libaec_tpu/decode.py's device route (decode_buffer_tpu,
decode.py:232).  Phase 1 runs on the host in the JAX package's native
code, which imports no JAX: the records-only structural walk
(native.scan_blocks) on the calling thread, the window bucketing and fill
(native.fill_windows) on one worker, both writing straight into pinned
host buffers.  Phase 2 copies each chunk to the device and runs kernel 3
(kernels/decode_cuda.py) and kernel 4, or for 3-byte samples kernel 5 and
kernel 4's byte layout (kernels/unpredict_cuda.py), at most 4 chunks in
flight; one FIFO fetch thread copies the output back.  The serial native tail
(native.decode_tail) finishes what the scan could not validate, which
gives the reference's status and truncation semantics.

Unlike the JAX route, chunks are not padded to power-of-two shapes: that
bounded XLA recompiles, and the kernels take their sizes at run time.
"""
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from libaec_tpu import native as _native
from libaec_tpu.config import Config
from libaec_tpu.constants import (
    AEC_MEM_ERROR,
    AEC_OK,
    AecDataError,
    AecMemError,
)
from libaec_tpu.decode import DEVICE_DECODE_MIN_BYTES, _decode_cpu_status

from .kernels import decode_cuda, unpredict_cuda
from .ops import bitunpack

MAX_INFLIGHT = 4  # chunks queued on the device before the oldest is fetched


class _Slot:
    """Host buffers of one chunk, reused across chunks.

    Serves native.scan_blocks as its arena (`fits()` and the four record
    arrays).  fs_off and lsb_off stay on the host; the four int32 records
    the kernels read (fs_bit, lsb_rel, meta, ref_sample) are the rows of
    one pinned tensor, and the windows are a pinned tensor with room for
    nrec worst-case windows, viewed at the chunk's bucket width.  The scan
    and the fill write into numpy views of them, so nothing is staged
    twice.  `copied` is an event recorded after the chunk's H2D copies:
    the slot is rewritten only once it has completed."""

    wf = 0      # the scan runs records-only
    win = None

    def __init__(self, cfg, nrec, pin):
        self.nrec = nrec
        self.fs_off = np.empty(nrec, np.uint64)
        self.lsb_off = np.empty(nrec, np.uint64)
        self.rec = torch.empty(4, nrec, dtype=torch.int32, pin_memory=pin)
        (self.fs_bit, self.lsb_rel, self.meta,
         self.ref_sample) = self.rec.numpy().view(np.uint32)
        self.windows = torch.empty(nrec * bitunpack.window_words(cfg),
                                   dtype=torch.int32, pin_memory=pin)
        self.copied = None

    def fits(self, nrec, wf):
        return nrec <= self.nrec and wf == 0

    def window_view(self, wf):
        return self.windows.numpy().view(np.uint32)[: self.nrec * wf] \
            .reshape(self.nrec, wf)


def scan_chunk(data, ask, cfg, start_bit, slot):
    """Records of up to `ask` whole RSIs from start_bit, into the slot:
    (recs, n_rsis, tail_bit), as native.scan_blocks."""
    res = _native.scan_blocks(data, ask, bitunpack.max_fs_bits(cfg), cfg,
                              wf=0, start_bit=start_bit, arena=slot)
    if res is None:
        raise RuntimeError(f"native scan refused the config: {cfg}")
    return res


def fill_chunk(data, cfg, slot, recs, tail_bit):
    """Bucket width, windows and the two derived records (fs_bit, lsb_rel,
    as libaec_tpu.decode.scan_record_arrays) of one scanned chunk, into
    the slot (the fill worker's job).  Returns the width."""
    n = len(recs["fs_off"])
    wf = bitunpack.bucket_wf(cfg, recs, tail_bit)
    _native.fill_windows(data, recs["fs_off"], recs["meta"], wf, 1,
                         slot.window_view(wf))
    np.bitwise_and(recs["fs_off"], np.uint64(31), out=slot.fs_bit[:n],
                   casting="unsafe")
    np.subtract(recs["lsb_off"], recs["fs_off"], out=slot.lsb_rel[:n],
                casting="unsafe")
    return wf


def stage_chunk(slot, n, wf, device):
    """The slot's windows int32 [n, wf] and records int32 [4, nrec] on the
    device.  On the card the copies are asynchronous (pinned memory) on
    the current stream, ahead of the chunk's kernels; the slot's `copied`
    event marks their end."""
    win = slot.windows[: n * wf].view(n, wf)
    if device.type != "cuda":  # CPU tensors: the kernels' plain versions
        return win, slot.rec
    win_d = win.to(device, non_blocking=True)
    rec_d = slot.rec.to(device, non_blocking=True)
    slot.copied = torch.cuda.Event()
    slot.copied.record()
    return win_d, rec_d


def decode_chunk(cfg, win, rec, n_rsi):
    """The kernels on one chunk of n_rsi whole RSIs: its output bytes,
    uint8 [n_rsi, S * bytes_per_sample].  Kernel 3, then kernel 4; for
    3-byte samples, as the JAX route (decode.py:147-149), kernel 5 (with
    preprocessing) and kernel 4 as the byte layout alone."""
    n = n_rsi * cfg.rsi
    deltas = decode_cuda.decode_blocks(cfg, win, rec[0, :n], rec[1, :n],
                                       rec[2, :n], rec[3, :n])
    deltas = deltas.view(n_rsi, cfg.samples_per_rsi)
    if cfg.bytes_per_sample == 3:
        return unpredict_cuda.samples_to_bytes(
            cfg, unpredict_cuda.unpredict_rsis(cfg, deltas))
    return unpredict_cuda.unpredict_swizzle(cfg, deltas)


def fetch_chunk(chunk_out, dst, staging):
    """A chunk's output bytes to the host: copied into the host tensor
    dst, or returned as bytes when dst is None.  On the card they go
    through `staging`, a pinned buffer (a copy to pageable memory runs at
    a fraction of the bus's rate), on the current stream."""
    flat = chunk_out.view(-1)
    if staging is not None:
        host = staging[:flat.numel()]
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        flat = host
    if dst is None:
        return flat.numpy().tobytes()
    dst.copy_(flat)
    return None


def finish(data, cfg, tail_bit, done_bytes, out_size, out):
    """The serial native tail from tail_bit, and the whole output:
    (status, tail bytes, output bytes or None when out is None)."""
    status, tail = _native.decode_tail(data, tail_bit,
                                       out_size - done_bytes, cfg)
    if out is None:
        return status, tail, None
    out = out.numpy()
    out[done_bytes:done_bytes + len(tail)] = np.frombuffer(tail, np.uint8)
    return status, tail, out[:done_bytes + len(tail)].tobytes()


def _kernels_supported(cfg):
    return (decode_cuda.kernel_supported(cfg)
            and unpredict_cuda.kernel_supported(cfg))


def decode_buffer_device(data, cfg: Config, out_size, device,
                         chunk_rsis=None, part_sink=None):
    """Two-phase decode with the payload phase on `device` (status,
    bytes); twin of libaec_tpu.decode.decode_buffer_tpu.

    part_sink, if given, receives the decoded bytes in order, chunk by
    chunk, and the returned bytes are empty: host memory then holds one
    chunk at a time.  chunk_rsis is the number of RSIs per device chunk
    (default: 8 Mi samples' worth, as the JAX route).  A CUDA device
    that is missing, a missing native library and a config outside the
    kernel gates raise; nothing falls back."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    if _native.get_lib() is None:
        raise RuntimeError("the device decode needs the native scan, "
                           "and the native library is unavailable")
    if not _kernels_supported(cfg):
        raise ValueError(f"config outside the kernel gates: {cfg}")
    if not isinstance(data, bytes):
        data = bytes(data)
    bsz, S = cfg.bytes_per_sample, cfg.samples_per_rsi
    want_rsis = out_size // bsz // S
    if chunk_rsis is None:
        chunk_rsis = max(1, (8 << 20) // S)
    per_chunk = min(chunk_rsis, max(want_rsis, 1))  # RSIs a slot holds
    nrec = per_chunk * cfg.rsi
    out = torch.empty(out_size, dtype=torch.uint8) \
        if part_sink is None else None
    fetch_stream = torch.cuda.Stream(device) if cuda else None
    staging = torch.empty(per_chunk * S * bsz, dtype=torch.uint8,
                          pin_memory=True) if cuda else None
    free = deque()      # slots whose chunk has been dispatched
    pending = []        # (chunk output, done event, output offset)
    fetch_futs = []
    staged = None       # (fill future, slot, n_rsi, output offset)

    def take_slot():
        if not free:
            return _Slot(cfg, nrec, cuda)
        slot = free.popleft()
        if slot.copied is not None:
            slot.copied.synchronize()
        return slot

    def fetch(chunk_out, done, off):
        if done is not None:
            done.synchronize()
        dst = None if out is None else out[off:off + chunk_out.numel()]
        with (torch.cuda.stream(fetch_stream) if cuda else nullcontext()):
            part = fetch_chunk(chunk_out, dst, staging)
        if part is not None:
            part_sink(part)

    def drain_one(fetch_pool):
        fetch_futs.append(fetch_pool.submit(fetch, *pending.pop(0)))
        if len(fetch_futs) >= 3:
            fetch_futs[-3].result()

    def dispatch_staged(fetch_pool):
        fut, slot, n_rsi, off = staged
        wf = fut.result()
        win, rec = stage_chunk(slot, n_rsi * cfg.rsi, wf, device)
        free.append(slot)
        chunk_out = decode_chunk(cfg, win, rec, n_rsi)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record()
        pending.append((chunk_out, done, off))
        if len(pending) > MAX_INFLIGHT:
            drain_one(fetch_pool)

    n_rsis = tail_bit = 0
    # the walk of chunk i+1 runs while chunk i's fill runs on its worker
    # and earlier chunks decode on the device (decode.py:299-371)
    with ThreadPoolExecutor(1) as fill_pool, \
            ThreadPoolExecutor(1) as fetch_pool:
        while n_rsis < want_rsis:
            ask = min(chunk_rsis, want_rsis - n_rsis)
            slot = take_slot()
            recs, cnt, tail_bit = scan_chunk(data, ask, cfg, tail_bit, slot)
            if cnt == 0:
                break
            fut = fill_pool.submit(fill_chunk, data, cfg, slot, recs,
                                   tail_bit)
            if staged is not None:
                dispatch_staged(fetch_pool)
            staged = (fut, slot, cnt, n_rsis * S * bsz)
            n_rsis += cnt
            if cnt < ask:  # truncated / malformed / oversized-FS tail
                break
        if staged is not None:
            dispatch_staged(fetch_pool)
        while pending:
            drain_one(fetch_pool)
        for f in fetch_futs:
            f.result()

    status, tail, result = finish(data, cfg, tail_bit, n_rsis * S * bsz,
                                  out_size, out)
    if part_sink is not None:
        if tail:
            part_sink(tail)
        return status, b""
    return status, result


def _use_device(cfg, out_size, force_device):
    """Routing twin of _device_decode_wanted (libaec_tpu/decode.py:37-59):
    the device when the kernel gates pass, the native scan is present,
    and the output is large (or force_device is set)."""
    if not _kernels_supported(cfg):
        return False
    if not (force_device or out_size >= DEVICE_DECODE_MIN_BYTES):
        return False
    if _native.get_lib() is None:
        if force_device:
            raise RuntimeError("the device decode needs the native scan, "
                               "and the native library is unavailable")
        return False
    return True


def decode_buffer_status(data, cfg: Config, out_size, device="cuda",
                         force_device=False, chunk_rsis=None):
    """One-shot decode with C-style (status, bytes) result
    (aec_buffer_decode parity), twin of libaec_tpu.decode_buffer_status.

    Outputs of at least 16 MiB whose config passes the kernel gates
    (block size 8..64; any sample width) decode on `device`;
    `force_device=True` drops the size threshold (the tests use it to
    reach the device path at small sizes).  Everything else goes to the
    native decoder.  A device that is missing raises; nothing falls back
    from the device path."""
    if _use_device(cfg, out_size, force_device):
        return decode_buffer_device(data, cfg, out_size, device,
                                    chunk_rsis=chunk_rsis)
    return _decode_cpu_status(data, cfg, out_size)


def decode_buffer(data, cfg: Config, out_size, device="cuda",
                  force_device=False, chunk_rsis=None):
    """One-shot decode; raises AecError subclasses on failure, as
    libaec_tpu.decode_buffer."""
    status, out = decode_buffer_status(data, cfg, out_size, device=device,
                                       force_device=force_device,
                                       chunk_rsis=chunk_rsis)
    if status == AEC_OK:
        return out
    if status == AEC_MEM_ERROR:
        raise AecMemError("output size not a whole number of samples")
    raise AecDataError(f"status {status}")
