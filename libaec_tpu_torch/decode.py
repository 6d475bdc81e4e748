"""Decoder orchestration on torch: CCSDS 121.0-B-2 stream -> bytes.

Twin of libaec_tpu/decode.py's device routes: one stream
(decode_buffer_tpu, decode.py:232) and many (decode_buffers_tpu,
decode.py:399).  Phase 1 runs on the host in the port's native code
(native/): the records-only structural walk (native.scan_blocks), the
window bucketing and fill (native.fill_windows) on one worker, writing
into pinned host buffers.  Phase 2 copies each chunk to the device and
runs kernel 3 (kernels/decode_cuda.py) and kernel 4, or for 3-byte samples
kernel 5 and kernel 4's byte layout (kernels/unpredict_cuda.py), or, opted
into with `fused`, kernel 6 alone (kernels/decode_fused_cuda.py); at most
4 chunks in flight; one FIFO fetch thread copies the output back.  The
serial native tail (native.decode_tail) finishes what the scan could not
validate, which gives the reference's status and truncation semantics.

Unlike the JAX route, chunks are not padded to power-of-two shapes: that
bounded XLA recompiles, and the kernels take their sizes at run time.  For
the same reason many streams share a device chunk: the kernels work per
block and per RSI, so whole-RSI records of consecutive streams
concatenate without changing any output byte.
"""
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from . import native as _native
from .config import Config
from .constants import AEC_MEM_ERROR, AEC_OK, AecDataError, AecMemError
from .kernels import decode_cuda, decode_fused_cuda, unpredict_cuda
from .ops import bitunpack
from .ops.bitunpack import WF_BUCKETS  # noqa: F401

MAX_INFLIGHT = 4  # chunks queued on the device before the oldest is fetched
# Outputs of at least this size decode on the device by default; below it
# the per-call cost outweighs the device (libaec_tpu/decode.py:34).
DEVICE_DECODE_MIN_BYTES = 16 << 20


def scan_record_arrays(recs):
    """The kernels' input arrays from a native.scan_blocks record dict
    with windows: (win, fs_bit, lsb_rel, meta, ref_sample), as
    libaec_tpu/decode.py:156."""
    fs_off = recs["fs_off"]
    return (
        recs["win"],
        (fs_off & np.uint64(31)).astype(np.uint32),
        # LSB region offset relative to the payload start (zero-run
        # records carry fs_off == lsb_off == 0, so this stays 0)
        (recs["lsb_off"] - fs_off).astype(np.uint32),
        recs["meta"],
        recs["ref_sample"],
    )


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


def _fill_rows(data, slot, recs, wf, row):
    """Windows at width wf and the two derived records (fs_bit, lsb_rel,
    as scan_record_arrays) of scanned records, into the slot's rows from
    `row` on."""
    rows = slice(row, row + len(recs["fs_off"]))
    _native.fill_windows(data, recs["fs_off"], recs["meta"], wf, 1,
                         slot.window_view(wf)[rows])
    np.bitwise_and(recs["fs_off"], np.uint64(31), out=slot.fs_bit[rows],
                   casting="unsafe")
    np.subtract(recs["lsb_off"], recs["fs_off"], out=slot.lsb_rel[rows],
                casting="unsafe")
    return rows


def fill_chunk(data, cfg, slot, recs, tail_bit):
    """Bucket width, windows and derived records of one chunk scanned into
    the slot (the fill worker's job).  Returns the width."""
    wf = bitunpack.bucket_wf(cfg, recs, tail_bit)
    _fill_rows(data, slot, recs, wf, 0)
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


def fused_wanted(fused):
    """The `fused` argument of the entry points: None reads
    LIBAEC_TPU_FUSED_DECODE, as the JAX package does (decode.py:122-124)."""
    if fused is None:
        return bool(os.environ.get("LIBAEC_TPU_FUSED_DECODE"))
    return bool(fused)


def decode_chunk(cfg, win, rec, n_rsi, fused=False):
    """The kernels on one chunk of n_rsi whole RSIs: its output bytes,
    uint8 [n_rsi, S * bytes_per_sample].  Kernel 3, then kernel 4; for
    3-byte samples, as the JAX route (decode.py:147-149), kernel 5 (with
    preprocessing) and kernel 4 as the byte layout alone.  With `fused`,
    kernel 6 alone replaces kernels 3 and 4 where its gate passes
    (decode_fused_cuda.fused_supported); a config outside that gate takes
    the route above, as in the JAX package (decode.py:122-137)."""
    n = n_rsi * cfg.rsi
    if fused and decode_fused_cuda.fused_supported(cfg):
        return decode_fused_cuda.decode_unpredict_swizzle(
            cfg, win, rec[0, :n], rec[1, :n], rec[2, :n], rec[3, :n], n_rsi)
    deltas = decode_cuda.decode_blocks(cfg, win, rec[0, :n], rec[1, :n],
                                       rec[2, :n], rec[3, :n])
    deltas = deltas.view(n_rsi, cfg.samples_per_rsi)
    if cfg.bytes_per_sample == 3:
        return unpredict_cuda.samples_to_bytes(
            cfg, unpredict_cuda.unpredict_rsis(cfg, deltas))
    return unpredict_cuda.unpredict_swizzle(cfg, deltas)


def fetch_chunk(chunk_out, staging):
    """A chunk's output bytes on the host, as a flat uint8 tensor.  On the
    card they go through `staging`, a pinned buffer (a copy to pageable
    memory runs at a fraction of the bus's rate), on the current stream,
    and the result is a view of it: valid until the next fetch."""
    flat = chunk_out.view(-1)
    if staging is None:
        return flat
    host = staging[:flat.numel()]
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return host


def store_part(flat, dst):
    """Fetched bytes into the host tensor dst, or returned as bytes when
    dst is None."""
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


def _check_device_route(cfg, device):
    """The device route's preconditions; nothing falls back."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    _native.get_lib()  # raises when the native library cannot be built
    if not _kernels_supported(cfg):
        raise ValueError(f"config outside the kernel gates: {cfg}")


class _ChunkPipe:
    """What both device routes share: the pool of slots, the chunks in
    flight on the device (at most MAX_INFLIGHT) and the FIFO fetch of
    their outputs.  deliver(flat, tag) receives each chunk's bytes on the
    host, in order, on the fetch worker, with the tag given at dispatch."""

    def __init__(self, cfg, per_chunk, device, fused, fetch_pool, deliver):
        self.cfg, self.device, self.fused = cfg, device, fused
        self.cuda = device.type == "cuda"
        self.nrec = per_chunk * cfg.rsi  # records a slot holds
        self.fetch_pool, self.deliver = fetch_pool, deliver
        self.fetch_stream = torch.cuda.Stream(device) if self.cuda else None
        self.staging = torch.empty(
            per_chunk * cfg.rsi_len_bytes, dtype=torch.uint8,
            pin_memory=True) if self.cuda else None
        self.free = deque()   # slots whose chunk has been dispatched
        self.pending = []     # (chunk output, done event, tag)
        self.fetch_futs = []

    def take_slot(self):
        if not self.free:
            return _Slot(self.cfg, self.nrec, self.cuda)
        slot = self.free.popleft()
        if slot.copied is not None:
            slot.copied.synchronize()
        return slot

    def dispatch(self, slot, n_rsi, wf, tag):
        """The filled slot's chunk to the device, and the oldest chunk to
        the fetch worker once more than MAX_INFLIGHT are queued."""
        win, rec = stage_chunk(slot, n_rsi * self.cfg.rsi, wf, self.device)
        self.free.append(slot)
        chunk_out = decode_chunk(self.cfg, win, rec, n_rsi, self.fused)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        self.pending.append((chunk_out, done, tag))
        if len(self.pending) > MAX_INFLIGHT:
            self._drain_one()

    def submit(self, fn, *args):
        """fn(*args) on the fetch worker, in turn with the fetches."""
        self.fetch_futs.append(self.fetch_pool.submit(fn, *args))

    def _fetch(self, chunk_out, done, tag):
        if done is not None:
            done.synchronize()
        with (torch.cuda.stream(self.fetch_stream) if self.cuda
              else nullcontext()):
            self.deliver(fetch_chunk(chunk_out, self.staging), tag)

    def _drain_one(self):
        self.submit(self._fetch, *self.pending.pop(0))
        if len(self.fetch_futs) >= 3:
            self.fetch_futs[-3].result()

    def drain(self):
        """Fetch what is still in flight and wait for the fetch worker."""
        while self.pending:
            self._drain_one()
        for f in self.fetch_futs:
            f.result()


def decode_buffer_device(data, cfg: Config, out_size, device,
                         chunk_rsis=None, part_sink=None, fused=None):
    """Two-phase decode with the payload phase on `device` (status,
    bytes); twin of libaec_tpu.decode.decode_buffer_tpu.

    part_sink, if given, receives the decoded bytes in order, chunk by
    chunk, and the returned bytes are empty: host memory then holds one
    chunk at a time.  chunk_rsis is the number of RSIs per device chunk
    (default: 8 Mi samples' worth, as the JAX route).  `fused` chooses
    the one-kernel route (see decode_chunk; None reads
    LIBAEC_TPU_FUSED_DECODE).  A CUDA device that is missing, a native
    library that cannot be built and a config outside the kernel gates
    raise; nothing falls back."""
    device = torch.device(device)
    _check_device_route(cfg, device)
    if not isinstance(data, bytes):
        data = bytes(data)
    rsi_bytes = cfg.rsi_len_bytes
    want_rsis = out_size // rsi_bytes
    if chunk_rsis is None:
        chunk_rsis = max(1, (8 << 20) // cfg.samples_per_rsi)
    out = torch.empty(out_size, dtype=torch.uint8) \
        if part_sink is None else None

    def deliver(flat, off):
        dst = None if out is None else out[off:off + flat.numel()]
        part = store_part(flat, dst)
        if part is not None:
            part_sink(part)

    n_rsis = tail_bit = 0
    staged = None  # (fill future, slot, RSIs, output offset)
    # the walk of chunk i+1 runs while chunk i's fill runs on its worker
    # and earlier chunks decode on the device (decode.py:299-371)
    with ThreadPoolExecutor(1) as fill_pool, \
            ThreadPoolExecutor(1) as fetch_pool:
        pipe = _ChunkPipe(cfg, min(chunk_rsis, max(want_rsis, 1)), device,
                          fused_wanted(fused), fetch_pool, deliver)
        while n_rsis < want_rsis:
            ask = min(chunk_rsis, want_rsis - n_rsis)
            slot = pipe.take_slot()
            recs, cnt, tail_bit = scan_chunk(data, ask, cfg, tail_bit, slot)
            if cnt == 0:
                break
            fut = fill_pool.submit(fill_chunk, data, cfg, slot, recs,
                                   tail_bit)
            if staged is not None:
                pipe.dispatch(staged[1], staged[2], staged[0].result(),
                              staged[3])
            staged = (fut, slot, cnt, n_rsis * rsi_bytes)
            n_rsis += cnt
            if cnt < ask:  # truncated / malformed / oversized-FS tail
                break
        if staged is not None:
            pipe.dispatch(staged[1], staged[2], staged[0].result(), staged[3])
        pipe.drain()

    status, tail, result = finish(data, cfg, tail_bit, n_rsis * rsi_bytes,
                                  out_size, out)
    if part_sink is not None:
        if tail:
            part_sink(tail)
        return status, b""
    return status, result


def scan_stream(data, cfg, want_rsis, chunk_rsis):
    """The records-only walk of one whole stream, in parts of at most
    chunk_rsis RSIs (a scan-pool job of decode_buffers): ([(records, RSIs,
    bucket width)], tail_bit, RSIs scanned)."""
    parts, n_rsis, tail_bit = [], 0, 0
    while n_rsis < want_rsis:
        ask = min(chunk_rsis, want_rsis - n_rsis)
        res = _native.scan_blocks(data, ask, bitunpack.max_fs_bits(cfg), cfg,
                                  wf=0, start_bit=tail_bit)
        if res is None:
            raise RuntimeError(f"native scan refused the config: {cfg}")
        recs, cnt, tail_bit = res
        if cnt == 0:
            break
        parts.append((recs, cnt, bitunpack.bucket_wf(cfg, recs, tail_bit)))
        n_rsis += cnt
        if cnt < ask:  # truncated / malformed / oversized-FS tail
            break
    return parts, tail_bit, n_rsis


def fill_part(data, slot, recs, wf, row):
    """The records and windows of one stream's part into the slot's rows
    from `row` on, at the chunk's width wf (a fill-pool job of
    decode_buffers; parts of one chunk fill side by side)."""
    rows = _fill_rows(data, slot, recs, wf, row)
    slot.meta[rows] = recs["meta"]
    slot.ref_sample[rows] = recs["ref_sample"]


def decode_buffers(datas, cfg: Config, out_sizes, device="cuda",
                   scan_threads=None, chunk_rsis=None, fused=None):
    """Decode many independent streams: a list of (status, bytes), each
    identical to decode_buffer_device(datas[i], cfg, out_sizes[i], device).
    Twin of libaec_tpu.decode.decode_buffers_tpu: the deployment of one
    stream per HDF5 chunk or SZIP scanline.

    Every stream goes to the device whatever its size.  The records-only
    scans run on a pool of scan_threads host threads (the native call
    releases the GIL); the calling thread takes them in stream order and
    packs the whole-RSI records of consecutive streams (or parts of a
    long stream) into device chunks of at most chunk_rsis RSIs, so one
    launch serves many streams: the kernels work per block and per RSI,
    and no output byte depends on a chunk's neighbours.  A second pool
    fills each chunk's windows, its parts side by side, at one bucket
    width, the widest of its parts; one FIFO worker fetches each chunk's
    output, hands every stream its rows and runs the native tail of each
    stream that ends in the chunk, so results finish in order while later
    chunks are dispatched.  At most MAX_INFLIGHT chunks are outstanding.
    `fused` as decode_buffer_device.  A CUDA device that is missing, a
    native library that cannot be built and a config outside the kernel
    gates raise; nothing falls back."""
    datas = [d if isinstance(d, bytes) else bytes(d) for d in datas]
    n = len(datas)
    if n == 0:
        return []
    device = torch.device(device)
    _check_device_route(cfg, device)
    rsi_bytes = cfg.rsi_len_bytes
    wants = [size // rsi_bytes for size in out_sizes]
    if chunk_rsis is None:
        chunk_rsis = max(1, (8 << 20) // cfg.samples_per_rsi)
    per_chunk = min(chunk_rsis, max(sum(wants), 1))  # RSIs a slot holds
    if scan_threads is None:
        scan_threads = min(max(1, (os.cpu_count() or 2) - 1), 8, n)
    results = [None] * n
    pieces = [[] for _ in range(n)]  # each stream's output, part by part
    tails = [None] * n               # (tail_bit, RSIs scanned)

    def finish_stream(i):
        tail_bit, n_rsis = tails[i]
        status, tail, _ = finish(datas[i], cfg, tail_bit, n_rsis * rsi_bytes,
                                 out_sizes[i], None)
        if tail or not pieces[i]:
            pieces[i].append(tail)
        # one piece is the result as it is: no second copy
        results[i] = (status, pieces[i][0] if len(pieces[i]) == 1
                      else b"".join(pieces[i]))
        pieces[i] = None

    def deliver(flat, parts):
        row = 0
        for i, cnt, last in parts:
            nbytes = cnt * rsi_bytes
            pieces[i].append(store_part(flat[row:row + nbytes], None))
            row += nbytes
            if last:
                finish_stream(i)

    staged = None          # (fill futures, slot, RSIs, width, parts)
    cur, cur_rsis = [], 0  # (stream, records, RSIs, width, last part?)

    def flush():
        """The packed chunk's parts to the fill pool; the chunk before it,
        whose fills ran meanwhile, to the device."""
        nonlocal staged, cur, cur_rsis
        if cur:
            slot = pipe.take_slot()
            wf = max(part_wf for _, _, _, part_wf, _ in cur)
            futs, row = [], 0
            for i, recs, cnt, _, _ in cur:
                futs.append(fill_pool.submit(fill_part, datas[i], slot, recs,
                                             wf, row))
                row += cnt * cfg.rsi
        if staged is not None:
            for fut in staged[0]:
                fut.result()
            pipe.dispatch(*staged[1:])
            staged = None
        if cur:
            staged = (futs, slot, cur_rsis, wf,
                      [(i, cnt, last) for i, _, cnt, _, last in cur])
            cur, cur_rsis = [], 0

    with ThreadPoolExecutor(scan_threads) as scan_pool, \
            ThreadPoolExecutor(scan_threads) as fill_pool, \
            ThreadPoolExecutor(1) as fetch_pool:
        pipe = _ChunkPipe(cfg, per_chunk, device, fused_wanted(fused),
                          fetch_pool, deliver)
        scans = [scan_pool.submit(scan_stream, datas[i], cfg, wants[i],
                                  chunk_rsis) for i in range(n)]
        for i, scan in enumerate(scans):
            parts, tail_bit, n_rsis = scan.result()
            tails[i] = (tail_bit, n_rsis)
            if not parts:  # shorter than one RSI: the native tail alone
                pipe.submit(finish_stream, i)
            for j, (recs, cnt, wf) in enumerate(parts):
                if cur_rsis + cnt > per_chunk:
                    flush()
                cur.append((i, recs, cnt, wf, j == len(parts) - 1))
                cur_rsis += cnt
        flush()  # the last chunk to the fill pool
        flush()  # and to the device
        pipe.drain()
    return results


def _use_device(cfg, out_size, force_device):
    """Routing twin of _device_decode_wanted (libaec_tpu/decode.py:37-59):
    the device when the kernel gates pass and the output is large (or
    force_device is set)."""
    return _kernels_supported(cfg) and (
        force_device or out_size >= DEVICE_DECODE_MIN_BYTES)


def decode_buffer_status(data, cfg: Config, out_size, device="cuda",
                         force_device=False, chunk_rsis=None, fused=None):
    """One-shot decode with C-style (status, bytes) result
    (aec_buffer_decode parity), twin of libaec_tpu.decode_buffer_status.

    Outputs of at least 16 MiB whose config passes the kernel gates
    (block size 8..64; any sample width) decode on `device`;
    `force_device=True` drops the size threshold (the tests use it to
    reach the device path at small sizes).  Everything else goes to the
    native decoder.  `fused=True` (None: LIBAEC_TPU_FUSED_DECODE set)
    opts into the one-kernel device route.  A device that is missing and
    a native library that cannot be built raise; nothing falls back from
    the device path."""
    if _use_device(cfg, out_size, force_device):
        return decode_buffer_device(data, cfg, out_size, device,
                                    chunk_rsis=chunk_rsis, fused=fused)
    return _native.decode(bytes(data), out_size, cfg)


def decode_buffer(data, cfg: Config, out_size, device="cuda",
                  force_device=False, chunk_rsis=None, fused=None):
    """One-shot decode; raises AecError subclasses on failure, as
    libaec_tpu.decode_buffer."""
    status, out = decode_buffer_status(data, cfg, out_size, device=device,
                                       force_device=force_device,
                                       chunk_rsis=chunk_rsis, fused=fused)
    if status == AEC_OK:
        return out
    if status == AEC_MEM_ERROR:
        raise AecMemError("output size not a whole number of samples")
    raise AecDataError(f"status {status}")
