"""Decoder orchestration on torch: CCSDS 121.0-B-2 stream -> bytes.

Twin of libaec_tpu/decode.py's device routes: one stream
(decode_buffer_tpu, decode.py:232) and many (decode_buffers_tpu,
decode.py:399).  Phase 1 runs on the host in the port's native code
(native/): the records-only structural walk (native.scan_blocks) on the
calling thread; the window bucketing and fill (native.fill_windows, in
FILL_THREADS pieces of rows) on a fill worker, writing into pinned host
buffers.  Phase 2 copies each chunk to the device and runs kernel 3
(kernels/decode_cuda.py) and kernel 4, or for 3-byte samples kernel 5 and
kernel 4's byte layout (kernels/unpredict_cuda.py), or, opted into with
`fused`, kernel 6 alone (kernels/decode_fused_cuda.py); at most 4 chunks
in flight; one FIFO fetch worker copies the output back and stores it
into the result in STORE_THREADS pieces, after a touch worker has
written into each of the result's new pages.  The workers, the helpers
that take the pieces and the chunk slots of one stream's decode live as
long as the process (_pipeline_pools, _ChunkPipe).  The serial native
tail (native.decode_tail) finishes what the scan could not validate,
which gives the reference's status and truncation semantics.

Unlike the JAX route, chunks are not padded to power-of-two shapes: that
bounded XLA recompiles, and the kernels take their sizes at run time.  For
the same reason many streams share a device chunk: the kernels work per
block and per RSI, so whole-RSI records of consecutive streams
concatenate without changing any output byte.
"""
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import nullcontext

import numpy as np
import torch

from . import native as _native
from .config import Config
from .constants import AEC_MEM_ERROR, AEC_OK, AecDataError, AecMemError
from .hostbytes import HostBytes
from .kernels import decode_cuda, decode_fused_cuda, unpredict_cuda
from .ops import bitunpack
from .ops.bitunpack import WF_BUCKETS  # noqa: F401

MAX_INFLIGHT = 4  # chunks queued on the device before the oldest is fetched
# Outputs of at least this size decode on the device by default; below it
# the per-call cost outweighs the device (libaec_tpu/decode.py:34).
DEVICE_DECODE_MIN_BYTES = 16 << 20


def pipeline_threads(cores=None):
    """(fill, store) pieces of one stream's decode on a host of `cores`
    cores (default os.cpu_count()).  The walk holds the calling thread
    and the first touch of the result's pages the touch worker; the fill
    cuts each chunk's windows into `fill` pieces of rows and the store
    each chunk's bytes into `store` pieces, done at once by their worker
    and the pipeline's helpers.  On the 8 cores of the H100 host, 3 and
    4 decoded cell 1 faster than 1 or 2 pieces of fill and 2 or 3 of
    store (PERF.md section 6); the two take up to the cores the
    walk leaves."""
    cores = cores or os.cpu_count() or 1
    fill = max(1, min(3, (cores - 2) // 2))
    store = max(1, min(4, cores - 1 - fill))
    return fill, store


FILL_THREADS, STORE_THREADS = pipeline_threads()
PAGE = 4096
_POOLS = {}  # process id -> _Pools
_SLOTS = {}  # (process id, records, window words, pinned) -> idle slots
_LOCK = threading.Lock()


class _Pools:
    """The threads of one stream's decode, made at a process's first such
    decode and kept for every later one (a forked child makes its own),
    so that no call pays for new threads: the fill worker, the FIFO fetch
    worker, the touch worker and the helpers that take the fill's and
    the store's other pieces.  Calls from several threads share them;
    each call waits for its own jobs only."""

    def __init__(self):
        cores = os.cpu_count() or 1
        self.fill = ThreadPoolExecutor(1, "aec-decode-fill")
        self.fetch = ThreadPoolExecutor(1, "aec-decode-fetch")
        self.touch = ThreadPoolExecutor(1, "aec-decode-touch")
        self.helpers = ThreadPoolExecutor(cores, "aec-decode-help")


def _pipeline_pools():
    with _LOCK:
        pools = _POOLS.get(os.getpid())
        if pools is None:
            pools = _POOLS[os.getpid()] = _Pools()
        return pools


def _in_pieces(fn, n, pieces, align=1):
    """fn(slice) over `pieces` pieces of range(n), each a multiple of
    align long but the last, at once: the first on this thread, the
    others on the pipeline's helpers."""
    step = max(1, -(-n // (pieces * align))) * align
    cuts = [slice(a, a + step) for a in range(0, n, step)]
    helpers = [_pipeline_pools().helpers.submit(fn, c) for c in cuts[1:]]
    try:
        if cuts:
            fn(cuts[0])
    finally:
        for f in helpers:
            f.result()


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
    twice; the bucket width is worked out in `scratch`.  `copied` is an
    event recorded after the chunk's H2D copies: the slot is rewritten
    only once it has completed.  Slots outlive a call (_ChunkPipe keeps
    them for the next), so their pages are touched once a process."""

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
        self.scratch = bitunpack.BucketScratch(nrec)
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


def _fill_rows(data, slot, recs, wf, row, threads=1):
    """Windows at width wf and the two derived records (fs_bit, lsb_rel,
    as scan_record_arrays) of scanned records, into the slot's rows from
    `row` on; the windows in `threads` pieces of rows at once
    (_in_pieces: on threads of the process, not threads made a call)."""
    n = len(recs["fs_off"])
    rows = slice(row, row + n)
    fs_off, meta, win = recs["fs_off"], recs["meta"], \
        slot.window_view(wf)[rows]
    _in_pieces(lambda p: _native.fill_windows(data, fs_off[p], meta[p], wf,
                                              1, win[p]), n, threads)
    np.bitwise_and(fs_off, np.uint64(31), out=slot.fs_bit[rows],
                   casting="unsafe")
    np.subtract(recs["lsb_off"], fs_off, out=slot.lsb_rel[rows],
                casting="unsafe")
    return rows


def fill_chunk(data, cfg, slot, recs, tail_bit):
    """Bucket width, windows and derived records of one chunk scanned into
    the slot (the fill worker's job; the windows in FILL_THREADS
    pieces).  Returns the width."""
    wf = bitunpack.bucket_wf(cfg, recs, tail_bit, slot.scratch)
    _fill_rows(data, slot, recs, wf, 0, FILL_THREADS)
    return wf


def touch_pages(view):
    """One byte of each page of view (uint8, a stretch of the result)
    written: the pages' first-touch faults taken here, on the touch
    worker, ahead of the store (a result's pages are new in every call;
    on the H100 host they cost more than the store's copy, PERF.md
    section 6)."""
    view[::PAGE] = 0


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
    """Fetched bytes into dst, a view of the result's bytes (HostBytes),
    or returned as bytes when dst is None (the part_sink route).  A
    tensor (one stream's chunk) is cut into STORE_THREADS pieces of
    whole pages, copied at once (_in_pieces) by numpy, which releases
    the interpreter lock.  Not by torch: its copy runs in an OpenMP team
    of as many threads as cores, whose workers spin for milliseconds
    after each copy unless the process already holds another team, so
    the walk and the fill lost cores to them in a process that had run
    no torch CPU op on its main thread (ROADMAP C.17).  numpy arrays
    (decode_buffers, whose pools keep every core busy) are copied on
    this thread alone."""
    if dst is None:
        return flat.numpy().tobytes()
    if isinstance(dst, np.ndarray):
        dst[:] = flat
        return None
    src, out = flat.numpy(), dst.numpy()
    _in_pieces(lambda p: np.copyto(out[p], src[p]), len(out), STORE_THREADS,
               PAGE)
    return None


def finish(data, cfg, tail_bit, done_bytes, out_size, out):
    """The serial native tail from tail_bit, and the whole output:
    (status, tail bytes, output bytes).  `out` is the HostBytes that the
    first done_bytes were stored into: the tail goes in after them and
    the output is `out` itself, cut in place where the stream ended
    short.  With out None (no part stored, or parts sent to a sink) the
    output is the tail."""
    status, tail = _native.decode_tail(data, tail_bit,
                                       out_size - done_bytes, cfg)
    if out is None:
        return status, tail, tail
    end = done_bytes + len(tail)
    out.view.numpy()[done_bytes:end] = np.frombuffer(tail, np.uint8)
    return status, tail, out.take(end)


def _check_device_route(device):
    """The device route's preconditions; nothing falls back."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    _native.get_lib()  # raises when the native library cannot be built


class _ChunkPipe:
    """What both device routes share: the pool of slots, the chunks in
    flight on the device (at most MAX_INFLIGHT) and the FIFO fetch of
    their outputs.  deliver(flat, tag) receives each chunk's bytes on the
    host, in order, on the fetch worker, with the tag given at dispatch.
    settle() waits for every job submitted through it, whatever became of
    the others, so a call that raises leaves no job writing into its
    buffers, and keeps the call's slots for the process's next call."""

    def __init__(self, cfg, per_chunk, device, fused, fetch_pool, deliver):
        self.cfg, self.device, self.fused = cfg, device, fused
        self.cuda = device.type == "cuda"
        self.nrec = per_chunk * cfg.rsi  # records a slot holds
        self.fetch_pool, self.deliver = fetch_pool, deliver
        self.fetch_stream = torch.cuda.Stream(device) if self.cuda else None
        self.staging = torch.empty(
            per_chunk * cfg.rsi_len_bytes, dtype=torch.uint8,
            pin_memory=True) if self.cuda else None
        self.key = (os.getpid(), self.nrec, bitunpack.window_words(cfg),
                    self.cuda)
        self.slots = []       # every slot this call holds
        self.free = deque()   # slots whose chunk has been dispatched
        self.pending = []     # (chunk output, done event, tag)
        self.fetch_futs, self.fill_futs, self.touch_futs = [], [], []

    def take_slot(self):
        if not self.free:
            with _LOCK:
                kept = _SLOTS.get(self.key)
                slot = kept.pop() if kept else None
            if slot is None:
                slot = _Slot(self.cfg, self.nrec, self.cuda)
            self.slots.append(slot)
            return slot
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

    def fill(self, pool, fn, *args):
        """fn(*args) on a fill worker of `pool`: its future."""
        fut = pool.submit(fn, *args)
        self.fill_futs.append(fut)
        return fut

    def touch(self, view, step):
        """touch_pages over view (uint8) in stretches of step bytes, in
        order, on the touch worker."""
        pool = _pipeline_pools().touch
        self.touch_step = step
        self.touch_futs = [pool.submit(touch_pages, view[a:a + step])
                           for a in range(0, len(view), step)]

    def touched(self, end):
        """Waits until touch() has done every page before byte `end`: a
        stretch is stored only after its touch, which writes into it."""
        if self.touch_futs and end > 0:
            self.touch_futs[min((end - 1) // self.touch_step,
                                len(self.touch_futs) - 1)].result()

    def settle(self):
        wait(self.fill_futs + self.fetch_futs + self.touch_futs)
        for slot in self.slots:
            if slot.copied is not None:
                slot.copied.synchronize()
        with _LOCK:
            for key in [k for k in _SLOTS if k != self.key]:
                del _SLOTS[key]  # the slots of another chunk geometry
            _SLOTS.setdefault(self.key, []).extend(self.slots)
        self.slots = []

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
    LIBAEC_TPU_FUSED_DECODE).  A CUDA device that is missing and a native
    library that cannot be built raise; nothing falls back."""
    device = torch.device(device)
    _check_device_route(device)
    if not isinstance(data, bytes):
        data = bytes(data)
    rsi_bytes = cfg.rsi_len_bytes
    want_rsis = out_size // rsi_bytes
    if chunk_rsis is None:
        chunk_rsis = max(1, (8 << 20) // cfg.samples_per_rsi)
    # the result itself, filled in place (no part is stored below one RSI)
    out = HostBytes(out_size) if part_sink is None and want_rsis else None

    def deliver(flat, off):
        if out is None:
            part_sink(store_part(flat, None))
            return
        pipe.touched(off + flat.numel())
        store_part(flat, out.view[off:off + flat.numel()])

    n_rsis = tail_bit = 0
    staged = None  # (fill future, slot, RSIs, output offset)
    pools = _pipeline_pools()
    pipe = _ChunkPipe(cfg, min(chunk_rsis, max(want_rsis, 1)), device,
                      fused_wanted(fused), pools.fetch, deliver)
    # the walk of chunk i+1 runs while chunk i's fill runs on its worker,
    # earlier chunks decode on the device and the result's pages are
    # touched ahead of their store (decode.py:299-371)
    try:
        if out is not None:
            pipe.touch(out.view.numpy()[:want_rsis * rsi_bytes],
                       chunk_rsis * rsi_bytes)
        while n_rsis < want_rsis:
            ask = min(chunk_rsis, want_rsis - n_rsis)
            slot = pipe.take_slot()
            recs, cnt, tail_bit = scan_chunk(data, ask, cfg, tail_bit, slot)
            if cnt == 0:
                break
            fut = pipe.fill(pools.fill, fill_chunk, data, cfg, slot, recs,
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
    finally:
        pipe.settle()

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
    `fused` as decode_buffer_device.

    A CUDA device that is missing and a native library that cannot be
    built raise; nothing falls back."""
    datas = [d if isinstance(d, bytes) else bytes(d) for d in datas]
    n = len(datas)
    if n == 0:
        return []
    device = torch.device(device)
    _check_device_route(device)
    rsi_bytes = cfg.rsi_len_bytes
    wants = [size // rsi_bytes for size in out_sizes]
    if chunk_rsis is None:
        chunk_rsis = max(1, (8 << 20) // cfg.samples_per_rsi)
    per_chunk = min(chunk_rsis, max(sum(wants), 1))  # RSIs a slot holds
    if scan_threads is None:
        scan_threads = min(max(1, (os.cpu_count() or 2) - 1), 8, n)
    results = [None] * n
    outs = [None] * n     # each stream's result (HostBytes), filled in place
    stored = [0] * n      # bytes of it stored so far
    tails = [None] * n    # (tail_bit, RSIs scanned)

    def finish_stream(i):
        tail_bit, n_rsis = tails[i]
        status, _, result = finish(datas[i], cfg, tail_bit,
                                   n_rsis * rsi_bytes, out_sizes[i], outs[i])
        results[i] = (status, result)
        outs[i] = None

    def deliver(flat, parts):
        row = 0
        for i, cnt, last in parts:
            nbytes = cnt * rsi_bytes
            if outs[i] is None:
                outs[i] = HostBytes(out_sizes[i])
            store_part(flat[row:row + nbytes].numpy(),
                       outs[i].view[stored[i]:stored[i] + nbytes].numpy())
            stored[i] += nbytes
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


def _use_device(out_size, force_device):
    """Routing twin of _device_decode_wanted (libaec_tpu/decode.py:37-59):
    the device when the output is large (or force_device is set)."""
    return force_device or out_size >= DEVICE_DECODE_MIN_BYTES


def decode_buffer_status(data, cfg: Config, out_size, device="cuda",
                         force_device=False, chunk_rsis=None, fused=None):
    """One-shot decode with C-style (status, bytes) result
    (aec_buffer_decode parity), twin of libaec_tpu.decode_buffer_status.

    Outputs of at least 16 MiB decode on `device`, whatever the config
    (any block size, any sample width); `force_device=True` drops the size
    threshold (the tests use it to reach the device path at small sizes).
    Smaller outputs go to the native decoder.  `fused=True` (None:
    LIBAEC_TPU_FUSED_DECODE set) opts into the one-kernel device route.
    A device that is missing and a native library that cannot be built
    raise; nothing falls back from the device path."""
    if _use_device(out_size, force_device):
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
