"""One stream's decode host pipeline in libaec_tpu_torch/decode.py: the
walk on the calling thread; the fill on a fill worker, its windows in
decode.FILL_THREADS pieces of rows; the first touch of the result's
pages on a touch worker, ahead of the store; the store on the fetch
worker in decode.STORE_THREADS pieces; the pieces on the pipeline's
helpers; every worker and slot kept for the process.

The decode with its thread counts (and with others, patched in) is held
against libaec_tpu.decode.decode_buffer_tpu and native.decode at a small
size, on the kernels' plain versions, over streams of at least three
chunks: every tests/gen.py kind, a truncated stream, an output size
short of a whole sample, 3-byte samples and the part_sink route.
_fill_rows in pieces is held row by row against one piece on chunks of
more than 4096 records; the bucket width, worked out in a slot's
scratch, against the JAX package's _bucket_wf.  The mechanism the repair
of ROADMAP C.17 rests on is checked, never a time: the store copies with
numpy, never with torch (whose OpenMP team spins after each copy); each
stretch of the result is touched before it is stored; two calls run on
the same threads and slots.  Tolerance zero.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gen import KINDS, gen_values, pack_samples  # noqa: E402

import libaec_tpu_torch  # noqa: E402
from libaec_tpu import Config, native  # noqa: E402
from libaec_tpu.constants import (  # noqa: E402
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_MEM_ERROR,
    AEC_OK,
)
from libaec_tpu.decode import decode_buffer_tpu  # noqa: E402
from libaec_tpu_torch import decode as dec  # noqa: E402
from libaec_tpu_torch import native as tnative  # noqa: E402
from libaec_tpu_torch.config import Config as TConfig  # noqa: E402
from libaec_tpu_torch.ops import bitunpack  # noqa: E402

PP, MSB = AEC_DATA_PREPROCESS, AEC_DATA_MSB
SMALL = Config(16, 64, 32, MSB | PP)  # 4 KiB RSIs
CHUNK = 8  # RSIs a chunk: 32 KiB, cut into pieces of whole pages


def make_raw(cfg, n_samples, kind="lowentropy", seed=0):
    rng = np.random.default_rng(seed)
    vals = gen_values(rng, n_samples, cfg.bits_per_sample, cfg.signed, kind)
    return pack_samples(vals, cfg.bits_per_sample, cfg.flags)


def encode(raw, cfg):
    status, comp = native.encode(raw, cfg)
    assert status == AEC_OK
    return comp


def torch_decode(comp, cfg, out_size, **kw):
    return libaec_tpu_torch.decode_buffer_status(
        comp, cfg, out_size, device="cpu", force_device=True, **kw)


@pytest.fixture(params=[None, (1, 1), (3, 3), (4, 6)],
                ids=["default", "fill1-store1", "fill3-store3",
                     "fill4-store6"])
def counts(request, monkeypatch):
    """The pipeline's own thread counts, and others patched in."""
    if request.param is not None:
        monkeypatch.setattr(dec, "FILL_THREADS", request.param[0])
        monkeypatch.setattr(dec, "STORE_THREADS", request.param[1])
    return dec.FILL_THREADS, dec.STORE_THREADS


@pytest.mark.parametrize("kind", KINDS)
def test_pipeline_matches_jax_and_native(counts, kind):
    raw = make_raw(SMALL, (3 * CHUNK + 5) * SMALL.samples_per_rsi + 777,
                   kind, KINDS.index(kind) + 40)
    comp = encode(raw, SMALL)
    want = native.decode(comp, len(raw), SMALL)
    assert want == (AEC_OK, raw)
    assert decode_buffer_tpu(comp, SMALL, len(raw), chunk_rsis=CHUNK) == want
    assert torch_decode(comp, SMALL, len(raw), chunk_rsis=CHUNK) == want


def test_pipeline_truncated_and_odd_out_size(counts):
    raw = make_raw(SMALL, 4 * CHUNK * SMALL.samples_per_rsi, "midentropy", 9)
    comp = encode(raw, SMALL)
    for stream, out_size in ((comp[: len(comp) * 3 // 4 + 5], len(raw)),
                             (comp, len(raw) - 1)):
        want = native.decode(stream, out_size, SMALL)
        assert decode_buffer_tpu(stream, SMALL, out_size,
                                 chunk_rsis=CHUNK) == want
        assert torch_decode(stream, SMALL, out_size, chunk_rsis=CHUNK) \
            == want
    assert native.decode(comp, len(raw) - 1, SMALL)[0] == AEC_MEM_ERROR
    assert len(native.decode(comp[: len(comp) * 3 // 4 + 5], len(raw),
                             SMALL)[1]) < len(raw)


def test_pipeline_3byte(counts):
    cfg = Config(24, 64, 16, MSB | PP | AEC_DATA_3BYTE)
    raw = make_raw(cfg, (3 * CHUNK + 1) * cfg.samples_per_rsi + 64 + 2,
                   "midentropy", 5)
    comp = encode(raw, cfg)
    want = native.decode(comp, len(raw), cfg)
    assert want[0] == AEC_OK and want[1] == raw
    assert decode_buffer_tpu(comp, cfg, len(raw), chunk_rsis=CHUNK) == want
    assert torch_decode(comp, cfg, len(raw), chunk_rsis=CHUNK) == want


def test_pipeline_part_sink(counts):
    raw = make_raw(SMALL, (3 * CHUNK + 2) * SMALL.samples_per_rsi + 99,
                   "edges", 3)
    comp = encode(raw, SMALL)
    want = native.decode(comp, len(raw), SMALL)
    parts = []
    got = dec.decode_buffer_device(comp, SMALL, len(raw), "cpu",
                                   chunk_rsis=CHUNK, part_sink=parts.append)
    assert got == (want[0], b"")
    assert b"".join(parts) == want[1]
    assert len(parts) == 5  # 4 chunks (the last of 2 RSIs) and the tail


@pytest.mark.parametrize("threads", sorted({2, 3, 8, dec.FILL_THREADS}))
def test_fill_rows_over_threads_match_one(threads):
    """Chunks of more than 4096 records cut into pieces of rows on the
    pipeline's helpers: every window row and derived record equal to the
    fill in one piece (the rows of zero blocks, which no kernel reads,
    are left as they were: zero here)."""
    cfg = TConfig(16, 16, 64, MSB | PP)
    n_rsi = 80  # 5120 records a chunk
    raw = make_raw(Config(16, 16, 64, MSB | PP),
                   2 * n_rsi * cfg.samples_per_rsi, "midentropy", 17)
    comp = encode(raw, Config(16, 16, 64, MSB | PP))
    tail_bit = 0
    for _ in range(2):  # the second chunk starts mid-stream
        slots = [dec._Slot(cfg, n_rsi * cfg.rsi, False) for _ in range(2)]
        for s in slots:
            s.windows.zero_()
        recs, cnt, next_bit = dec.scan_chunk(comp, n_rsi, cfg, tail_bit,
                                             slots[0])
        assert cnt == n_rsi and len(recs["fs_off"]) > 4096
        wf = bitunpack.bucket_wf(cfg, recs, next_bit)
        rows = dec._fill_rows(comp, slots[0], recs, wf, 0, 1)
        recs2 = {k: v.copy() for k, v in recs.items()}
        assert dec._fill_rows(comp, slots[1], recs2, wf, 0, threads) == rows
        one, many = (s.window_view(wf)[rows] for s in slots)
        assert np.array_equal(one, many)
        assert np.array_equal(slots[0].fs_bit[rows], slots[1].fs_bit[rows])
        assert np.array_equal(slots[0].lsb_rel[rows], slots[1].lsb_rel[rows])
        tail_bit = next_bit


def test_fill_chunk_cuts_the_windows_into_pieces(monkeypatch):
    """fill_chunk fills a chunk's windows in FILL_THREADS pieces of rows,
    one native call each (one thread a call), on the fill worker and the
    helpers."""
    monkeypatch.setattr(dec, "FILL_THREADS", 3)
    seen = []
    real = tnative.fill_windows

    def fill_windows(data, fs_off, meta, wf, threads=None, win=None):
        seen.append((threading.current_thread().name, len(fs_off), threads))
        return real(data, fs_off, meta, wf, threads, win)

    monkeypatch.setattr(tnative, "fill_windows", fill_windows)
    raw = make_raw(SMALL, 3 * CHUNK * SMALL.samples_per_rsi, seed=2)
    comp = encode(raw, SMALL)
    assert torch_decode(comp, SMALL, len(raw), chunk_rsis=CHUNK) \
        == (AEC_OK, raw)
    assert len(seen) == 9 and {t for _, _, t in seen} == {1}
    assert sum(n for _, n, _ in seen) == 3 * CHUNK * SMALL.rsi
    names = {name.rsplit("_", 1)[0] for name, _, _ in seen}
    assert names == {"aec-decode-fill", "aec-decode-help"}


def test_bucket_width_in_scratch_matches_jax():
    """bucket_wf in a slot's scratch (kept from chunk to chunk) against
    the JAX package's _bucket_wf: zero blocks, spans at each bucket's
    edge, a lone payload, none at all, and a tail bit before the last
    payload (u64 wrap)."""
    from libaec_tpu.decode import _bucket_wf

    cfg = TConfig(16, 64, 32, MSB | PP)
    rng = np.random.default_rng(3)
    scratch = bitunpack.BucketScratch(4096)
    for case in range(300):
        n = int(rng.integers(1, 4096))
        kinds = rng.integers(0, 4, n).astype(np.uint32)
        if case % 7 == 0:
            kinds[:] = 0
        elif case % 7 == 1:
            kinds[:] = 0
            kinds[rng.integers(0, n)] = 2
        gaps = rng.integers(1, 32 * int(rng.choice([4, 8, 16, 20, 40])), n)
        fs_off = np.cumsum(gaps).astype(np.uint64)
        recs = {"fs_off": fs_off, "meta": kinds | np.uint32(4 << 8)}
        tail = int(fs_off[-1]) + int(rng.integers(0, 700))
        if case % 11 == 0:
            tail = int(fs_off[-1]) - 1
        want = _bucket_wf(cfg, recs, tail)
        assert bitunpack.bucket_wf(cfg, recs, tail, scratch) == want, case
        assert bitunpack.bucket_wf(cfg, recs, tail) == want, case


def test_thread_counts_fit_the_cores():
    for cores in (1, 2, 3, 4, 8, 16, 64, 256):
        fill, store = dec.pipeline_threads(cores)
        assert fill >= 1 and store >= 1
        # with the walk, they leave a core free wherever there are 3
        assert cores < 3 or 1 + fill + store <= cores
    assert (dec.FILL_THREADS, dec.STORE_THREADS) == dec.pipeline_threads()


@pytest.mark.parametrize("nbytes", [1, 4095, 4096, 3 * 4096 + 1,
                                    (1 << 20) + 123])
@pytest.mark.parametrize("store", [1, 2, 4, 7])
def test_store_cuts_whole_pages_and_copies_with_numpy(monkeypatch, nbytes,
                                                      store):
    """A tensor part is stored in pieces of whole pages, the first on the
    calling thread and each other on a helper, by numpy's copy; torch's
    copy (and its OpenMP team) is never used."""
    monkeypatch.setattr(dec, "STORE_THREADS", store)
    src = torch.from_numpy(np.random.default_rng(nbytes).integers(
        0, 256, nbytes, dtype=np.uint8))
    out = torch.zeros(nbytes + 10, dtype=torch.uint8)
    copies = []
    real = np.copyto

    def copyto(dst, s):
        copies.append((dst.ctypes.data, len(dst),
                       threading.current_thread().name))
        real(dst, s)

    def no_torch(*a, **k):
        raise AssertionError("the store copied with torch")

    monkeypatch.setattr(dec.np, "copyto", copyto)
    monkeypatch.setattr(torch.Tensor, "copy_", no_torch)
    monkeypatch.setattr(torch.Tensor, "__setitem__", no_torch)
    assert dec.store_part(src, out[5:5 + nbytes]) is None
    monkeypatch.undo()
    assert torch.equal(out[5:5 + nbytes], src)
    assert not out[:5].any() and not out[5 + nbytes:].any()
    copies.sort()
    sizes = [n for _, n, _ in copies]
    assert sum(sizes) == nbytes and len(copies) <= store
    assert all(n % 4096 == 0 for n in sizes[:-1])
    assert copies[0][2] == threading.current_thread().name
    assert all(name.startswith("aec-decode-help") for *_, name in copies[1:])


def test_every_stretch_is_touched_before_it_is_stored(monkeypatch):
    """The touch worker writes one byte of each page of the result (the
    whole RSIs) ahead of the store, and the store of a chunk waits for
    the touch of its stretch; the tail and the output are unchanged."""
    events, lock = [], threading.Lock()
    touch, store = dec.touch_pages, dec.store_part

    def touch_pages(view):
        with lock:
            events.append(("touch", view.ctypes.data, len(view),
                           threading.current_thread().name))
        time.sleep(0.02)  # a slow touch: the store must wait for it
        touch(view)
        with lock:
            events.append(("touched", view.ctypes.data, len(view), ""))

    def store_part(flat, dst):
        with lock:
            events.append(("store", dst.data_ptr(), dst.numel(), ""))
        return store(flat, dst)

    monkeypatch.setattr(dec, "touch_pages", touch_pages)
    monkeypatch.setattr(dec, "store_part", store_part)
    raw = make_raw(SMALL, 3 * CHUNK * SMALL.samples_per_rsi + 77, seed=12)
    comp = encode(raw, SMALL)
    assert torch_decode(comp, SMALL, len(raw), chunk_rsis=CHUNK) \
        == (AEC_OK, raw)
    touches = [e for e in events if e[0] == "touch"]
    base = touches[0][1]
    step = CHUNK * SMALL.rsi_len_bytes
    assert [(a - base, n) for _, a, n, _ in touches] == \
        [(k * step, step) for k in range(3)]
    assert {name.rsplit("_", 1)[0] for *_, name in touches} \
        == {"aec-decode-touch"}
    for i, (kind, addr, n, _) in enumerate(events):
        if kind == "store":
            done = {a for k, a, _, _ in events[:i] if k == "touched"}
            assert addr in done  # its stretch, one chunk each here


def test_numpy_parts_and_sinks_stay_on_the_calling_thread(monkeypatch):
    """decode_buffers' numpy parts are copied on the fetch worker alone,
    and the part_sink route returns bytes."""
    monkeypatch.setattr(dec, "STORE_THREADS", 4)
    src = np.arange(1 << 16, dtype=np.uint32).view(np.uint8)
    out = np.zeros_like(src)
    pool = dec._pipeline_pools().helpers
    monkeypatch.setattr(pool, "submit", lambda *a: pytest.fail("helper"))
    assert dec.store_part(src, out) is None
    assert np.array_equal(out, src)
    assert dec.store_part(torch.from_numpy(src), None) == src.tobytes()


def test_two_calls_run_on_the_same_workers_and_slots(monkeypatch):
    """The fill, fetch, touch and helper threads and the slots outlive a
    call: a second call's jobs run on the first call's threads and fill
    the first call's slots (none are made per call)."""
    seen = {"fill": set(), "store": set(), "slots": []}
    fill, store = dec.fill_chunk, dec.store_part

    def fill_chunk(data, cfg, slot, recs, tail_bit):
        seen["fill"].add(threading.get_ident())
        seen["slots"].append(id(slot))
        return fill(data, cfg, slot, recs, tail_bit)

    def store_part(flat, dst):
        seen["store"].add(threading.get_ident())
        return store(flat, dst)

    monkeypatch.setattr(dec, "fill_chunk", fill_chunk)
    monkeypatch.setattr(dec, "store_part", store_part)
    raw = make_raw(SMALL, 8 * CHUNK * SMALL.samples_per_rsi, seed=4)
    comp = encode(raw, SMALL)
    pools = dec._pipeline_pools()
    slots = []
    for _ in range(2):
        assert torch_decode(comp, SMALL, len(raw), chunk_rsis=CHUNK) \
            == (AEC_OK, raw)
        slots.append(set(seen["slots"]))
        seen["slots"].clear()
    assert dec._pipeline_pools() is pools
    assert len(seen["fill"]) == len(seen["store"]) == 1
    assert seen["fill"] != seen["store"]
    assert threading.get_ident() not in seen["fill"] | seen["store"]
    assert slots[1] <= slots[0]


def test_a_forked_child_makes_its_own_workers(monkeypatch):
    pools = dec._pipeline_pools()
    monkeypatch.setattr(dec.os, "getpid", lambda: -1)
    child = dec._pipeline_pools()
    assert child is not pools and dec._pipeline_pools() is child
    monkeypatch.undo()
    assert dec._pipeline_pools() is pools
    for p in (child.fill, child.fetch, child.touch, child.helpers):
        p.shutdown()
    del dec._POOLS[-1]


@pytest.mark.parametrize("step", ["fill_chunk", "store_part"])
def test_a_failed_worker_raises_and_leaves_no_job(monkeypatch, step):
    """A fill or store that fails raises from the call, and the call
    returns only once every job of it has ended (the jobs after the
    failure take a while)."""
    real = getattr(dec, step)
    started, ended = [], []

    def failing(*a):
        started.append(1)
        try:
            if len(started) == 2:
                raise ValueError(f"{step} failed")
            if len(started) > 2:
                time.sleep(0.05)
            return real(*a)
        finally:
            ended.append(1)

    monkeypatch.setattr(dec, step, failing)
    raw = make_raw(SMALL, 6 * CHUNK * SMALL.samples_per_rsi, seed=8)
    comp = encode(raw, SMALL)
    with pytest.raises(ValueError, match=step):
        torch_decode(comp, SMALL, len(raw), chunk_rsis=CHUNK)
    assert len(started) >= 2 and len(ended) == len(started)
    monkeypatch.undo()
    assert torch_decode(comp, SMALL, len(raw), chunk_rsis=CHUNK) \
        == (AEC_OK, raw)


def test_concurrent_calls_share_the_workers_and_slots():
    """More calls at once than cores, from threads, with a short switch
    interval: each result is its own stream's, and every slot a call
    held is back in the process's keep once all have returned."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    streams = []
    for seed in range((os.cpu_count() or 1) + 2):
        raw = make_raw(SMALL, (CHUNK + 1) * SMALL.samples_per_rsi + seed,
                       KINDS[seed % len(KINDS)], 100 + seed)
        streams.append((raw, encode(raw, SMALL)))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(len(streams)) as ex:
            futs = [ex.submit(torch_decode, comp, SMALL, len(raw),
                              chunk_rsis=CHUNK) for raw, comp in streams]
            got = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert got == [(AEC_OK, raw) for raw, _ in streams]
    kept = [s for k, v in dec._SLOTS.items() if k[0] == os.getpid()
            for s in v]
    assert len(kept) == len({id(s) for s in kept}) >= 2


def test_the_step_timers_find_every_step():
    """chip_smoke.decode_timers (and bench_torch/run.py through it) times
    each of the decode's steps by its name in the module: all nine and
    the touch worker's are there, and each is wrapped inside the context
    and put back after it."""
    import chip_smoke

    names = ["scan_chunk", "fill_chunk", "stage_chunk", "decode_chunk",
             "fetch_chunk", "store_part", "finish", "scan_stream",
             "fill_part", "touch_pages"]
    before = {n: getattr(dec, n) for n in names}
    with chip_smoke.decode_timers():
        assert all(getattr(dec, n) is not before[n] for n in names)
    assert all(getattr(dec, n) is before[n] for n in names)
