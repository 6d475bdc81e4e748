#!/usr/bin/env python3
"""Time what one stream's decode does to host memory: the first touch of
a new result's pages, and copies into and out of pinned memory.

    python3 tools/host_pages.py [MIB]

For MIB (default 256, cell bench16-field-256MiB's output) it times, in
turns over 7 rounds, and prints the median and quartiles in ms of:

  * touch_T: a new HostBytes (libaec_tpu_torch/hostbytes.py) of MIB,
    one byte of every page written, over T threads (1, 2, 4): the first
    touch alone, and whether it scales with threads;
  * populate: a new HostBytes, its whole pages populated by one
    madvise(MADV_POPULATE_WRITE) (Linux 5.14; "refused" where the kernel
    refuses it);
  * store_T: a new HostBytes filled from a pinned buffer over T numpy
    copies on T threads (1, 4), as the decode's store;
  * store_warm_4: the same into a buffer whose pages were touched
    before (the copy without the first touch);
  * into_pinned_T / into_pageable_T: MIB copied over T threads (1, 4)
    into a pinned buffer, and into a pageable one touched before, from
    pageable memory (the fill writes its windows into pinned memory).

Each copy is checked.  Without a card, pinned buffers are plain host
memory.  It prints the host's cores first.
"""
import ctypes
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from libaec_tpu_torch.hostbytes import HostBytes  # noqa: E402

MIB = 1 << 20
PAGE = 4096
MADV_POPULATE_WRITE = 23
POOL = ThreadPoolExecutor(4)


def split(n, t):
    step = -(-n // (t * PAGE)) * PAGE
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def on_threads(fn, n, t):
    """fn(piece) over t pieces of range(n), at once on t threads."""
    parts = split(n, t)
    futs = [POOL.submit(fn, p) for p in parts[1:]]
    fn(parts[0])
    for f in futs:
        f.result()


def populate(view):
    libc = ctypes.CDLL(None, use_errno=True)
    libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    lo = -(-view.data_ptr() // PAGE) * PAGE
    hi = (view.data_ptr() + view.numel()) // PAGE * PAGE
    if libc.madvise(lo, hi - lo, MADV_POPULATE_WRITE):
        raise OSError(ctypes.get_errno(), "madvise(MADV_POPULATE_WRITE)")


def main(argv):
    mib = int(argv[0]) if argv else 256
    n = mib * MIB
    card = torch.cuda.is_available()
    src = torch.from_numpy(np.random.default_rng(mib).integers(
        0, 256, n, dtype=np.uint8))
    pinned = src.pin_memory() if card else src.clone()
    pin_dst = torch.empty(n, dtype=torch.uint8, pin_memory=card)
    pin_dst.numpy()[:] = 1
    page_dst = np.ones(n, np.uint8)
    warm = HostBytes(n)
    warm.view.numpy()[::PAGE] = 0
    s, p = src.numpy(), pinned.numpy()
    print(f"host_pages cores={os.cpu_count()} card="
          f"{torch.cuda.get_device_name(0) if card else 'none'} mib={mib}")

    def touch(t):
        def way():
            out = HostBytes(n)
            v = out.view.numpy()
            on_threads(lambda sl: v[sl][::PAGE].fill(0), n, t)
            return None
        return way

    def populated():
        out = HostBytes(n)
        populate(out.view)

    def store(t, dst=None):
        def way():
            hold = HostBytes(n) if dst is None else None  # alive till checked
            out = dst if hold is None else hold.view.numpy()
            on_threads(lambda sl: np.copyto(out[sl], p[sl]), n, t)
            return out, hold
        return way

    def into(dst, t):
        def way():
            on_threads(lambda sl: np.copyto(dst[sl], s[sl]), n, t)
            return dst, None
        return way

    ways = {f"touch_{t}": touch(t) for t in (1, 2, 4)}
    ways["populate"] = populated
    ways.update({f"store_{t}": store(t) for t in (1, 4)})
    ways["store_warm_4"] = store(4, warm.view.numpy())
    for t in (1, 4):
        ways[f"into_pinned_{t}"] = into(pin_dst.numpy(), t)
        ways[f"into_pageable_{t}"] = into(page_dst, t)
    ms = {name: [] for name in ways}
    for rnd in range(7):
        names = list(ways) if rnd % 2 == 0 else list(ways)[::-1]
        for name in names:
            if name == "populate" and ms[name] is None:
                continue
            t0 = time.perf_counter()
            try:
                got = ways[name]()
            except OSError as e:
                print(f"host_pages {name} refused: {e}")
                ms[name] = None
                continue
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if got is not None:
                want = p if name.startswith("store") else s
                if not np.array_equal(got[0], want):
                    raise SystemExit(f"{name}: wrong copy")
            del got
    for name, xs in ms.items():
        if xs:
            q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
            print(f"host_pages mib={mib} {name} median_ms={q2:.3f} "
                  f"q1={q1:.3f} q3={q3:.3f} n={len(xs)}")


if __name__ == "__main__":
    main(sys.argv[1:])
