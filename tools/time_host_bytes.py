#!/usr/bin/env python3
"""Time the host end of an entry point's result: N bytes from pinned
memory into the `bytes` object handed back.

    python3 tools/time_host_bytes.py [MIB ...]

For each size (default 180 and 256 MiB: cell bench16-field-256MiB's
stream and decoded output) it times, in turns over 10 rounds, and prints
the median and quartiles in ms of:

  * empty_tobytes: torch.empty, copy_ from pinned memory, tobytes()
    (what decode did before its results were written in place);
  * hostbytes:     HostBytes (libaec_tpu_torch/hostbytes.py), copy_ into
    its view, take() at the full size;
  * hostbytes_cut: the same at 1.4 x the size, cut by take() (encode's
    upper bound and its cut in place);
  * hostbytes_huge: as hostbytes, its range first advised to the kernel
    as huge pages (madvise MADV_HUGEPAGE), so that the first touch
    faults once per 2 MiB instead of once per 4 KiB.

Each result is checked against the source.  It prints the kernel's
transparent huge page setting and torch's thread count first.  The
source is pinned when a card is present (as the entry points' staging
is), plain host memory otherwise.
"""
import ctypes
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from libaec_tpu_torch.hostbytes import HostBytes  # noqa: E402

MIB = 1 << 20
MADV_HUGEPAGE = 14
HUGE = 2 * MIB


def advise_huge(view):
    """madvise(MADV_HUGEPAGE) over the 2 MiB pages inside view."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    start = view.data_ptr()
    lo = -(-start // HUGE) * HUGE
    hi = (start + view.numel()) // HUGE * HUGE
    if hi > lo and libc.madvise(lo, hi - lo, MADV_HUGEPAGE):
        raise OSError(ctypes.get_errno(), "madvise")


def empty_tobytes(src):
    out = torch.empty(src.numel(), dtype=torch.uint8)
    out.copy_(src)
    return out.numpy().tobytes()


def hostbytes(src, scale=1.0, huge=False):
    out = HostBytes(int(src.numel() * scale))
    if huge:
        advise_huge(out.view)
    out.view[:src.numel()].copy_(src)
    return out.take(src.numel())


WAYS = {"empty_tobytes": empty_tobytes, "hostbytes": hostbytes,
        "hostbytes_cut": lambda s: hostbytes(s, 1.4),
        "hostbytes_huge": lambda s: hostbytes(s, huge=True)}


def main(argv):
    sizes = [int(a) for a in argv] or [180, 256]
    thp = Path("/sys/kernel/mm/transparent_hugepage/enabled")
    print(f"thp {thp.read_text().strip() if thp.exists() else 'absent'} | "
          f"torch threads {torch.get_num_threads()} | card "
          f"{torch.cuda.get_device_name(0) if torch.cuda.is_available() else 'none'}")
    for mib in sizes:
        src = torch.from_numpy(np.random.default_rng(mib).integers(
            0, 256, mib * MIB, dtype=np.uint8))
        if torch.cuda.is_available():
            src = src.pin_memory()
        want = src.numpy().tobytes()
        ms = {name: [] for name in WAYS}
        for rnd in range(10):
            names = list(WAYS) if rnd % 2 == 0 else list(WAYS)[::-1]
            for name in names:
                t0 = time.perf_counter()
                got = WAYS[name](src)
                ms[name].append((time.perf_counter() - t0) * 1e3)
                if type(got) is not bytes or got != want:
                    raise SystemExit(f"{name}: wrong result")
                del got
        for name, xs in ms.items():
            q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
            print(f"host_bytes mib={mib} {name} median_ms={q2:.3f} "
                  f"q1={q1:.3f} q3={q3:.3f} n={len(xs)}")


if __name__ == "__main__":
    main(sys.argv[1:])
