#!/usr/bin/env python3
"""Time a codec cell's single-stream decode before and after one change to
the process or to the decode's host pipeline, in one process.

    python3 tools/decode_store_variants.py DIR VARIANT [--cell NAME]
                                           [--reps N] [--seed N]
                                           [--device D] [--mib M] [--out F]
                                           [--data-cache DIR]

from the repository root.  DIR holds the libaec_tpu_torch to time (`git
archive <commit> libaec_tpu_torch | tar -x -C DIR`); this tree's
bench_torch makes the cell's data (bench16-field-256MiB by default; --mib
cuts it, for a dry run on the CPU with --device cpu; --data-cache keeps
the data and its stream in DIR for the next process).  Nothing is
encoded on the card unless the variant says so.

The process decodes the cell's stream (decode_buffer_status, the output
checked against the input) once untimed and N times timed (default 8),
each call with chip_smoke.decode_timers, keeping each call's output until
the next returns, as the runner's steps do: phase `before`.  Then it
applies VARIANT and runs the same calls again: phase `after`.  It prints
and writes, for each phase, the median MiB/s of the calls and the median
ms of each host step a call (walk `scan_main`, fill `fill_fill`, store
`store_fetch`, ...).  `none` changes nothing (the drift between two
phases of one process).  The variants isolate what could make a later
store faster than an earlier one:

  * one-way changes to the process, made on the calling thread:
    `plain_tail` (kernels 1 and 2's plain versions on one short RSI, in
    torch's CPU ops, as the short last RSI of an encode ran before it
    went to the card), `torch_op` (one parallel torch CPU op on 64 KiB),
    `malloc_free` (16 MiB from malloc, freed untouched: glibc then
    serves blocks up to that size from its heap instead of mmap),
    `encode_once` (one encode_buffer of the cell on the card, dropped);
  * changes to the pipeline, patched into the DIR's decode module:
    `lasting_threads` (the fill and fetch executors outlive the call),
    `prefault` (every page of the result written once on the calling
    thread before the pipeline starts), `populate_ahead` (the same by one
    madvise(MADV_POPULATE_WRITE)), `populate_store` (each part's pages
    populated so by the store before its copy), `store_threads_N` (torch's
    thread count on the fetch thread set to N), `store_numpy` (the store
    as one numpy copy on the fetch thread), `fill_threads_N`
    (native.fill_windows given N threads; on a tree that cuts the fill
    into decode.FILL_THREADS pieces, one piece), `fill_split_N` (such a
    tree: N pieces), `store_split_N` (a tree whose store is cut into
    decode.STORE_THREADS pieces: N of them), `no_touch` (a tree whose
    touch worker touches the result's pages ahead of the store
    (decode.touch_pages): nothing touched).

A variable of the environment that libgomp reads at start, such as
OMP_WAIT_POLICY=PASSIVE, applies to both phases: compare it with
`none` in processes without it.

Imports neither jax nor the JAX package.
"""
import argparse
import gc
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CELL = "bench16-field-256MiB"
MIB = 1 << 20


class _Lasting:
    """Stands in for ThreadPoolExecutor(1) in the decode module: the n-th
    pool a call opens is the same executor in every call, and leaving
    the `with` leaves its thread running."""

    def __init__(self):
        self.pools, self.opened = [], 0

    def __call__(self, workers):
        if self.opened == len(self.pools):
            self.pools.append(ThreadPoolExecutor(workers))
        self.opened += 1
        return self

    def __enter__(self):
        return self.pools[self.opened - 1]

    def __exit__(self, *exc):
        self.opened -= 1
        return False


def populate(view):
    """The whole pages of a uint8 tensor populated for writing by one
    madvise(MADV_POPULATE_WRITE) (Linux 5.14), instead of a fault a page
    at its first write."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    lo = -(-view.data_ptr() // 4096) * 4096
    hi = (view.data_ptr() + view.numel()) // 4096 * 4096
    if hi > lo and libc.madvise(lo, hi - lo, 23):
        raise OSError(ctypes.get_errno(), "madvise(MADV_POPULATE_WRITE)")


class _Native:
    """The decode module's native library with fill_windows' thread count
    fixed."""

    def __init__(self, native, threads):
        self._native, self._threads = native, threads

    def __getattr__(self, name):
        return getattr(self._native, name)

    def fill_windows(self, data, fs_off, meta, wf, threads=None, win=None):
        return self._native.fill_windows(data, fs_off, meta, wf,
                                         self._threads, win)


def variants(ctx):
    """{name: function applying it} for the cell's context."""
    import torch

    import libaec_tpu_torch as lt
    from libaec_tpu_torch import decode as mod

    def plain_tail():
        cfg, raw = ctx["cfg"], ctx["raw"]
        short = raw[:cfg.rsi_len_bytes * 3 // 2]
        lt.encode_buffer(short, cfg, device="cpu", force_device=True)

    def torch_op():
        torch.ones(1 << 16, dtype=torch.uint8).add_(1)

    def malloc_free():
        del_me = np.empty(16 * MIB, np.uint8)
        del del_me

    def encode_once():
        lt.encode_buffer(ctx["raw"], ctx["cfg"], device=ctx["device"],
                         force_device=True)
        gc.collect()

    def lasting_threads():
        mod.ThreadPoolExecutor = _Lasting()

    def prefault():
        class Touched(mod.HostBytes):
            def __init__(self, n):
                super().__init__(n)
                self.view.numpy()[::4096] = 0
        mod.HostBytes = Touched

    def store_threads(n):
        seen = set()
        store = mod.store_part

        def store_part(flat, dst):
            import threading
            if threading.get_ident() not in seen:
                seen.add(threading.get_ident())
                torch.set_num_threads(n)
            return store(flat, dst)
        return lambda: setattr(mod, "store_part", store_part)

    def store_numpy():
        def store_part(flat, dst):
            if dst is None:
                return flat.numpy().tobytes()
            np.copyto(dst.numpy(), flat.numpy())
            return None
        mod.store_part = store_part

    def fill_threads(n):
        def apply():
            if hasattr(mod, "FILL_THREADS"):
                mod.FILL_THREADS = 1  # the native split alone
            mod._native = _Native(mod._native, n)
        return apply

    def fill_split(n):
        def apply():
            if not hasattr(mod, "FILL_THREADS"):
                raise SystemExit(f"{mod.__file__} has no FILL_THREADS")
            mod.FILL_THREADS = n
        return apply

    def no_touch():
        if not hasattr(mod, "touch_pages"):
            raise SystemExit(f"{mod.__file__} has no touch_pages")
        mod.touch_pages = lambda view: None

    def populate_store():
        store = mod.store_part

        def store_part(flat, dst):
            if isinstance(dst, torch.Tensor):
                populate(dst)
            return store(flat, dst)
        mod.store_part = store_part

    def populate_ahead():
        class Populated(mod.HostBytes):
            def __init__(self, n):
                super().__init__(n)
                populate(self.view)
        mod.HostBytes = Populated

    def store_split(n):
        def apply():
            if not hasattr(mod, "STORE_THREADS"):
                raise SystemExit(f"{mod.__file__} has no STORE_THREADS")
            mod.STORE_THREADS = n
        return apply

    out = {"none": lambda: None, "plain_tail": plain_tail,
           "torch_op": torch_op, "malloc_free": malloc_free,
           "encode_once": encode_once, "lasting_threads": lasting_threads,
           "prefault": prefault, "store_numpy": store_numpy,
           "populate_store": populate_store,
           "populate_ahead": populate_ahead}
    for n in (1, 2, 4):
        out[f"store_threads_{n}"] = store_threads(n)
    for n in FILL_THREADS:
        out[f"fill_threads_{n}"] = fill_threads(n)
        out[f"fill_split_{n}"] = fill_split(n)
    out["no_touch"] = no_touch
    for n in STORE_SPLITS:
        out[f"store_split_{n}"] = store_split(n)
    return out


FILL_THREADS = (1, 2, 3, 4, 8)
STORE_SPLITS = (1, 2, 3, 4, 6, 8)
NAMES = ["none", "plain_tail", "torch_op", "malloc_free", "encode_once",
         "lasting_threads", "prefault", "store_numpy", "populate_store",
         "populate_ahead"] \
    + [f"store_threads_{n}" for n in (1, 2, 4)] \
    + [f"fill_threads_{n}" for n in FILL_THREADS] \
    + [f"fill_split_{n}" for n in FILL_THREADS] \
    + [f"store_split_{n}" for n in STORE_SPLITS] + ["no_touch"]


def phase(decode, body, reps):
    """One untimed call and reps timed ones: (MiB/s, {step: ms}) a call.
    Beside the decode's steps, the fill's two parts: `fill_bucket`
    (bitunpack.bucket_wf) and `fill_windows` (native.fill_windows)."""
    import chip_smoke
    from libaec_tpu_torch import native
    from libaec_tpu_torch.ops import bitunpack

    calls, out = [], None
    saved = bitunpack.bucket_wf, native.fill_windows
    for rep in range(reps + 1):
        with chip_smoke.decode_timers() as spent:
            def timed(key, fn):
                def run(*a, **k):
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **k)
                    finally:
                        spent[key] += time.perf_counter() - t0
                return run
            bitunpack.bucket_wf = timed("fill_bucket", saved[0])
            native.fill_windows = timed("fill_windows", saved[1])
            try:
                t0 = time.perf_counter()
                out = decode()  # the last output is held until this returns
                secs = time.perf_counter() - t0
            finally:
                bitunpack.bucket_wf, native.fill_windows = saved
        if out != (0, body):
            raise SystemExit("decode differs from the input")
        if rep:
            calls.append((len(body) / secs / MIB,
                          {k: v * 1e3 for k, v in spent.items()}))
    steps = sorted({k for _, s in calls for k in s})
    return {"decode_mibs_median": statistics.median(c[0] for c in calls),
            "decode_mibs": [c[0] for c in calls],
            "host_ms_median": {k: statistics.median(s.get(k, 0.0)
                                                    for _, s in calls)
                               for k in steps}}


def cell_data(args, kw, cfg, nbytes, data, native):
    """The cell's data and its native stream, from --data-cache when an
    earlier process left them there."""
    cache = Path(args.data_cache) if args.data_cache else None
    stem = f"{args.cell}_{args.seed}_{nbytes}"
    if cache and (cache / f"{stem}.raw").exists():
        return ((cache / f"{stem}.raw").read_bytes(),
                (cache / f"{stem}.rz").read_bytes())
    raw = data.MAKERS[kw["kind"]](cfg, nbytes, args.seed)
    comp = native.encode(raw, cfg)[1]
    if cache:
        cache.mkdir(parents=True, exist_ok=True)
        (cache / f"{stem}.rz").write_bytes(comp)
        (cache / f"{stem}.raw").write_bytes(raw)
    return raw, comp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", help="directory holding libaec_tpu_torch")
    ap.add_argument("variant", choices=NAMES)
    ap.add_argument("--cell", default=CELL)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mib", type=float, help="cut the cell's data to M MiB")
    ap.add_argument("--out")
    ap.add_argument("--data-cache", help="keep the data and stream here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.dir).resolve()))
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("decode_store_variants: no CUDA device available",
              file=sys.stderr)
        return 1
    import libaec_tpu_torch as lt
    from bench_torch import data, run
    from libaec_tpu_torch import native

    where = Path(lt.__file__).resolve().parent.parent
    if where != Path(args.dir).resolve():
        raise SystemExit(f"libaec_tpu_torch came from {where}")
    kw = run.CELLS[args.cell][1]
    cfg = run.codec(data.load_config(kw["config"]))
    nbytes = int(args.mib * MIB) if args.mib else kw["nbytes"]
    raw, comp = cell_data(args, kw, cfg, nbytes, data, native)
    body = raw[:len(raw) // cfg.bytes_per_sample * cfg.bytes_per_sample]
    device = torch.device(args.device)
    ctx = {"cfg": cfg, "raw": raw, "device": device}

    def decode():
        return lt.decode_buffer_status(comp, cfg, len(body), device=device,
                                       force_device=True)

    res = {"cell": args.cell, "variant": args.variant, "tree": args.dir,
           "bytes": len(body), "torch_threads": torch.get_num_threads(),
           "before": phase(decode, body, args.reps)}
    t0 = time.perf_counter()
    variants(ctx)[args.variant]()
    res["apply_ms"] = (time.perf_counter() - t0) * 1e3
    res["after"] = phase(decode, body, args.reps)
    for side in ("before", "after"):
        r = res[side]
        host = " ".join(f"{k}={v:.2f}" for k, v in r["host_ms_median"].items())
        print(f"dsv [{args.dir} {args.variant} {args.cell} {side}] "
              f"decode_mibs_median={r['decode_mibs_median']:.2f} | {host}",
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
