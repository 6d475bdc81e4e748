#!/usr/bin/env python3
"""Time kernels 4, 5 and 6 of libaec_tpu_torch under other tuning constants.

    python3 tools/tune_unpredict_scan.py SCAN_REPAIRS=3 AHEAD=2,SCAN_REPAIRS=3
    python3 tools/tune_unpredict_scan.py --fused-only SKIP_STEP=1 SKIP_STEP=2

Needs one NVIDIA GPU and nvcc.  `--fused-only` times kernel 6 (and kernels
3 + 4 beside it) alone.  Each other argument is one variant: a list of
NAME=VALUE for the `constexpr int` constants of libaec_tpu_torch/csrc
(SCAN_V, SCAN_REPAIRS in unpredict_step.cuh; AHEAD in unpredict.cu;
FUSED_WARPS, MAX_CHAINERS, SLAB_GROUPS, BLOCKS_PER_SM, SKIP_STEP in
decode_fused.cu); the sources as they are always run first.  A variant is
built from a patched copy of the package in a temporary directory, in a
process of its own, and timed at the decode path's chunk (512 RSIs of
16384 samples, 16-bit MSB and 24-bit 3-byte).  Kernels 4 and 5 run on the
deltas of `lowentropy`, `midentropy` and `random` samples (tests/gen.py);
kernel 6, beside kernels 3 + 4 on the same inputs, on the scanned streams
of a random walk and of those three kinds, and of 4096 short RSIs of
13-bit signed samples (16 RSIs a thread block), of every kind and of
`lowentropy` alone, at each chunk's own window width.  Times are median
CUDA-event milliseconds of 20 runs after 3 warm-ups, in three sweeps over
the variants in turn; the median of the sweeps is printed with each
sweep's time.  The kernels' outputs must not
differ between variants (SKIP_STEP leaves a step of kernel 6 out to time
the other alone: its outputs are not compared).
"""
import hashlib
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def timed(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return out, statistics.median(s.elapsed_time(e) for s, e in pairs)


def run(label, fused_only):
    """Time the package that PYTHONPATH names (a patched copy)."""
    import numpy as np
    import torch

    sys.path.append(str(ROOT / "tests"))
    import gen

    from libaec_tpu_torch import (AEC_DATA_3BYTE, AEC_DATA_MSB,
                                  AEC_DATA_PREPROCESS, Config)
    from libaec_tpu_torch.kernels import unpredict_cuda
    from libaec_tpu_torch.ops import preprocess
    from libaec_tpu_torch.ops.u32 import to_bits

    device = torch.device("cuda", 0)
    pp, msb = AEC_DATA_PREPROCESS, AEC_DATA_MSB
    digest = hashlib.sha256()
    for name, cfg in () if fused_only else (
            ("16-bit", Config(16, 64, 256, msb | pp)),
            ("24-bit 3-byte", Config(24, 64, 256, msb | pp | AEC_DATA_3BYTE))):
        rng = np.random.default_rng(74)
        S, n_rsi = cfg.samples_per_rsi, (8 << 20) // cfg.samples_per_rsi
        for kind in ("lowentropy", "midentropy", "random"):
            raw = torch.from_numpy(gen.gen_values(
                rng, n_rsi * S, cfg.bits_per_sample, False, kind).astype(
                    np.int64)).view(n_rsi, S).to(device)
            d64, ref = preprocess.delta_map(raw, cfg)
            d64[:, 0] = ref
            d = to_bits(d64)
            out4, ms4 = timed(
                torch, lambda: unpredict_cuda.unpredict_swizzle(cfg, d))
            out5, ms5 = timed(
                torch, lambda: unpredict_cuda.unpredict_rsis(cfg, d))
            lay, ms_l = timed(
                torch, lambda: unpredict_cuda.samples_to_bytes(cfg, out5))
            for t in (out4, out5, lay):
                digest.update(t.cpu().numpy().tobytes())
            print(f"tune [{label}] {name} {kind}: unpredict_swizzle "
                  f"ms={ms4:.4f} unpredict_rsis ms={ms5:.4f} "
                  f"samples_to_bytes ms={ms_l:.4f}", flush=True)
    run_fused(label, torch, device, digest)
    print(f"tune [{label}] outputs sha256={digest.hexdigest()[:16]}",
          flush=True)


def run_fused(label, torch, device, digest):
    """Kernel 6 and kernels 3 + 4 on four scanned chunks of the bench
    config and two of many short RSIs."""
    import importlib.util

    import gen
    import numpy as np

    from libaec_tpu_torch import (AEC_DATA_MSB, AEC_DATA_PREPROCESS,
                                  AEC_DATA_SIGNED, Config, native)
    from libaec_tpu_torch.decode import scan_record_arrays
    from libaec_tpu_torch.kernels import (decode_cuda, decode_fused_cuda,
                                          unpredict_cuda)
    from libaec_tpu_torch.ops.u32 import u32_to_bits

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    cfg = Config(16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS)
    S, n_rsi = cfg.samples_per_rsi, (8 << 20) // cfg.samples_per_rsi
    rng = np.random.default_rng(76)
    short = Config(13, 32, 64, AEC_DATA_SIGNED | AEC_DATA_PREPROCESS
                   | AEC_DATA_MSB)
    chunks = [("walk2", cfg, chip_smoke.walk_data(cfg, n_rsi, 62, 2))] + [
        (kind, cfg, chip_smoke.pack_samples(gen.gen_values(
            rng, n_rsi * S, 16, False, kind), 16, cfg.flags))
        for kind in ("lowentropy", "midentropy", "random")] + [
        ("short RSIs, all kinds", short,
         chip_smoke.chunk_data(short, 4096, 13)),
        ("short RSIs, lowentropy", short, chip_smoke.pack_samples(
            gen.gen_values(rng, 4096 * short.samples_per_rsi, 13, True,
                           "lowentropy"), 13, short.flags))]
    for name, cfg, raw in chunks:
        S, n_rsi = cfg.samples_per_rsi, len(raw) // cfg.rsi_len_bytes
        comp, recs, wf = chip_smoke.scanned_chunk(cfg, raw)
        recs["win"] = native.fill_windows(comp, recs["fs_off"], recs["meta"],
                                          wf)
        args = [u32_to_bits(a).to(device) for a in scan_record_arrays(recs)]
        out6, ms6 = timed(
            torch, lambda: decode_fused_cuda.decode_unpredict_swizzle(
                cfg, *args, n_rsi))
        out34, ms34 = timed(
            torch, lambda: unpredict_cuda.unpredict_swizzle(
                cfg, decode_cuda.decode_blocks(cfg, *args).view(n_rsi, S)))
        right = torch.equal(out6, out34)
        if "SKIP_STEP" not in label:
            digest.update(out6.cpu().numpy().tobytes())
        print(f"tune [{label}] fused {name} Wf={wf}: decode_fused "
              f"ms={ms6:.4f} kernels_3_4 ms={ms34:.4f} "
              f"identical={right}", flush=True)


def patched_copy(tmp, variant):
    """A copy of the package under tmp with the variant's constants."""
    dst = Path(tmp) / (re.sub(r"\W", "_", variant) or "as_is")
    shutil.copytree(ROOT / "libaec_tpu_torch", dst / "libaec_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    for item in filter(None, variant.split(",")):
        name, value = item.split("=")
        hits = 0
        for src in (dst / "libaec_tpu_torch" / "csrc").glob("*.cu*"):
            text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{int(value)};", src.read_text())
            if n:
                src.write_text(text)
                hits += n
        if hits != 1:
            raise SystemExit(f"{name}: {hits} definitions found, expected 1")
    return dst


def main():
    fused_only = "--fused-only" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--fused-only"]
    if len(args) == 2 and args[0] == "--run":
        return run(args[1], fused_only)
    variants = ["", *args]
    times = {}  # (variant, input, kernel) -> [ms of each sweep]
    sums = set()
    with tempfile.TemporaryDirectory() as tmp:
        copies = [(v or "as is", patched_copy(tmp, v)) for v in variants]
        for _ in range(3):
            for label, path in copies:
                out = subprocess.run(
                    [sys.executable, __file__, "--run", label,
                     *(["--fused-only"] if fused_only else [])], check=True,
                    env={**os.environ, "PYTHONPATH": str(path)},
                    capture_output=True, text=True).stdout
                for line in out.splitlines():
                    found = re.match(r"tune \[.*?\] (.*?): (.*)", line)
                    if found:
                        for kernel, ms in re.findall(r"(\w+) ms=([\d.]+)",
                                                     found.group(2)):
                            times.setdefault((label, found.group(1), kernel),
                                             []).append(float(ms))
                    if "SKIP_STEP" not in label:
                        sums.update(re.findall(r"sha256=(\w+)", line))
    for (label, data, kernel), ms in times.items():
        print(f"tune [{label}] {data} {kernel}: median_ms="
              f"{statistics.median(ms):.4f} sweeps="
              f"{' '.join(f'{m:.4f}' for m in ms)}")
    print(f"tune outputs identical across variants: {len(sums) == 1}")
    if len(sums) != 1:
        raise SystemExit("the variants' outputs differ")


if __name__ == "__main__":
    main()
