#!/usr/bin/env python3
"""Time kernels 2, 3 and 6 of libaec_tpu_torch for checkouts and variants.

    python3 tools/time_decode_merge.py [--only merge|decode]
        [CHECKOUT | NAME=VALUE[,...] | KNOCKOUT[,...]] ...

Needs one NVIDIA GPU and nvcc.  Each argument is a version to time: a
directory that holds a `libaec_tpu_torch` package (an older commit
unpacked by `git archive <commit> libaec_tpu_torch | tar -x -C DIR`), or
a list of NAME=VALUE for the `constexpr int` constants of this
repository's csrc/ (BLOCKS_PER_WARP and WARPS in decode.cu,
SKIP_STEP in decode_fused.cu, ...) and of knock-outs (KNOCKOUTS below:
a kernel with one phase left out, to time the rest), built from a patched
copy.  This repository as it is always runs too.  Each version is built
and run in a process of its own, the versions in turn and then in reverse
turn, so that versions are compared on one card within one call.
`--only` times one of the two parts.  Per version it prints:
  - kernel 2 (merge_cuda.merge_windows) at the encode path's chunk (1024
    RSIs of the bench config, NB 262144) on the windows kernel 1 makes of
    samples of every tests/gen.py kind, of `lowentropy` and of
    `midentropy` samples: the median over bit0 0..7 of each bit0's median
    CUDA-event ms (20 runs after 3 warm-ups), and the profiler's mean
    device ms of a call and of each kernel it launches (20 calls in one
    trace);
  - kernel 3 (decode_cuda.decode_blocks) at the decode path's chunk (512
    RSIs, NB 131072) of random walks and of every kind, at each window
    width the path can choose: event ms and device ms;
  - kernel 6 and kernels 3 + 4 on the same inputs, and on a chunk of
    block 10 and one of 4096 short RSIs: event ms.
Then the medians of each row over the sweeps.  The outputs (kernel 2's
used prefix and tail, kernel 3's deltas, kernel 6's bytes) must not
differ between versions; versions with a knock-out or a SKIP_ constant
are not compared.
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

# knock-outs: name -> (file in csrc/, text, the text that replaces it)
KNOCKOUTS = {
    # kernel 3 without its parse: the records loaded, zeros stored
    "skip_parse": ("decode.cu", "        decode_block(win + blk * wf,",
                   "        if (0) decode_block(win + blk * wf,"),
    # kernel 2 without its words: the tile sums, the tile's prefix and
    # the tail (one word a tile keeps them live)
    "skip_gather": (
        "merge.cu",
        "    // the last word reaches past the tile's bits",
        "    if (tid == 0 && lo < nwords) words[lo] = (uint32_t)hi;\n"
        "    return;\n"
        "    // the last word reaches past the tile's bits"),
    # kernel 2 without the sum of the earlier tiles' sums (taken as 0)
    "skip_prefix": ("merge.cu", "i < t; i += TILE) before += sums[i]",
                    "i < 0; i += TILE) before += sums[i]"),
    # kernel 2's gather without its window loads (the search and the walk
    # over the blocks of a word kept)
    "skip_windows": ("merge.cu",
                     "v |= window_part(win, b0 + j, w, x + 32 - s_start[j]);",
                     "v |= (uint32_t)(x + 32 - s_start[j]);"),
    # kernel 2 without warp 0's gather of a tile's last word
    "skip_spill": ("merge.cu", "const bool spill = !last_tile",
                   "const bool spill = false && !last_tile"),
}


def compared(label):
    """Whether a version computes the real outputs."""
    return "skip_" not in label.lower()


def load_chip_smoke():
    """This repository's chip_smoke.py (its helpers), whatever package
    PYTHONPATH puts first."""
    import importlib.util

    sys.path.append(str(ROOT / "tests"))  # tests/gen.py, for its data
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(label, only):
    """Time the package that PYTHONPATH names: kernel 2, kernels 3 and 6,
    or both (`only` None)."""
    import torch

    cs = load_chip_smoke()

    from libaec_tpu_torch import AEC_DATA_MSB, AEC_DATA_PREPROCESS, Config

    device = torch.device("cuda", 0)
    bench = Config(16, 64, 256, AEC_DATA_MSB | AEC_DATA_PREPROCESS)
    digest = hashlib.sha256()

    def row(name, **ms):
        print(f"time [{label}] {name}: "
              + " ".join(f"{k} ms={v:.4f}" for k, v in ms.items()),
              flush=True)

    if only != "decode":
        time_merge(cs, bench, device, row, digest)
    if only != "merge":
        time_decode(cs, bench, device, row, digest, label)
    print(f"time [{label}] outputs sha256={digest.hexdigest()[:16]}",
          flush=True)


def time_merge(cs, bench, device, row, digest):
    """Kernel 2 at the encode path's chunk."""
    import numpy as np
    import torch

    from libaec_tpu_torch.encode import default_rsis_per_chunk
    from libaec_tpu_torch.kernels import encode_cuda, merge_cuda

    n_enc = default_rsis_per_chunk(bench)
    k0 = torch.tensor([3], dtype=torch.int32, device=device)
    raw = torch.from_numpy(np.frombuffer(
        cs.chunk_data(bench, n_enc, seed=n_enc + 16), np.uint8).copy())
    inputs = [("all kinds", encode_cuda.encode_fields(
        bench, raw.to(device), k0)[:2])]
    del raw
    for seed, kind in enumerate(("lowentropy", "midentropy")):
        inputs.append((kind, cs.kind_windows(bench, n_enc, kind, 40 + seed,
                                             device)))
    for name, (win, block_bits) in inputs:
        nwords = merge_cuda.word_count(bench, win.shape[0], win.shape[1] - 1)
        times = []
        for bit0 in range(8):
            b0 = torch.tensor([bit0], dtype=torch.int64, device=device)
            (words, tail), ms = cs.timed(lambda: merge_cuda.merge_windows(
                win, block_bits, b0, nwords), 20)
            used = (int(tail[0]) + 63) // 32
            digest.update(words[:used].cpu().numpy().tobytes())
            digest.update(tail.cpu().numpy().tobytes())
            times.append(ms)
        passes = cs.pass_times(name, lambda: merge_cuda.merge_windows(
            win, block_bits, b0, nwords))
        row(f"merge_windows {name} NB={win.shape[0]}",
            merge_windows=statistics.median(times),
            merge_windows_device=sum(passes.values()),
            **{f"{kernel}_device": ms for kernel, ms in passes.items()})


def time_decode(cs, bench, device, row, digest, label):
    """Kernels 3, 6 and 3 + 4 at the decode path's chunk."""
    from libaec_tpu_torch import (AEC_DATA_MSB, AEC_DATA_PREPROCESS,
                                  AEC_DATA_SIGNED, AEC_NOT_ENFORCE, Config,
                                  native)
    from libaec_tpu_torch.decode import scan_record_arrays
    from libaec_tpu_torch.kernels import (decode_cuda, decode_fused_cuda,
                                          unpredict_cuda)
    from libaec_tpu_torch.ops import bitunpack
    from libaec_tpu_torch.ops.u32 import u32_to_bits

    def device_ms(fn):
        return sum(cs.pass_times(label, fn).values())

    pp, msb = AEC_DATA_PREPROCESS, AEC_DATA_MSB
    n_dec = (8 << 20) // bench.samples_per_rsi
    short = Config(13, 32, 64, AEC_DATA_SIGNED | pp | msb)
    bs10 = Config(16, 10, 256, msb | pp | AEC_NOT_ENFORCE)
    chunks = [
        ("walk flat", bench, cs.walk_data(bench, n_dec, 60, 0), True),
        ("walk 2", bench, cs.walk_data(bench, n_dec, 62, 2), True),
        ("walk 8", bench, cs.walk_data(bench, n_dec, 68, 8), True),
        ("all kinds", bench, cs.chunk_data(bench, n_dec, 16), True),
        ("bs10", bs10, cs.chunk_data(bs10, (8 << 20) // bs10.samples_per_rsi,
                                     17), False),
        ("4096 short RSIs", short, cs.chunk_data(short, 4096, 13), False),
    ]
    for name, cfg, data, every_width in chunks:
        S, n_rsi = cfg.samples_per_rsi, len(data) // cfg.rsi_len_bytes
        comp, recs, bucket = cs.scanned_chunk(cfg, data)
        wf_max = bitunpack.window_words(cfg)
        widths = sorted({w for w in (*bitunpack.WF_BUCKETS, wf_max)
                         if bucket <= w <= wf_max}) if every_width \
            else [bucket]
        for wf in widths:
            recs["win"] = native.fill_windows(comp, recs["fs_off"],
                                              recs["meta"], wf)
            args = [u32_to_bits(a).to(device)
                    for a in scan_record_arrays(recs)]
            deltas, ms3 = cs.timed(
                lambda: decode_cuda.decode_blocks(cfg, *args), 20)
            out6, ms6 = cs.timed(
                lambda: decode_fused_cuda.decode_unpredict_swizzle(
                    cfg, *args, n_rsi), 20)
            _, ms34 = cs.timed(lambda: unpredict_cuda.unpredict_swizzle(
                cfg, decode_cuda.decode_blocks(cfg, *args).view(n_rsi, S)),
                20)
            digest.update(deltas.cpu().numpy().tobytes())
            digest.update(out6.cpu().numpy().tobytes())
            row(f"decode {name} NB={deltas.shape[0]} Wf={wf}",
                decode_blocks=ms3,
                decode_blocks_device=device_ms(
                    lambda: decode_cuda.decode_blocks(cfg, *args)),
                decode_fused=ms6, kernels_3_4=ms34)


def version_dir(tmp, arg):
    """A checkout as it is, or a patched copy of this one."""
    if "=" not in arg and arg.split(",")[0] not in KNOCKOUTS:
        return Path(arg).resolve()
    dst = Path(tmp) / re.sub(r"\W", "_", arg)
    shutil.copytree(ROOT / "libaec_tpu_torch", dst / "libaec_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    csrc = dst / "libaec_tpu_torch" / "csrc"
    for item in arg.split(","):
        if item in KNOCKOUTS:
            name, old, new = KNOCKOUTS[item]
            text = (csrc / name).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{item}: its text is not once in {name}")
            (csrc / name).write_text(text.replace(old, new))
            continue
        name, value = item.split("=")
        hits = 0
        for src in csrc.glob("*.cu*"):
            text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                              rf"\g<1>{int(value)};", src.read_text())
            if n:
                src.write_text(text)
                hits += n
        if hits != 1:
            raise SystemExit(f"{name}: {hits} definitions found, expected 1")
    return dst


def main():
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--run":
        return run(args[1], None if args[2] == "all" else args[2])
    only = "all"
    if args[:1] == ["--only"]:
        only, args = args[1], args[2:]
        if only not in ("merge", "decode"):
            raise SystemExit("--only takes merge or decode")
    times = {}  # (version, row, kernel) -> [ms of each sweep]
    sums, failed = set(), False
    with tempfile.TemporaryDirectory() as tmp:
        versions = [("as is", ROOT)] + [(a, version_dir(tmp, a))
                                        for a in args]
        for label, path in (*versions, *reversed(versions)):
            done = subprocess.run(
                [sys.executable, __file__, "--run", label, only],
                env={**os.environ, "PYTHONPATH": str(path)},
                capture_output=True, text=True)
            print(done.stdout, end="", flush=True)
            if done.returncode:
                print(f"time [{label}] failed ({done.returncode}): "
                      f"{done.stderr[-3000:]}", flush=True)
                failed = True
                continue
            for line in done.stdout.splitlines():
                found = re.match(r"time \[.*?\] (.*?): (.*)", line)
                if found and "sha256" not in line:
                    for kernel, ms in re.findall(r"(\w+) ms=([\d.]+)",
                                                 found.group(2)):
                        times.setdefault((label, found.group(1), kernel),
                                         []).append(float(ms))
                if "sha256=" in line and compared(label):
                    sums.add(line.split("sha256=")[1])
    for (label, name, kernel), ms in times.items():
        print(f"median [{label}] {name} {kernel}: "
              f"{statistics.median(ms):.4f} sweeps="
              f"{' '.join(f'{m:.4f}' for m in ms)}")
    print(f"time outputs identical across versions: {len(sums) == 1}")
    if failed or len(sums) != 1:
        raise SystemExit("a version failed or the versions' outputs differ")


if __name__ == "__main__":
    main()
