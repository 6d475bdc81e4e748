#!/usr/bin/env python3
"""Time the passes of kernel 1 of libaec_tpu_torch apart, for one or more
checkouts.

    python3 tools/time_encode_passes.py [CHECKOUT ...]

Needs one NVIDIA GPU and nvcc.  Each CHECKOUT is a directory that holds a
`libaec_tpu_torch` package (this repository when none is given; an older
commit unpacked by `git archive` to compare with).  Each is built and run
in a process of its own, the checkouts in turn and then in reverse turn,
so that two versions are compared on one card within one call.  Per
checkout and chunk -- the encode path's chunk at the bench config (16-bit
MSB, block 64, RSI 256: 1024 RSIs, NB 262144) and at AEC_NOT_ENFORCE
block 10 (NB 1677568) -- it prints the median CUDA-event milliseconds of
`encode_cuda.encode_fields` over 20 runs after 3 warm-ups, and the mean
device milliseconds of each of its kernels by name over 20 calls in one
torch.profiler trace.  The outputs must not differ between checkouts.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


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


def run(label):
    """Time the package that PYTHONPATH names."""
    import numpy as np
    import torch

    chip_smoke = load_chip_smoke()

    from libaec_tpu_torch import (AEC_DATA_MSB, AEC_DATA_PREPROCESS,
                                  AEC_NOT_ENFORCE, Config)
    from libaec_tpu_torch.encode import default_rsis_per_chunk
    from libaec_tpu_torch.kernels import encode_cuda

    device = torch.device("cuda", 0)
    pp, msb = AEC_DATA_PREPROCESS, AEC_DATA_MSB
    digest = hashlib.sha256()
    for name, cfg in (("bench bs64", Config(16, 64, 256, msb | pp)),
                      ("bs10", Config(16, 10, 256,
                                      msb | pp | AEC_NOT_ENFORCE))):
        n_rsi = default_rsis_per_chunk(cfg)
        raw = torch.from_numpy(np.frombuffer(chip_smoke.chunk_data(
            cfg, n_rsi, seed=n_rsi + cfg.bits_per_sample),
            np.uint8).copy()).to(device)
        k0 = torch.tensor([3], dtype=torch.int32, device=device)

        def call():
            return encode_cuda.encode_fields(cfg, raw, k0)

        got, ms = chip_smoke.timed(call, 20)
        for t in got:
            digest.update(t.cpu().numpy().tobytes())
        print(f"time [{label}] {name} NB={got[0].shape[0]}: "
              f"encode_fields ms={ms:.4f}", flush=True)
        chip_smoke.pass_times(f"{label}] [{name}", call)
    print(f"time [{label}] outputs sha256={digest.hexdigest()[:16]}",
          flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        return run(sys.argv[2])
    roots = [Path(a).resolve() for a in sys.argv[1:]] or [ROOT]
    sums = set()
    for root in (*roots, *reversed(roots)):
        done = subprocess.run(
            [sys.executable, __file__, "--run", root.name],
            env={**os.environ, "PYTHONPATH": str(root)},
            capture_output=True, text=True)
        out = done.stdout
        print(out, end="", flush=True)
        if done.returncode:
            print(f"time [{root.name}] failed ({done.returncode}): "
                  f"{done.stderr[-2000:]}", flush=True)
            sums.add("failed")
        sums.update(line.split("sha256=")[1] for line in out.splitlines()
                    if "sha256=" in line)
    print(f"time outputs identical across checkouts: {len(sums) == 1}")
    if len(sums) != 1:
        raise SystemExit("the checkouts' outputs differ")


if __name__ == "__main__":
    main()
