"""Command-line tool of the port with the reference `aec` option surface
(libaec's src/aec.c:242-257), the twin of libaec_tpu/cli.py:

    python -m libaec_tpu_torch.cli [-3] [-N] [-b size] [-d] [-j samples]
        [-m] [-n bits] [-p] [-r blocks] [-s] [-t] SOURCE DEST

(installed as `aec-torch`).  Defaults match the reference: 8 bits/sample,
block 8, rsi 2, preprocessing on.

Routing.  Inside the kernel gates, encodes of at least 4 MiB of input and
decodes of at least 16 MiB of output (the entry points' own thresholds)
run on the card: encode through encode_buffer, decode to the file through
decode_buffer_device after an offsets-only scan gives the tight output
size.  Everything else runs on the host in the native codec, decode in
bounded memory chunk by chunk.  The JAX package's knobs choose as there:
LIBAEC_TPU_ENCODE=native (or numpy) and LIBAEC_TPU_DECODE=cpu ask for the
host whatever the size; LIBAEC_TPU_ENCODE=jax and LIBAEC_TPU_DECODE=device
drop the size threshold.  When the card route is chosen and there is no
card, the tool exits with status 1 and names the knob; it does not fall
back to the host.  With LIBAEC_TPU_PRINT_LAUNCHES set, the kernels'
launch counts go to stderr as one JSON line at exit.
"""
import json
import os
import sys

import torch

from . import native
from .config import Config
from .constants import (
    AEC_DATA_3BYTE,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
)
from .decode import (
    DEVICE_DECODE_MIN_BYTES,
    decode_buffer_device,
    kernels_supported,
)
from .encode import AUTO_JAX_MIN_BYTES, encode_buffer
from .kernels import (decode_cuda, decode_fused_cuda, encode_cuda, merge_cuda,
                      unpredict_cuda)

_USAGE = """NAME
\taec - encode or decode files with Adaptive Entropy Coding

SYNOPSIS
\taec [OPTION]... SOURCE DEST

OPTIONS
\t-3\t\t24 bit samples are stored in 3 bytes
\t-N\t\tdisable pre/post processing
\t-b size\t\tinternal buffer size in bytes
\t-d\t\tdecode SOURCE. If -d is not used: encode.
\t-j samples\tblock size in samples
\t-m\t\tsamples are MSB first. Default is LSB
\t-n bits\t\tbits per sample
\t-p\t\tpad RSI to byte boundary
\t-r blocks\treference sample interval in blocks
\t-s\t\tsamples are signed. Default is unsigned
\t-t\t\tuse restricted set of code options
"""


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    bits_per_sample = 8
    block_size = 8
    rsi = 2
    flags = AEC_DATA_PREPROCESS
    dflag = False
    chunk = 10485760  # -b: internal buffer size (aec.c:149-156)

    def get_param(i):
        if len(argv[i]) == 2:
            return int(argv[i + 1]), i + 2
        return int(argv[i][2:]), i + 1

    i = 0
    try:
        while i < len(argv) - 2:
            opt = argv[i]
            if not opt.startswith("-"):
                raise ValueError(opt)
            c = opt[1]
            if c == "3":
                flags |= AEC_DATA_3BYTE
            elif c == "N":
                flags &= ~AEC_DATA_PREPROCESS
            elif c == "b":
                chunk, i = get_param(i)
                continue
            elif c == "d":
                dflag = True
            elif c == "j":
                block_size, i = get_param(i)
                continue
            elif c == "m":
                flags |= AEC_DATA_MSB
            elif c == "n":
                bits_per_sample, i = get_param(i)
                continue
            elif c == "p":
                flags |= AEC_PAD_RSI
            elif c == "r":
                rsi, i = get_param(i)
                continue
            elif c == "s":
                flags |= AEC_DATA_SIGNED
            elif c == "t":
                flags |= AEC_RESTRICTED
            else:
                raise ValueError(opt)
            i += 1
    except (ValueError, IndexError):
        sys.stderr.write(_USAGE)
        return 1

    if len(argv) - i < 2:
        sys.stderr.write(_USAGE)
        return 1
    infn, outfn = argv[i], argv[i + 1]

    try:
        cfg = Config(bits_per_sample, block_size, rsi, flags)
    except Exception as e:
        sys.stderr.write(f"ERROR: initialization failed ({e})\n")
        return 1

    with open(infn, "rb") as f:
        data = f.read()

    # -b sizes the internal buffer; the reference scales it by the sample
    # byte width (aec.c:149-156).  Host chunking here is whole RSIs, so the
    # scaled byte size maps onto rsis_per_chunk.
    if cfg.bits_per_sample > 16:
        chunk *= 3 if (cfg.bits_per_sample <= 24 and cfg.three_byte) else 4
    elif cfg.bits_per_sample > 8:
        chunk *= 2
    rsis_per_chunk = max(1, chunk // cfg.rsi_len_bytes)

    try:
        if dflag:
            return _decode_to_file(data, cfg, outfn,
                                   rsis_per_chunk=rsis_per_chunk)
        return _encode_to_file(data, cfg, outfn,
                               rsis_per_chunk=rsis_per_chunk)
    finally:
        if os.environ.get("LIBAEC_TPU_PRINT_LAUNCHES"):
            sys.stderr.write(f"launches {json.dumps(launch_counts())}\n")


def launch_counts():
    """Every kernel wrapper's launch count in this process."""
    return {"encode_fields": encode_cuda.launches,
            "merge_windows": merge_cuda.launches,
            "decode_blocks": decode_cuda.launches,
            "unpredict_swizzle": unpredict_cuda.launches,
            "unpredict_rsis": unpredict_cuda.rsis_launches,
            "samples_to_bytes": unpredict_cuda.layout_launches,
            "decode_fused": decode_fused_cuda.launches}


def _card_missing(device, knob):
    """True, with a message naming the knob that asks for the host, when
    the card route was chosen on a host without a card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write(f"ERROR: no CUDA device for the card route; set "
                         f"{knob} to run on the host\n")
        return True
    return False


def _encode_to_file(data, cfg, outfn, rsis_per_chunk=None, device="cuda",
                    force_device=False):
    """Encode `data` into the file outfn: on `device` inside the kernel
    gate at 4 MiB or more (any size with force_device or
    LIBAEC_TPU_ENCODE=jax), else natively (always with
    LIBAEC_TPU_ENCODE=native or numpy).  Returns the exit status."""
    mode = os.environ.get("LIBAEC_TPU_ENCODE", "auto")
    if (encode_cuda.kernel_supported(cfg) and mode not in ("native", "numpy")
            and (force_device or mode == "jax"
                 or len(data) >= AUTO_JAX_MIN_BYTES)):
        if _card_missing(device, "LIBAEC_TPU_ENCODE=native"):
            return 1
        out = encode_buffer(data, cfg, device=device, force_device=True,
                            rsis_per_chunk=rsis_per_chunk)
    else:
        status, out = native.encode(data, cfg)
        if status != 0:
            sys.stderr.write(f"ERROR: {status}\n")
            return 1
    with open(outfn, "wb") as f:
        f.write(out)
    return 0


def _decode_to_file(data, cfg, outfn, rsis_per_chunk=None, device="cuda",
                    force_device=False):
    """Stream-decode in bounded memory: complete RSIs are scanned and
    decoded in chunks written straight to the file; only the sub-RSI tail
    needs a one-RSI buffer.  CLI semantics stream until input is exhausted
    (aec.c:191-219), so no output-size bound is involved.

    Inside the kernel gates, an offsets-only pre-scan gives the exact
    complete-RSI count; an output of 16 MiB or more (any size with
    force_device or LIBAEC_TPU_DECODE=device) then decodes on `device`
    through decode_buffer_device with the file as its part_sink.
    LIBAEC_TPU_DECODE=cpu keeps every size on the host."""
    mode = os.environ.get("LIBAEC_TPU_DECODE", "auto")
    rsi_bytes = cfg.rsi_len_bytes
    scanned = None
    if mode != "cpu" and kernels_supported(cfg):
        scanned = native.scan_rsis(data, 0, 1 << 40, cfg)
    if scanned is not None:
        # the tight output size: the complete RSIs, +1 for the tail
        tight = (scanned[0] + 1) * rsi_bytes
        if force_device or mode == "device" \
                or tight >= DEVICE_DECODE_MIN_BYTES:
            if _card_missing(device, "LIBAEC_TPU_DECODE=cpu"):
                return 1
            with open(outfn, "wb") as f:
                status, _ = decode_buffer_device(data, cfg, tight, device,
                                                 part_sink=f.write)
            if status < 0:
                sys.stderr.write(f"ERROR: {status}\n")
                return 1
            return 0

    if rsis_per_chunk is None:
        rsis_per_chunk = max(1, (64 << 20) // rsi_bytes)
    pos = 0
    status = 0
    with open(outfn, "wb") as f:
        while True:
            n, end = native.scan_rsis(data, pos, rsis_per_chunk, cfg)
            if n == 0:
                break
            status, out = native.decode(data, n * rsi_bytes, cfg,
                                        start_bit=pos)
            f.write(out)
            pos = end
            if status < 0:
                break
        if status == 0:
            # partial trailing RSI (or trailing padding bits)
            status, out = native.decode_tail(data, pos, rsi_bytes, cfg)
            f.write(out)
    if status < 0:
        sys.stderr.write(f"ERROR: {status}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
