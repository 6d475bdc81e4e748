"""SZIP (szlib) compatibility surface of the port, on the card.

The port's copy of libaec_tpu/szip.py (libaec's src/sz_compat.c:
option-mask conversion, scanline padding, and byte-plane interleaving for
32/64-bit pixels), with the port's entry points behind it: compress
through encode_buffer, decompress through decode_buffer_status, many
streams through decode_buffers.  Names, signatures and results are the
JAX package's, except that each call takes `device=` (default "cuda")
where the JAX package picks a backend; `force_device=True` drops the
entry points' size thresholds, as it does on encode_buffer and
decode_buffer_status.  Gives HDF5/netCDF-style callers a drop-in API:

    params = SZCom(options_mask=SZ_MSB_OPTION_MASK | SZ_NN_OPTION_MASK,
                   bits_per_pixel=16, pixels_per_block=16,
                   pixels_per_scanline=512)
    comp = sz_buffto_buff_compress(data, params)
    orig = sz_buffto_buff_decompress(comp, params, out_size=len(data))
"""
from dataclasses import dataclass

import numpy as np

from .config import Config
from .constants import (
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_NOT_ENFORCE,
    AEC_OK,
    AEC_STREAM_ERROR,
    AecError,
)
from .decode import decode_buffer_status, decode_buffers
from .encode import encode_buffer

# Option masks (szlib.h:6-12)
SZ_ALLOW_K13_OPTION_MASK = 1
SZ_CHIP_OPTION_MASK = 2
SZ_EC_OPTION_MASK = 4
SZ_LSB_OPTION_MASK = 8
SZ_MSB_OPTION_MASK = 16
SZ_NN_OPTION_MASK = 32
SZ_RAW_OPTION_MASK = 128

SZ_OK = AEC_OK
SZ_OUTBUFF_FULL = 2
SZ_NO_ENCODER_ERROR = -1
SZ_PARAM_ERROR = -1
SZ_MEM_ERROR = -4

SZ_MAX_PIXELS_PER_BLOCK = 32
SZ_MAX_BLOCKS_PER_SCANLINE = 128
SZ_MAX_PIXELS_PER_SCANLINE = SZ_MAX_BLOCKS_PER_SCANLINE * SZ_MAX_PIXELS_PER_BLOCK


@dataclass
class SZCom:
    """SZ_com_t equivalent (szlib.h:26-32)."""

    options_mask: int
    bits_per_pixel: int
    pixels_per_block: int
    pixels_per_scanline: int


def sz_check_params(param: SZCom):
    """Parameter validation the HDF5 szip filter performs against the
    szlib.h limits (szlib.h:21-24) plus the stream-level constraints
    aec_encode_init would reject under AEC_NOT_ENFORCE (encode.c:780-793).
    Returns SZ_OK or SZ_PARAM_ERROR."""
    ppb = param.pixels_per_block
    pps = param.pixels_per_scanline
    bpp = param.bits_per_pixel
    if ppb <= 0 or ppb > SZ_MAX_PIXELS_PER_BLOCK or ppb & 1:
        return SZ_PARAM_ERROR
    if pps <= 0 or -(-pps // ppb) > SZ_MAX_BLOCKS_PER_SCANLINE:
        return SZ_PARAM_ERROR
    if not (1 <= bpp <= 32 or bpp == 64):
        return SZ_PARAM_ERROR
    return SZ_OK


def _convert_options(sz_opts):
    """sz_compat.c:12-27."""
    opts = 0
    if sz_opts & SZ_MSB_OPTION_MASK:
        opts |= AEC_DATA_MSB
    if sz_opts & SZ_NN_OPTION_MASK:
        opts |= AEC_DATA_PREPROCESS
    return opts


def _bits_to_bytes(bit_length):
    if bit_length > 16:
        return 4
    if bit_length > 8:
        return 2
    return 1


def _interleave(buf, wordsize):
    """Byte-plane transpose (sz_compat.c:39-53): sample-major to plane-major."""
    a = np.frombuffer(buf, np.uint8)
    n = len(a) - len(a) % wordsize
    return a[:n].reshape(-1, wordsize).T.copy().tobytes() + bytes(a[n:])


def _deinterleave(buf, wordsize, n):
    a = np.frombuffer(buf[: (n // wordsize) * wordsize], np.uint8)
    out = a.reshape(wordsize, -1).T.copy().tobytes()
    return out + bytes(buf[len(out): n])


def _stream_params(param: SZCom):
    block_size = param.pixels_per_block
    rsi = (param.pixels_per_scanline + param.pixels_per_block - 1) \
        // param.pixels_per_block
    return block_size, rsi


def sz_buffto_buff_compress(source, param: SZCom, dest_len=None,
                            device="cuda", force_device=False):
    """SZ_BufftoBuffCompress (sz_compat.c:110-183). Returns bytes.

    Raises AecError on configuration problems; if dest_len is given and the
    output exceeds it, returns SZ_OUTBUFF_FULL semantics via AecError with
    status SZ_OUTBUFF_FULL.  The padded scanlines go to encode_buffer on
    `device` (native under 4 MiB or outside the kernel gate)."""
    if sz_check_params(param) != SZ_OK:
        raise AecError(SZ_PARAM_ERROR, "invalid SZ parameters")
    block_size, rsi = _stream_params(param)
    flags = AEC_NOT_ENFORCE | _convert_options(param.options_mask)

    interleave = param.bits_per_pixel in (32, 64)
    if interleave:
        bits_per_sample = 8
        buf = _interleave(source, param.bits_per_pixel // 8)
    else:
        bits_per_sample = param.bits_per_pixel
        buf = bytes(source)

    pixel_size = _bits_to_bytes(bits_per_sample)
    line_pixels = param.pixels_per_scanline
    padded_pixels = rsi * block_size

    scanlines = -(-(len(buf) // pixel_size) // line_pixels)
    # pad each scanline to a whole RSI (sz_compat.c:71-94): repeat the last
    # pixel under NN (preprocessing), zero-fill otherwise
    a = np.frombuffer(buf, np.uint8)
    line_bytes = line_pixels * pixel_size
    padded_bytes = padded_pixels * pixel_size
    out = np.zeros(scanlines * padded_bytes, np.uint8)
    pp = bool(flags & AEC_DATA_PREPROCESS)
    pos = 0
    for s in range(scanlines):
        chunk = a[s * line_bytes : (s + 1) * line_bytes]
        out[pos : pos + len(chunk)] = chunk
        pad_start = pos + len(chunk)
        pad_len = padded_bytes - len(chunk)
        if pad_len:
            if pp and len(chunk):
                pixel = chunk[-pixel_size:]
            else:
                pixel = np.zeros(pixel_size, np.uint8)
            reps = -(-pad_len // pixel_size)
            out[pad_start : pos + padded_bytes] = np.tile(pixel, reps)[:pad_len]
        pos += padded_bytes

    cfg = Config(bits_per_sample, block_size, rsi, flags)
    comp = encode_buffer(out.tobytes(), cfg, device=device,
                         force_device=force_device)
    if dest_len is not None and len(comp) > dest_len:
        raise AecError(SZ_OUTBUFF_FULL, "output buffer full")
    return comp


def _decompress_plan(param: SZCom, out_size):
    """Shared decompress plan: (cfg, decode buffer size, postprocess)
    where postprocess(raw decode bytes) -> final pixel bytes (scanline
    unpadding + byte-plane deinterleave, sz_compat.c:209-250)."""
    block_size, rsi = _stream_params(param)
    # AEC_NOT_ENFORCE on the decode side too (sz_compat.c:125-128 applies
    # it to both directions): SZ block sizes are any even value <= 32, not
    # just the CCSDS set
    flags = AEC_NOT_ENFORCE | _convert_options(param.options_mask)

    deinterleave = param.bits_per_pixel in (32, 64)
    pad_scanline = param.pixels_per_scanline % param.pixels_per_block
    bits_per_sample = 8 if deinterleave else param.bits_per_pixel
    pixel_size = _bits_to_bytes(bits_per_sample)

    line_pixels = param.pixels_per_scanline
    padded_pixels = rsi * block_size

    if pad_scanline:
        scanlines = -(-(out_size // pixel_size) // line_pixels)
        buf_size = padded_pixels * pixel_size * scanlines
    else:
        scanlines = 0
        buf_size = out_size

    cfg = Config(bits_per_sample, block_size, rsi, flags)

    def post(buf):
        if pad_scanline:
            a = np.frombuffer(buf, np.uint8)
            line_bytes = line_pixels * pixel_size
            padded_bytes = padded_pixels * pixel_size
            nlines = len(a) // padded_bytes
            trimmed = a[: nlines * padded_bytes].reshape(nlines,
                                                         padded_bytes)
            buf = trimmed[:, :line_bytes].tobytes() \
                + bytes(a[nlines * padded_bytes:])
            buf = buf[: scanlines * line_bytes]
        n = min(len(buf), out_size)
        if deinterleave:
            return _deinterleave(buf, param.bits_per_pixel // 8, n)
        return bytes(buf[:n])

    return cfg, buf_size, post


def sz_buffto_buff_decompress(source, param: SZCom, out_size, device="cuda",
                              force_device=False):
    """SZ_BufftoBuffDecompress (sz_compat.c:185-268). Returns bytes of length
    <= out_size.  The stream goes to decode_buffer_status on `device`
    (native under 16 MiB of output or outside the kernel gates)."""
    if sz_check_params(param) != SZ_OK:
        raise AecError(SZ_PARAM_ERROR, "invalid SZ parameters")
    cfg, buf_size, post = _decompress_plan(param, out_size)
    status, buf = decode_buffer_status(bytes(source), cfg, buf_size,
                                       device=device,
                                       force_device=force_device)
    if status != AEC_OK:
        raise AecError(status, "decode failed")
    return post(buf)


def sz_decompress_batch(sources, param: SZCom, out_sizes, device="cuda"):
    """Decompress many independent SZ streams (the HDF5 dataset shape: one
    stream per chunk) through decode_buffers: the structural scans run on
    host threads while `device` decodes every stream's payloads, many
    streams to a launch (a config outside the kernel gates, as pixels per
    block under 8, decodes each stream natively).  No reference
    counterpart -- the reference is strictly one-buffer-at-a-time.
    Returns a list of bytes; raises AecError carrying the first failing
    stream's status."""
    if sz_check_params(param) != SZ_OK:
        raise AecError(SZ_PARAM_ERROR, "invalid SZ parameters")
    plans = [_decompress_plan(param, n) for n in out_sizes]
    if not plans:
        return []
    results = decode_buffers([bytes(s) for s in sources], plans[0][0],
                             [p[1] for p in plans], device=device)
    out = []
    for (status, buf), (_, _, post) in zip(results, plans):
        if status != AEC_OK:
            raise AecError(status, "decode failed")
        out.append(post(buf))
    return out


def sz_encoder_enabled():
    return 1


def sz_compress():
    """netcdf's configure probes for an SZ_Compress symbol; the reference
    ships a do-nothing stub (sz_compat.c:275-276)."""
    return SZ_OK


# ---------------------------------------------------------------------------
# C-style entry points: status-code returns instead of exceptions, matching
# the reference's error mapping (sz_compat.c:170-174: AEC_STREAM_ERROR ->
# SZ_OUTBUFF_FULL on compress; raw AEC status otherwise).
# ---------------------------------------------------------------------------

def SZ_BufftoBuffCompress(source, param: SZCom, dest_len=None, device="cuda",
                          force_device=False):
    """Returns (status, bytes)."""
    try:
        return SZ_OK, sz_buffto_buff_compress(source, param, dest_len,
                                              device, force_device)
    except AecError as e:
        st = SZ_OUTBUFF_FULL if e.status == AEC_STREAM_ERROR else e.status
        return st, b""


def SZ_BufftoBuffDecompress(source, param: SZCom, out_size, device="cuda",
                            force_device=False):
    """Returns (status, bytes)."""
    if sz_check_params(param) != SZ_OK:
        return SZ_PARAM_ERROR, b""
    try:
        return SZ_OK, sz_buffto_buff_decompress(source, param, out_size,
                                                device, force_device)
    except AecError as e:
        return e.status, b""


SZ_encoder_enabled = sz_encoder_enabled
SZ_Compress = sz_compress
SZ_CheckParams = sz_check_params
