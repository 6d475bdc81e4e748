"""Streaming (zlib-style) API with aec_stream parity, on the card.

The port's copy of libaec_tpu/stream.py.  libaec implements byte-dribble
streaming with a resumable state machine (src/encode.c:467-707,
decode.c:342-460); here suspend/resume stays at the host framing layer:
input is buffered to whole RSIs (the format's safe cut points), and every
call codes the whole RSIs it completes.  Byte output is identical to the
reference for any chunking of input and output.

Encode: each call's whole RSIs go through encode.encode_blocks on the
stream's device (kernels 1 and 2 on the card, their plain versions for
"cpu"), with the warm-start k and the bit cursor carried on the host
between calls; so does the short last RSI at AEC_FLUSH, as a chunk of
one RSI of fewer blocks.
`device=None` uses the native streaming session (native.EncSession)
instead.  Decode is on the host, as in the
JAX package: the native offsets-only scan, the native decoder from an RSI
boundary and the serial tail.

API mirrors libaec.h:154-166:

    s = AecStream(bits_per_sample=16, block_size=64, rsi=256,
                  flags=AEC_DATA_MSB | AEC_DATA_PREPROCESS)
    aec_encode_init(s); s.next_in = ...; aec_encode(s, AEC_FLUSH); ...

next_in/next_out are bytes-like/bytearray buffers indexed by the stream's
internal cursors; avail_in/avail_out/total_in/total_out match the C fields.
"""
import numpy as np
import torch

from . import native
from .config import Config
from .constants import AEC_FLUSH, AEC_OK, AEC_STREAM_ERROR
from .encode import encode_blocks


class AecStream:
    """Mutable stream object mirroring struct aec_stream (libaec.h:67-97).

    `device` is where the encode's RSIs, the short last one too, are
    coded: "cuda" (the default), "cpu" (the kernels' plain versions), or
    None (the native session on the host)."""

    def __init__(self, bits_per_sample=8, block_size=8, rsi=2, flags=0,
                 device="cuda"):
        self.bits_per_sample = bits_per_sample
        self.block_size = block_size
        self.rsi = rsi
        self.flags = flags
        self.next_in = b""
        self.avail_in = None  # None -> len(next_in)
        self.next_out = None  # bytearray to write into; None -> internal
        self.avail_out = None
        self.total_in = 0
        self.total_out = 0
        self._device = device
        self._state = None

    # internal ------------------------------------------------------------
    def _cfg(self):
        return Config(self.bits_per_sample, self.block_size, self.rsi,
                      self.flags)


class _EncState:
    """Encode state on the kernels: bytes coded but not handed out, the
    bit count and the warm-start k."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but none is available")
        self.inbuf = bytearray()   # buffered input not yet coded
        self.outbuf = bytearray()  # coded bytes not yet handed out
        self.bits = 0              # total bits coded so far
        self.k = 0                 # warm-start k carry
        self.flushed = False

    def _run_one(self, raw, nb):
        bit0 = self.bits % 8
        chunk, bits, self.k = encode_blocks(self.cfg, raw, nb, self.k, bit0,
                                            self.device)
        if bit0 and len(self.outbuf):
            self.outbuf[-1] |= int(chunk[0])
            self.outbuf += chunk[1:].tobytes()
        else:
            self.outbuf += chunk.tobytes()
        self.bits += bits - bit0

    def feed(self, data, flush):
        """Consume input bytes; code any complete RSIs (all, on flush)."""
        cfg = self.cfg
        self.inbuf += data
        take = len(self.inbuf) // cfg.rsi_len_bytes * cfg.rsi_len_bytes
        if take:
            self._run_one(np.frombuffer(self.inbuf, np.uint8, take), cfg.rsi)
            del self.inbuf[:take]
        if flush == AEC_FLUSH:
            bsz = cfg.bytes_per_sample
            n_samples = len(self.inbuf) // bsz
            if n_samples:
                self._run_one(
                    np.frombuffer(self.inbuf, np.uint8, n_samples * bsz),
                    -(-n_samples // cfg.block_size))
            self.inbuf = bytearray()
            if not self.flushed and self.bits == 0:
                # reference flushes one zero byte even with no input
                # (encode.c:686-695)
                self.outbuf += b"\x00"
                self.bits = 8
            self.flushed = True

    def servable(self):
        # the trailing byte is held back while it is still partial (the
        # reference carries it in cds_buf until finalised, encode.c:929-931)
        if not self.flushed and self.bits % 8 != 0:
            return len(self.outbuf) - 1
        return len(self.outbuf)

    def take(self, cap):
        emit = bytes(self.outbuf[:cap])
        del self.outbuf[:cap]
        return emit

    def done(self):
        return self.flushed and not self.outbuf


class _SessionState:
    """Encode state on the native session (native.EncSession), for configs
    outside the encode kernel's gate and for device=None.  The complete
    bytes of the word the session holds back are served too, as the JAX
    stream serves every complete byte (libaec_tpu/stream.py:178-183);
    `ahead` counts those handed out before the session emits them, and
    the session's copies of them are dropped when it does."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.session = native.EncSession(cfg)
        self.inbuf = bytearray()
        self.flushed = False
        self.ahead = 0

    def feed(self, data, flush):
        self.inbuf += data
        take = len(self.inbuf) // self.cfg.rsi_len_bytes \
            * self.cfg.rsi_len_bytes
        if take:
            self.session.feed(memoryview(self.inbuf)[:take])
            del self.inbuf[:take]
        if flush == AEC_FLUSH and not self.flushed:
            self.session.finish(self.inbuf)
            self.inbuf = bytearray()
            self.flushed = True

    def _drop_served(self):
        self.ahead -= len(self.session.read(self.ahead))

    def servable(self):
        self._drop_served()
        return (self.session.pending() + len(self.session.held())
                - self.ahead)

    def take(self, cap):
        self._drop_served()
        out = self.session.read(cap)
        if len(out) < cap:  # nothing pending: the held word's bytes
            extra = self.session.held()[self.ahead:][:cap - len(out)]
            self.ahead += len(extra)
            out += extra
        return out

    def done(self):
        return self.flushed and not self.servable()


def aec_encode_init(strm: AecStream):
    cfg = strm._cfg()  # raises AecConfError on bad params
    if strm._device is None:
        strm._state = _SessionState(cfg)
    else:
        strm._state = _EncState(cfg, strm._device)
    strm.total_in = 0
    strm.total_out = 0
    return AEC_OK


def aec_encode(strm: AecStream, flush):
    st = strm._state
    data = bytes(strm.next_in[: strm.avail_in]
                 if strm.avail_in is not None else strm.next_in)
    strm.total_in += len(data)
    strm.avail_in = 0
    strm.next_in = b""
    st.feed(data, flush)

    servable = st.servable()
    cap = strm.avail_out if strm.avail_out is not None else servable
    emit = st.take(min(cap, servable))
    if strm.next_out is None:
        strm.next_out = bytearray()
    strm.next_out += emit
    if strm.avail_out is not None:
        strm.avail_out -= len(emit)
    strm.total_out += len(emit)
    return AEC_OK


def aec_encode_end(strm: AecStream):
    st = strm._state
    strm._state = None
    if st is not None and not st.done():
        return AEC_STREAM_ERROR
    return AEC_OK


class _DecState:
    """Incremental streaming decode state -- bounded memory.

    Complete RSIs are decoded exactly once as input accumulates (the scan
    position `pos_bit` persists across calls); only the trailing partial
    RSI is re-decoded per call, bounding per-call work by one RSI
    regardless of how the input dribbles in -- the reference achieves the
    same with its resumable FSM (decode.c:342-460), we do it by whole-RSI
    replay.  Consumed input bytes are trimmed from `inbuf` (rebasing
    `pos_bit`) and emitted output is dropped from `done_out`, so a
    drip-fed stream of any length holds O(chunk + RSI) state -- parity
    with the reference's O(rsi) decode session (decode.h:68-133).  A
    native library that cannot be built raises."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.inbuf = bytearray()
        self.pos_bit = 0   # bit offset of the first un-decoded RSI,
        #                    relative to inbuf[0] (whole consumed bytes
        #                    are trimmed; trimming preserves pos_bit%8 so
        #                    PAD_RSI byte realignment is unaffected)
        self.done_out = bytearray()  # complete-RSI output not yet emitted
        self.complete_produced = 0   # total complete-RSI bytes ever decoded
        self.emitted = 0             # total bytes handed to the caller
        self.status = AEC_OK
        self._tail = b""       # cached partial-RSI decode
        self._status_tail = AEC_OK
        self._tail_len = -1    # input length the cache was computed at

    def take(self, cap):
        """Decode newly completed RSIs, return (status, fresh bytes)."""
        cfg = self.cfg
        rsi_bytes = cfg.rsi_len_bytes
        if self.status != AEC_OK:
            # sticky error: the reference stops producing on DATA_ERROR
            return self.status, b""
        data = bytes(self.inbuf)
        n_new, end_bit = native.scan_rsis(data, self.pos_bit, 1 << 40, cfg)
        if n_new:
            st, out = native.decode(data, n_new * rsi_bytes, cfg,
                                    start_bit=self.pos_bit)
            # tail bytes handed out earlier are re-produced by the
            # complete-RSI decode; skip the already-emitted overlap
            overlap = max(0, self.emitted - self.complete_produced)
            self.done_out += out[overlap:]
            self.complete_produced += len(out)
            self.pos_bit = end_bit
            self._tail_len = -1  # tail moved; invalidate cache
            if st != AEC_OK:
                self.status = st
            # trim consumed whole input bytes, rebasing the cursor
            adv = self.pos_bit // 8
            if adv:
                del self.inbuf[:adv]
                self.pos_bit -= adv * 8
                data = bytes(self.inbuf)
        # trailing partial RSI: bounded re-decode (serial core), cached
        # so output-drain calls with no new input cost nothing
        if self._tail_len != len(data):
            self._status_tail, self._tail = native.decode_tail(
                data, self.pos_bit, rsi_bytes, cfg)
            self._tail_len = len(data)
        status = self._status_tail if self.status == AEC_OK \
            else self.status
        emit = bytearray()
        n = min(cap, len(self.done_out))
        if n:
            emit += self.done_out[:n]
            del self.done_out[:n]
        if (len(emit) < cap and not self.done_out
                and self.status == AEC_OK):
            skip = self.emitted + len(emit) - self.complete_produced
            emit += self._tail[skip: skip + (cap - len(emit))]
        self.emitted += len(emit)
        return status, bytes(emit)


def aec_decode_init(strm: AecStream):
    cfg = strm._cfg()
    strm._state = _DecState(cfg)
    strm.total_in = 0
    strm.total_out = 0
    return AEC_OK


def aec_decode(strm: AecStream, flush):
    st = strm._state
    data = bytes(strm.next_in[: strm.avail_in]
                 if strm.avail_in is not None else strm.next_in)
    strm.total_in += len(data)
    strm.avail_in = 0
    strm.next_in = b""
    st.inbuf += data

    cap = strm.avail_out if strm.avail_out is not None else (1 << 62)
    status, emit = st.take(cap)
    if strm.next_out is None:
        strm.next_out = bytearray()
    strm.next_out += emit
    if strm.avail_out is not None:
        strm.avail_out -= len(emit)
    strm.total_out += len(emit)
    return AEC_OK


def aec_decode_end(strm: AecStream):
    strm._state = None
    return AEC_OK
