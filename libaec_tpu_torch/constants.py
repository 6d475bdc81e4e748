"""Public flag / error constants, mirroring the reference API surface
(the port's own copy of libaec_tpu/constants.py).

Parity: libaec's src/libaec.h:105-149 (flags, errors, flush modes).
"""

# Sample data description flags (libaec.h:105-124)
AEC_DATA_SIGNED = 1
AEC_DATA_3BYTE = 2
AEC_DATA_MSB = 4
AEC_DATA_PREPROCESS = 8
AEC_RESTRICTED = 16
AEC_PAD_RSI = 32
AEC_NOT_ENFORCE = 64

# Return codes (libaec.h:129-133)
AEC_OK = 0
AEC_CONF_ERROR = -1
AEC_STREAM_ERROR = -2
AEC_DATA_ERROR = -3
AEC_MEM_ERROR = -4

# Flush options (libaec.h:141-149)
AEC_NO_FLUSH = 0
AEC_FLUSH = 1


class AecError(Exception):
    """Raised by the pythonic API; carries the C-compatible status code."""

    def __init__(self, status, msg=""):
        self.status = status
        super().__init__(f"AEC error {status}: {msg}")


class AecConfError(AecError):
    def __init__(self, msg=""):
        super().__init__(AEC_CONF_ERROR, msg or "invalid configuration")


class AecDataError(AecError):
    def __init__(self, msg=""):
        super().__init__(AEC_DATA_ERROR, msg or "corrupt input data")


class AecMemError(AecError):
    def __init__(self, msg=""):
        super().__init__(AEC_MEM_ERROR, msg or "buffer too small")


class AecStreamError(AecError):
    def __init__(self, msg=""):
        super().__init__(AEC_STREAM_ERROR, msg or "stream error")
