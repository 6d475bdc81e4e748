"""libaec_tpu_torch: the CCSDS 121.0-B-2 / SZIP codec on PyTorch + CUDA.

The port of libaec_tpu (JAX/Pallas on a TPU) to an NVIDIA Hopper GPU.
This package imports torch and never jax.  It reuses the JAX package's
host-only code (Config, constants, the native C++ runtime with its
structural scan and serial decoder, the numpy tail encoder) by import.
Five hand-written CUDA kernels, built with nvcc at first use, carry the
device paths: encode through kernels/encode_cuda.py and merge_cuda.py,
decode through kernels/decode_cuda.py (payload parse) and
unpredict_cuda.py (inverse predictor and byte layout in one pass, or for
3-byte samples the inverse predictor alone and then the layout).  Every
kernel has a plain PyTorch version beside it.

The codec has no weights: both packages take the same Config object, the
same (k, bit0) carries and the same scan records (scan_record_arrays), so
nothing needs converting between them.
"""
from libaec_tpu.config import Config  # noqa: F401
from libaec_tpu.constants import (  # noqa: F401
    AEC_CONF_ERROR,
    AEC_DATA_3BYTE,
    AEC_DATA_ERROR,
    AEC_DATA_MSB,
    AEC_DATA_PREPROCESS,
    AEC_DATA_SIGNED,
    AEC_FLUSH,
    AEC_MEM_ERROR,
    AEC_NO_FLUSH,
    AEC_NOT_ENFORCE,
    AEC_OK,
    AEC_PAD_RSI,
    AEC_RESTRICTED,
    AEC_STREAM_ERROR,
    AecConfError,
    AecDataError,
    AecError,
    AecMemError,
    AecStreamError,
)

from .decode import decode_buffer, decode_buffer_status  # noqa: F401
from .encode import encode_buffer, encode_buffer_status  # noqa: F401
