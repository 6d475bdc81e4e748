"""libaec_tpu_torch: the CCSDS 121.0-B-2 / SZIP codec on PyTorch + CUDA.

The port of libaec_tpu (JAX/Pallas on a TPU) to an NVIDIA Hopper GPU.
This package imports torch, never jax and nothing of libaec_tpu: it keeps
its own copy of the host-only code (config.py, constants.py, and native/,
the C++ runtime with the structural scan, the encoders and the serial
decoder, built with g++ at first use).  Six hand-written CUDA kernels,
built with nvcc at first use, carry the device paths: encode through
kernels/encode_cuda.py and merge_cuda.py, decode through
kernels/decode_cuda.py (payload parse) and unpredict_cuda.py (inverse
predictor and byte layout in one pass, or for 3-byte samples the inverse
predictor alone and then the layout), or, opted into with fused=True or
LIBAEC_TPU_FUSED_DECODE, through kernels/decode_fused_cuda.py (all of it
in one kernel).  Every kernel has a plain PyTorch version beside it.

The codec has no weights: both packages take a Config of the same fields,
the same (k, bit0) carries and the same scan records, so nothing needs
converting between them.
"""
from .config import Config  # noqa: F401
from .constants import (  # noqa: F401
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

from .decode import (  # noqa: F401
    decode_buffer,
    decode_buffer_status,
    decode_buffers,
)
from .encode import encode_buffer, encode_buffer_status  # noqa: F401
