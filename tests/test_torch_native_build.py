"""The native host library is loaded in every test process.

The root conftest.py builds `libaec_tpu/native/libaectpu.so` once, before
pytest-xdist starts its workers; without that, workers that raced on the
first build could load a half-written file and run with no native library
(their native-dependent tests then skip or fail).
"""
from libaec_tpu import native


def test_native_library_loaded_in_this_worker():
    assert native.get_lib() is not None
