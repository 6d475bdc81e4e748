"""The native host libraries are loaded in every test process.

The root conftest.py builds `libaec_tpu/native/libaectpu.so` once, before
pytest-xdist starts its workers; without that, workers that raced on the
first build could load a half-written file and run with no native library
(their native-dependent tests then skip or fail).  The port's own copy
builds race-free into `build/libaec_tpu_torch/`.
"""
from libaec_tpu import native


def test_native_library_loaded_in_this_worker():
    assert native.get_lib() is not None


def test_port_native_library_loaded_in_this_worker():
    from libaec_tpu_torch import native as torch_native

    lib = torch_native.get_lib()
    assert lib is torch_native.get_lib()
    assert torch_native.library_path().exists()
