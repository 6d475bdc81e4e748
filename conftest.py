"""Build the native host libraries once, before any test process uses them.

`libaec_tpu.native.get_lib()` compiles `libaectpu.so` at first use,
straight to its final path.  Under pytest-xdist every worker would start
that build at once, and a worker that loads a half-written file marks the
library as unavailable for its whole life (its native-dependent tests then
skip or fail).  Building here, in the controller's `pytest_configure`,
runs before any worker starts; workers find the finished library.

The port's own copy (`libaec_tpu_torch.native`) builds through a temporary
file and a rename, so its workers cannot race; it is built here too so
that six workers do not each compile it.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    from libaec_tpu import native

    native.get_lib()
    try:
        from libaec_tpu_torch import native as torch_native
    except ImportError:  # no torch: the port's tests skip
        return
    torch_native.get_lib()
