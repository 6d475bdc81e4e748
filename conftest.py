"""Build the native host library once, before any test process uses it.

`libaec_tpu.native.get_lib()` compiles `libaectpu.so` at first use,
straight to its final path.  Under pytest-xdist every worker would start
that build at once, and a worker that loads a half-written file marks the
library as unavailable for its whole life (its native-dependent tests then
skip or fail).  Building here, in the controller's `pytest_configure`,
runs before any worker starts; workers find the finished library.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    from libaec_tpu import native

    native.get_lib()
