"""The `bytes` an entry point returns, filled in place on the host.

A `bytes` object is immutable to Python code, so the usual way to return
one is to fill some other buffer and copy it (`tobytes()`, `bytes(...)`),
and every output byte is then written twice.  CPython's C API builds a
`bytes` of n bytes left uninitialised (PyBytes_FromStringAndSize(NULL, n),
the documented way to make one that the caller then fills) and shrinks
one that no other code has seen yet (_PyBytes_Resize).  HostBytes holds
such an object by its address alone, so that its reference count stays 1
until it is handed over, lends its bytes out as a writable uint8 tensor,
and hands the object over once it is filled: every output byte is
written once, into the object the caller gets.

The object is never hashed, shared or returned before take(); a view is
not used after it (take() may move the object).  Sizes below 1 are
refused: CPython returns its shared empty `bytes` for size 0.
"""
import ctypes

import numpy as np
import torch

# Prototypes of our own (PYFUNCTYPE: the interpreter lock held, a Python
# error raised), not ctypes.pythonapi's shared function objects, whose
# argtypes any other module may set.
_new = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p)(
    ("PyBytes_AsString", ctypes.pythonapi))
_resize = ctypes.PYFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                            ctypes.c_ssize_t)(
    ("_PyBytes_Resize", ctypes.pythonapi))
_decref = ctypes.PYFUNCTYPE(None, ctypes.c_void_p)(
    ("Py_DecRef", ctypes.pythonapi))


class HostBytes:
    """A new `bytes` of n uninitialised bytes (n >= 1), written through
    `view` (a uint8 tensor over them) and handed over by take()."""

    def __init__(self, n):
        if n < 1:
            raise ValueError(f"HostBytes of {n} bytes")
        # a new reference, owned here by address: no Python name holds it
        self._obj = ctypes.c_void_p(_new(None, n))
        mem = (ctypes.c_uint8 * n).from_address(_data(self._obj))
        self.view = torch.from_numpy(np.frombuffer(mem, np.uint8))

    def take(self, n):
        """The object cut to its first n bytes, which must all have been
        written; the view is dropped.  At the full size nothing moves; a
        shorter result is shrunk in place (realloc), not copied."""
        if not 0 <= n <= self.view.numel():
            raise ValueError(f"take({n}) of {self.view.numel()} bytes")
        self.view = None
        _resize(ctypes.byref(self._obj), n)
        obj = ctypes.cast(self._obj, ctypes.py_object).value
        _decref(self._obj)  # the reference Python now holds is obj's
        self._obj = None
        return obj

    def __del__(self):
        # an object never taken (an exception on the way) is released
        if getattr(self, "_obj", None) is not None and _decref is not None:
            _decref(self._obj)
            self._obj = None
