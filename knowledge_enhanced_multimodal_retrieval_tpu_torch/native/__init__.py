"""Native (C++) host-side components, loaded via ctypes.

The device compute path is PyTorch and the CUDA kernels of ``csrc/``; these
are the *host* hot paths (the port's own copies of the reference package's
``native/`` sources). Each
component builds lazily with ``g++`` on first use and degrades gracefully to
the pure-Python implementation when a toolchain is unavailable.
"""

from .build import load_library, native_available  # noqa: F401
