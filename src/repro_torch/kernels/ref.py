"""The plain PyTorch versions of every kernel, in one place.

Counterpart of repro.kernels.ref.  Each plain version is defined in its
kernel's module beside the wrapper; tests and the chip check hold the
kernels against these.
"""
from .bellman import bellman_banded_batched_ref, bellman_banded_ref  # noqa: F401
from .serve_scan import serve_scan_ref  # noqa: F401
