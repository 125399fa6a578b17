"""The plain PyTorch versions of every kernel, in one place.

Counterpart of repro.kernels.ref.  Each plain version is defined in its
kernel's module beside the wrapper; tests and the chip check hold the
kernels against these.
"""
from .bellman import bellman_banded_batched_ref, bellman_banded_ref  # noqa: F401
from .decode_attention import decode_attention_ref  # noqa: F401
from .flash_attention import attention_ref, lse_ref  # noqa: F401
from .flash_attention_bwd import flash_attention_bwd_ref  # noqa: F401
from .serve_scan import serve_scan_ref  # noqa: F401
from .ssd_scan import ssd_scan_ref  # noqa: F401
