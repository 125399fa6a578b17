"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``csrc/*.cu`` are compiled by nvcc at first use (``_build``).  Every
wrapper counts its kernel launches in a plain integer attribute
``launches``; ``launch_counts()`` / ``reset_launch_counts()`` read and zero
them all, so a run can show that it went through the kernels.
"""
from typing import Dict

from . import bellman as _bellman
from . import serve_scan as _serve_scan

WRAPPERS = {
    "bellman_banded": _bellman.bellman_banded,
    "bellman_banded_batched": _bellman.bellman_banded_batched,
    "serve_scan": _serve_scan.serve_scan,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
