"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

``csrc/*.cu`` are compiled by nvcc at first use (``_build``).  Every
wrapper counts its kernel launches in a plain integer attribute
``launches``; ``launch_counts()`` / ``reset_launch_counts()`` read and zero
them all, so a run can show that it went through the kernels.  A wrapper
with several kernel instances also counts each in ``instance_launches``
(reported as ``"<wrapper>:<instance>"``).
"""
from typing import Dict

from . import belief_forward as _belief
from . import bellman as _bellman
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import flash_attention_bwd as _flash_bwd
from . import fleet_scan as _fleet_scan
from . import mmpp_sample as _mmpp_sample
from . import serve_scan as _serve_scan
from . import sim_scan as _sim_scan
from . import ssd_scan as _ssd_scan
from . import wkv6_scan as _wkv6_scan

WRAPPERS = {
    "bellman_banded": _bellman.bellman_banded,
    "bellman_banded_batched": _bellman.bellman_banded_batched,
    "serve_scan": _serve_scan.serve_scan,
    "belief_forward": _belief.belief_forward,
    "fleet_scan": _fleet_scan.fleet_scan,
    "mmpp_sample": _mmpp_sample.mmpp_sample,
    "sim_scan": _sim_scan.sim_scan,
    "flash_attention": _flash.flash_attention,
    "flash_attention_bwd": _flash_bwd.flash_attention_bwd,
    "decode_attention": _decode.decode_attention,
    "ssd_scan": _ssd_scan.ssd_scan,
    "wkv6_scan": _wkv6_scan.wkv6_scan,
}


def launch_counts() -> Dict[str, int]:
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    for name, fn in WRAPPERS.items():
        for inst, n in sorted(getattr(fn, "instance_launches", {}).items()):
            counts[f"{name}:{inst}"] = n
    return counts


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "instance_launches"):
            fn.instance_launches = {}
