"""Build the hand-written CUDA kernels at first use (nvcc -> .so -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
nvcc into its own shared library under ``build/repro_torch/`` at the root
of the checkout, named by a hash of the flags, the source and every local
header it includes (``csrc/*.cuh``), so a changed source or header
rebuilds and an unchanged one loads straight away.  No
PyTorch headers are included: a source builds in seconds.

``build_all()`` starts one nvcc per source at once and waits for all of
them; ``load(name)`` returns the loaded ``ctypes.CDLL`` (building it if
needed); ``function(name, symbol, restype, argtypes)`` returns one of its C
functions with its ctypes signature set once, so a launch does no more
than its checks and the call.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/repro_torch (this file is src/repro_torch/kernels/_build.py)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ARCH + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

#: per-source extra flags.  serve_scan must round t + means[a] * draw as
#: numpy does (product first): FMA contraction would move admissions by
#: one ulp and break decision-for-decision equality with the reference.
#: belief_forward fuses only where its plain version does (explicit fma).
#: fleet_scan rounds its clocks and crash energies the same way, and
#: mmpp_sample / sim_scan round t + gap, nsw + e * dwell, s * T + sum as
#: their plain walks do.  ssd_scan is held to tolerances, not bit for bit,
#: and keeps nvcc's default contraction.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "belief_forward": ["-fmad=false"],
    "bellman": [],
    "fleet_scan": ["-fmad=false"],
    "mmpp_sample": ["-fmad=false"],
    "serve_scan": ["-fmad=false"],
    "sim_scan": ["-fmad=false"],
    "flash_attention": [],
    "flash_attention_bwd": [],
    "decode_attention": [],
    "ssd_scan": [],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Any] = {}
#: compiler output (ptxas register / shared-memory report) per source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every local header it includes ("..."),
    directly or through another header, in the order first reached."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / inc.decode()).resolve())
    return found


def _target(name: str) -> Tuple[Path, List[str]]:
    """The library's path, named by a hash of the flags and of every source
    it compiles (a changed header rebuilds its includers), and the flags."""
    flags = BASE_FLAGS + EXTRA_FLAGS[name]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so", flags


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    so, flags = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, so


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file


def build_all() -> float:
    """Compile every source in parallel (one nvcc each); returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        names = sorted(EXTRA_FLAGS)
        started = {n: _start(n) for n in names}
        errors = []
        for n in names:  # wait for every process, even after a failure
            try:
                _finish(n, started[n])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)[0]))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, restype, argtypes: Sequence):
    """C function ``symbol`` of ``csrc/<name>.cu``, its signature set once."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _fns[(name, symbol)] = fn
    return fn
