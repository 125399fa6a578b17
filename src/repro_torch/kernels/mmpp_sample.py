"""The MMPP(2) arrival sampler's walk: its wrapper and plain version.

Per lane, the competing-clocks carry (t, phase, next_switch) is walked
over pre-drawn unit exponentials ``draws[lane] = (E_0, E_g[0], E_d[0],
E_g[1], E_d[1], ...)`` -- ``1 + 2 * n_steps`` of them:

    t = 0, phase = 0, nsw = E_0 * dwell[0]
    gap    = E_g[i] / lam[phase]
    switch = t + gap >= nsw
    switch: phase = 1 - phase, t = nsw, nsw = nsw + E_d[i] * dwell[phase]
    else:   t = t + gap

and every step writes (t, not switch, phase).  This is the ``step`` of
the reference's ``mmpp2_times_jax`` (src/repro/serving/arrivals.py:580-593)
with its ``jax.random`` draws replaced by the shared stream, so the kernel
and this plain walk read the same numbers and agree exactly.

The kernel is ``csrc/mmpp_sample.cu``, the device counterpart of the
reference's ``lax.scan`` (not of a Pallas kernel).  Draws given as CPU
tensors run the plain version below; CUDA tensors launch the kernel or
raise.  ``mmpp_sample.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..device import refuse_grad
from . import _build


def _check(draws, lam, dwell) -> int:
    if (not isinstance(draws, torch.Tensor) or draws.dtype != torch.float64
            or draws.dim() != 2):
        raise TypeError("draws must be a 2-d float64 tensor (lanes, 1 + 2 n_steps)")
    if draws.shape[1] < 3 or draws.shape[1] % 2 != 1:
        raise ValueError(f"draws need 1 + 2 n_steps columns, got {draws.shape[1]}")
    if len(lam) != 2 or len(dwell) != 2:
        raise ValueError("lam and dwell are (phase 0, phase 1) pairs")
    return (draws.shape[1] - 1) // 2


def mmpp_sample_ref(draws, lam: Sequence[float], dwell: Sequence[float]):
    """Plain version: the walk in torch ops on the draws' device, all
    lanes a step at a time.  Returns (times (L, n) f64, emitted (L, n)
    bool, phases (L, n) int32)."""
    n = _check(draws, lam, dwell)
    L = draws.shape[0]
    dev = draws.device
    e_g, e_d = draws[:, 1::2], draws[:, 2::2]
    lam_t = torch.tensor([float(lam[0]), float(lam[1])], dtype=torch.float64, device=dev)
    dw_t = torch.tensor([float(dwell[0]), float(dwell[1])], dtype=torch.float64, device=dev)
    times = torch.empty((L, n), dtype=torch.float64, device=dev)
    emitted = torch.empty((L, n), dtype=torch.bool, device=dev)
    phases = torch.empty((L, n), dtype=torch.int32, device=dev)
    t = torch.zeros(L, dtype=torch.float64, device=dev)
    phase = torch.zeros(L, dtype=torch.long, device=dev)
    nsw = draws[:, 0] * dw_t[0]
    for i in range(n):
        cand = t + e_g[:, i] / lam_t[phase]
        sw = cand >= nsw
        phase = torch.where(sw, 1 - phase, phase)
        t = torch.where(sw, nsw, cand)
        nsw = torch.where(sw, nsw + e_d[:, i] * dw_t[phase], nsw)
        times[:, i] = t
        emitted[:, i] = ~sw
        phases[:, i] = phase
    return times, emitted, phases


def mmpp_sample(draws, lam: Sequence[float], dwell: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk over (L, 1 + 2 n) f64 ``draws`` with ``lam`` / ``dwell``
    the (phase 0, phase 1) rates and mean dwells.  Returns (times (L, n)
    f64, emitted (L, n) bool, phases (L, n) int32) on the draws' device."""
    n = _check(draws, lam, dwell)
    if draws.device.type == "cpu":
        return mmpp_sample_ref(draws, lam, dwell)
    if draws.device.type != "cuda":
        raise ValueError(f"unsupported device {draws.device}")
    refuse_grad("mmpp_sample", draws)
    L = draws.shape[0]
    dev = draws.device
    draws = draws.contiguous()
    times = torch.empty((L, n), dtype=torch.float64, device=dev)
    emitted = torch.empty((L, n), dtype=torch.uint8, device=dev)
    phases = torch.empty((L, n), dtype=torch.int32, device=dev)
    fn = _build.function("mmpp_sample", "mmpp_sample_launch", ctypes.c_int,
                         [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                         + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 4)
    rc = fn(draws.data_ptr(), L, n, float(lam[0]), float(lam[1]), float(dwell[0]),
            float(dwell[1]), times.data_ptr(), emitted.data_ptr(), phases.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mmpp_sample launch failed: CUDA error {rc}")
    mmpp_sample.launches += 1
    return times, emitted.view(torch.bool), phases


mmpp_sample.launches = 0
