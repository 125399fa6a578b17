"""Latency/energy profiles: the paper's GPU tables + TPU-v5e roofline-derived.

The paper profiles l(b), zeta(b) on NVIDIA GPUs.  Our target is TPU v5e, so
we *derive* per-architecture profiles from the roofline model:

    l(b)    = n_tokens * max( b * flops_tok / PEAK_FLOPS,
                              (param_bytes + b * kv_bytes) / HBM_BW )
    zeta(b) = P_STATIC * l(b) + E_FLOP * n_tokens * b * flops_tok

Both satisfy the paper's monotonicity assumptions (theta, eta non-decreasing):
l is a max of affines with non-negative intercepts; zeta is static power over
a non-decreasing time plus a linear term.

Hardware constants (TPU v5e, per chip): 197 TFLOP/s bf16, 819 GB/s HBM.
Power: ~60 W idle/static, ~200 W at full MXU utilization (modeled).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .service_models import PiecewiseMaxProfile, ServiceModel

PEAK_FLOPS = 197e12  # bf16 FLOP/s per chip
HBM_BW = 819e9  # bytes/s per chip
P_STATIC = 60.0  # W
P_PEAK = 200.0  # W at full utilization
E_FLOP = (P_PEAK - P_STATIC) / PEAK_FLOPS  # J per FLOP (dynamic)


@dataclasses.dataclass(frozen=True)
class DecodeWorkload:
    """One unit of batch service = decoding `n_tokens` tokens per request."""

    flops_per_token: float  # ~2 * N_active params
    param_bytes: float  # weight bytes streamed per decode step
    kv_bytes_per_request: float  # KV/state bytes read per step per request
    n_tokens: int = 32  # tokens per service segment
    chips: int = 1  # chips the model is sharded over


def tpu_decode_latency(w: DecodeWorkload) -> PiecewiseMaxProfile:
    """l(b) in milliseconds (matching the paper's units)."""
    compute_slope = w.n_tokens * w.flops_per_token / (PEAK_FLOPS * w.chips) * 1e3
    mem_intercept = w.n_tokens * w.param_bytes / (HBM_BW * w.chips) * 1e3
    mem_slope = w.n_tokens * w.kv_bytes_per_request / (HBM_BW * w.chips) * 1e3
    return PiecewiseMaxProfile(
        slope1=compute_slope,
        intercept1=0.0,
        slope2=mem_slope,
        intercept2=mem_intercept,
    )


@dataclasses.dataclass(frozen=True)
class TPUEnergyProfile:
    """zeta(b) in millijoules: static power * l(b) + dynamic per-FLOP energy."""

    latency: PiecewiseMaxProfile
    dyn_mj_per_batch: float  # E_FLOP * n_tokens * flops_tok (per request) * 1e3
    p_static: float = P_STATIC

    def __call__(self, b):
        import numpy as np

        barr = np.asarray(b, dtype=np.float64)
        # l is in ms -> static energy in mJ = W * ms
        return self.p_static * self.latency(barr) + self.dyn_mj_per_batch * barr


def tpu_service_model(
    w: DecodeWorkload, family: str = "det", **kw
) -> tuple[ServiceModel, TPUEnergyProfile]:
    lat = tpu_decode_latency(w)
    energy = TPUEnergyProfile(
        latency=lat,
        dyn_mj_per_batch=E_FLOP * w.n_tokens * w.flops_per_token / w.chips * w.chips * 1e3,
    )
    return ServiceModel(latency=lat, family=family, **kw), energy


def workload_for_arch(
    n_params_active: float,
    n_layers: int,
    kv_heads: int,
    head_dim: int,
    context_len: int = 8192,
    n_tokens: int = 32,
    chips: int = 1,
    state_bytes: Optional[float] = None,  # for SSM archs: per-request state
    dtype_bytes: int = 2,
) -> DecodeWorkload:
    kv = (
        state_bytes
        if state_bytes is not None
        else 2 * n_layers * kv_heads * head_dim * context_len * dtype_bytes
    )
    return DecodeWorkload(
        flops_per_token=2.0 * n_params_active,
        param_bytes=n_params_active * dtype_bytes,
        kv_bytes_per_request=float(kv),
        n_tokens=n_tokens,
        chips=chips,
    )
