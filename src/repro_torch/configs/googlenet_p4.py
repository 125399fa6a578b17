"""The paper's own serving scenario: GoogLeNet inference on a TESLA P4.

Not an LM architecture — this is the queueing-side config (Sec. VII basic
scenario): deterministic service, l(b) = 0.3051 b + 1.0524 ms,
zeta(b) = 19.899 b + 19.603 mJ, B in [1, 32].

    from repro_torch.configs.googlenet_p4 import paper_spec
    spec = paper_spec(rho=0.7, w2=1.6)
"""
from __future__ import annotations

import numpy as np

from ..core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
)

B_MIN, B_MAX = 1, 32


def service(family: str = "det") -> ServiceModel:
    return ServiceModel(latency=GOOGLENET_P4_LATENCY, family=family)


def paper_spec(
    rho: float = 0.7,
    w1: float = 1.0,
    w2: float = 1.0,
    s_max: int = 128,
    c_o: float = 100.0,
    family: str = "det",
) -> SMDPSpec:
    svc = service(family)
    lam = rho * B_MAX / float(svc.mean(B_MAX))
    return SMDPSpec(
        lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY,
        b_min=B_MIN, b_max=B_MAX, w1=w1, w2=w2, s_max=s_max, c_o=c_o,
    )


def energy_table() -> np.ndarray:
    return np.array(
        [0.0] + [float(GOOGLENET_P4_ENERGY(b)) for b in range(B_MIN, B_MAX + 1)]
    )
