"""Generate the latency-power tradeoff curve (paper Fig. 5) as CSV.

The port of examples/tradeoff_sweep.py: the SMDP points come from one
batched sweep over the w2 grid (core.tradeoff.smdp_tradeoff_curve ->
core.sweep.sweep_solve), the benchmark rows from evaluating the greedy and
static-b policies.  ``--backup pallas`` runs every lockstep backup of the
sweep as one launch of the spec-batched CUDA Bellman kernel.

    PYTHONPATH=src python -m repro_torch.launch.tradeoff_sweep --device cpu
        [--rho 0.7] [--b-max 32] [--w2 0 0.2 ...] [--backup banded|pallas]
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ServiceModel,
    SMDPSpec,
)
from ..core.tradeoff import TradeoffPoint, benchmark_points, smdp_tradeoff_curve

#: the example's energy weights (Fig. 5)
W2_DEFAULT = [0.0, 0.2, 0.5, 0.8, 1.3, 1.6, 2.2, 3.5, 5.0, 8.0, 15.0, 50.0]


def fig5_spec(rho: float = 0.7, b_max: int = 32) -> SMDPSpec:
    """The paper's Table-I service (GoogLeNet on a Tesla P4) at load rho."""
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    lam = rho * b_max / float(svc.mean(b_max))
    return SMDPSpec(lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY,
                    b_min=1, b_max=b_max, w1=1.0, w2=0.0, s_max=128)


def main(argv: Optional[List[str]] = None) -> List[TradeoffPoint]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rho", type=float, default=0.7)
    ap.add_argument("--b-max", type=int, default=32)
    ap.add_argument("--w2", type=float, nargs="+", default=W2_DEFAULT)
    ap.add_argument("--backup", choices=("banded", "pallas"), default="banded")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    spec = fig5_spec(args.rho, args.b_max)
    points = smdp_tradeoff_curve(spec, args.w2, backup=args.backup,
                                 device=args.device)
    print("policy,w2,W_ms,P_watt")
    for pt in points:
        print(f"smdp,{pt.w2},{pt.w_bar:.4f},{pt.p_bar:.4f}")
    for name, (w, p) in benchmark_points(spec).items():
        print(f"{name},,{w:.4f},{p:.4f}")
    print("# pareto frontier = smdp rows; benchmarks lie on/above it",
          file=sys.stderr)
    return points


if __name__ == "__main__":
    main()
