"""High-level solver: build -> RVI -> tail-tolerance check (paper Sec. V).

Implements the paper's adaptive truncation rule: accept the approximation
when Delta^pi < delta, else grow s_max and re-solve.  The abstract cost c_o
is what keeps the accepted s_max small (Table II).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from .evaluate import PolicyEval, evaluate_policy
from .rvi import RVIResult, relative_value_iteration
from .smdp import SMDPSpec, TruncatedSMDP, build_smdp


@dataclasses.dataclass
class SolveResult:
    spec: SMDPSpec
    rvi: RVIResult
    eval: PolicyEval
    # dense tensors are only needed by a few consumers; sweeps skip them
    _mdp: Optional[TruncatedSMDP] = None

    @property
    def mdp(self) -> TruncatedSMDP:
        """The dense truncated SMDP (materialized on first access)."""
        if self._mdp is None:
            self._mdp = build_smdp(self.spec)
        return self._mdp

    @property
    def policy(self) -> np.ndarray:
        return self.rvi.policy

    def action(self, s: int) -> int:
        """Infinite-state policy pi_eps (eq. 30)."""
        s_max = self.spec.s_max
        return int(self.policy[min(s, s_max)])

    def action_table(self, upto: Optional[int] = None) -> np.ndarray:
        """Dense lookup table for the serving scheduler."""
        upto = upto if upto is not None else self.spec.s_max
        return np.array([self.action(s) for s in range(upto + 1)], dtype=np.int64)


def resolve_abstract_cost(spec: SMDPSpec) -> SMDPSpec:
    """Scale-aware default for the abstract cost c_o (beyond-paper).

    The paper fixes c_o ~ 100 for its cost scale (w2 <= 15).  For large
    energy weights the tail-cost estimate must grow with the objective
    scale, or the truncated model prefers parking at S_o ("always wait" —
    the failure mode the paper reports for underestimated c_o).  We bound
    the optimal average cost by the greedy policy's cost and set
    c_o = 2 * g_greedy: parked-at-S_o then always looks worse than serving.
    """
    from .policies import greedy_policy

    probe = dataclasses.replace(spec, c_o=0.0)
    mdp0 = build_smdp(probe)
    try:
        g = evaluate_policy(
            mdp0, greedy_policy(spec.s_max, spec.b_min, spec.b_max)
        ).g
    except RuntimeError:
        g = 100.0
    return dataclasses.replace(spec, c_o=max(100.0, 2.0 * g))


def solve(
    spec: SMDPSpec,
    eps: float = 1e-2,
    max_iter: int = 10_000,
    delta: Optional[float] = 1e-3,
    grow_factor: float = 1.5,
    max_s_max: int = 4096,
    backup: str = "banded",
    auto_c_o: bool = True,
    accel: str = "none",
    *,
    device: DeviceLike = None,
) -> SolveResult:
    """Solve the dynamic-batching SMDP; auto-grow s_max until Delta < delta.

    The RVI runs on ``device`` (CUDA unless ``device="cpu"``); building
    the SMDP and evaluating the policy stay numpy on the host.
    """
    dev = resolve_device(device)
    cur = spec
    if cur.buffer is not None:
        # finite-buffer solve: no abstract tail to calibrate, and Delta is
        # not a truncation error (B is physical) — never regrow
        auto_c_o = False
        delta = None
    if auto_c_o:
        cur = resolve_abstract_cost(cur)
    while True:
        mdp = build_smdp(cur)
        res = relative_value_iteration(
            mdp, eps=eps, max_iter=max_iter, backup=backup, accel=accel,
            device=dev,
        )
        ev = evaluate_policy(mdp, res.policy)
        if delta is None or ev.delta < delta or cur.s_max >= max_s_max:
            return SolveResult(spec=cur, rvi=res, eval=ev, _mdp=mdp)
        cur = dataclasses.replace(
            cur, s_max=min(int(np.ceil(cur.s_max * grow_factor)), max_s_max)
        )
