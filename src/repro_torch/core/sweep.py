"""Batched spec sweeps: solve a whole w2 / lambda / profile grid at once.

Every figure in the paper (Fig. 4/5/8/9, Table III) is a sweep over some
spec parameter.  Here the grid is stacked into one BatchedSMDP
(smdp.build_smdp_batched) and solved by the lockstep batched RVI on the
device (rvi.relative_value_iteration_batched); with backup="pallas" each
lockstep backup of the whole batch is one launch of the spec-batched CUDA
Bellman kernel.  Policy evaluation and the abstract-cost calibration run
on the banded transition structure in numpy, so nothing on the sweep path
is O(S^2) per spec.

The paper's adaptive truncation rule (Sec. V: accept when the tail
tolerance Delta^pi < delta, else grow s_max) is applied batch-wide: after
each batched solve only the specs whose Delta still exceeds delta are
regrown and re-solved together.

The sweep defaults to accel="auto" — the accelerated solver (accel="mpi")
whenever the sweep reaches the slow-mixing regime, plain lockstep
otherwise — and each batch is re-ordered along (rho, w2) so the
anchor-interpolated warm starts chain along the rho axis.  The c_o probe
batch is reused as the first solve batch.  Results always come back in
the caller's original spec order.

sweep_solve_modulated / sweep_bank(phases=...) are the exact MMPP-aware
mirrors: the same ordering, c_o-probe reuse, warm-start chaining and
adaptive-truncation machinery runs on the (phase, queue) product chain
(smdp.build_smdp_modulated_batched) in float64 on the device, producing
(K, S) phase-indexed policies the serving layer consumes as table stacks.

guard=True (default) routes every batched solve through the rvi
guardrail ladder, and report_sink=[...] collects the merged SolveReport.
The durable, checkpointed sweep (checkpoint_dir=) is not ported yet
(ROADMAP.md, queue 1) and raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from .evaluate import (
    PolicyEval,
    _finish_from_batch,
    evaluate_policy_banded,
    evaluate_policy_batched,
    evaluate_policy_modulated,
    evaluate_policy_modulated_batched,
    stationary_distribution_batched,
)
from .policies import greedy_policy
from .rvi import (
    ACCEL_RHO_THRESHOLD as _ACCEL_RHO_THRESHOLD,
    SolveReport,
    relative_value_iteration_batched,
    relative_value_iteration_modulated,
)
from .smdp import (
    PhaseConfig,
    SMDPSpec,
    build_smdp_batched,
    build_smdp_modulated_batched,
    modulated_spec,
    phase_rho,
)
from .solve import ModulatedSolveResult, SolveResult


def sweep_bank(
    base: SMDPSpec,
    lams: Sequence[float],
    w2s: Optional[Sequence[float]] = None,
    profiles: Optional[dict] = None,
    phases: Optional[PhaseConfig] = None,
    **solve_kw,
):
    """Solve a lambda x w2 (x service-profile) grid as an SMDPSchedulerBank.

    The serving-side entry point for regime-adaptive scheduling: the bank's
    keyed action tables are what the serving layer hot-swaps as the
    arrival rate (or the energy price) drifts.  ``w2s`` defaults to the
    base spec's w2 (a pure lambda grid).

    ``profiles`` adds the third bank axis: a mapping from a numeric
    service-profile id to the spec fields that profile overrides (a dict
    for dataclasses.replace).  Keys become (lam, w2, profile).  All
    profiles must share b_max (the action axis cannot be padded).
    ``solve_kw`` goes to sweep_solve (``backup=``, ``device=``, ...).

    ``phases`` switches the bank to *exact MMPP-aware* solves: each lam is
    the target mean rate, the PhaseConfig's per-phase rates are scaled to
    hit it (same burst ratio and switching dynamics), and every table
    becomes a (K, S) phase-indexed stack solved on the (phase, queue)
    product chain (sweep_solve_modulated; ``solve_kw`` goes there).
    Mutually exclusive with ``profiles``.
    """
    from ..serving.scheduler import SMDPScheduler

    lams = list(lams)
    w2s = [base.w2] if w2s is None else list(w2s)
    if len(lams) == 0 or len(w2s) == 0:
        raise ValueError("sweep_bank needs at least one lam and one w2")
    if phases is not None:
        if profiles is not None:
            raise ValueError("phases= and profiles= are mutually exclusive")
        specs, phase_list, keys = [], [], []
        for lam in lams:
            ph = phases.scaled(float(lam) / phases.mean_rate)
            for w2 in w2s:
                specs.append(
                    modulated_spec(dataclasses.replace(base, w2=float(w2)), ph)
                )
                phase_list.append(ph)
                keys.append((float(lam), float(w2)))
        return SMDPScheduler.bank(
            sweep_solve_modulated(specs, phase_list, **solve_kw),
            keys=keys,
            key_names=("lam", "w2"),
        )
    variants = [(None, {})] if profiles is None else [
        (float(pid), dict(over)) for pid, over in profiles.items()
    ]
    if not variants:
        raise ValueError("profiles= must contain at least one profile")
    specs, keys = [], []
    for pid, over in variants:
        for lam in lams:
            for w2 in w2s:
                specs.append(
                    dataclasses.replace(
                        base, lam=float(lam), w2=float(w2), **over
                    )
                )
                keys.append(
                    (float(lam), float(w2))
                    if pid is None
                    else (float(lam), float(w2), pid)
                )
    key_names = ("lam", "w2") if profiles is None else ("lam", "w2", "profile")
    return SMDPScheduler.bank(
        sweep_solve(specs, **solve_kw), keys=keys, key_names=key_names
    )


def pad_specs(specs: Sequence[SMDPSpec]) -> List[SMDPSpec]:
    """Lift a mixed-truncation spec list to a shared s_max (batch padding).

    A larger truncation level only refines the approximation, so padding to
    the max is always sound.  b_max must already agree across specs — the
    action axis cannot be padded without changing feasible sets.
    """
    specs = list(specs)
    if not specs:
        return []
    b_maxes = {sp.b_max for sp in specs}
    if len(b_maxes) > 1:
        raise ValueError(f"sweep specs must share b_max; got {sorted(b_maxes)}")
    s_max = max(sp.s_max for sp in specs)
    # finite-buffer specs are never padded: their truncation level IS the
    # physical buffer (buffer == s_max is an exact-fold invariant)
    return [
        sp
        if sp.s_max == s_max or sp.buffer is not None
        else dataclasses.replace(sp, s_max=s_max)
        for sp in specs
    ]


def _greedy_c_o(batch) -> np.ndarray:
    """Per-spec abstract cost c_o = max(100, 2 * g_greedy) from a c_o=0 batch.

    The greedy gains of the whole probe batch come from one batched
    stationary solve; specs whose greedy chain degenerates keep the paper
    default of 100 (same fallback as the serial resolver).
    """
    pols = np.stack(
        [
            greedy_policy(sp.s_max, sp.b_min, sp.b_max)
            for sp in batch.specs
        ]
    )
    p = batch.policy_transitions_batched(pols)
    mu, ok = stationary_distribution_batched(p)
    out = np.empty(batch.n_specs)
    for i in range(batch.n_specs):
        if ok[i]:
            g = _finish_from_batch(batch, i, pols[i], mu[i]).g
        else:
            try:
                g = evaluate_policy_banded(batch, i, pols[i]).g
            except RuntimeError:
                g = 100.0
        out[i] = max(100.0, 2.0 * g)
    return out


def resolve_abstract_cost_batched(
    specs: Sequence[SMDPSpec],
) -> List[SMDPSpec]:
    """Batched solve.resolve_abstract_cost: c_o = max(100, 2 * g_greedy).

    One banded batch build of the c_o = 0 probes calibrates every spec's
    abstract cost (one batched stationary solve for all greedy gains).
    """
    specs = list(specs)
    probes = [dataclasses.replace(sp, c_o=0.0) for sp in specs]
    batch = build_smdp_batched(probes)
    c_os = _greedy_c_o(batch)
    return [
        dataclasses.replace(sp, c_o=float(c)) for sp, c in zip(specs, c_os)
    ]


def _round_plan(
    pending: List[tuple], chunk_size: Optional[int]
) -> List[List[tuple]]:
    """Chunked processing plan for one sweep round.

    Items are (idx, spec) tuples.  Groups by truncation level (ascending),
    stably sorts each group along (rho, w2) and splits groups into
    consecutive chunks of ``chunk_size`` (one chunk per group if None).
    """
    plan: List[List[tuple]] = []
    for s_max in sorted({it[1].s_max for it in pending}):
        group = [it for it in pending if it[1].s_max == s_max]
        group.sort(key=lambda it: (it[1].rho, it[1].w2))
        step = len(group) if chunk_size is None else int(chunk_size)
        for k in range(0, len(group), step):
            plan.append(group[k : k + step])
    return plan


def _nan_eval(n_states: int) -> PolicyEval:
    """Placeholder eval for rows the guard ladder could not heal."""
    nan = float("nan")
    return PolicyEval(
        g=nan,
        delta=nan,
        w_bar=nan,
        p_bar=nan,
        mu=np.full(n_states, np.nan),
        mean_batch=nan,
        throughput=nan,
    )


def _eval_healthy(
    batch,
    policies: np.ndarray,
    healthy: np.ndarray,
    batched_eval: Callable,
    n_states: Callable[[SMDPSpec], int],
) -> List[PolicyEval]:
    """Evaluate only ladder-healthy rows; failed rows get NaN placeholders.

    evaluate_* rejects the garbage policies a failed row carries, so those
    rows are masked out of the batched stationary solve entirely and come
    back as all-NaN PolicyEvals (the sweep accepts them without
    regrowing)."""
    if healthy.all():
        return batched_eval(batch, policies)
    evs: List[Optional[PolicyEval]] = [None] * len(healthy)
    ok = [int(i) for i in np.flatnonzero(healthy)]
    if ok:
        sub = batched_eval(batch.take(ok), policies[np.asarray(ok)])
        for j, e in zip(ok, sub):
            evs[j] = e
    return [
        e if e is not None else _nan_eval(n_states(batch.specs[j]))
        for j, e in enumerate(evs)
    ]


#: below this batch width the anchor pre-solve costs more than it saves
_WARM_START_MIN = 6


def _warm_start_t(specs: Sequence[SMDPSpec], c_feat: np.ndarray) -> np.ndarray:
    """Per-spec interpolation coordinate t in [0, 1] along the anchor pair.

      * rho varies across the batch — project the normalized (rho, w2)
        parameter point onto the anchor segment (c_tilde is NOT affine in
        lambda: the arrival pmfs move with it);
      * rho constant (w2 / energy-profile sweeps) — project the cost
        features ``c_feat`` (finite c_tilde entries, flattened per spec)
        onto the anchor segment, exact for any parameter c_tilde is
        affine in.
    """
    rhos = np.array([sp.rho for sp in specs])
    w2s = np.array([sp.w2 for sp in specs])
    if abs(rhos[-1] - rhos[0]) > 1e-12:

        def norm(v):
            span = v[-1] - v[0]
            return (v - v[0]) / span if abs(span) > 1e-12 else np.zeros_like(v)

        theta = np.stack([norm(rhos), norm(w2s)], axis=1)  # (N, 2)
        d = theta[-1] - theta[0]
        return np.clip(theta @ d / float(d @ d), 0.0, 1.0)
    d = c_feat[-1] - c_feat[0]
    denom = float(d @ d)
    if denom <= 0.0:
        return np.zeros(len(specs))
    return np.clip((c_feat - c_feat[0]) @ d / denom, 0.0, 1.0)


def _anchor_warm_start(batch, eps: float, max_iter: int, **rvi_kw):
    """Interpolated h0 from solving the two end-of-batch anchor specs.

    Any h0 reaches the same fixed point — a good one just makes the
    batched RVI converge in fewer lockstep iterations.  The batch is
    pre-sorted along (rho, w2) by sweep_solve, so the anchors are the
    extreme-rho specs and interpolation chains along the rho axis.
    """
    if batch.n_specs < _WARM_START_MIN:
        return None
    anchors = relative_value_iteration_batched(
        batch.take([0, batch.n_specs - 1]), eps=eps, max_iter=max_iter, **rvi_kw
    )
    mask = batch.feasible.all(axis=0)  # finite c_tilde in every spec
    t = _warm_start_t(batch.specs, batch.c_tilde[:, mask])
    return (1.0 - t)[:, None] * anchors.h[0] + t[:, None] * anchors.h[1]


def _anchor_warm_start_modulated(mbatch, eps: float, max_iter: int, **rvi_kw):
    """Modulated anchor warm start: h0 chains along rho per phase block.

    The discipline of _anchor_warm_start — the anchors are the
    extreme-(rho, w2) specs of the pre-sorted batch — with the (K, S)
    phase-blocked h interpolated jointly (every phase block shares the
    spec's interpolation coordinate: the whole chain moves with (rho, w2)).
    """
    if mbatch.n_specs < _WARM_START_MIN:
        return None
    anchors = relative_value_iteration_modulated(
        mbatch.take([0, mbatch.n_specs - 1]), eps=eps, max_iter=max_iter, **rvi_kw
    )
    mask = mbatch.feasible.all(axis=0)  # (S, A) feasible in every spec
    c_feat = mbatch.c_tilde[:, :, mask].reshape(mbatch.n_specs, -1)
    t = _warm_start_t(mbatch.specs, c_feat)
    return (
        (1.0 - t)[:, None, None] * anchors.h[0]
        + t[:, None, None] * anchors.h[1]
    )


def sweep_solve(
    specs: Sequence[SMDPSpec],
    eps: float = 1e-2,
    max_iter: int = 10_000,
    delta: float = 1e-3,
    grow_factor: float = 1.5,
    max_s_max: int = 4096,
    auto_c_o: bool = True,
    accel: str = "auto",
    backup: str = "banded",
    guard: bool = True,
    report_sink: Optional[list] = None,
    checkpoint_dir: Optional[str] = None,
    chunk_size: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> List[SolveResult]:
    """Batched equivalent of solve.solve() over a list of specs.

    Returns one SolveResult per input spec, in input order; each matches the
    serial solver's output for the same spec to solver tolerance.  Specs with
    differing s_max are padded to the batch maximum first.  Results carry no
    dense tensors — ``result.mdp`` materializes one lazily if accessed.

    ``accel`` / ``backup`` are forwarded to the batched RVI, which runs on
    ``device`` (CUDA unless ``device="cpu"``).  The default "auto" routes
    through accel="mpi" whenever the sweep reaches into the slow-mixing
    regime (any rho >= ACCEL_RHO_THRESHOLD) and stays on the plain
    lockstep path otherwise.  ``chunk_size`` splits each round's batches.

    ``guard`` (default on) runs every batched solve through the rvi
    guardrail ladder; rows the full ladder cannot heal come back with NaN
    evals rather than raising, on every device.  On a CUDA device with
    backup="pallas" a row that the banded rung heals raises instead: the
    kernel disagreed with its plain version there (rvi._ladder).  Pass a
    list as ``report_sink`` to receive one merged rvi.SolveReport for the
    sweep.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointed sweeps (checkpoint_dir=) are not ported yet "
            "(see ROADMAP.md, queue 1)"
        )
    dev = resolve_device(device)
    specs = list(specs)
    flags = {sp.buffer is not None for sp in specs}
    if len(flags) > 1:
        raise ValueError(
            "sweep_solve cannot mix finite-buffer and tail-abstracted "
            "specs in one batch; solve the two families separately"
        )
    if flags and flags.pop():
        # finite-buffer solves: no abstract tail to calibrate, and Delta
        # is not a truncation error (B is physical) — never regrow
        auto_c_o = False
        delta = None
    specs = pad_specs(specs)
    if not specs:
        return []
    if accel == "auto":
        accel = (
            "mpi"
            if max(sp.rho for sp in specs) >= _ACCEL_RHO_THRESHOLD
            else "none"
        )
    # chain the work along rho (then w2) once, up front: the warm-start
    # anchors become the extreme-rho specs, where mixing is worst, and the
    # c_o probe batch can be reused (row-patched) as the first solve batch
    order = sorted(
        range(len(specs)), key=lambda i: (specs[i].rho, specs[i].w2)
    )
    prebuilt = None
    if auto_c_o:
        probe_batch = build_smdp_batched(
            [dataclasses.replace(specs[i], c_o=0.0) for i in order]
        )
        prebuilt = probe_batch.with_c_o(_greedy_c_o(probe_batch))
        base = list(prebuilt.specs)
    else:
        base = [specs[i] for i in order]
    pending = list(zip(order, base))
    results: List[SolveResult] = [None] * len(specs)  # type: ignore[list-item]
    report_parts: List[Tuple[SolveReport, List[int]]] = []
    next_round: List[tuple] = []
    rvi_kw = dict(accel=accel, backup=backup, device=dev)
    while pending:
        for chunk in _round_plan(pending, chunk_size):
            if (
                prebuilt is not None
                and len(chunk) == prebuilt.n_specs
                and all(a is b for (_, a), b in zip(chunk, prebuilt.specs))
            ):
                batch = prebuilt
            else:
                batch = build_smdp_batched([sp for _, sp in chunk])
            rvi = relative_value_iteration_batched(
                batch,
                eps=eps,
                max_iter=max_iter,
                h0=_anchor_warm_start(batch, eps, max_iter, **rvi_kw),
                guard=guard,
                **rvi_kw,
            )
            if rvi.report is not None:
                healthy = rvi.report.healthy
                report_parts.append((rvi.report, [idx for idx, _ in chunk]))
            else:
                healthy = np.ones(len(chunk), dtype=bool)
            evs = _eval_healthy(batch, rvi.policies, healthy,
                                evaluate_policy_batched, lambda sp: sp.s_max + 1)
            for row, (idx, sp) in enumerate(chunk):
                ev = evs[row]
                if (
                    not healthy[row]
                    # ladder-exhausted row: keep the NaN-flagged result
                    # (growing the truncation cannot heal divergence)
                    or delta is None
                    or ev.delta < delta
                    or sp.s_max >= max_s_max
                ):
                    results[idx] = SolveResult(
                        spec=sp, rvi=rvi.unstack(row), eval=ev
                    )
                else:
                    next_round.append(
                        (
                            idx,
                            dataclasses.replace(
                                sp,
                                s_max=min(
                                    int(np.ceil(sp.s_max * grow_factor)),
                                    max_s_max,
                                ),
                            ),
                        )
                    )
        prebuilt = None
        pending, next_round = next_round, []
    if report_sink is not None:
        report_sink.append(
            SolveReport.merged(report_parts, len(specs), eps)
            if report_parts
            else _report_of(results, eps)
        )
    return results


def _report_of(results: List[SolveResult], eps: float) -> SolveReport:
    """Certificates recomputed from solved results (an unguarded sweep has
    no ladder record): health from the arrays, no rung attribution."""
    span = np.array([r.rvi.span for r in results])
    conv = np.array([r.rvi.converged for r in results], dtype=bool)
    healthy = np.array(
        [
            bool(c) and np.isfinite(r.rvi.g) and bool(np.isfinite(r.rvi.h).all())
            for r, c in zip(results, conv)
        ],
        dtype=bool,
    )
    return SolveReport(
        eps=eps,
        span=span,
        converged=conv,
        healthy=healthy,
        failed=[k for k in range(len(results)) if not healthy[k]],
    )


# ---------------------------------------------------------------------------
# Phase-modulated sweeps (exact MMPP-aware solves)
# ---------------------------------------------------------------------------


def _greedy_c_o_modulated(mbatch) -> np.ndarray:
    """Per-spec abstract cost c_o = max(100, 2 * g_greedy), modulated chain.

    The greedy policy is phase-independent (largest feasible batch now), so
    its (K, S) lift is the scalar table tiled across phases; gains come
    from the batched product-chain stationary solve."""
    K = mbatch.n_phases
    pols = np.stack(
        [
            np.tile(greedy_policy(sp.s_max, sp.b_min, sp.b_max)[None, :], (K, 1))
            for sp in mbatch.specs
        ]
    )
    out = np.empty(mbatch.n_specs)
    try:
        evs = evaluate_policy_modulated_batched(mbatch, pols)
        for i, ev in enumerate(evs):
            out[i] = max(100.0, 2.0 * ev.g)
    except RuntimeError:
        for i in range(mbatch.n_specs):
            try:
                g = evaluate_policy_modulated(mbatch, i, pols[i]).g
            except RuntimeError:
                g = 100.0
            out[i] = max(100.0, 2.0 * g)
    return out


def sweep_solve_modulated(
    specs: Sequence[SMDPSpec],
    phases,
    eps: float = 1e-2,
    max_iter: int = 10_000,
    delta: float = 1e-3,
    grow_factor: float = 1.5,
    max_s_max: int = 1024,
    auto_c_o: bool = True,
    accel: str = "auto",
    guard: bool = True,
    report_sink: Optional[list] = None,
    checkpoint_dir: Optional[str] = None,
    chunk_size: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> List[ModulatedSolveResult]:
    """Batched exact MMPP-aware solves over aligned (spec, phases) pairs.

    The modulated mirror of sweep_solve: specs are padded to a shared
    s_max, sorted along (rho, w2) so anchor warm starts chain along the
    rho axis per phase block, the c_o = 0 probe batch calibrates every
    abstract cost with one batched product-chain stationary solve (then
    row-patched via with_c_o, never rebuilt), and the paper's adaptive
    truncation rule regrows only the specs whose Delta (summed over every
    phase's overflow state) still exceeds ``delta``.  Results return in
    input order; each carries the (K, S) phase-indexed policy.  The RVI
    runs in float64 on ``device`` (CUDA unless ``device="cpu"``).

    ``phases`` may be one shared PhaseConfig or a sequence aligned with
    ``specs``.  ``max_s_max`` defaults lower than the scalar sweep: the
    product chain is K x larger per state.  ``guard`` / ``report_sink``
    behave as in sweep_solve; ``checkpoint_dir`` is not ported yet.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointed sweeps (checkpoint_dir=) are not ported yet "
            "(see ROADMAP.md, queue 1)"
        )
    dev = resolve_device(device)
    specs = list(specs)
    if not specs:
        return []
    if isinstance(phases, PhaseConfig):
        phases = [phases] * len(specs)
    phases = list(phases)
    if len(phases) != len(specs):
        raise ValueError(f"{len(phases)} phase configs for {len(specs)} specs")
    specs = pad_specs(specs)
    if accel == "auto":
        # the burst phase sets the mixing wall: key on max within-phase rho
        rho_z = max(phase_rho(sp, ph) for sp, ph in zip(specs, phases))
        accel = "mpi" if rho_z >= _ACCEL_RHO_THRESHOLD else "none"
    order = sorted(range(len(specs)), key=lambda i: (specs[i].rho, specs[i].w2))
    prebuilt = None
    if auto_c_o:
        probe = build_smdp_modulated_batched(
            [dataclasses.replace(specs[i], c_o=0.0) for i in order],
            [phases[i] for i in order],
        )
        prebuilt = probe.with_c_o(_greedy_c_o_modulated(probe))
        base = list(prebuilt.specs)
    else:
        base = [specs[i] for i in order]
    pending = [(i, sp, phases[i]) for i, sp in zip(order, base)]
    results: List[ModulatedSolveResult] = [None] * len(specs)  # type: ignore[list-item]
    report_parts: List[Tuple[SolveReport, List[int]]] = []
    next_round: List[tuple] = []
    rvi_kw = dict(accel=accel, device=dev)
    while pending:
        for chunk in _round_plan(pending, chunk_size):
            if (
                prebuilt is not None
                and len(chunk) == prebuilt.n_specs
                and all(a is b for (_, a, _), b in zip(chunk, prebuilt.specs))
            ):
                mbatch = prebuilt
            else:
                mbatch = build_smdp_modulated_batched(
                    [sp for _, sp, _ in chunk], [ph for _, _, ph in chunk]
                )
            rvi = relative_value_iteration_modulated(
                mbatch,
                eps=eps,
                max_iter=max_iter,
                h0=_anchor_warm_start_modulated(mbatch, eps, max_iter, **rvi_kw),
                guard=guard,
                **rvi_kw,
            )
            if rvi.report is not None:
                healthy = rvi.report.healthy
                report_parts.append((rvi.report, [idx for idx, _, _ in chunk]))
            else:
                healthy = np.ones(len(chunk), dtype=bool)
            evs = _eval_healthy(
                mbatch, rvi.policies, healthy, evaluate_policy_modulated_batched,
                lambda sp: mbatch.n_phases * (sp.s_max + 1),
            )
            for row, (idx, sp, ph) in enumerate(chunk):
                ev = evs[row]
                if (
                    not healthy[row]
                    or delta is None
                    or ev.delta < delta
                    or sp.s_max >= max_s_max
                ):
                    results[idx] = ModulatedSolveResult(
                        spec=sp, phases=ph, rvi=rvi.unstack(row), eval=ev
                    )
                else:
                    next_round.append((
                        idx,
                        dataclasses.replace(
                            sp,
                            s_max=min(int(np.ceil(sp.s_max * grow_factor)), max_s_max),
                        ),
                        ph,
                    ))
        prebuilt = None
        pending, next_round = next_round, []
    if report_sink is not None:
        report_sink.append(
            SolveReport.merged(report_parts, len(specs), eps)
            if report_parts
            else _report_of(results, eps)
        )
    return results


def solve_modulated(
    spec: SMDPSpec, phases: PhaseConfig, **kw
) -> ModulatedSolveResult:
    """Exact MMPP-aware solve of one spec (the N == 1 modulated sweep).

    ``spec.lam`` must equal ``phases.mean_rate`` (use smdp.modulated_spec).
    The K = 1 degenerate config reproduces the scalar solve() policy — the
    safety rail the tests pin.  ``device=None`` means CUDA.
    """
    return sweep_solve_modulated([spec], phases, **kw)[0]
