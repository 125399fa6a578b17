"""Serving layer of the port: one event semantics, two backends.

serving.engine runs every mode (profiled virtual clock, wall-clock
executor, trace replay) through a single Python event loop, and exposes
the same semantics compiled (run(backend="compiled")) -- one launch of the
CUDA event kernel, serving.compiled, whose run_grid / run_grid_adaptive
run whole seeds x tables sweeps in one launch; serving.arrivals supplies
the numpy arrival processes, the on-device samplers (poisson_times,
mmpp2_times -- one launch of the MMPP sampler kernel -- and diurnal_times)
and the MMPP phase filter (belief_forward: a whole trace's posterior in
one launch of the belief kernel);
serving.scheduler the policy tables and the
bank-retuning AdaptiveController and the phase schedulers (oracle,
belief-filtered, rate-tracked); serving.metrics the latency quantiles
(P² on the Python path, a fixed-bin histogram sketch on the compiled
path).  serving.fleet routes one arrival stream across M replicas
(rr / jsq / pow2 / batch-aware routers, each replica its own table) in
one launch of the fleet event kernel, streams long horizons in O(chunk)
memory (FleetStream) and sweeps traces x policies x routers in one launch
(run_fleet_grid); serving.faults injects degraded mode into every fleet
lane (FaultModel -> FaultSchedule: outages, crashes with bounded
retries, prorated crash energy, finite waiting rooms), certified against
the Python fleet loop by verify_faults.
"""
from .arrivals import (  # noqa: F401
    ArrivalEvent,
    ArrivalProcess,
    DiurnalProcess,
    MMPP2,
    MMPP2Process,
    PhaseBeliefFilter,
    PoissonProcess,
    TraceProcess,
    as_process,
    belief_forward,
    diurnal_times,
    mmpp2_times,
    poisson_times,
)
from .scheduler import (  # noqa: F401
    AdaptiveController,
    BeliefPhaseScheduler,
    GreedyScheduler,
    OraclePhaseScheduler,
    PhaseAwareScheduler,
    QPolicyScheduler,
    SMDPScheduler,
    SMDPSchedulerBank,
    StaticScheduler,
    as_action_table,
    solve_phase_policies,
)
from .metrics import (  # noqa: F401
    P2Quantile,
    RateEstimator,
    ServingMetrics,
    histogram_quantiles,
)
from .engine import (  # noqa: F401
    EngineReport,
    Request,
    ServingEngine,
    verify_backends,
)
from .compiled import (  # noqa: F401
    PHASE_MODES,
    AdaptiveLane,
    CompiledResult,
    pad_arrivals,
    pad_arrivals_batch,
    run_grid,
    run_grid_adaptive,
    simulate_compiled,
)
from .fleet import (  # noqa: F401
    ROUTERS,
    FleetResult,
    FleetStream,
    PythonFleet,
    run_fleet_grid,
    simulate_fleet,
    simulate_fleet_stream,
    threshold_gaps,
    verify_fleet,
)
from .faults import (  # noqa: F401
    FaultModel,
    FaultSchedule,
    verify_faults,
)
