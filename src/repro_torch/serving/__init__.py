"""Serving layer of the port: one event semantics, two backends.

serving.engine runs every mode (profiled virtual clock, wall-clock
executor, trace replay) through a single Python event loop, and exposes
the same semantics compiled (run(backend="compiled")) -- one launch of the
CUDA event kernel, serving.compiled, whose run_grid / run_grid_adaptive
run whole seeds x tables sweeps in one launch; serving.arrivals supplies
the numpy arrival processes; serving.scheduler the policy tables and the
bank-retuning AdaptiveController; serving.metrics the latency quantiles
(P² on the Python path, a fixed-bin histogram sketch on the compiled
path).
"""
from .arrivals import (  # noqa: F401
    ArrivalEvent,
    ArrivalProcess,
    DiurnalProcess,
    MMPP2,
    MMPP2Process,
    PoissonProcess,
    TraceProcess,
    as_process,
)
from .scheduler import (  # noqa: F401
    AdaptiveController,
    GreedyScheduler,
    OraclePhaseScheduler,
    QPolicyScheduler,
    SMDPScheduler,
    SMDPSchedulerBank,
    StaticScheduler,
    as_action_table,
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
    AdaptiveLane,
    CompiledResult,
    pad_arrivals,
    pad_arrivals_batch,
    run_grid,
    run_grid_adaptive,
    simulate_compiled,
)
