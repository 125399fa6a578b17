"""Core SMDP dynamic-batching library, PyTorch port.

The SMDP construction, the benchmark policies and the policy evaluators
are numpy (copies of the reference's numpy-only modules); the relative
value iteration -- scalar, batched and accelerated -- runs on torch
tensors, its banded Bellman core on the hand-written CUDA kernels with
``backup="pallas"``.  sweep_solve batches a spec grid through it;
solve_modulated / sweep_solve_modulated solve the (phase, queue) product
chain of MMPP traffic exactly, in float64 torch ops.
"""
from .service_models import (  # noqa: F401
    AffineProfile,
    ConstantProfile,
    LogProfile,
    PiecewiseMaxProfile,
    ServiceModel,
    TableProfile,
    GOOGLENET_P4_LATENCY,
    GOOGLENET_P4_ENERGY,
    IDEAL_PARALLEL_LATENCY,
    LOG_ENERGY,
)
from .smdp import (  # noqa: F401
    BatchedSMDP,
    ModulatedBatchedSMDP,
    PhaseConfig,
    SMDPSpec,
    TruncatedSMDP,
    build_smdp,
    build_smdp_batched,
    build_smdp_modulated,
    build_smdp_modulated_batched,
    modulated_spec,
)
from .rvi import (  # noqa: F401
    BatchedRVIResult,
    RVIResult,
    SolveReport,
    relative_value_iteration,
    relative_value_iteration_batched,
    relative_value_iteration_modulated,
)
from .policies import (  # noqa: F401
    static_policy,
    greedy_policy,
    q_policy,
    optimal_q_closed_form,
)
from .evaluate import (  # noqa: F401
    PolicyEval,
    evaluate_policy,
    evaluate_policy_modulated,
)
from .solve import ModulatedSolveResult, SolveResult, solve  # noqa: F401
from .sweep import (  # noqa: F401
    pad_specs,
    solve_modulated,
    sweep_bank,
    sweep_solve,
    sweep_solve_modulated,
)
