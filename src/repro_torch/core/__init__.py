"""Core SMDP dynamic-batching library, PyTorch port.

The SMDP construction, the benchmark policies and the policy evaluators
are numpy (copies of the reference's numpy-only modules); the relative
value iteration runs on torch tensors, its banded Bellman core on the
hand-written CUDA kernel with ``backup="pallas"``.
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
    SMDPSpec,
    TruncatedSMDP,
    build_smdp,
    build_smdp_batched,
)
from .rvi import RVIResult, relative_value_iteration  # noqa: F401
from .policies import (  # noqa: F401
    static_policy,
    greedy_policy,
    q_policy,
    optimal_q_closed_form,
)
from .evaluate import PolicyEval, evaluate_policy  # noqa: F401
from .solve import SolveResult, solve  # noqa: F401
