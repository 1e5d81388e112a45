"""repro_torch.core — domain metric models + allocation (numpy/SciPy).

Public API:

    Metric models (§3.1/§4.2): LatencyModel, AccuracyModel, CombinedModel,
        fit_latency_model, fit_accuracy_model, relative_error
    Allocation (§3.2/§4.3): AllocationProblem, Allocation, makespan,
        proportional_allocation (eq. 11), ml_allocation (batched
        simulated-annealing chains in PyTorch + LP polish), milp_allocation
        (eq. 12 via HiGHS)
    Scale: cluster_tasks / clustered_allocation (task-family super-tasks),
        patch_allocation (O(k) incremental re-solve for k arrivals)
    SLO tail metrics: quantile, P2Quantile, SLOConfig / SLOTracker
"""
from .allocation import (  # noqa: F401
    SUPPORT_ATOL,
    Allocation,
    AllocationProblem,
    CapacityError,
    assert_capacity_feasible,
    capacity_ok,
    check_allocation,
    expand_allocation,
    linear_work_reduction,
    makespan,
    mc_work_reduction,
    platform_latencies,
    platform_usage,
    restrict_allocation,
    restrict_problem,
)
from .annealing import anneal, lp_polish, ml_allocation  # noqa: F401
from .clustering import ClusterPlan, cluster_tasks, clustered_allocation  # noqa: F401
from .heuristic import proportional_allocation  # noqa: F401
from .incremental import patch_allocation  # noqa: F401
from .metrics import (  # noqa: F401
    AccuracyModel,
    CombinedModel,
    LatencyModel,
    fit_accuracy_model,
    fit_latency_model,
    relative_error,
    wls,
)
from .milp import milp_allocation  # noqa: F401
from .slo import P2Quantile, SLOConfig, SLOTracker, quantile  # noqa: F401
