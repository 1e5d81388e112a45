"""repro_torch.pricing — the derivatives-pricing application domain (paper §4).

Contracts (underlyings + derivatives), the Monte Carlo engine (the CUDA
moments kernel on the card, its plain PyTorch version on the CPU), the
Table 1 workload, the Table 2 platform cluster, online benchmarking, and
the characterise -> allocate -> execute solver flow.
"""
from .contracts import (  # noqa: F401
    ASIAN,
    BARRIER,
    DIGITAL_DOUBLE_BARRIER,
    DOUBLE_BARRIER,
    EUROPEAN,
    BlackScholes,
    Heston,
    Option,
    PricingTask,
    TaskBatch,
    asian,
    barrier,
    digital_double_barrier,
    double_barrier,
    european,
    family_key,
    group_by_family,
    group_by_launch,
    launch_key,
    payoff_from_stats,
    payoff_from_stats_coded,
)
from .mc import (  # noqa: F401
    PriceResult,
    launch_count,
    path_stats,
    price,
    price_batch,
    reset_launch_count,
)
from .platforms import (  # noqa: F401
    TABLE2_SPECS,
    LocalTorchPlatform,
    Platform,
    PlatformSpec,
    RunRecord,
    SimulatedPlatform,
    TaskPlatformModel,
    benchmark,
    benchmark_batch,
    build_cluster,
    characterise,
    dispatch_batch,
    kflop_per_path,
    model_matrices,
)
from .solver import SOLVERS, ExecutionReport, PricingSolver  # noqa: F401
from .workload import TABLE1_CATEGORIES, make_task, table1_workload  # noqa: F401
