"""repro_torch.runtime — the domain-agnostic allocation runtime.

The characterise -> allocate -> execute workflow (paper Fig. 1): a
:class:`Domain` protocol for workloads, a generic :class:`Scheduler` that
drives the loop over the shared :mod:`repro_torch.core` solvers, the
concurrent :class:`Executor`, the fault layer and replayable scenarios.

    from repro_torch.runtime import Scheduler
    sched = Scheduler(PricingDomain(tasks, platforms))
    report = sched.run(method="milp")
"""
from .domain import Domain, PlatformSpec, RunRecordLike, seed_for  # noqa: F401
from .executor import Executor, TimedResult  # noqa: F401
from .faults import (  # noqa: F401
    BreakerTransition,
    CircuitBreaker,
    CorruptResult,
    DegradationEvent,
    DispatchFault,
    DispatchTimeout,
    FaultEvent,
    JobCancelled,
    RetryPolicy,
    TransientFault,
    check_records,
)
from .scenario import PlatformOutage, Scenario  # noqa: F401
from .scheduler import SOLVERS, DispatchResult, RuntimeReport, Scheduler  # noqa: F401
