"""repro_torch.runtime — the domain-agnostic allocation runtime.

The characterise -> allocate -> execute workflow (paper Fig. 1): a
:class:`Domain` protocol for workloads, a generic :class:`Scheduler` that
drives the loop over the shared :mod:`repro_torch.core` solvers, the
concurrent :class:`Executor`, the fault layer, replayable scenarios, the
online re-allocation loop (:class:`OnlineScheduler`) with admission control
and open-loop load, JSONL record persistence and a domain registry.

    from repro_torch.runtime import Scheduler, make_domain
    sched = Scheduler(make_domain("pricing", tasks, platforms))
    report = sched.run(method="milp")
"""
from .admission import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
    BrownoutTransition,
    RejectedTask,
    ShedEvent,
    predicted_unit_rates,
)
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
from .loadgen import BurstyRate, ConstantRate, DiurnalRate, LoadGenerator  # noqa: F401
from .online import (  # noqa: F401
    DriftDetector,
    OnlineConfig,
    OnlineReport,
    OnlineScheduler,
    TailDriftDetector,
)
from .records import dump_records, group_records, load_records  # noqa: F401
from .registry import (  # noqa: F401
    available_domains,
    domain_factory,
    make_domain,
    register_domain,
)
from .scenario import PlatformOutage, Scenario  # noqa: F401
from .scheduler import SOLVERS, DispatchResult, RuntimeReport, Scheduler  # noqa: F401
