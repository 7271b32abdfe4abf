"""Network-aware client scheduling for the aggregation barrier
(``repro.sched``): the policies of :mod:`repro_torch.sched.policy`, and
the population engine's cohort samplers (which C of N clients train an
aggregation window) in :mod:`repro_torch.sched.cohort`."""
from repro_torch.sched.cohort import (
    COHORT_SAMPLERS,
    CohortSampler,
    StratifiedCohort,
    UniformCohort,
    get_cohort_sampler,
    register_cohort,
    resolve_cohort,
)
from repro_torch.sched.policy import (
    BandwidthHPolicy,
    DeadlinePolicy,
    SchedContext,
    SchedulerPolicy,
    StratifiedPolicy,
    WAIT_ALL,
    WaitAllPolicy,
    available_policies,
    client_tiers,
    get_policy,
    register_policy,
    resolve_policy,
    scheduler_from_flags,
)

__all__ = [
    "BandwidthHPolicy",
    "COHORT_SAMPLERS",
    "CohortSampler",
    "StratifiedCohort",
    "UniformCohort",
    "get_cohort_sampler",
    "register_cohort",
    "resolve_cohort",
    "DeadlinePolicy",
    "SchedContext",
    "SchedulerPolicy",
    "StratifiedPolicy",
    "WAIT_ALL",
    "WaitAllPolicy",
    "available_policies",
    "client_tiers",
    "get_policy",
    "register_policy",
    "resolve_policy",
    "scheduler_from_flags",
]
