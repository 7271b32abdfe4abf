"""Network-aware client scheduling for the aggregation barrier
(``repro.sched``): the policies of :mod:`repro_torch.sched.policy`.  The
population engine's cohort samplers (``repro.sched.cohort``) are not
ported yet."""
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
