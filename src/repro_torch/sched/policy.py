"""Network-aware client scheduling (``repro.sched.policy``, numpy only):
who does the aggregation barrier wait for?

A :class:`SchedulerPolicy` chooses, against the per-client links of
:mod:`repro_torch.network`:

  - ``wait_all``   -- the default; admits everyone.  The Trainer resolves
    it to its unmasked code path, so runs are bitwise those of a
    scheduler-free build.
  - ``deadline``   -- partial aggregation: a wall-clock budget T per round;
    a client whose analytic round time exceeds T is dropped and FedAvg
    renormalizes its weights over the admitted participants.
  - ``bandwidth_h``-- bandwidth-scaled upload period: client c uploads every
    ``stride_c`` rounds, ``stride_c`` inversely proportional to its uplink
    bandwidth (capped); non-participants keep their local state.
  - ``stratified`` -- tier-stratified cohort sampling: each round samples a
    fraction of every :class:`~repro_torch.network.TieredNetwork` tier.

The sync engines realize ``plan(ctx, R) -> [R, n]`` bool masks, drawn
once per run.  Two traits parameterize what a masked FedAvg means:
``refresh_dropped`` (True: the participants' average is broadcast to the
whole fleet; False: non-participants keep their local state) and
``local_when_skipped`` (read by the event engine).

Add your own policy::

    @register_policy
    class OddRounds(SchedulerPolicy):
        name = "odd_rounds"
        def plan(self, ctx, num_rounds):
            import numpy as np
            masks = np.ones((num_rounds, ctx.fsl.num_clients), bool)
            masks[::2] = False
            return masks
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

# ---------------------------------------------------------------------------
# Context: what a policy knows about the run it schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchedContext:
    """The environment a plan is drawn against.

    ``up_bytes`` / ``down_bytes`` are ONE client's codec-effective wire
    bytes per upload unit / reply (0 when unknown — e.g. under the ideal
    network, where transfer time is 0 regardless); ``uploads_per_round``
    the method's K; ``blocking`` whether the client waits for a gradient
    reply per unit.  ``network`` is the
    :class:`repro_torch.network.NetworkModel`
    whose ``expected_links`` the deterministic plans consult.
    """
    fsl: Any
    network: Any
    up_bytes: int = 0
    down_bytes: int = 0
    blocking: bool = False
    uploads_per_round: int = 1


def client_tiers(network, n: int) -> Optional[List[str]]:
    """Per-client tier names when the network model assigns them (the
    :class:`~repro_torch.network.TieredNetwork` contract:
    ``client_tier(c, n)``), else None."""
    tier_of = getattr(network, "client_tier", None)
    if tier_of is None:
        return None
    return [tier_of(c, n) for c in range(n)]


# ---------------------------------------------------------------------------
# The policy interface
# ---------------------------------------------------------------------------


class SchedulerPolicy:
    """Base class: subclasses set the traits and implement ``plan`` (and,
    for arrival-driven policies, ``round_budget``)."""

    name: str = ""
    # True: the trainers bypass ALL scheduling machinery (legacy bitwise).
    is_wait_all: bool = False
    # True: masked FedAvg broadcasts the participants' average to every
    # client (global-model semantics); False: non-participants keep their
    # own local state until they next participate.
    refresh_dropped: bool = True
    # Async engine: a plan-skipped client still runs its local steps
    # (non-blocking methods only) instead of idling the round out.
    local_when_skipped: bool = False

    def plan(self, ctx: SchedContext, num_rounds: int) -> np.ndarray:
        """``[num_rounds, n]`` bool: does client c participate in round
        r's upload/aggregation?  Deterministic per (policy, ctx) — the
        sync engines realize exactly this plan; the async engine uses it
        for pre-round skips and layers arrival admission on top."""
        return np.ones((num_rounds, ctx.fsl.num_clients), bool)

    def round_budget(self, ctx: SchedContext,
                     rnd: int) -> Optional[float]:
        """Wall-clock budget for round ``rnd`` in the event engine: an
        upload arriving past it is dropped.  None = wait for every
        launched upload."""
        return None

    def summary(self, ctx: SchedContext, masks: np.ndarray) -> Dict:
        """Participation summary of a realized plan (printable).
        A zero-round plan (resume exactly at the horizon, degenerate
        sweeps) yields a well-defined all-zero record — no NaN means, no
        ``min()`` of an empty reduction."""
        n = masks.shape[1]
        rounds = int(masks.shape[0])
        out: Dict[str, Any] = {
            "policy": self.name,
            "rounds": rounds,
            "mean_cohort": round(float(masks.sum(1).mean()), 3)
            if rounds else 0.0,
            "min_cohort": int(masks.sum(1).min()) if rounds else 0,
            "participation_rate": [round(float(x), 3)
                                   for x in masks.mean(0)]
            if rounds else [0.0] * n,
        }
        tiers = client_tiers(ctx.network, n)
        if tiers is not None:
            out["tier_participation"] = {
                t: round(float(masks[:, [c for c in range(n)
                                         if tiers[c] == t]].mean()), 3)
                if rounds else 0.0
                for t in sorted(set(tiers))}
        return out

    def __repr__(self):
        return f"<SchedulerPolicy {self.name}>"


# ---------------------------------------------------------------------------
# Built-in policies
# ---------------------------------------------------------------------------


class WaitAllPolicy(SchedulerPolicy):
    """The legacy barrier: wait for every client, always.  Trainers
    special-case it to the exact pre-scheduler code paths (no mask ops
    anywhere), so it bitwise-reproduces scheduler-free runs."""

    name = "wait_all"
    is_wait_all = True


@dataclasses.dataclass(frozen=True)
class DeadlinePolicy(SchedulerPolicy):
    """Deadline-based partial aggregation: drop arrivals past ``deadline_s``
    and renormalize the FedAvg weights over the participants.

    Event engine: realized arrival times are compared against the budget.
    Sync engines: the analytic analogue — a client is dropped when its
    expected per-round time (``compute_s`` + payload transfer over its
    ``expected_links`` rate, round trips included for blocking methods)
    exceeds the budget, so e.g. the whole 3g tier of a
    :class:`~repro_torch.network.TieredNetwork` sits out every round once T is
    below its upload time.  Dropped clients still receive the aggregated
    model (``refresh_dropped``): partial aggregation changes who is
    *waited for*, not who is served."""

    deadline_s: float = 30.0
    compute_s: float = 1.0       # analytic per-unit client compute seconds
    server_time: float = 0.05    # analytic server service time per upload

    name = "deadline"

    def client_seconds(self, ctx: SchedContext) -> np.ndarray:
        """Analytic per-client round completion time (the last upload
        unit's arrival at the server) under ``ctx.network``'s expected
        links — the sync-engine analogue of the event engine's realized
        arrival times."""
        links = ctx.network.expected_links(ctx.fsl.num_clients)
        K = ctx.uploads_per_round
        out = []
        for link in links:
            if ctx.blocking:
                t = K * (self.compute_s + link.up_seconds(ctx.up_bytes)) \
                    + (K - 1) * (self.server_time
                                 + link.down_seconds(ctx.down_bytes))
            else:
                t = K * self.compute_s + link.up_seconds(ctx.up_bytes)
            out.append(t)
        return np.asarray(out)

    def plan(self, ctx, num_rounds):
        ok = self.client_seconds(ctx) <= self.deadline_s
        return np.broadcast_to(ok, (num_rounds, ok.size)).copy()

    def round_budget(self, ctx, rnd):
        return self.deadline_s

    def summary(self, ctx, masks):
        out = super().summary(ctx, masks)
        out["deadline_s"] = self.deadline_s
        return out


@dataclasses.dataclass(frozen=True)
class BandwidthHPolicy(SchedulerPolicy):
    """Bandwidth-scaled upload period: client c participates every
    ``stride_c`` rounds, ``stride_c = clip(round(max_bw / bw_c), 1,
    max_stride)`` — upload frequency proportional to uplink bandwidth.
    Skipped rounds are spent on extra local epochs (the async engine runs
    the local steps and discards the upload; the lockstep sync engines
    train every round anyway), so a stride-s client's effective upload
    period is ``s * h`` local batches: slow clients upload less often,
    not less trained.  Non-participants keep their local state at
    aggregation (``refresh_dropped=False``) and fold in at their next
    participating round."""

    # cap keeps even dial-up-grade links participating regularly; 8 still
    # separates the 3g / 4g / wifi tiers (strides 8 / 5 / 1) where a lower
    # cap would saturate 3g and 4g to the same stride
    max_stride: int = 8

    name = "bandwidth_h"
    refresh_dropped = False
    local_when_skipped = True

    def strides(self, ctx: SchedContext) -> np.ndarray:
        up = np.asarray([l.up_bps for l in
                         ctx.network.expected_links(ctx.fsl.num_clients)],
                        float)
        finite = np.isfinite(up)
        if not finite.any():
            return np.ones(up.size, int)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = up[finite].max() / up
        ratio = np.where(np.isfinite(ratio), ratio, 1.0)
        return np.clip(np.round(ratio), 1, self.max_stride).astype(int)

    def plan(self, ctx, num_rounds):
        s = self.strides(ctx)
        r = np.arange(num_rounds)[:, None]
        return (r + 1) % s[None, :] == 0


@dataclasses.dataclass(frozen=True)
class StratifiedPolicy(SchedulerPolicy):
    """Tier-stratified cohort sampling: each round draws ``frac`` of every
    network tier (at least one client per tier, seeded, without
    replacement within a round), using the network model's deterministic
    per-client tier assignment (:meth:`~repro_torch.network.TieredNetwork.
    client_tier`).  Networks without tiers degrade to plain uniform
    cohort sampling over one fleet-wide stratum.  The cohort's average is
    broadcast to everyone (``refresh_dropped``) — standard
    FedAvg-with-client-sampling semantics."""

    frac: float = 0.5
    seed: int = 0

    name = "stratified"

    def plan(self, ctx, num_rounds):
        n = ctx.fsl.num_clients
        tiers = client_tiers(ctx.network, n) or ["all"] * n
        groups: Dict[str, List[int]] = {}
        for c, t in enumerate(tiers):
            groups.setdefault(t, []).append(c)
        rng = np.random.default_rng((self.seed, 0x5C4ED))
        masks = np.zeros((num_rounds, n), bool)
        for r in range(num_rounds):
            for t in sorted(groups):
                cs = groups[t]
                k = min(len(cs), max(1, int(round(self.frac * len(cs)))))
                for i in rng.choice(len(cs), size=k, replace=False):
                    masks[r, cs[i]] = True
        return masks


# ---------------------------------------------------------------------------
# Registry (mirrors the transport's codec registry)
# ---------------------------------------------------------------------------

_POLICIES: Dict[str, SchedulerPolicy] = {}


def register_policy(cls):
    """Class decorator: makes ``cls.name`` resolvable by
    :func:`get_policy` (and the ``--scheduler`` flags)."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if cls.name in _POLICIES:
        raise ValueError(
            f"duplicate policy name {cls.name!r}: already registered by "
            f"{type(_POLICIES[cls.name]).__name__}; pick a distinct .name "
            f"(registered: {available_policies()})")
    _POLICIES[cls.name] = cls()
    return cls


for _cls in (WaitAllPolicy, DeadlinePolicy, BandwidthHPolicy,
             StratifiedPolicy):
    register_policy(_cls)

WAIT_ALL = _POLICIES["wait_all"]


def get_policy(name: Union[str, SchedulerPolicy]) -> SchedulerPolicy:
    if isinstance(name, SchedulerPolicy):
        return name
    try:
        return _POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown scheduler policy {name!r}; registered: "
                       f"{available_policies()}") from None


def available_policies() -> tuple:
    return tuple(sorted(_POLICIES))


def resolve_policy(policy) -> SchedulerPolicy:
    """Normalize a trainer ``scheduler=`` argument: ``None`` means the
    legacy wait-all barrier, a string names a registered policy, an
    instance passes through."""
    if policy is None:
        return WAIT_ALL
    return get_policy(policy)


def scheduler_from_flags(name: str, deadline_s: float = 30.0,
                         seed: int = 0) -> SchedulerPolicy:
    """CLI adapter for ``--scheduler NAME --deadline-s T``: the deadline
    policy takes the budget flag, stratified the sampling seed, the rest
    use their registered defaults."""
    if name == "deadline":
        return DeadlinePolicy(deadline_s=deadline_s)
    if name == "stratified":
        return StratifiedPolicy(seed=seed)
    return get_policy(name)
