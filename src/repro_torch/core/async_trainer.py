"""Event-driven wall-clock execution engine for federated split learning
(``repro.core.async_trainer``).

The :class:`~repro_torch.core.trainer.Trainer` runs the clients in
lockstep; this engine simulates the paper's *wall-clock* story (Fig. 3/6,
Eq. 11-13): every client has a compute latency and a network link, its
uploads land on a priority queue, and the server consumes them **in
arrival order** -- the synchronous barrier and its straggler overhead are
reported as the counterfactual.

  at = AsyncTrainer(bundle, fsl, latency=LognormalLatency(), seed=0)
  state = at.init(seed=0)
  state, history = at.run(state, batcher, num_rounds=20, log_every=5)
  params = at.merged_params(state)
  print(at.stats.as_dict())          # async vs barrier wall-clock, idle time

Design notes:

- method-agnostic: every method's :class:`AsyncHooks` run here, called
  directly on one client's slice (``client_compute``) and one upload
  (``server_consume``); blocking methods (gradient download) model the
  per-batch client/server round trips, the others stream their uploads.
- per-client state is a slice (``x[c]``) of the stacked state the sync
  Trainer uses -- ``init`` is ``FSLMethod.init_state`` -- so sync and
  event-driven runs are comparable seed for seed; aggregation restacks the
  slices and runs the method's wire aggregate.
- aggregation fires on the shared :class:`AggregationCadence`, resumed
  from ``state["round"]``, so a zero-latency run realizes the sync
  Trainer's aggregation schedule, also where C is not a multiple of h.
- the wire: each upload (and each reply) is coded for its own client as it
  is sent, ``Transport.code_uplink(..., client=c)`` with the seeds the sync
  round gives that client, so a zero-latency run draws the sync run's
  quantization noise; the aggregate takes the model-sync seeds at the
  unit counter, as ``Trainer._round_seeds`` derives them.
- determinism: the latency trace is drawn up front from a seeded numpy
  generator in an arrival-independent order (bit for bit the JAX
  package's trace), and the heap pops FIFO on ties; same seed and same
  trace give the same final params.
- time semantics: LatencyModels describe COMPUTE time; transfer time comes
  from the :class:`repro_torch.network.NetworkModel` -- each event lasts
  ``compute + wire_bytes / bandwidth + rtt`` with the payload's
  codec-effective bytes; the trace's ``up``/``down`` fields stay additive
  base latencies (the default ideal network adds exactly 0.0 s).
- observability: a ``telemetry`` recorder (``repro_torch.telemetry``)
  records a record per round (engine ``"async"``, with the simulated
  clock) and the simulated timeline: per-client compute, each wire
  attempt and retry backoff, server service, outages and model-sync
  barriers, placed on the global simulated clock.  It is host bookkeeping
  on floats the engine has computed already: the schedule, state, history
  and meter are bitwise the same with it on and off.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import warnings
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel, Recordable
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.core.methods import CommProfile, FSLMethod, get_method
from repro_torch.core.methods.base import stacked_keys
from repro_torch.core.trainer import AggregationCadence
from repro_torch.faults import (FRAME_BYTES, FaultStats, accumulate_round,
                                check_frame, corrupt_frame, make_frame,
                                resolve_fault, retry_key)
from repro_torch.network import IdealNetwork, NetworkModel, NetworkTrace
from repro_torch.sched import SchedContext, resolve_policy
from repro_torch.telemetry import resolve_telemetry
from repro_torch.transport import resolve_transport

# Distinct seeded stream for the network trace, so (seed) determines both
# the compute-latency trace and the link weather without coupling them.
_NET_STREAM = 0x6E6574          # "net"

# ---------------------------------------------------------------------------
# Latency models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatencyTrace:
    """Pre-drawn per-event timings, all shaped [rounds, n_clients, K].

    K = the method's ``uploads_per_round``; ``compute[r, c, k]`` is client
    c's local compute time for upload unit k of round r, ``up``/``down``
    the uplink/downlink latencies.  Drawing the full trace up front (in an
    arrival-independent order) is what makes runs reproducible and lets
    two runs share one trace exactly.
    """
    compute: np.ndarray
    up: np.ndarray
    down: np.ndarray

    @property
    def shape(self):
        return self.compute.shape


class LatencyModel:
    """Interface: ``draw(rng, rounds, n, k) -> LatencyTrace``.

    The trace means COMPUTE time; its ``up``/``down`` fields are additive
    base per-event latencies (transfer time proper -- payload bytes over
    bandwidth plus RTT -- belongs to the network model).  Use
    :meth:`compute_only` when composing with a real network so the wire
    isn't counted twice."""

    def draw(self, rng: np.random.Generator, rounds: int, n: int,
             k: int) -> LatencyTrace:
        raise NotImplementedError

    def compute_only(self) -> "LatencyModel":
        """This model narrowed to compute time (up/down zeroed)."""
        return ComputeOnlyLatency(self)


@dataclasses.dataclass(frozen=True)
class ConstantLatency(LatencyModel):
    """Fixed timings; ``ConstantLatency(0, 0, 0)`` is the zero-latency
    profile whose event order degenerates to the synchronous schedule."""
    compute: float = 1.0
    up: float = 0.1
    down: float = 0.1

    def draw(self, rng, rounds, n, k):
        full = lambda v: np.full((rounds, n, k), float(v))
        return LatencyTrace(full(self.compute), full(self.up),
                            full(self.down))


@dataclasses.dataclass(frozen=True)
class LognormalLatency(LatencyModel):
    """Lognormal per-event jitter around per-client mean speeds.

    ``spread`` is the sigma of a *static* per-client speed factor (the
    Fig. 3 device heterogeneity); ``sigma`` the per-event jitter.  Means
    are bias-corrected so e.g. ``compute`` stays the expected value.
    """
    compute: float = 1.0
    up: float = 0.1
    down: float = 0.1
    sigma: float = 0.5
    spread: float = 0.5

    def draw(self, rng, rounds, n, k):
        speed = np.exp(rng.normal(-0.5 * self.spread ** 2, self.spread,
                                  size=n))

        def ln(mean):
            j = rng.normal(-0.5 * self.sigma ** 2, self.sigma,
                           size=(rounds, n, k))
            return mean * np.exp(j)

        return LatencyTrace(ln(self.compute) * speed[None, :, None],
                            ln(self.up), ln(self.down))


@dataclasses.dataclass(frozen=True)
class StragglerLatency(LatencyModel):
    """Straggler tail: a fixed fraction of clients (drawn once per trace)
    computes ``slowdown`` times slower than the base model says."""
    base: LatencyModel = dataclasses.field(default_factory=LognormalLatency)
    frac: float = 0.25
    slowdown: float = 8.0

    def draw(self, rng, rounds, n, k):
        tr = self.base.draw(rng, rounds, n, k)
        num = max(1, int(round(self.frac * n)))
        idx = rng.choice(n, size=num, replace=False)
        compute = tr.compute.copy()
        compute[:, idx, :] *= self.slowdown
        return LatencyTrace(compute, tr.up, tr.down)


@dataclasses.dataclass(frozen=True)
class ComputeOnlyLatency(LatencyModel):
    """Narrow ``base`` to compute time only: the base model's compute
    column (the same rng draws) with the up/down latencies zeroed."""
    base: LatencyModel

    def draw(self, rng, rounds, n, k):
        tr = self.base.draw(rng, rounds, n, k)
        return LatencyTrace(tr.compute, np.zeros_like(tr.up),
                            np.zeros_like(tr.down))

    def compute_only(self):
        return self


LATENCY_MODELS = {"constant": ConstantLatency, "lognormal": LognormalLatency,
                  "straggler": StragglerLatency}


def make_latency(name: str, **kw) -> LatencyModel:
    try:
        return LATENCY_MODELS[name](**kw)
    except KeyError:
        raise KeyError(f"unknown latency model {name!r}; registered: "
                       f"{tuple(sorted(LATENCY_MODELS))}") from None


# ---------------------------------------------------------------------------
# Wall-clock statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AsyncStats(Recordable):
    """Straggler / idle-time accounting for one ``AsyncTrainer.run``."""
    rounds: int = 0
    events: int = 0                 # server-consumed (admitted) uploads
    async_time: float = 0.0         # event-driven wall clock
    sync_time: float = 0.0          # synchronous-barrier counterfactual
    server_busy: float = 0.0        # shared-server service time
    client_wait: float = 0.0        # blocking methods: time spent waiting
    comm_time: float = 0.0          # network transfer seconds (all events)
    compute_time: float = 0.0       # client compute seconds (all launches)
    model_sync_time: float = 0.0    # aggregation model up/download seconds
    # scheduling (all zero / empty under the default wait_all barrier):
    dropped: int = 0                # uploads past the deadline, not consumed
    skipped: int = 0                # client-rounds the plan sat out
    # per aggregation event: how many clients the barrier admitted
    agg_participants: List[int] = dataclasses.field(default_factory=list)
    # client ids in first-round consumption order (the Fig. 6 permutation)
    arrival_order: List[int] = dataclasses.field(default_factory=list)

    @property
    def server_idle(self) -> float:
        return max(self.async_time - self.server_busy, 0.0)

    @property
    def speedup(self) -> float:
        """Barrier time / event-driven time (>1: stragglers removed)."""
        return self.sync_time / self.async_time if self.async_time else 1.0

    def as_dict(self) -> Dict[str, float]:
        return {"rounds": self.rounds, "events": self.events,
                "async_time": self.async_time, "sync_time": self.sync_time,
                "server_busy": self.server_busy,
                "server_idle": self.server_idle,
                "client_wait": self.client_wait,
                "comm_time": self.comm_time,
                "compute_time": self.compute_time,
                "model_sync_time": self.model_sync_time,
                "dropped": self.dropped, "skipped": self.skipped,
                "min_participants": min(self.agg_participants)
                if self.agg_participants else None,
                "speedup": self.speedup}


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _unit_batch(batch, c: int, k: int, hooks):
    """Upload unit k of client c from a [n, h, B, ...] round batch:
    ``[bpu, B, ...]`` for hooks whose unit keeps the h axis (CSE-style
    local phases -- also at h == 1, where ``bpu`` alone is ambiguous),
    ``[B, ...]`` for per-mini-batch hooks."""
    bpu = hooks.batches_per_upload
    if hooks.unit_has_h_axis:
        return tree_map(lambda x: x[c, k * bpu:(k + 1) * bpu], batch)
    return tree_map(lambda x: x[c, k], batch)


@dataclasses.dataclass
class AsyncTrainer:
    """Event-driven facade mirroring :class:`Trainer`: ``init`` / ``run`` /
    ``merged_params`` (plus ``stats``), on the bundle's device.

    ``latency`` shapes per-client compute timings; ``network`` the
    per-client links -- every event lasts compute + the payload's
    codec-effective ``wire_bytes / bandwidth + rtt`` (the default
    :class:`~repro_torch.network.IdealNetwork` adds exactly 0.0 s).
    ``server_time`` is the server's service time per consumed upload;
    ``seed`` seeds the latency trace and the network trace (distinct
    streams; the model seed lives in ``init``).

    The engine consumes uploads one at a time in arrival order:
    ``fsl.server_update="batched"`` (a sync-path fusion) has no event
    counterpart and is ignored here.
    """
    bundle: SplitModelBundle
    fsl: FSLConfig
    method: Optional[Union[str, FSLMethod]] = None  # default: fsl.method
    latency: LatencyModel = dataclasses.field(default_factory=ConstantLatency)
    network: NetworkModel = dataclasses.field(default_factory=IdealNetwork)
    server_time: float = 0.05
    seed: int = 0
    # wire codecs (None resolves fsl.codec and fsl.model_codec): every
    # upload is coded for its client before it enters the arrival queue,
    # every reply before the client receives it.
    transport: Optional[Any] = None
    # scheduling: None/"wait_all" keeps the wait-for-everyone barrier; a
    # policy name or repro_torch.sched.SchedulerPolicy decides which
    # arrivals each aggregation admits (plan-level skips + a per-round
    # deadline).
    scheduler: Optional[Any] = None
    # fault injection: None/"none" keeps the lossless schedule; a preset
    # name or repro_torch.faults.FaultModel pre-draws a FaultTrace -- lost
    # payloads retransmit with backoff (seconds in the event times, bytes
    # in CommMeter), crashed clients sit the round out, server outages
    # delay the round's service start.
    faults: Optional[Any] = None
    # observability: None resolves to the shared no-op NullTelemetry; a
    # repro_torch.telemetry.Telemetry records a record per round and the
    # simulated timeline (only observing: the schedule, state and history
    # are bitwise the same with it on and off).
    telemetry: Optional[Any] = None

    def __post_init__(self):
        m = self.method if self.method is not None else self.fsl.method
        if isinstance(m, str):
            m = get_method(m)
        self.method = m
        self.device = self.bundle.device
        self.transport = resolve_transport(self.transport, self.fsl)
        self.hooks = m.make_async_hooks(self.bundle, self.fsl)
        self._blocking = self.hooks.client_receive is not None
        self._agg_fn = m.make_wire_aggregate(self.bundle, self.fsl,
                                             transport=self.transport)
        self.scheduler = resolve_policy(self.scheduler)
        self.faults = resolve_fault(self.faults)
        self.telemetry = resolve_telemetry(self.telemetry)
        if not self.scheduler.is_wait_all or not self.faults.is_null:
            self._magg_fn = m.make_wire_aggregate(
                self.bundle, self.fsl, transport=self.transport,
                participation=True, refresh=self.scheduler.refresh_dropped)
        self._stacked_keys = stacked_keys(self.hooks)
        self._sched_ctx = self._sched_plan = None
        self._leaves = None
        self.stats = AsyncStats()
        self.fault_stats = None

    def participation_summary(self):
        """The scheduler policy's summary of the realized plan (None until
        a scheduled run has drawn one, and for wait_all), plus a
        ``"faults"`` entry with the run's :class:`FaultStats` whenever a
        non-null fault model was active."""
        base = None
        if self._sched_plan is not None:
            base = self.scheduler.summary(self._sched_ctx, self._sched_plan)
        if self.faults.is_null or self.fault_stats is None:
            return base
        out = dict(base or {})
        out["faults"] = self.fault_stats.as_dict()
        return out

    # -- facade parity with Trainer -----------------------------------------
    def init(self, seed: int = 0):
        """Initial state on the bundle's device, drawn from a CPU
        ``torch.Generator`` seeded with ``seed`` (as ``Trainer.init``)."""
        return self.method.init_state(self.bundle, self.fsl,
                                      torch.Generator().manual_seed(seed))

    def lr_at(self, rnd: int) -> float:
        steps = rnd // self.fsl.lr_decay_every
        return self.fsl.lr * self.fsl.lr_decay ** steps

    def merged_params(self, state):
        """Deployable {"client", ["aux",] "server"} params for evaluation."""
        return self.method.merged_params(state)

    def comm_profile(self, cost_model: CostModel, batch_size: int,
                     batch=None) -> CommProfile:
        """With a ``batch``, the profile's ``*_wire`` fields are exact for
        this trainer's transport; ``model_sync_wire`` needs no batch."""
        specs = mspecs = None
        if batch is not None and not self.transport.is_identity:
            specs = self.method.payload_specs(self.bundle, self.fsl, batch)
        if not self.transport.model_identity:
            mspecs = self.method.model_sync_specs(self.bundle, self.fsl)
        return self.method.comm_profile(cost_model, self.fsl, batch_size,
                                        transport=self.transport,
                                        payload_specs=specs,
                                        model_specs=mspecs)

    def to_device(self, batch):
        """A round batch as tensors on the device (as ``Trainer``)."""
        return tuple(tree_map(lambda x: torch.as_tensor(x).to(self.device),
                              batch))

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _round_seeds(self, unit0: int, batch) -> Dict[str, torch.Tensor]:
        """The wire seeds of the round starting at unit ``unit0`` as
        device tables (``Transport.stage_seeds``): uplink and downlink
        ``[K, leaves, n]``, and the model sync's at ``unit0 + K``, where
        the round's aggregation codes it -- what ``Trainer._round_seeds``
        stages for the sync round."""
        tp, m = self.transport, self.method
        if self._leaves is None:
            up, reply = m.payload_specs(self.bundle, self.fsl, batch)
            nm = 0 if tp.model_identity else len(
                m.model_sync_specs(self.bundle, self.fsl))
            counts = {"uplink": len(tree_leaves(up)),
                      "downlink": 0 if reply is None
                      else len(tree_leaves(reply)),
                      "model_up": nm, "model_down": nm}
            self._leaves = {ch: c for ch, c in counts.items()
                            if c and tp.seeded(ch)}
        return {k: self._put(v) for k, v in tp.stage_seeds(
            unit0, self.hooks.uploads_per_round, self.fsl.num_clients,
            self._leaves).items()}

    def _verify_frame(self, upload, unit: int, c: int):
        """Exercise the checksum frame for real on a faulty event: damage
        a copy of the coded payload deterministically (the ``retry_key``
        stream, disjoint from the codec seeds) and require the receiver to
        detect it.  The delivered payload stays the retransmitted clean
        one, so fault injection never perturbs the training numerics."""
        fr = make_frame(upload)
        bad, fr2 = corrupt_frame(upload, fr,
                                 retry_key(self.transport, unit, c))
        if bad is not upload and check_frame(bad, fr2):
            raise RuntimeError(
                "checksum frame failed to detect a simulated payload "
                f"corruption (unit {unit}, client {c}) -- the "
                "retransmission machinery would train on garbage")

    # -- state <-> per-client slices ----------------------------------------
    def _split(self, state):
        n = self.fsl.num_clients
        slices = [{k: tree_map(lambda x: x[c], state[k])
                   for k in self._stacked_keys} for c in range(n)]
        shared = state[self.hooks.server_key] if self.hooks.server_shared \
            else None
        return slices, shared

    def _join(self, state, slices, shared, round_val: int):
        out = dict(state)
        for k in self._stacked_keys:
            out[k] = tree_map(lambda *xs: torch.stack(xs),
                              *[s[k] for s in slices])
        if self.hooks.server_shared:
            out[self.hooks.server_key] = shared
        out["round"] = int(round_val)
        return out

    # -- the loop -----------------------------------------------------------
    def run(self, state, batcher, num_rounds: int, log_every: int = 0,
            callback=None, meter: Optional[CommMeter] = None,
            cost_model: Optional[CostModel] = None,
            trace: Optional[LatencyTrace] = None,
            net_trace: Optional[NetworkTrace] = None):
        """Run ``num_rounds`` global rounds event-driven.

        Same contract as ``Trainer.run`` (aggregation on the C-batch
        threshold-crossing cadence resumed from ``state["round"]``,
        ``log_every`` history rows with an ``aggregated`` flag and a
        cumulative ``sim_time`` column, CommMeter integration).  ``trace``
        overrides the compute-latency trace and ``net_trace`` the
        link-weather trace -- pass the same traces to two runs to replay
        identical wall-clock conditions.

        With a non-wait_all ``scheduler`` the aggregation barrier admits
        only what the policy allows: plan-skipped clients sit the round
        out (or train locally without uploading, per the policy's
        ``local_when_skipped``), arrivals past the policy's per-round
        budget are dropped unconsumed, and FedAvg runs masked and
        renormalized over the surviving participants (empty cohort: a
        warned no-op).  History rows gain ``participants`` /
        ``dropped_updates`` / ``skipped_updates`` columns and
        ``AsyncStats`` the matching totals; the uplink meter and the model
        sync charge only the clients that hit the wire.
        """
        fsl, hooks = self.fsl, self.hooks
        n, K = fsl.num_clients, hooks.uploads_per_round
        start_batches = self.method.batches_trained(fsl, state)
        cadence = AggregationCadence(fsl.resolved_agg_every, start_batches)
        rnd0 = start_batches // fsl.h
        round_val = int(state["round"])
        if trace is None:
            trace = self.latency.draw(np.random.default_rng(self.seed),
                                      num_rounds, n, K)
        if trace.shape != (num_rounds, n, K):
            raise ValueError(f"latency trace shape {trace.shape} != "
                             f"{(num_rounds, n, K)}")
        # the ideal default adds exactly 0.0 s per transfer
        ideal = self.network.is_ideal and net_trace is None
        if not ideal:
            if net_trace is None:
                net_trace = self.network.draw(
                    np.random.default_rng((self.seed, _NET_STREAM)),
                    num_rounds, n, K)
            if net_trace.shape != (num_rounds, n, K):
                raise ValueError(f"network trace shape {net_trace.shape} "
                                 f"!= {(num_rounds, n, K)}")
        zeros = np.zeros((n, K))
        up_bytes = down_bytes = ms_up = ms_down = None
        sched = self.scheduler
        sched_active = not sched.is_wait_all
        fault_active = not self.faults.is_null
        use_masks = sched_active or fault_active
        blocking = self._blocking
        # the fault trace is indexed by the ABSOLUTE round, so a resumed
        # run replays the uninterrupted run's faults
        ftrace = self.faults.trace(rnd0 + num_rounds, n, K) \
            if fault_active else None
        self.fault_stats = FaultStats() if fault_active else None
        fstats = self.fault_stats
        unit_bytes = plan = ctx = None
        # participation carry: a client enters an aggregation only if it
        # was admitted (not skipped, dropped or crashed, and delivered) in
        # EVERY round since the previous one
        part = np.ones(n, bool) if use_masks else None
        self.stats = AsyncStats()
        slices, shared = self._split(state)
        history = []
        profile = None
        for r in range(num_rounds):
            batch = self.to_device(batcher.next_round())
            if meter is not None and cost_model is not None \
                    and profile is None:
                batch_size = tree_leaves(batch[1])[0].shape[2]
                profile = self.comm_profile(cost_model, batch_size,
                                            batch=batch)
            if (not ideal or use_masks) and up_bytes is None:
                # the coded wire bytes of one upload unit / reply / model
                # sync (the plan and the cohort's metering need them under
                # the ideal network too)
                up_spec, reply_spec = self.method.payload_specs(
                    self.bundle, fsl, batch)
                up_bytes = self.transport.uplink_payload_bytes(up_spec)
                down_bytes = self.transport.downlink_payload_bytes(
                    reply_spec) if reply_spec is not None else 0
                mspec = self.method.model_sync_specs(self.bundle, fsl)
                ms_up = self.transport.model_up_wire_bytes(mspec)
                ms_down = self.transport.model_down_wire_bytes(mspec)
            if sched_active and plan is None:
                ctx = SchedContext(
                    fsl=fsl, network=self.network, up_bytes=up_bytes,
                    down_bytes=down_bytes, blocking=blocking,
                    uploads_per_round=K)
                plan = np.asarray(sched.plan(ctx, rnd0 + num_rounds), bool)
                if plan.shape != (rnd0 + num_rounds, n):
                    raise ValueError(f"scheduler plan shape {plan.shape} "
                                     f"!= {(rnd0 + num_rounds, n)}")
                self._sched_ctx, self._sched_plan = ctx, plan
            if ideal:
                xu = xd = zeros
            else:
                xu = net_trace.up_seconds(up_bytes, r)
                xd = net_trace.down_seconds(down_bytes, r)
            lr = self._put(np.float32(self.lr_at(rnd0 + r)))
            seeds = self._round_seeds(round_val, batch)
            skip = budget = None
            skipped0 = self.stats.skipped
            if sched_active:
                skip = ~plan[rnd0 + r]
                budget = sched.round_budget(ctx, rnd0 + r)
            frnd = None
            server_start = 0.0
            if fault_active:
                frnd = (ftrace.up_attempts[rnd0 + r], ftrace.up_ok[rnd0 + r],
                        ftrace.down_attempts[rnd0 + r],
                        ftrace.down_ok[rnd0 + r], ftrace.crash[rnd0 + r])
                if bool(ftrace.outage[rnd0 + r]):
                    # server down at round start: every upload waits out
                    # the recovery (the barrier counterfactual too)
                    server_start = float(self.faults.outage_s)
                    self.stats.sync_time += server_start
            shared, metrics = self._run_round(
                slices, shared, batch, lr, seeds, trace.compute[r],
                trace.up[r], trace.down[r], xu, xd, unit0=round_val,
                skip=skip, budget=budget, part=part, fault=frnd,
                server_start=server_start)
            self.stats.rounds += 1
            round_val += K
            if fault_active:
                # trace-exact billing: every transmission attempt of every
                # non-skipped client pays payload + checksum frame
                if profile is not None and unit_bytes is None:
                    unit_bytes = profile.unit_wire_bytes(n, K)
                wire = accumulate_round(
                    fstats, self.faults, ftrace, rnd0 + r,
                    *(unit_bytes if unit_bytes is not None else (0, 0, 0)),
                    blocking, FRAME_BYTES,
                    mask=plan[rnd0 + r] if sched_active else None)
                if profile is not None:
                    for field, total in wire.items():
                        meter.log(field, total)
            elif profile is not None:
                if sched_active:
                    # only the clients that uploaded hit the wire (dropped
                    # arrivals were sent and count; plan-skipped clients
                    # never launched)
                    live = n - (self.stats.skipped - skipped0)
                    for field, total in (
                            ("uplink_smashed", profile.wire_uplink_smashed),
                            ("uplink_labels", profile.uplink_labels),
                            ("downlink_grads", profile.wire_downlink_grads)):
                        meter.log(field, (total // n) * live)
                else:
                    meter.log("uplink_smashed", profile.wire_uplink_smashed)
                    meter.log("uplink_labels", profile.uplink_labels)
                    meter.log("downlink_grads", profile.wire_downlink_grads)
            aggregated = cadence.advance(fsl.h)
            row_part = int(part.sum()) if use_masks else n
            if aggregated:
                state = self._join(state, slices, shared, round_val)
                if use_masks:
                    k = int(part.sum())
                    self.stats.agg_participants.append(k)
                    if fault_active:
                        fstats.windows += 1
                        fstats.participants.append(k)
                        if k == 0:
                            fstats.empty_windows += 1
                    if k == 0:
                        who = (f"scheduler {sched.name!r}" if sched_active
                               else f"fault model {self.faults.name!r}")
                        warnings.warn(
                            f"{who} admitted no clients at the "
                            f"round-{rnd0 + r + 1} aggregation; FedAvg "
                            "skipped (no-op)")
                    else:
                        state = self._magg_fn(
                            state, self._put(part.astype(np.float32)), seeds)
                else:
                    state = self._agg_fn(state, seeds)
                slices, shared = self._split(state)
                if not ideal:
                    # each client ships its coded model up and pulls the
                    # coded average down, concurrently across the fleet:
                    # the barrier is the slowest link of the round's tail
                    if use_masks:
                        recv = np.ones(n, bool) if sched.refresh_dropped \
                            else part
                        per = (np.where(part,
                                        ms_up / net_trace.up_bps[r, :, -1]
                                        + net_trace.rtt[r, :, -1], 0.0)
                               + np.where(recv,
                                          ms_down
                                          / net_trace.down_bps[r, :, -1]
                                          + net_trace.rtt[r, :, -1], 0.0))
                        secs = float(per.max()) if k else 0.0
                    else:
                        secs = float(np.max(
                            ms_up / net_trace.up_bps[r, :, -1]
                            + ms_down / net_trace.down_bps[r, :, -1]
                            + 2.0 * net_trace.rtt[r, :, -1]))
                    if self.telemetry.enabled and secs:
                        self.telemetry.sim_span(
                            "model_sync", self.stats.async_time, secs,
                            track="server", round=rnd0 + r + 1)
                    self.stats.async_time += secs
                    self.stats.sync_time += secs
                    self.stats.model_sync_time += secs
                if profile is not None:
                    if use_masks:
                        recv_n = n if sched.refresh_dropped else k
                        meter.log("model_sync",
                                  0 if k == 0
                                  else k * ms_up + recv_n * ms_down)
                    else:
                        meter.log("model_sync", profile.wire_model_sync)
                if use_masks:
                    part[:] = True
            if self.telemetry.enabled:
                rex: dict = {}
                if use_masks:
                    rex["participants"] = row_part
                if sched_active:
                    rex["dropped_updates"] = self.stats.dropped
                    rex["skipped_updates"] = self.stats.skipped
                if fault_active:
                    rex["fault_retries"] = fstats.retries
                    rex["fault_drops"] = (fstats.crash_drops
                                          + fstats.wire_drops)
                self.telemetry.round_record(
                    "async", rnd0 + r + 1, metrics, aggregated,
                    comm_bytes=meter.total if meter is not None else None,
                    sim_time=self.stats.async_time, extra=rex or None)
            if log_every and (r + 1) % log_every == 0:
                row: dict = {"round": rnd0 + r + 1, **metrics,
                             "aggregated": aggregated,
                             "sim_time": self.stats.async_time}
                if sched_active:
                    row["participants"] = row_part
                    row["dropped_updates"] = self.stats.dropped
                    row["skipped_updates"] = self.stats.skipped
                if fault_active:
                    row["participants"] = row_part
                    row["fault_retries"] = fstats.retries
                    row["fault_drops"] = (fstats.crash_drops
                                          + fstats.wire_drops)
                if meter is not None:
                    row["comm_bytes"] = meter.total
                history.append(row)
                if callback:
                    callback(rnd0 + r + 1, dict(metrics),
                             self._join(state, slices, shared, round_val))
        if fault_active:
            # scheduler-induced drops, for contrast with crash/wire drops
            fstats.deadline_drops = self.stats.dropped
        if self.telemetry.enabled:
            self.telemetry.run_summary(
                "async", comm=meter, stats=self.stats,
                participation=self.participation_summary())
        return self._join(state, slices, shared, round_val), history

    def _run_round(self, slices: List[Dict[str, Any]], shared, batch,
                   lr: torch.Tensor, seeds: Dict[str, torch.Tensor],
                   comp: np.ndarray, up: np.ndarray, down: np.ndarray,
                   xu: np.ndarray, xd: np.ndarray, unit0: int = 0,
                   skip=None, budget=None, part=None, fault=None,
                   server_start: float = 0.0):
        """One global round of the event simulation: client transactions
        feed a priority queue of upload arrivals; the server services them
        in arrival order (FIFO on ties, so zero latency reproduces the
        synchronous order).  ``xu``/``xd`` are the [n, K] network transfer
        seconds of the coded upload/reply payloads (all zero under the
        ideal network), added on top of the per-event ``up``/``down`` base
        latencies.  ``unit0`` is the unit counter at round entry and
        ``seeds`` the round's wire seed tables (:meth:`_round_seeds`):
        unit k of client c codes with column c of row k.  Returns
        (shared', mean metrics).

        Scheduling operands (all None under wait_all): ``skip`` a bool [n]
        plan mask of clients sitting the round out (they still train
        locally, upload discarded, when the policy says
        ``local_when_skipped`` and the method is non-blocking); ``budget``
        a wall-clock deadline past which popped arrivals are dropped
        unconsumed; ``part`` the caller's running participation mask,
        AND-ed with this round's outcome in place.

        Fault operands (None under a null fault model): ``fault`` is the
        round's trace slice ``(up_attempts, up_ok, down_attempts, down_ok,
        crash)``.  Each lost transmission is retransmitted after an
        exponential-backoff wait, so a unit's transfer time is ``attempts
        * (latency + network) + backoff``.  A unit whose retry budget is
        exhausted never arrives (``part[c] = False``); crashed clients do
        no work and nobody waits on them; ``server_start > 0`` models a
        server outage.  With ``verify_frames`` each faulty unit's checksum
        frame is exercised for real (:meth:`_verify_frame`).
        """
        hooks, st = self.hooks, self.stats
        n, K = len(slices), hooks.uploads_per_round
        blocking = self._blocking
        tp = self.transport
        active = np.ones(n, bool)       # counted in this round's barrier
        if fault is not None:
            f_att, f_ok, fd_att, fd_ok, crash = fault
            fmodel = self.faults
        # telemetry: spans on the GLOBAL simulated clock, this round's
        # local event times offset by the clock so far -- host bookkeeping
        # on floats computed anyway, never touching the schedule
        tele = self.telemetry
        emit = tele.enabled
        t_base = st.async_time
        if emit and server_start > 0.0:
            tele.sim_span("outage", t_base, server_start, track="server")

        def wire_spans(name: str, c: int, k: int, t0: float, per: float,
                       att: int, ok: bool, channel: str):
            """One span per transmission attempt, interleaved with its
            retry-backoff waits: the durations add up to ``att * per +
            backoff_seconds(att)``, the transfer time in the arrival and
            reply instants."""
            cur = t_base + t0
            waits = fmodel.backoff_schedule(att) if fault is not None else ()
            for a in range(att):
                tele.sim_span(name, cur, per, track=f"client/{c}",
                              unit=unit0 + k, attempt=a + 1,
                              channel=channel,
                              delivered=ok and a == att - 1)
                cur += per
                if a < len(waits):
                    tele.sim_span("retry_backoff", cur, waits[a],
                                  track=f"client/{c}", unit=unit0 + k,
                                  channel=channel)
                    cur += waits[a]
        heap: list = []
        seq = itertools.count()
        next_k = [0] * n
        client_t = [0.0] * n        # per-client local clock
        # the metrics' device scalars in event order; fetched once a round
        tallies: Dict[str, list] = {}

        def tally(md):
            for key, v in md.items():
                tallies.setdefault(key, []).append(v)

        def compute(c: int, k: int):
            cslice, upload, pending, m = hooks.client_compute(
                slices[c], _unit_batch(batch, c, k, hooks), lr)
            slices[c] = cslice
            tally(m)
            return upload, pending

        def launch(c: int):
            """Client c computes its next upload unit and ships it coded,
            retransmitting per the fault trace until delivered or the
            retry budget runs out."""
            k = next_k[c]
            upload, pending = compute(c, k)
            if not tp.uplink.is_identity:
                useeds = seeds.get("uplink")
                upload = tp.code_uplink(
                    upload, unit0 + k, client=c,
                    seeds=None if useeds is None else useeds[k])
            if emit:
                tele.sim_span("compute", t_base + client_t[c],
                              float(comp[c, k]), track=f"client/{c}",
                              unit=unit0 + k)
            client_t[c] += float(comp[c, k])
            st.compute_time += float(comp[c, k])
            next_k[c] = k + 1
            att, ok, backoff = 1, True, 0.0
            if fault is not None:
                att, ok = int(f_att[c, k]), bool(f_ok[c, k])
                backoff = fmodel.backoff_seconds(att)
                if att > 1 and fmodel.verify_frames:
                    self._verify_frame(upload, unit0 + k, c)
            st.comm_time += att * float(xu[c, k])
            xfer = att * (float(up[c, k]) + float(xu[c, k])) + backoff
            if emit:
                wire_spans("wire/up", c, k, client_t[c],
                           float(up[c, k]) + float(xu[c, k]), att, ok,
                           "uplink")
            if not ok:
                # retry budget exhausted: the bytes burned on the wire,
                # the payload never arrived -- this client's round is lost
                client_t[c] += xfer
                if part is not None:
                    part[c] = False
                return
            heapq.heappush(heap, (client_t[c] + xfer,
                                  next(seq), c, k, upload, pending))

        for c in range(n):
            if skip is not None and skip[c]:
                st.skipped += 1
                if part is not None:
                    part[c] = False
                if self.scheduler.local_when_skipped and not blocking:
                    # extra local epochs, no upload: run the client's
                    # compute for every unit but discard the payloads
                    for k in range(K):
                        compute(c, k)
                        if emit:
                            tele.sim_span("compute", t_base + client_t[c],
                                          float(comp[c, k]),
                                          track=f"client/{c}",
                                          unit=unit0 + k, local=True)
                        client_t[c] += float(comp[c, k])
                        st.compute_time += float(comp[c, k])
                else:
                    active[c] = False   # idle: contributes no round time
                continue
            if fault is not None and crash[c]:
                # the client process died this round: its local update is
                # lost, nobody waits on it, and masked FedAvg renormalizes
                # over the survivors
                active[c] = False
                if part is not None:
                    part[c] = False
                continue
            if blocking:
                launch(c)           # next unit only after the reply lands
            else:
                for _ in range(K):
                    launch(c)       # local-only phase: stream all uploads

        server_free = server_start
        replica_free = [server_start] * n
        t_end = 0.0
        dropped_any = False
        while heap:
            t_arrive, _, c, k, upload, pending = heapq.heappop(heap)
            if budget is not None and t_arrive > budget:
                # past the deadline: sent, but the barrier does not wait
                # for (or consume) it -- partial aggregation
                st.dropped += 1
                dropped_any = True
                active[c] = False
                if part is not None:
                    part[c] = False
                continue
            if st.rounds == 0:
                st.arrival_order.append(c)
            free = server_free if hooks.server_shared else replica_free[c]
            t_done = max(t_arrive, free) + self.server_time
            sstate = shared if hooks.server_shared \
                else slices[c][hooks.server_key]
            sstate, reply, m = hooks.server_consume(sstate, upload, lr)
            tally(m)
            st.events += 1
            st.server_busy += self.server_time
            if emit:
                tele.sim_span("serve", t_base + t_done - self.server_time,
                              self.server_time,
                              track="server" if hooks.server_shared
                              else f"server/{c}", client=c, unit=unit0 + k)
            if hooks.server_shared:
                shared, server_free = sstate, t_done
            else:
                slices[c][hooks.server_key] = sstate
                replica_free[c] = t_done
            t_end = max(t_end, t_done)
            if blocking:
                d_att, d_ok, d_backoff = 1, True, 0.0
                if fault is not None:
                    d_att, d_ok = int(fd_att[c, k]), bool(fd_ok[c, k])
                    d_backoff = fmodel.backoff_seconds(d_att)
                st.comm_time += d_att * float(xd[c, k])
                t_reply = t_done + d_att * (float(down[c, k])
                                            + float(xd[c, k])) + d_backoff
                if emit:
                    wire_spans("wire/down", c, k, t_done,
                               float(down[c, k]) + float(xd[c, k]), d_att,
                               d_ok, "downlink")
                if not d_ok:
                    # the gradient reply never survived its retry budget:
                    # the client cannot continue its blocked chain -- the
                    # round is lost and it waits out the failed replies
                    if part is not None:
                        part[c] = False
                    st.client_wait += t_reply - client_t[c]
                    client_t[c] = t_reply
                    t_end = max(t_end, t_reply)
                    continue
                if not tp.downlink.is_identity:
                    dseeds = seeds.get("downlink")
                    reply = tp.code_downlink(
                        reply, unit0 + k, client=c,
                        seeds=None if dseeds is None else dseeds[k])
                slices[c] = hooks.client_receive(slices[c], pending, reply,
                                                 lr)
                st.client_wait += t_reply - client_t[c]
                client_t[c] = t_reply
                t_end = max(t_end, t_reply)
                if next_k[c] < K:
                    launch(c)

        # round wall-clock: the server's last service and the local clocks
        # of the clients the barrier waited for; a deadline round lasts at
        # least the budget (the server waited that long before cutting)
        round_time = max([t_end] + [client_t[c] for c in range(n)
                                    if active[c]])
        if dropped_any and budget is not None:
            round_time = max(round_time, budget)
        st.async_time += round_time
        # barrier counterfactual: every upload unit waits for the slowest
        # client (compute + base latency + network transfer), then the
        # server drains all n uploads back to back
        for k in range(K):
            st.sync_time += comp[:, k].max() + (up[:, k] + xu[:, k]).max() \
                + n * self.server_time
            if blocking:
                st.sync_time += (down[:, k] + xd[:, k]).max()
        # each mean a sum of the events' values in event order, as floats
        means = {}
        for key, vals in tallies.items():
            total = 0.0
            for v in torch.stack(vals).tolist():
                total += v
            means[key] = total / len(vals)
        return shared, means
