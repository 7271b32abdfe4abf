"""Method-agnostic host-level trainer (``repro.core.trainer``).

  bundle = cnn_bundle(CIFAR10)              # device="cuda" by default
  trainer = Trainer(bundle, fsl)            # method resolved from fsl.method
  state = trainer.init(seed=0)
  state, history = trainer.run(state, batcher, num_rounds=50,
                               log_every=10, meter=CommMeter(), cost_model=cm)

The Trainer runs on the bundle's device.  It owns the lr schedule, the
aggregation cadence (C), the wire seeds, callbacks / history, and — given
a :class:`CostModel` — communication metering from the method's
:class:`CommProfile`.  Two engines run the same round step:

- ``run`` is the per-round loop: one round step per round, eagerly, with
  the round's batch, lr and wire seeds staged on the device first;
- ``run_compiled(..., chunk=R)`` stages R rounds at once and runs them as
  one chunk program (``FSLMethod.make_chunk_step``): on the card each
  round is a replay of a captured CUDA graph (``repro_torch.core.graphs``)
  with no host work between replays; on the CPU the same program runs
  eagerly.  It is bitwise equal to ``run`` (state and history) on the CPU
  — use it whenever the host loop, not the math, bounds the round.

Aggregation goes through the model-sync wire (``make_wire_aggregate``;
with the identity model codecs it is the plain FedAvg).

Partial participation: a ``scheduler`` (``repro_torch.sched``: who the
barrier waits for, planned against a ``network`` of per-client links) and
``faults`` (``repro_torch.faults``: pre-drawn loss, crashes and outages)
mask clients out of FedAvg.  A client enters an aggregation only if the
plan admitted it and its wire round survived in every round since the
last one; the average is renormalized over those clients, an empty
cohort is a warned no-op, and retransmissions are billed to the byte.
With ``wait_all`` and no faults (the defaults) none of this is built.

A window that a call ends inside is kept, under a scheduler or faults:
the next call that continues the state (its round counter where the last
call stopped), or the state :meth:`Trainer.restore` brings back from a
checkpoint :meth:`Trainer.save` wrote, starts from that window's AND, so
a run split or restored mid-window admits to the window's FedAvg only the
clients the plan admitted and that survived every round of it, as the
uninterrupted run does.  (The JAX package starts each call's window
afresh, so its split runs differ from its uninterrupted ones.)

Observability: a ``telemetry`` recorder (``repro_torch.telemetry``) folds
every round into its record stream (engine ``"loop"`` or ``"compiled"``),
times each chunk's host staging and execution as host spans, and ends a
run with a summary record.  State, history and meter are bitwise the same
with it on and off.  The compiled engine's records read the metrics its
chunk fetches anyway.  ``run`` fetches a logged round's metrics in one
copy, and keeps an unlogged round's on the device: its record is folded
in with the next logged round's fetch, or fetched at the run's end (the
JAX package's recorder fetches every round).  So the recorder adds one
synchronizing call to a run whose last round is not logged (with
``log_every=0``, one a run), and none to the others.

``batcher.next_round()`` must yield ``(inputs, labels)`` with leading dims
``[n_clients, h, B, ...]``; ``inputs`` is an array or a tree of them
(``{"tokens": ...}`` for transformers).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core import graphs
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.core.methods import CommProfile, FSLMethod, get_method
from repro_torch.core.methods.base import participation_windows
from repro_torch.faults import (FRAME_BYTES, FaultStats, accumulate_round,
                                resolve_fault)
from repro_torch.network import IdealNetwork
from repro_torch.sched import SchedContext, resolve_policy
from repro_torch.telemetry import resolve_telemetry
from repro_torch.transport import resolve_transport


class AggregationCadence:
    """The paper's every-C-batches aggregation schedule (Eq. 14 cadence).

    Aggregation fires whenever the cumulative per-client batch count
    crosses a multiple of C — threshold crossing, not ``count % C == 0``,
    so the schedule is right also when C is not a multiple of h (h=3, C=2).
    """

    def __init__(self, agg_every: int, batches_done: int = 0):
        self.agg_every = agg_every
        self.batches_done = batches_done

    def advance(self, num_batches: int) -> bool:
        """Account ``num_batches`` more per-client batches; True if an
        aggregation threshold was crossed."""
        prev = self.batches_done
        self.batches_done += num_batches
        return self.batches_done // self.agg_every > prev // self.agg_every


def _stack_rounds(*xs):
    return np.stack(xs)


def _host_metrics(rounds: list) -> list:
    """Rounds' metric dicts of device scalars as host floats, in one fetch
    (float64 holds every fp32, bf16 and integer metric exactly, as
    ``float`` of each would)."""
    vals = torch.stack([v.to(torch.float64).reshape(()) for m in rounds
                        for v in m.values()]).tolist()
    out, i = [], 0
    for m in rounds:
        out.append(dict(zip(m, vals[i:i + len(m)])))
        i += len(m)
    return out


class _Participation:
    """The masked engines' host bookkeeping for one call of ``run`` or
    ``run_compiled``, a round at a time: the window's AND of the plan
    since the last aggregation (``part``: all True at the call's start, or
    the window the Trainer kept from the call before, see
    :meth:`Trainer._enter_window`), its scheduler-only mirror
    (which attributes drops to the policy in ``FaultStats``), the dropped
    updates, the fault billing and the rows' participation fields.  Both
    engines drive this one object, so their rows, meters and stats
    agree."""

    def __init__(self, trainer: "Trainer", horizon: int):
        self.tr, self.horizon = trainer, horizon
        self.n = n = trainer.fsl.num_clients
        self.sched_active = not trainer.scheduler.is_wait_all
        self.fault_active = not trainer.faults.is_null
        self.ftrace = trainer._plan_faults(horizon) \
            if self.fault_active else None
        self.masks = None
        self.part = np.ones(n, bool)
        self.part_s = np.ones(n, bool) \
            if self.sched_active and self.fault_active else None
        self.dropped_updates = 0
        self.unit_bytes = self.ms_pair = None

    def plan(self, batch) -> np.ndarray:
        """The ``[horizon, n]`` participation plan, drawn at the first
        batch (``batch`` or its spec sizes the scheduler's payloads)."""
        if self.masks is None:
            self.masks = self.tr._effective_masks(batch, self.horizon,
                                                  self.ftrace)
        return self.masks

    def advance(self, rnd: int, aggregated: bool, profile):
        """Account round ``rnd``; returns ``(mask, extra, model_sync_bytes,
        wire_bytes)``: the fp32 ``[n]`` cohort where the round aggregates a
        non-empty one (else None), the row's participation fields, the
        cohort's model-sync bytes and the trace-exact wire bytes (None
        where the meter is off or there are no faults)."""
        tr, n = self.tr, self.n
        self.part &= self.masks[rnd]
        if self.part_s is not None:
            self.part_s &= tr._sched_masks[rnd]
        wire = None
        if self.fault_active and profile is not None:
            if self.unit_bytes is None:
                self.unit_bytes = profile.unit_wire_bytes(
                    n, tr._uploads_per_round())
            wire = accumulate_round(tr._fault_stats, tr.faults, self.ftrace,
                                    rnd, *self.unit_bytes,
                                    tr.method.downloads_gradients,
                                    FRAME_BYTES)
        if not aggregated:
            return None, None, None, wire
        k, mask, ms_bytes = int(self.part.sum()), None, None
        if k == 0:
            who = (f"scheduler {tr.scheduler.name!r}" if self.sched_active
                   else f"fault model {tr.faults.name!r}")
            warnings.warn(f"{who} admitted no clients at the round-{rnd + 1} "
                          "aggregation; FedAvg skipped (no-op)")
        else:
            mask = self.part.astype(np.float32)
        self.dropped_updates += n - k
        extra = {"participants": k, "dropped_updates": self.dropped_updates}
        if self.fault_active:
            fs = tr._fault_stats
            fs.windows += 1
            fs.participants.append(k)
            if k == 0:
                fs.empty_windows += 1
            if self.part_s is not None:
                fs.deadline_drops += n - int(self.part_s.sum())
                self.part_s[:] = True
            extra.update(fault_retries=fs.retries,
                         fault_drops=fs.crash_drops + fs.wire_drops)
        if profile is not None:
            if self.ms_pair is None:
                self.ms_pair = tr._model_sync_wire_pair()
            recv = n if tr.scheduler.refresh_dropped else k
            ms_bytes = 0 if k == 0 \
                else k * self.ms_pair[0] + recv * self.ms_pair[1]
        self.part[:] = True
        return mask, extra, ms_bytes, wire


@dataclasses.dataclass
class Trainer:
    bundle: SplitModelBundle
    fsl: FSLConfig
    method: Optional[Union[str, FSLMethod]] = None  # default: fsl.method
    # wire codecs: None resolves fsl.codec and fsl.model_codec; a string
    # names the uplink codec; a repro_torch.transport.Transport passes
    # through.
    transport: Optional[Any] = None
    # scheduling: None/"wait_all" keeps the everyone-participates barrier
    # (no mask machinery is built); a policy name or a
    # repro_torch.sched.SchedulerPolicy gates FedAvg participation per
    # round, planned against ``network`` (default: the ideal network).
    scheduler: Optional[Any] = None
    network: Optional[Any] = None
    # fault injection: None/"none" keeps the lossless path; a preset name or
    # a repro_torch.faults.FaultModel pre-draws a FaultTrace that masks
    # crashed or undelivered clients out of FedAvg and bills every
    # retransmission.
    faults: Optional[Any] = None
    # observability: None resolves to the shared no-op NullTelemetry; a
    # repro_torch.telemetry.Telemetry records a record per round, counters
    # and host spans, on the host, after the values it reads were fetched.
    telemetry: Optional[Any] = None

    def __post_init__(self):
        m = self.method if self.method is not None else self.fsl.method
        if isinstance(m, str):
            m = get_method(m)
        self.method = m
        self.device = self.bundle.device
        self.transport = resolve_transport(self.transport, self.fsl)
        self.scheduler = resolve_policy(self.scheduler)
        self.faults = resolve_fault(self.faults)
        self.telemetry = resolve_telemetry(self.telemetry)
        if self.network is None:
            self.network = IdealNetwork()
        self._sched_ctx = self._sched_masks = None
        self._fault_stats = None
        self._payload_bytes = {}    # see _unit_payload_bytes
        self.step_fn = m.make_round_step(self.bundle, self.fsl,
                                         transport=self.transport)
        self.agg_fn = m.make_wire_aggregate(self.bundle, self.fsl,
                                            transport=self.transport)
        self.chunk_fn = m.make_chunk_step(self.bundle, self.fsl,
                                          transport=self.transport)
        self.pool_chunk_fn = m.make_chunk_step(
            self.bundle, self.fsl, transport=self.transport, gather=True)
        if self.masked:
            refresh = self.scheduler.refresh_dropped
            self.masked_agg_fn = m.make_wire_aggregate(
                self.bundle, self.fsl, transport=self.transport,
                participation=True, refresh=refresh)
            self.masked_chunk_fn, self.masked_pool_chunk_fn = (
                m.make_chunk_step(self.bundle, self.fsl,
                                  transport=self.transport,
                                  participation=True, refresh=refresh,
                                  gather=g) for g in (False, True))
        self.units_per_round = self.fsl.h // m.unit_batches(self.fsl)
        self._wire_leaves = self._model_leaves = None   # see _seed_leaves
        self._captured = None       # graphs.CapturedChunk on the card
        self._stream = None         # the captures' side stream
        # masked runs: (round, part, part_s) of the window the last call
        # ended in, for the call that continues it (_enter_window)
        self._window = None

    # -- public per-round API -------------------------------------------------
    def init(self, seed: int = 0):
        """Initial state on the bundle's device, drawn from a CPU
        ``torch.Generator`` seeded with ``seed`` (so every device starts
        from the same weights)."""
        gen = torch.Generator().manual_seed(seed)
        return self.method.init_state(self.bundle, self.fsl, gen)

    def lr_at(self, rnd: int) -> float:
        steps = rnd // self.fsl.lr_decay_every
        return self.fsl.lr * self.fsl.lr_decay ** steps

    def to_device(self, batch):
        """A round batch (a tuple of trees of numpy arrays or tensors) as
        tensors on the device; labels keep their int32 wire dtype."""
        return tuple(tree_map(lambda x: torch.as_tensor(x).to(self.device),
                              batch))

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _seed_leaves(self, batch) -> dict:
        """Channel -> number of payload leaves, for every channel whose
        codec draws random bits (the seeds :meth:`_round_seeds` stages).
        ``batch`` (any round batch or its spec) sizes the uplink's and
        downlink's payloads once; None asks for the model-sync channels
        only."""
        tp, method = self.transport, self.method
        if self._model_leaves is None:
            nm = 0 if tp.model_identity else len(
                method.model_sync_specs(self.bundle, self.fsl))
            self._model_leaves = {ch: nm for ch in ("model_up", "model_down")
                                  if tp.seeded(ch)}
        if batch is None:
            return self._model_leaves
        if self._wire_leaves is None:
            self._wire_leaves = {}
            if tp.seeded("uplink") or (method.downloads_gradients
                                       and tp.seeded("downlink")):
                up, reply = method.payload_specs(self.bundle, self.fsl,
                                                 batch)
                if tp.seeded("uplink"):
                    self._wire_leaves["uplink"] = len(tree_leaves(up))
                if reply is not None and tp.seeded("downlink"):
                    self._wire_leaves["downlink"] = len(tree_leaves(reply))
        return {**self._wire_leaves, **self._model_leaves}

    def _round_seeds(self, unit0: int, batch) -> dict:
        """Host (numpy) seeds of the round starting at unit ``unit0`` and
        of its aggregation (``batch`` None: the aggregation's only, at
        ``unit0``)."""
        units = 0 if batch is None else self.units_per_round
        return self.transport.stage_seeds(unit0, units, self.fsl.num_clients,
                                          self._seed_leaves(batch))

    def _lr(self, lr: float) -> torch.Tensor:
        """The lr as the 0-d fp32 device tensor the round step takes."""
        return self._put(np.float32(lr))

    def step(self, state, batch, lr: Optional[float] = None, *,
             rnd: Optional[int] = None):
        """One global round.  Pass ``lr`` explicitly or ``rnd`` to use the
        schedule (both None means lr_at(0))."""
        if lr is None:
            lr = self.lr_at(rnd or 0)
        batch = self.to_device(batch)
        seeds = {k: self._put(v) for k, v in
                 self._round_seeds(state["round"], batch).items()}
        return self.step_fn(state, batch, self._lr(lr), seeds)

    def aggregate(self, state):
        """FedAvg behind the model-sync wire, at the state's counter."""
        seeds = {k: self._put(v) for k, v in
                 self._round_seeds(state["round"], None).items()}
        return self.agg_fn(state, seeds)

    def merged_params(self, state):
        """Deployable ``{"client", "server"}`` params (with ``"aux"`` for
        the methods that train one) for evaluation."""
        return self.method.merged_params(state)

    def comm_profile(self, cost_model: CostModel, batch_size: int,
                     batch=None) -> CommProfile:
        """With a ``batch``, the profile's uplink and downlink wire bytes
        are exact for this trainer's transport (payload and reply specs
        from the method's hooks run on ``meta`` tensors); the model-sync
        wire bytes need no batch."""
        specs = mspecs = None
        if batch is not None and not self.transport.is_identity:
            specs = self.method.payload_specs(self.bundle, self.fsl, batch)
        if not self.transport.model_identity:
            mspecs = self.method.model_sync_specs(self.bundle, self.fsl)
        return self.method.comm_profile(cost_model, self.fsl, batch_size,
                                        transport=self.transport,
                                        payload_specs=specs,
                                        model_specs=mspecs)

    @property
    def masked(self) -> bool:
        """A scheduler other than wait_all, or faults, is set: FedAvg runs
        masked over each window's cohort."""
        return not self.scheduler.is_wait_all or not self.faults.is_null

    def wallclock_estimate(self, cost_model: CostModel, batch_size: int,
                           num_rounds: int, network, batch=None,
                           compute: float = 1.0, server_time: float = 0.05,
                           faults=None):
        """Analytic synchronous wall-clock of ``num_rounds`` rounds under
        ``network`` (a :class:`repro_torch.network.NetworkModel`), from the
        codec-effective wire bytes: exact payload bytes with a ``batch``
        (the method's payload specs), else from the analytic CommProfile
        (identity transports only).  ``compute`` is the per-upload-unit
        client compute seconds.  With a non-null fault model (``faults``,
        default the trainer's) transfer bytes scale by the expected
        transmissions under the retry budget, frame included per attempt,
        and the expected backoff joins the compute time.  Returns a
        :class:`repro_torch.network.WallClockEstimate`."""
        from repro_torch.network.wallclock import estimate_sync_wallclock
        fsl, m, tp = self.fsl, self.method, self.transport
        n = fsl.num_clients
        K = self._uploads_per_round()
        profile = self.comm_profile(cost_model, batch_size, batch=batch)
        if batch is not None:
            pb = self._unit_payload_bytes(batch)
            up_bytes, down_bytes = pb["up_bytes"], pb["down_bytes"]
        else:
            if not tp.is_identity:
                raise ValueError(
                    "wallclock_estimate needs a `batch` to derive the "
                    "codec-effective payload bytes of a non-identity "
                    "transport (without one the estimate would silently "
                    "use uncompressed sizes)")
            up_bytes = (profile.wire_uplink_smashed
                        + profile.uplink_labels) // (n * K)
            down_bytes = profile.wire_downlink_grads // (n * K)
        fm = resolve_fault(faults if faults is not None else self.faults)
        if not fm.is_null:
            att = fm.expected_attempts()
            up_bytes = int(round((up_bytes + FRAME_BYTES) * att))
            if down_bytes:
                down_bytes = int(round((down_bytes + FRAME_BYTES) * att))
            compute = compute + fm.expected_backoff()
        ms_up, ms_down = self._model_sync_wire_pair()
        # rounds that cross a C-batch threshold: at most one aggregation a
        # round, as AggregationCadence.advance(h) counts them
        C = fsl.resolved_agg_every
        aggs = sum(1 for r in range(1, num_rounds + 1)
                   if (r * fsl.h) // C > ((r - 1) * fsl.h) // C)
        return estimate_sync_wallclock(
            network, n, num_rounds, uploads_per_round=K, up_bytes=up_bytes,
            down_bytes=down_bytes, blocking=m.downloads_gradients,
            compute=compute, server_time=server_time, agg_events=aggs,
            model_up_bytes=ms_up, model_down_bytes=ms_down)

    # -- the window across calls, and the checkpoint --------------------------
    def _enter_window(self, book: Optional[_Participation], rnd0: int):
        """Start ``book`` from the window the last call ended in when this
        call continues it (starts at its round)."""
        w = self._window
        if book is None or w is None or w[0] != rnd0:
            return
        book.part = w[1].copy()
        if book.part_s is not None and w[2] is not None:
            book.part_s = w[2].copy()

    def _leave_window(self, book: Optional[_Participation], rnd: int):
        """Keep the window a call ended in, at round ``rnd``."""
        if book is not None:
            self._window = (rnd, book.part.copy(), None
                            if book.part_s is None else book.part_s.copy())

    def save(self, path: str, state):
        """Write ``state`` (and, under a scheduler or faults, the window it
        stands in) as a ``repro_torch.checkpoint``: an ``.npz`` and its
        JSON manifest."""
        rnd = self.method.batches_trained(self.fsl, state) // self.fsl.h
        tree, w = {"state": state}, self._window
        if w is not None and w[0] == rnd:
            tree["window"] = {"part": w[1]}
            if w[2] is not None:
                tree["window"]["part_s"] = w[2]
        ckpt.save(path, tree, step=rnd,
                  extra={"method": self.method.name,
                         "num_clients": self.fsl.num_clients,
                         "window": sorted(tree.get("window", {}))})
        return path

    def restore(self, path: str, like=None):
        """The state :meth:`save` wrote, on this trainer's device; a window
        saved with it (under a scheduler or faults) is the one the next
        call continues, and without one the next call starts a fresh
        window.  ``like`` is the
        template (default: the method's state on ``meta`` tensors, so no
        parameters are drawn)."""
        extra = ckpt.manifest(path)["extra"]
        if extra["method"] != self.method.name \
                or extra["num_clients"] != self.fsl.num_clients:
            raise ValueError(
                f"checkpoint is for {extra['method']} with "
                f"{extra['num_clients']} clients; the trainer runs "
                f"{self.method.name} with {self.fsl.num_clients}")
        if like is None:
            like = self.method.meta_state(self.bundle, self.fsl)
        tmpl = {"state": like}
        n = self.fsl.num_clients
        if extra["window"]:
            tmpl["window"] = {k: np.ones(n, bool) for k in extra["window"]}
        tree = ckpt.restore(path, tmpl, device=self.device)
        state = tree["state"]
        rnd = self.method.batches_trained(self.fsl, state) // self.fsl.h
        w = tree.get("window")
        self._window = None if w is None else (rnd, w["part"],
                                               w.get("part_s"))
        return state

    # -- participation: the scheduler's plan and the fault trace --------------
    def _plan_schedule(self, batch, horizon: int) -> np.ndarray:
        """The scheduler's plan for global rounds ``0..horizon-1`` (indexed
        by the absolute round, so a resumed run realizes the same plan),
        against a SchedContext whose payload bytes come from the method's
        payload specs through this trainer's transport."""
        m, fsl = self.method, self.fsl
        ctx = SchedContext(
            fsl=fsl, network=self.network, **self._unit_payload_bytes(batch),
            blocking=m.downloads_gradients,
            uploads_per_round=self._uploads_per_round())
        masks = np.asarray(self.scheduler.plan(ctx, horizon), bool)
        if masks.shape != (horizon, fsl.num_clients):
            raise ValueError(f"scheduler plan shape {masks.shape} != "
                             f"{(horizon, fsl.num_clients)}")
        self._sched_ctx, self._sched_masks = ctx, masks
        return masks

    def _unit_payload_bytes(self, batch) -> dict:
        """One client's ``up_bytes`` / ``down_bytes`` a unit (the reply's 0
        for non-blocking methods): the method's payload specs through this
        trainer's transport, computed once per batch shape (the specs come
        from running the hooks on ``meta`` tensors, which on a large model
        costs more than a captured round's host work)."""
        key = tuple((tuple(x.shape), str(x.dtype)) for x in tree_leaves(batch))
        if key not in self._payload_bytes:
            tp = self.transport
            up, reply = self.method.payload_specs(self.bundle, self.fsl,
                                                  batch)
            self._payload_bytes[key] = {
                "up_bytes": tp.uplink_payload_bytes(up),
                "down_bytes": tp.downlink_payload_bytes(reply)
                if reply is not None else 0}
        return self._payload_bytes[key]

    def _uploads_per_round(self) -> int:
        return self.fsl.h if self.method.uploads_every_batch else 1

    def _plan_faults(self, horizon: int):
        """The fault trace of global rounds ``0..horizon-1``; resets the
        run's :class:`FaultStats`."""
        trace = self.faults.trace(horizon, self.fsl.num_clients,
                                  self._uploads_per_round())
        self._fault_stats = FaultStats()
        return trace

    def _effective_masks(self, batch, horizon: int,
                         fault_trace) -> np.ndarray:
        """Per-round participation, ``[horizon, n]``: the scheduler's plan
        AND the fault trace's survival (no crash, every unit delivered,
        and for blocking methods every reply received)."""
        if not self.scheduler.is_wait_all:
            masks = np.array(self._plan_schedule(batch, horizon), copy=True)
        else:
            masks = np.ones((horizon, self.fsl.num_clients), bool)
        if fault_trace is not None:
            masks &= fault_trace.survives(self.method.downloads_gradients)
        return masks

    def participation_summary(self):
        """The scheduler's summary of the realized plan (None before a
        scheduled run and for wait_all), plus ``"faults"`` (the run's
        :class:`FaultStats`) whenever a fault model was active."""
        base = None
        if self._sched_masks is not None:
            base = self.scheduler.summary(self._sched_ctx, self._sched_masks)
        if self.faults.is_null or self._fault_stats is None:
            return base
        out = dict(base or {})
        out["faults"] = self._fault_stats.as_dict()
        return out

    def _model_sync_wire_pair(self):
        """(up, down) wire bytes of ONE client's model-sync payload."""
        mspecs = self.method.model_sync_specs(self.bundle, self.fsl)
        return (self.transport.model_up_wire_bytes(mspecs),
                self.transport.model_down_wire_bytes(mspecs))

    def _log_round(self, rnd, rnd0, aggregated, metrics_fn, profile, meter,
                   log_every, callback, history, state, extra=None,
                   model_sync_bytes=None, wire_bytes=None, engine="loop",
                   pending=None, device_metrics=None):
        """Meter + history row for one finished (post-aggregation) round.
        ``metrics_fn`` lazily yields the float-cast metrics, so device
        scalars are fetched only on logged rounds.  The masked engines pass
        the row's participation ``extra`` fields, the cohort's
        ``model_sync_bytes`` (None: the whole fleet's, from the profile)
        and, under faults, ``wire_bytes``: the trace-exact bytes by kind
        (retransmissions and frames included) in place of the profile's
        per-round charges.  An enabled telemetry recorder folds every
        round into its stream under ``engine``, from the same values; with
        ``pending`` (a list) and the round's ``device_metrics``, an
        unlogged round's record waits there for :meth:`_fold_pending`."""
        if profile is not None:
            if wire_bytes is None:
                meter.log("uplink_smashed", profile.wire_uplink_smashed)
                meter.log("uplink_labels", profile.uplink_labels)
                meter.log("downlink_grads", profile.wire_downlink_grads)
            else:
                for kind, nb in wire_bytes.items():
                    meter.log(kind, nb)
            if aggregated:
                meter.log("model_sync", profile.wire_model_sync
                          if model_sync_bytes is None else model_sync_bytes)
        tele = self.telemetry
        logged = log_every and (rnd + 1 - rnd0) % log_every == 0
        if tele.enabled and pending is not None:
            pending.append((engine, rnd + 1, {
                k: v.detach() for k, v in device_metrics.items()},
                aggregated, meter.total if meter is not None else None,
                extra))
            m = self._fold_pending(pending) if logged else None
        else:
            m = metrics_fn() if (logged or tele.enabled) else None
            if tele.enabled:
                tele.round_record(engine, rnd + 1, m, aggregated,
                                  comm_bytes=meter.total if meter is not None
                                  else None, extra=extra)
        if logged:
            row: dict = {"round": rnd + 1, **m, "aggregated": aggregated}
            if extra:
                row.update(extra)
            if meter is not None:
                row["comm_bytes"] = meter.total
            history.append(row)
            if callback:
                callback(rnd + 1, m, state)

    def _fold_pending(self, pending: list):
        """Fold the waiting round records into the recorder, their metrics
        fetched in one copy (:func:`_host_metrics`); returns the last
        record's metrics."""
        if not pending:
            return None
        for (engine, rnd, _, aggregated, comm, extra), m in zip(
                pending, _host_metrics([rec[2] for rec in pending])):
            self.telemetry.round_record(engine, rnd, m, aggregated,
                                        comm_bytes=comm, extra=extra)
        pending.clear()
        return m

    # -- the loop -------------------------------------------------------------
    def run(self, state, batcher, num_rounds: int, log_every: int = 0,
            callback=None, meter: Optional[CommMeter] = None,
            cost_model: Optional[CostModel] = None):
        """Run ``num_rounds`` global rounds, one round step each.

        - aggregation fires every C batches (``fsl.resolved_agg_every``) on
          threshold crossing, resumed from ``state["round"]``;
        - ``callback(rnd, metrics, state)`` fires on the ``log_every``
          cadence, after aggregation, with float-cast metrics;
        - with ``meter`` + ``cost_model``, per-round and per-aggregation
          bytes from the method's CommProfile are logged and a
          ``comm_bytes`` running total joins the history rows; each row
          also records whether that round ``aggregated``;
        - with a scheduler other than wait_all, or faults, FedAvg runs
          masked over each window's cohort (:class:`_Participation`); rows
          of aggregating rounds gain ``participants`` and
          ``dropped_updates`` (and, under faults, ``fault_retries`` and
          ``fault_drops``), the model-sync meter bills the cohort, and an
          empty cohort is a warned no-op.

        For many rounds of a small model, :meth:`run_compiled` runs the
        same rounds without the per-round host dispatch.
        """
        start_batches = self.method.batches_trained(self.fsl, state)
        cadence = AggregationCadence(self.fsl.resolved_agg_every,
                                     start_batches)
        rnd0 = start_batches // self.fsl.h
        history = []
        profile = None
        book = _Participation(self, rnd0 + num_rounds) if self.masked \
            else None
        self._enter_window(book, rnd0)
        pending = []                # records waiting for a fetch
        for rnd in range(rnd0, rnd0 + num_rounds):
            batch = self.to_device(batcher.next_round())
            if meter is not None and cost_model is not None and profile is None:
                profile = self.comm_profile(cost_model, batch[1].shape[2],
                                            batch=batch)
            if book is not None:
                book.plan(batch)
            seeds = {k: self._put(v) for k, v in
                     self._round_seeds(state["round"], batch).items()}
            state, metrics = self.step_fn(state, batch,
                                          self._lr(self.lr_at(rnd)), seeds)
            aggregated = cadence.advance(self.fsl.h)
            extra = ms_bytes = wire = None
            if book is None:
                if aggregated:
                    state = self.agg_fn(state, seeds)
            else:
                mask, extra, ms_bytes, wire = book.advance(rnd, aggregated,
                                                           profile)
                if mask is not None:
                    state = self.masked_agg_fn(state, self._put(mask), seeds)
            self._log_round(rnd, rnd0, aggregated,
                            lambda: _host_metrics([metrics])[0],
                            profile, meter, log_every, callback, history,
                            state, extra=extra, model_sync_bytes=ms_bytes,
                            wire_bytes=wire, pending=pending,
                            device_metrics=metrics)
        self._fold_pending(pending)
        self._leave_window(book, rnd0 + num_rounds)
        if self.telemetry.enabled:
            self.telemetry.run_summary(
                "loop", comm=meter, participation=self.participation_summary())
        return state, history

    # -- the compiled loop ----------------------------------------------------
    @staticmethod
    def pool_round_spec(pool, idx_shape):
        """The ``(inputs, labels)`` round batch a device pool and an ``[n,
        h, B]`` index plan imply, as ``meta`` tensors: shape-compatible
        with a staged batch wherever only specs matter (CommProfile's
        payload specs, the seed tables' leaf counts)."""
        lead = tuple(idx_shape)
        return tree_map(lambda p: torch.empty(lead + tuple(p.shape[1:]),
                                              dtype=p.dtype, device="meta"),
                        pool)

    def run_compiled(self, state, batcher, num_rounds: int, chunk: int = 16,
                     log_every: int = 0, callback=None,
                     meter: Optional[CommMeter] = None,
                     cost_model: Optional[CostModel] = None,
                     device_data: bool = True):
        """Run ``num_rounds`` global rounds, ``chunk`` rounds per chunk
        program — bitwise equal to :meth:`run` (state and history) on the
        CPU.

        Each chunk stages ``R = min(chunk, remaining)`` rounds at once: the
        batches (or their index plan), the lrs (computed in double as
        :meth:`lr_at` does, staged as fp32) and the wire seeds.  On the card
        the rounds are replays of one captured round (``core/graphs.py``),
        with and without the aggregation as the cadence says; the per-round
        metrics come back in one fetch a chunk, and the meter and history
        rows are rebuilt on the host from the CommProfile and the cadence.
        On the CPU the same chunk program runs eagerly.  A capture that
        fails raises: the card never falls back to eager rounds.

        Differences from :meth:`run` worth knowing:
        - donation: on the card the state passed in becomes the captured
          program's buffers, overwritten every round — keep no reference to
          it, nor to a state returned earlier, across calls;
        - ``callback(rnd, metrics, state)`` fires on the ``log_every``
          cadence with that round's metrics but the *chunk-final* state
          (mid-chunk states never reach the host).  Pass
          ``chunk=log_every`` when the callback inspects the state;
        - resume: like :meth:`run`, the cadence and the lr schedule restart
          from ``state["round"]``, chunk-aligned or not.

        Under a scheduler or faults the chunk takes its rounds' slice of
        the participation plan and the carry of the plan's AND across
        chunks (the JAX chunk's ``part``); each round's cohort is computed
        on the host and staged as a table the masked aggregate reads, and
        on the card a round whose cadence fires on an empty cohort replays
        the graph without the aggregation.  Rows, meter and stats come
        from the same host bookkeeping as :meth:`run`'s.

        Data path: with ``device_data=True`` (the default) and a batcher
        that speaks the device-pool protocol (``device_pool(device)`` +
        ``next_round_indices()``), the sample pool is uploaded once and
        each chunk ships only an ``[R, n, h, B]`` index plan; the batches
        are gathered on the device, bitwise equal to staging.  Other
        batchers, or ``device_data=False``, stage the batches.
        """
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk} "
                             "(use Trainer.run for the per-round loop)")
        if self.transport.bits_fn is not None and self.device.type == "cuda":
            raise ValueError("bits_fn reads the unit counter on the host; "
                             "it cannot drive a captured round")
        start_batches = self.method.batches_trained(self.fsl, state)
        rnd0 = start_batches // self.fsl.h
        history, profile, done = [], None, 0
        book = _Participation(self, rnd0 + num_rounds) if self.masked \
            else None
        self._enter_window(book, rnd0)
        # the chunks' participation carry (the JAX chunk's ``part``): the
        # window's AND so far, as the host's ``book.part``
        carry = np.ones(self.fsl.num_clients, np.float32) if book is None \
            else book.part.astype(np.float32)
        pooled = (device_data and hasattr(batcher, "device_pool")
                  and hasattr(batcher, "next_round_indices"))
        pool = batcher.device_pool(self.device) if pooled else None
        tele, chunk_idx = self.telemetry, 0
        while done < num_rounds:
            r = min(chunk, num_rounds - done)
            # host spans: the chunk's staging, then its rounds (on the card
            # the replays and the one fetch of their metrics); ``capture``
            # marks a chunk that captured its graphs first
            with tele.timed("chunk/build", chunk=chunk_idx, rounds=r):
                if pooled:
                    data = np.stack([batcher.next_round_indices()
                                     for _ in range(r)]).astype(np.int64)
                    sample = self.pool_round_spec(pool, data.shape[1:])
                else:
                    rounds = [batcher.next_round() for _ in range(r)]
                    sample = rounds[0]
                    data = tree_map(_stack_rounds, *rounds)
                if meter is not None and cost_model is not None \
                        and profile is None:
                    profile = self.comm_profile(
                        cost_model, tree_leaves(sample[1])[0].shape[2],
                        batch=sample)
                lrs = np.array([self.lr_at(rnd0 + done + i)
                                for i in range(r)], dtype=np.float32)
                plan = None
                if book is not None:
                    plan = book.plan(sample)[rnd0 + done:rnd0 + done + r] \
                        .astype(np.float32)
            with tele.timed("chunk/execute", chunk=chunk_idx,
                            rounds=r) as span:
                state, metrics, agg_mask, carry, captured = self._chunk(
                    state, pool, data, lrs, sample, chunk, plan, carry)
                span.label(capture=captured)
            chunk_idx += 1
            for i in range(r):
                rnd, aggregated = rnd0 + done + i, bool(agg_mask[i])
                extra = ms_bytes = wire = None
                if book is not None:
                    _, extra, ms_bytes, wire = book.advance(rnd, aggregated,
                                                            profile)
                self._log_round(
                    rnd, rnd0, aggregated,
                    lambda: {k: float(v[i]) for k, v in metrics.items()},
                    profile, meter, log_every, callback, history, state,
                    extra=extra, model_sync_bytes=ms_bytes, wire_bytes=wire,
                    engine="compiled")
            done += r
        self._leave_window(book, rnd0 + num_rounds)
        if tele.enabled:
            tele.run_summary("compiled", comm=meter,
                             participation=self.participation_summary())
        return state, history

    def _chunk(self, state, pool, data, lrs: np.ndarray, sample, chunk: int,
               plan=None, carry=None, defer: bool = False):
        """One chunk of ``r = len(lrs)`` rounds from ``state``: the rounds'
        wire seeds staged from ``state["round"]`` (``sample``, a round
        batch or its spec, sizes them), then on the card a replay a round
        (:meth:`_replay`, captures of ``max(chunk, r)`` rows) and on the
        CPU the eager chunk program.  ``data`` is the int64 ``[r, n, h,
        B]`` index plan into the device ``pool``, or (``pool`` None) the
        stacked batches; ``plan`` and ``carry`` the masked chunk's fp32
        participation plan and its carry.  Returns ``(state, {name: [r]
        floats}, flags, carry, captured)``: ``flags`` says which rounds
        aggregated by the cadence, ``captured`` whether the chunk captured
        its graphs first.  With ``defer`` the metrics come as a function
        that returns them: on the card it waits for the replays, which run
        on while the host does other work."""
        r, unit0 = lrs.shape[0], state["round"]
        per = [self._round_seeds(unit0 + i * self.units_per_round, sample)
               for i in range(r)]
        seeds = {k: np.stack([p[k] for p in per]) for k in per[0]}
        if self.device.type == "cuda":
            return self._replay(state, pool, data, lrs, seeds, chunk, plan,
                                carry, fetch=not defer)
        if plan is None:
            fn = self.pool_chunk_fn if pool is not None else self.chunk_fn
        else:
            fn = self.masked_pool_chunk_fn if pool is not None \
                else self.masked_chunk_fn
        args = (pool, self._put(data)) if pool is not None \
            else (tree_map(self._put, data),)
        args += (self._put(lrs), {k: self._put(v) for k, v in seeds.items()})
        if plan is not None:
            args += (self._put(plan), self._put(carry))
        state, metrics, agg_mask, *out = fn(state, *args)
        if out:
            carry = out[0].cpu().numpy()
        metrics = {k: v.tolist() for k, v in metrics.items()}
        return (state, (lambda: metrics) if defer else metrics,
                agg_mask.tolist(), carry, False)

    def _replay(self, state, pool, data, lrs, seeds, chunk: int, plan=None,
                carry=None, fetch: bool = True):
        """One chunk on the card: stage it into the captured program's
        buffers (capturing first where no capture fits) and replay a
        round per row.  With ``plan`` (the chunk's fp32 ``[r, n]``
        participation plan) and ``carry``, the host computes each round's
        cohort (:func:`participation_windows`), stages the table, and
        replays the aggregating graph only where the cadence fires and the
        cohort is not empty.  Returns ``(state, {name: [r] floats}, flags,
        carry, captured)``; ``flags`` is the cadence.  ``fetch=False``:
        the metrics come as a function that waits for the replays
        (:meth:`graphs.CapturedChunk.replay`)."""
        r, unit0 = lrs.shape[0], state["round"]
        masked = plan is not None
        if masked:
            fn = self.masked_pool_chunk_fn if pool is not None \
                else self.masked_chunk_fn
        else:
            fn = self.pool_chunk_fn if pool is not None else self.chunk_fn
        flags = fn.cadence(unit0, r)
        fires, windows = flags, None
        if masked:
            windows, fires, carry = participation_windows(plan, carry, flags)
        cap = self._captured
        captured = not graphs.matches(cap, r, pool, data, masked)
        if not captured:
            cap.load_state(state)
            cap.stage(data, lrs, seeds, windows)
        else:
            self._captured = cap = None
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            # each capture takes a fresh private pool: a pool whose graphs
            # have been freed cannot start another capture
            cap = graphs.CapturedChunk(fn.body, state, max(chunk, r), data,
                                       lrs, seeds, pool,
                                       torch.cuda.graph_pool_handle(),
                                       self._stream, windows=windows)
            self._captured = cap
        names = cap.names

        def metrics_of(rows):
            return {k: rows[:, j].tolist() for j, k in enumerate(names)}

        rows = cap.replay(fires, fetch)
        state = {**cap.state, "round": unit0 + r * self.units_per_round}
        metrics = metrics_of(rows) if fetch \
            else (lambda: metrics_of(rows()))
        return state, metrics, flags, carry, captured
