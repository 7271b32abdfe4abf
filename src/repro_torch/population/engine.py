"""The population engine (``repro.population.engine``): cohorts of C from
fleets of N >= 10^6.

CSE-FSL's storage headline is that the server holds ONE model however
many clients exist; this engine makes the simulation keep the same
scaling.  Instead of dense per-client state for N clients (the dense
:class:`~repro_torch.core.trainer.Trainer`, O(N) memory), a
:class:`Population` keeps:

  - the *cohort* state: the C sampled clients of the current aggregation
    window, stacked exactly like a dense ``fsl.num_clients = C`` trainer
    state, run through the Trainer's pooled chunk program (on the card a
    replay of its captured round a round, batches gathered from the
    device-resident pool);
  - ONE *default row*: the state of every untouched client.  Methods
    FedAvg their whole stacked subtrees (params AND opt state), so after
    an aggregation every cohort row is the same: an untouched client's
    state is a pure function of the global model, and with
    ``refresh=True`` (the CSE-FSL global-model semantics) the sparse cache
    below stays empty;
  - a sparse host-side *cache* for ``refresh=False`` (non-cohort clients
    keep their last state): the post-window row, one shared tree a window
    since all cohort rows are equal, keyed by the touched client ids.
    Memory is O(windows), not O(N).

Engine memory is therefore independent of N (:meth:`memory_report`), and
for C == N with a :class:`~repro_torch.population.data.FederatedPool` the
engine is bitwise equal to ``Trainer.run`` on the CPU and to
``Trainer.run_compiled`` on the card.

Cohorts are drawn per aggregation *window* (the span between C-batch
threshold crossings) by a :class:`~repro_torch.sched.CohortSampler` keyed
on ``(seed, window)``; the window is a pure function of the round counter,
so a restored engine re-derives its cohorts with no sampler state.

Every row the engine keeps is a copy (``clone``), never a view of the
running state: on the card ``Trainer._replay`` adopts the state as the
captured program's static buffers and overwrites them every round.

The JAX engine's ``donate`` and ``mesh`` options are not ported: the port
has no donation flag (on the card the state is always adopted by the
captured program) and no sharding yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.common import bytes_of, tree_leaves, tree_map, tree_stack
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.core.trainer import Trainer, _Participation
from repro_torch.network.model import IDEAL_LINK, TIERS, ClientLink
from repro_torch.sched import CohortSampler, resolve_cohort


def _row(tree):
    """Row 0 of a stacked tree, as a copy."""
    return tree_map(lambda x: x[0].clone(), tree)


def _held_bytes(tree) -> int:
    """Bytes of a tree's tensors; the host round counter counts as the
    JAX package's int32 scalar, so the report equals the reference's."""
    return sum(4 if isinstance(x, int) else x.numel() * x.element_size()
               for x in tree_leaves(tree))


@dataclasses.dataclass
class Population:
    """Cohort-sampled training over a fleet of ``population`` clients.

    ``fsl.num_clients`` is the COHORT size C: the chunk programs, the
    CommProfile and the wire accounting all see a C-client fleet a window,
    which is how cohort-scaled federated accounting is defined (bytes
    scale with who trains, not with N).
    """

    bundle: SplitModelBundle
    fsl: FSLConfig
    population: int
    data: Any                                   # FederatedPool / VirtualPool
    sampler: Optional[Union[str, CohortSampler]] = None
    transport: Optional[Any] = None
    network: Optional[Any] = None
    refresh: bool = True
    seed: int = 0
    compute_s: float = 1.0          # per-upload-unit client compute seconds
    server_time: float = 0.05       # per-reply server seconds (blocking)
    # fault injection (repro_torch.faults): faults are drawn per COHORT
    # SLOT (slot c of window w is the sampled client occupying it), and
    # crashed or undelivered slots drop out of the window's FedAvg through
    # the dense trainer's masked machinery.  Needs refresh=True: a crashed
    # client's lost local update is exactly the refresh overwrite.
    faults: Optional[Any] = None
    # observability (repro_torch.telemetry): passed to the inner Trainer;
    # the engine emits a record a round under engine="population", chunk
    # build/execute host spans and a "population" summary.  It only
    # observes.
    telemetry: Optional[Any] = None

    def __post_init__(self):
        C = self.fsl.num_clients
        if self.population < C:
            raise ValueError(f"population {self.population} < cohort {C}")
        self.trainer = Trainer(self.bundle, self.fsl,
                               transport=self.transport,
                               network=self.network, faults=self.faults,
                               telemetry=self.telemetry)
        self.telemetry = self.trainer.telemetry
        self.faults = self.trainer.faults
        if not self.faults.is_null and not self.refresh:
            raise ValueError(
                "fault injection needs refresh=True cohort semantics: with "
                "refresh=False a crashed slot's locally-trained rows would "
                "enter the sparse cache as if aggregated")
        self.network = self.trainer.network
        self.sampler = resolve_cohort(self.sampler, seed=self.seed)
        self._unit = self.trainer.method.unit_batches(self.fsl)
        self._agg_every = self.fsl.resolved_agg_every
        self._state = None
        self._default: Dict[str, Any] = {}
        self._cache: Dict[int, Dict[str, Any]] = {}
        self._cohorts: Dict[int, np.ndarray] = {}
        self._window: Optional[int] = None
        self._stacked: tuple = ()
        self._windows_seen: set = set()
        self._records: List[Dict[str, Any]] = []
        self._payload_bytes = None
        self._tier_spans = None
        # fault runs: the global row at the current window's entry, kept so
        # a zero-participant window (a FedAvg no-op) can be unwound: the
        # next cohort inherits the last aggregated model, not the rows the
        # no-op left trained locally
        self._entry_row: Optional[Dict[str, Any]] = None
        self._window_empty = False
        # fault runs: the window's participation so far (the host's AND of
        # the slots' survival since the last aggregation, and the chunk
        # program's fp32 carry of it), kept across calls of ``run`` and in
        # checkpoints, so a run split or restored mid-window drops the
        # slots that failed before the split (the JAX engine restarts both
        # at every call)
        self._part = np.ones(C, bool)
        self._carry = np.ones(C, np.float32)

    # -- lazy per-client state ---------------------------------------------
    @property
    def cohort_size(self) -> int:
        return self.fsl.num_clients

    def window_of(self, rnd: int) -> int:
        """Aggregation-window index of global round ``rnd``: the number of
        C-batch thresholds crossed before it (pure in ``rnd``)."""
        return (rnd * self._unit) // self._agg_every

    def cohort_for(self, window: int) -> np.ndarray:
        ids = self._cohorts.get(window)
        if ids is None:
            ids = self.sampler.sample(window, self.population,
                                      self.cohort_size, network=self.network)
            self._cohorts[window] = ids
        return ids

    def _row(self, cid: int) -> Dict[str, Any]:
        cached = self._cache.get(int(cid))
        return cached if cached is not None else self._default

    def _restack(self, ids: np.ndarray):
        """The cohort's stacked rows from the cache and the default row."""
        rows = [self._row(i) for i in ids]
        stacked = {k: tree_stack([r[k] for r in rows])
                   for k in self._stacked}
        self._state = {**self._state, **stacked}

    def _advance_window(self, window: int):
        """Finish the current window, enter ``window``.

        With ``refresh=True`` nothing moves: the rows after the
        aggregation are all the same and ARE the global model, the
        incoming cohort's rows bit for bit.  With ``refresh=False`` the
        outgoing cohort's (shared) post-window row enters the sparse cache
        and the incoming cohort restacks from the cache and the default."""
        if not self.refresh and self._window is not None:
            row = {k: _row(self._state[k]) for k in self._stacked}
            for cid in self._cohorts[self._window]:
                self._cache[int(cid)] = row
            self._restack(self.cohort_for(window))
        self._window = window

    def _close_window(self, state):
        """Fault runs only, at every window boundary: if the finished
        window aggregated nobody, restack every row from the window's
        entry row; then row 0 (the new global model) becomes the next
        window's entry row."""
        if self._window_empty:
            stacked = {k: tree_stack([self._entry_row[k]] * self.cohort_size)
                       for k in self._stacked}
            state = {**state, **stacked}
            self._window_empty = False
        self._entry_row = {k: _row(state[k]) for k in self._stacked}
        return state

    # -- lifecycle ----------------------------------------------------------
    def init(self, seed: int = 0, state=None):
        """Draw the initial state (``Trainer.init(seed)``), or start from
        ``state``, a C-client trainer state whose rows are all the same."""
        state = self.trainer.init(seed) if state is None else state
        self._stacked = tuple(k for k in ("clients", "servers") if k in state)
        # stack_clients broadcasts one init row to all C clients, so row 0
        # IS the global model every untouched client shares
        self._default = {k: _row(state[k]) for k in self._stacked}
        self._cache = {}
        self._state = state
        rnd = self.trainer.method.batches_trained(self.fsl, state) \
            // self.fsl.h
        self._window = self.window_of(rnd)
        self.cohort_for(self._window)
        if not self.faults.is_null:
            self._entry_row = {k: _row(state[k]) for k in self._stacked}
            self._window_empty = False
        self._part = np.ones(self.cohort_size, bool)
        self._carry = np.ones(self.cohort_size, np.float32)
        return self

    # -- stats ---------------------------------------------------------------
    def _client_link(self, cid: int) -> ClientLink:
        net = self.network
        if getattr(net, "is_ideal", False):
            return IDEAL_LINK
        if self._tier_spans is not None:
            for name, lo, hi in self._tier_spans:
                if lo <= cid < hi:
                    return TIERS[name]
            return TIERS[self._tier_spans[-1][0]]
        return net.expected_links(1)[0]

    def _client_seconds(self, link: ClientLink) -> float:
        """Analytic per-round seconds of one cohort client: the blocking /
        streaming decomposition of the deadline scheduler and the sync
        wall-clock estimator."""
        up, down = self._payload_bytes
        m = self.trainer.method
        K = self.fsl.h if m.uploads_every_batch else 1
        if m.downloads_gradients:
            return (K * (self.compute_s + link.up_seconds(up))
                    + (K - 1) * (self.server_time + link.down_seconds(down)))
        return K * self.compute_s + link.up_seconds(up)

    def _record_window(self, window: int, ids: np.ndarray, rnd: int):
        if window in self._windows_seen:
            return
        self._windows_seen.add(window)
        tiers: Dict[str, int] = {}
        spans = getattr(self.network, "tier_ranges", None)
        if spans is not None and self._tier_spans is None:
            self._tier_spans = spans(self.population)
        seconds = []
        for cid in ids:
            link = self._client_link(int(cid))
            if self._tier_spans is not None:
                name = next(nm for nm, lo, hi in self._tier_spans
                            if lo <= int(cid) < hi)
                tiers[name] = tiers.get(name, 0) + 1
            if self._payload_bytes is not None:
                seconds.append(self._client_seconds(link))
        self._records.append({"window": window, "round": rnd,
                              "cohort": len(ids), "tiers": tiers,
                              "seconds": seconds})

    def population_summary(self, history=None) -> Dict[str, Any]:
        """Population-level stats: participation by tier, the straggler
        seconds' quantiles over every window's cohort, and the coverage of
        the fleet (per-client rows never exist; this replaces them)."""
        tiers: Dict[str, int] = {}
        seconds: List[float] = []
        for rec in self._records:
            for name, k in rec["tiers"].items():
                tiers[name] = tiers.get(name, 0) + k
            seconds.extend(rec["seconds"])
        total = sum(tiers.values())
        out: Dict[str, Any] = {
            "population": self.population,
            "cohort": self.cohort_size,
            "windows": len(self._records),
            "sampler": self.sampler.name,
            "unique_clients": len({int(c) for w in self._windows_seen
                                   for c in self._cohorts.get(w, [])}),
            "per_tier": {name: {"participants": k,
                                "share": k / max(total, 1)}
                         for name, k in sorted(tiers.items())},
        }
        if seconds:
            q = np.quantile(np.asarray(seconds), [0.5, 0.9, 0.99])
            out["straggler_seconds"] = {"p50": float(q[0]),
                                        "p90": float(q[1]),
                                        "p99": float(q[2]),
                                        "max": float(max(seconds))}
        if history:
            accs = [row["accuracy"] for row in history
                    if "accuracy" in row]
            if accs:
                out["final_accuracy"] = float(accs[-1])
        return out

    def memory_report(self) -> Dict[str, Any]:
        """Engine-held bytes against what a dense N-client fleet would
        cost.  ``engine_total`` does not depend on ``population``: the
        rows counted are the copies the engine holds (a cache row shared
        by a window's clients once)."""
        row_bytes = _held_bytes(self._default)
        shared = {k: v for k, v in self._state.items()
                  if k not in self._stacked}
        unique_rows = {id(r): r for r in self._cache.values()}
        engine = {
            "cohort_state": _held_bytes({k: self._state[k]
                                         for k in self._stacked}),
            "server_state": _held_bytes(shared),
            "default_row": row_bytes,
            "cache_rows": sum(_held_bytes(r) for r in unique_rows.values()),
            "cache_entries": len(self._cache),
            "pool": bytes_of(self.data.device_pool(self.trainer.device)),
        }
        engine_total = (engine["cohort_state"] + engine["server_state"]
                        + engine["default_row"] + engine["cache_rows"])
        dense = self.population * row_bytes + engine["server_state"]
        return {"population": self.population, "cohort": self.cohort_size,
                "engine": engine, "engine_total": engine_total,
                "dense_extrapolated": dense}

    # -- checkpoint ----------------------------------------------------------
    def save(self, path: str):
        """Persist the cohort stack and the sparse cache
        (``repro_torch.checkpoint``).  Cohorts and data plans are pure
        functions of the round counter (the sampler keyed on (seed,
        window), stateless data backends on (seed, client, round)), so
        nothing else is needed for a bitwise resume."""
        cache_ids = sorted(self._cache)
        tree = {"state": self._state, "default": self._default}
        if cache_ids:
            tree["cache"] = tree_stack([self._cache[i] for i in cache_ids])
        if self._entry_row is not None:
            # fault runs: the current window's entry row must survive a
            # restart mid-window for the empty-window recovery to replay
            # bitwise against the uninterrupted run
            tree["entry"] = self._entry_row
            tree["participation"] = {"part": self._part,
                                     "carry": self._carry}
        ckpt.save(path, tree, step=int(self._state["round"]),
                  extra={"population": self.population,
                         "cohort": self.cohort_size,
                         "refresh": self.refresh,
                         "sampler": self.sampler.name,
                         "has_entry": self._entry_row is not None,
                         "cache_ids": [int(i) for i in cache_ids]})

    def restore(self, path: str):
        """Rebuild the cohort stack, the default row and the sparse cache on
        the trainer's device; re-derive the window and its cohort from the
        restored round counter.  The template is the live state where the
        engine has one, else the method's state on ``meta`` tensors (no
        parameters drawn)."""
        man = ckpt.manifest(path)
        extra = man["extra"]
        if extra["population"] != self.population \
                or extra["cohort"] != self.cohort_size:
            raise ValueError(
                f"checkpoint is for population={extra['population']} "
                f"cohort={extra['cohort']}, engine has "
                f"{self.population}/{self.cohort_size}")
        state_like = self._state if self._state is not None else \
            self.trainer.method.meta_state(self.bundle, self.fsl)
        self._stacked = tuple(k for k in ("clients", "servers")
                              if k in state_like)
        row_like = {k: tree_map(lambda x: x[0], state_like[k])
                    for k in self._stacked}
        like = {"state": state_like, "default": row_like}
        cache_ids = [int(i) for i in extra["cache_ids"]]
        if cache_ids:
            like["cache"] = tree_map(
                lambda x: x.expand((len(cache_ids),) + tuple(x.shape)),
                row_like)
        has_entry = bool(extra.get("has_entry", False))
        if has_entry:
            like["entry"] = row_like
            like["participation"] = {"part": self._part,
                                     "carry": self._carry}
        tree = ckpt.restore(path, like, device=self.trainer.device)
        self._state = tree["state"]
        self._default = tree["default"]
        self._part = np.ones(self.cohort_size, bool)
        self._carry = np.ones(self.cohort_size, np.float32)
        if has_entry:
            self._entry_row = tree["entry"]
            self._part = tree["participation"]["part"]
            self._carry = tree["participation"]["carry"]
        elif not self.faults.is_null:
            # a checkpoint without an entry row resumed into a fault run:
            # right whenever the checkpoint sits on a window boundary
            self._entry_row = {k: _row(self._state[k])
                               for k in self._stacked}
        self._window_empty = False
        self._cache = {}
        for j, cid in enumerate(cache_ids):
            self._cache[cid] = tree_map(lambda x: x[j].clone(),
                                        tree["cache"])
        rnd = self.trainer.method.batches_trained(self.fsl, self._state) \
            // self.fsl.h
        self._window = self.window_of(rnd)
        self.cohort_for(self._window)
        return self

    # -- the loop ------------------------------------------------------------
    def run(self, num_rounds: int, chunk: int = 16, log_every: int = 0,
            callback: Optional[Callable] = None,
            meter: Optional[CommMeter] = None,
            cost_model: Optional[CostModel] = None):
        """Run ``num_rounds`` global rounds of cohort training.

        Each dispatch covers a *segment* of rounds through the Trainer's
        chunk path (``Trainer._chunk``: the pooled chunk program, on the
        card a replay a round of its captured graphs): only the ``[R, C,
        h, B]`` index plans of the sampled cohorts cross to the device.
        With ``refresh=True`` segments span window boundaries freely (the
        aggregation leaves every row equal to the new global model, the
        next cohort's exact initial state); with ``refresh=False`` or
        faults, segments end at window boundaries so the host can move
        rows between windows.  History rows, metering and the lr/cadence
        schedule match ``Trainer.run_compiled`` row for row: for C == N
        with a FederatedPool, bitwise.

        A segment's host plan reads nothing of the card, so the engine
        builds it while the segment before it still replays, then waits
        for that segment's metrics (one fetch), logs its rounds, moves the
        rows at a window boundary and launches the new segment: the host
        plan costs no card time.  A segment's ``chunk/execute`` span runs
        from its launch to its metrics' landing, around the next
        segment's ``chunk/build``.
        """
        if self._state is None:
            raise RuntimeError("call init() or restore() before run()")
        t = self.trainer
        state = self._state
        rnd0 = t.method.batches_trained(self.fsl, state) // self.fsl.h
        pool = self.data.device_pool(t.device)
        history: List[dict] = []
        profile = None
        fault_active = not self.faults.is_null
        carry = self._carry
        # the dense engines' fault bookkeeping (rows, meter, FaultStats),
        # with the window's participation carried in from the last call
        book = None
        if fault_active:
            book = _Participation(t, rnd0 + num_rounds)
            book.part = self._part
        tele = self.telemetry

        def land(seg_run):
            """Wait for a segment's metrics, then its rows, meter and
            records (the card's replays ran on meanwhile)."""
            r0, seg, w0, t0, metrics, agg_mask, captured = seg_run
            metrics = metrics()
            tele.host_span("chunk/execute", t0, time.perf_counter() - t0,
                           window=w0, rounds=seg, capture=captured)
            for i in range(seg):
                rnd = r0 + i
                aggregated = bool(agg_mask[i])
                extra = ms_bytes = wire = None
                if book is not None:
                    _, extra, ms_bytes, wire = book.advance(rnd, aggregated,
                                                            profile)
                    if aggregated and extra["participants"] == 0:
                        self._window_empty = True
                t._log_round(
                    rnd, rnd0, aggregated,
                    lambda: {k: float(v[i]) for k, v in metrics.items()},
                    profile, meter, log_every, callback, history, state,
                    extra=extra, model_sync_bytes=ms_bytes, wire_bytes=wire,
                    engine="population")

        done, in_flight = 0, None
        while done < num_rounds:
            r0 = rnd0 + done
            w0 = self.window_of(r0)
            seg = min(chunk, num_rounds - done)
            if not self.refresh or fault_active:
                # faults cut segments at window boundaries too, so an
                # empty window is repaired on the host before the next
                # cohort trains on its rows
                s = 1
                while s < seg and self.window_of(r0 + s) == w0:
                    s += 1
                seg = s
            # the segment's host plan (cohorts, index plans, lrs) reads
            # nothing of the card: it is built while the segment before it
            # still replays there
            with tele.timed("chunk/build", window=w0, rounds=seg):
                plans, cohorts = [], []
                for i in range(seg):
                    w = self.window_of(r0 + i)
                    ids = self.cohort_for(w)
                    plans.append(self.data.round_indices(ids, r0 + i))
                    if w not in self._windows_seen:
                        cohorts.append((w, ids, r0 + i))
                sample = t.pool_round_spec(pool, plans[0].shape)
                if self._payload_bytes is None:
                    pb = t._unit_payload_bytes(sample)
                    self._payload_bytes = (pb["up_bytes"], pb["down_bytes"])
                for w, ids, rnd in cohorts:
                    self._record_window(w, ids, rnd)
                if meter is not None and cost_model is not None \
                        and profile is None:
                    profile = t.comm_profile(
                        cost_model, tree_leaves(sample[1])[0].shape[2],
                        batch=sample)
                idx = np.stack(plans).astype(np.int64)
                lrs = np.array([t.lr_at(r0 + i) for i in range(seg)],
                               dtype=np.float32)
                plan = None if book is None else book.plan(sample)[
                    r0:r0 + seg].astype(np.float32)
            if in_flight is not None:
                land(in_flight)
            if w0 != self._window:
                if fault_active:
                    state = self._close_window(state)
                self._state = state
                self._advance_window(w0)
                state = self._state
            t0 = time.perf_counter()
            state, metrics, agg_mask, carry, captured = t._chunk(
                state, pool, idx, lrs, sample, chunk, plan, carry,
                defer=True)
            in_flight = (r0, seg, w0, t0, metrics, agg_mask, captured)
            done += seg
        if in_flight is not None:
            land(in_flight)
        self._state, self._carry = state, carry
        if book is not None:
            self._part = book.part
        # a segment can END exactly on a window boundary: enter the new
        # window now so the cache and the cohorts are current for save()
        w_next = self.window_of(rnd0 + num_rounds)
        if w_next != self._window:
            if fault_active:
                self._state = self._close_window(self._state)
            self._advance_window(w_next)
        if tele.enabled:
            tele.run_summary(
                "population", comm=meter,
                population=self.population_summary(history),
                participation=t.participation_summary())
        return self._state, history
