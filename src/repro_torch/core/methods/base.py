"""The `FSLMethod` interface (``repro.core.methods.base``): one API for
CSE-FSL and the three baselines.

A *method* is a stateless strategy object:

  - ``init_state(bundle, fsl, generator)`` -> state (clients, and server
    replicas where a method has them, stacked on dim 0)
  - ``make_round_step(bundle, fsl, transport=None)``
        -> ``round_step(state, batch, lr, seeds) -> (state, metrics)``
  - ``make_aggregate()``                  -> ``aggregate(state, seeds=None)``
  - ``make_masked_aggregate(refresh)``    -> ``aggregate(state, mask,
    seeds=None)``
  - ``make_wire_aggregate(bundle, fsl, transport=None, participation=False,
    refresh=True)`` -> the aggregate behind the model-sync wire
  - ``make_chunk_step(bundle, fsl, transport=None, participation=False,
    refresh=True, gather=False)`` -> ``chunk_step`` over a chunk of rounds
  - ``merged_params(state)``              -> deployable params
  - ``comm_profile(cm, fsl, batch_size)`` -> declarative :class:`CommProfile`

All methods share one batch contract: ``batch = (inputs, labels)`` tensors
with leading dims ``[n_clients, h, B, ...]``.  Tensors live on the bundle's
device, and so do the round step's per-round inputs: ``lr`` is a 0-d fp32
tensor and ``seeds`` the round's wire seeds (``Transport.stage_seeds``, as
device int64 tables), so nothing in a round reads a host value that
changes from round to round.  ``state["round"]`` is a Python int, the
upload-unit counter: the round step advances it as host bookkeeping (the
codecs read it only through the tests' ``bits_fn``), and the compiled
runner sets it on the host after each chunk.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CostModel
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.optim import SLICE_NUMEL

# ---------------------------------------------------------------------------
# Declarative communication / storage profile (paper Table II per method)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommProfile:
    """Bytes moved / held by one method at a given (cost model, fsl, B).

    Per-*round* fields are totals across all ``n`` clients for one global
    round; ``model_sync`` is the total for one aggregation event.  The
    ``*_wire`` fields are the codec-effective bytes (exact per
    ``Codec.wire_bytes``); -1 means "the raw analytic value".
    """
    uplink_smashed: int         # per round, at the model dtype (analytic)
    uplink_labels: int          # per round
    downlink_grads: int         # per round, at the model dtype (analytic)
    model_sync: int             # per aggregation event
    server_storage: int         # persistent server-side model bytes
    total_storage: int          # aggregation-time storage (server + clients)
    uplink_smashed_wire: int = -1
    downlink_grads_wire: int = -1
    model_sync_wire: int = -1

    @property
    def wire_uplink_smashed(self) -> int:
        w = self.uplink_smashed_wire
        return w if w >= 0 else self.uplink_smashed

    @property
    def wire_downlink_grads(self) -> int:
        w = self.downlink_grads_wire
        return w if w >= 0 else self.downlink_grads

    @property
    def wire_model_sync(self) -> int:
        w = self.model_sync_wire
        return w if w >= 0 else self.model_sync

    def unit_wire_bytes(self, n: int, k: int):
        """Per-upload-unit ``(smashed, labels, grads)`` wire bytes: the
        per-round totals split over the ``n * k`` identical upload units of
        a round (k uploads per client a round).  Fault billing charges each
        transmission attempt of a unit these bytes again."""
        per = n * k
        return (self.wire_uplink_smashed // per, self.uplink_labels // per,
                self.wire_downlink_grads // per)


# ---------------------------------------------------------------------------
# Event decomposition of one round, and the sync round step built from it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AsyncHooks:
    """A method's decomposition of one global round (see the JAX package):

    1. ``client_compute(cslice, cbatch, lr) -> (cslice', upload, pending,
       metrics)`` — one client's local work for one upload unit;
    2. ``server_consume(sstate, upload, lr) -> (sstate', reply, metrics)``
       — applied in arrival order (paper Eq. 11-13);
    3. ``client_receive`` — blocking methods only (gradient download).
    """
    client_compute: Callable
    server_consume: Callable
    client_receive: Optional[Callable] = None
    uploads_per_round: int = 1
    batches_per_upload: int = 1
    server_key: str = "server"
    server_shared: bool = True
    unit_has_h_axis: bool = False


def stacked_keys(hooks: AsyncHooks) -> tuple:
    """The state keys stacked on the client dim: the clients, and the
    server replicas where each client has its own."""
    return ("clients",) if hooks.server_shared \
        else ("clients", hooks.server_key)


def _one_client(tree):
    """ONE client's slice of a stacked ``meta`` tree."""
    return tree_map(lambda x: torch.empty(tuple(x.shape[1:]), dtype=x.dtype,
                                          device="meta"), tree)


def _mean_metrics(rows):
    """``{name: mean}`` over a list of metric dicts of scalars."""
    return {k: torch.stack([m[k] for m in rows]).mean() for k in rows[0]}


def assemble_round_step(hooks: AsyncHooks, fsl: FSLConfig, transport=None):
    """Build the synchronous ``round_step`` from a method's AsyncHooks.
    Per upload unit:

      1. ``vmap(client_compute)`` over the stacked client axis;
      2. the transport codes all clients' uploads (one launch per float
         leaf; labels pass through);
      3. the server consumes: one by one in client-index order when it is
         shared (the zero-latency arrival order, Eq. 11-13), or
         ``vmap(server_consume)`` over the stacked per-client replicas;
      4. blocking methods code the gradient replies on the downlink (the
         unit's seeds, salt 1) and run ``vmap(client_receive)`` over the
         clients and their pending inputs.

    Hooks whose unit has the ``h`` axis run one unit a round; per-mini-batch
    hooks run one unit per mini-batch (``state["round"]`` advances each
    unit), and their metrics are the mean over clients within a unit, then
    over the ``h`` units.  Unit ``k`` of the round codes with
    ``seeds["uplink"][k]`` and ``seeds["downlink"][k]``.  With the identity
    transport no codec op runs.
    """
    from repro_torch.transport import resolve_transport
    tp = resolve_transport(transport, fsl)
    k_units, bpu = hooks.uploads_per_round, hooks.batches_per_upload
    if k_units * bpu != fsl.h:
        raise ValueError(f"hooks decompose {k_units}x{bpu} batches per "
                         f"round, but fsl.h={fsl.h}")
    if hooks.unit_has_h_axis:
        if k_units != 1:
            raise ValueError("unit_has_h_axis hooks must use a single "
                             "upload unit per round")
    elif bpu != 1:
        raise ValueError("unsupported decomposition: per-mini-batch hooks "
                         "require batches_per_upload == 1")
    blocking = hooks.client_receive is not None
    skey, shared = hooks.server_key, hooks.server_shared
    stacked = stacked_keys(hooks)
    n = fsl.num_clients
    code_up = not tp.uplink.is_identity
    code_down = blocking and not tp.downlink.is_identity

    def unit_step(state, ubatch, lr, useeds):
        def client(cs, b):
            cs, upload, pending, m = hooks.client_compute(cs, b, lr)
            return (cs, upload, m, pending) if blocking else (cs, upload, m)

        cstack, uploads, cmetrics, *pendings = vmap(client)(
            {k: state[k] for k in stacked}, ubatch)
        if code_up:
            uploads = tp.code_uplink(uploads, state["round"],
                                     seeds=useeds.get("uplink"))
        if shared:
            sstate, replies, smetrics = state[skey], [], []
            for i in range(n):
                sstate, reply, m = hooks.server_consume(
                    sstate, tree_map(lambda u: u[i], uploads), lr)
                replies.append(reply)
                smetrics.append(m)
            smetrics = _mean_metrics(smetrics)
            if blocking:
                replies = torch.stack(replies)
        else:
            def server(s, up):
                s, reply, m = hooks.server_consume(s, up, lr)
                return (s, m, reply) if blocking else (s, m)

            sstates, smetrics, *replies = vmap(server)(cstack[skey], uploads)
            cstack = {**cstack, skey: sstates}
            smetrics = {k: v.mean() for k, v in smetrics.items()}
            replies = replies[0] if blocking else None
        if blocking:
            if code_down:
                replies = tp.code_downlink(replies, state["round"],
                                           seeds=useeds.get("downlink"))
            cstack = vmap(lambda cs, p, r: hooks.client_receive(cs, p, r, lr))(
                cstack, pendings[0], replies)
        new_state = {**state, **cstack, "round": state["round"] + 1}
        if shared:
            new_state[skey] = sstate
        metrics = {k: v.mean() for k, v in cmetrics.items()}
        metrics.update(smetrics)
        return new_state, metrics

    def round_step(state, batch, lr, seeds=None):
        batch = tuple(batch)
        seeds = seeds or {}

        def unit_seeds(k):
            return {ch: seeds[ch][k] for ch in ("uplink", "downlink")
                    if ch in seeds}

        if hooks.unit_has_h_axis:
            # one unit covering the whole [n, h, B, ...] round (CSE-style)
            return unit_step(state, batch, lr, unit_seeds(0))
        # per-mini-batch hooks: one unit per mini-batch of the h axis
        rows = []
        for k in range(fsl.h):
            state, m = unit_step(state, tree_map(lambda x: x[:, k], batch),
                                 lr, unit_seeds(k))
            rows.append(m)
        return state, _mean_metrics(rows)

    return round_step


_DONATED = contextvars.ContextVar("repro_torch_state_donated", default=False)


@contextlib.contextmanager
def donated_state():
    """Inside it a round step may update the state it was handed in place:
    the captured round's static state (``core/graphs.py``), which the round
    overwrites at its end anyway (the CSE-FSL clients' optimizer steps take
    it as their ``out``).  A round step outside it never writes into its
    input state."""
    token = _DONATED.set(True)
    try:
        yield
    finally:
        _DONATED.reset(token)


def state_donated() -> bool:
    """Whether the running round step was handed a donated state."""
    return _DONATED.get()


# ---------------------------------------------------------------------------
# A chunk of rounds as one program
# ---------------------------------------------------------------------------


def participation_windows(masks, part, flags):
    """The masked chunk's per-round cohorts, on the host: the JAX package's
    chunk carries the same AND in its scan.  ``masks`` is the chunk's
    ``[R, n]`` 0/1 plan, ``part`` the carry (the AND of the plan since the
    last aggregation, ``[n]``), ``flags`` the cadence.  A client is in
    round i's window if the plan admitted it in every round since the last
    aggregation; the carry resets to all ones after each aggregating round.
    Returns ``(windows, fires, part)``: the fp32 ``[R, n]`` windows, the
    rounds whose FedAvg runs (the cadence fires and the window is not
    empty) and the carry after the chunk (fp32 ``[n]``)."""
    acc = np.asarray(part, np.float32).copy()
    windows = np.zeros(np.shape(masks), np.float32)
    fires = []
    for i, aggregated in enumerate(flags):
        acc = acc * np.asarray(masks[i], np.float32)
        windows[i] = acc
        fires.append(bool(aggregated) and acc.sum() > 0)
        if aggregated:
            acc = np.ones_like(acc)
    return windows, fires, acc


def make_chunk_step(round_step, aggregate, fsl: FSLConfig,
                    unit_batches: int, gather: bool = False,
                    masked_aggregate=None):
    """A chunk of global rounds as one program: the port's counterpart of
    the JAX package's ``lax.scan`` over ``[R, n, h, B, ...]``.

    Each round is ``body(state, data, lrs, seeds, step, aggregated,
    windows=None)``: it reads round ``step`` (an int64 ``[1]`` tensor on the
    device) of the staged chunk -- the batch (``data`` is ``[R, n, h, B,
    ...]`` batches, or with ``gather`` a ``(pool, idx)`` pair: every pool
    leaf ``[S, ...]`` and an int64 ``[R, n, h, B]`` index plan, the batch
    gathered on the device), the lr (``lrs`` fp32 ``[R]``) and the wire
    seeds (``seeds``, channel -> ``[R, ...]`` tables of
    ``Transport.stage_seeds``) -- then runs the round step and, where
    ``aggregated``, the aggregate.  With ``masked_aggregate`` (a
    participation-aware ``aggregate(state, mask, seeds)``) that aggregate
    takes row ``step`` of ``windows``, the fp32 ``[R, n]`` cohorts of
    :func:`participation_windows`.  Only tensor indexing touches ``step``,
    so the body can be captured once and replayed for every round
    (``repro_torch.core.graphs``).

    The aggregation cadence is host arithmetic on the unit counter: a
    round covers ``fsl.h // unit_batches`` units, and aggregates where the
    per-client batch count ``state["round"] * unit_batches`` crosses a
    multiple of C (``AggregationCadence``), exactly as the JAX chunk's
    ``advance`` computes it in its carry.

    Returns ``chunk_step(state, batches, lrs, seeds)`` (with ``gather``:
    ``chunk_step(state, pool, idx, lrs, seeds)``) ``-> (state, metrics,
    agg_mask)``: it runs the chunk's rounds eagerly on the state's device,
    with the metrics stacked per round (``{name: [R]}``) and the bool
    ``[R]`` mask of the rounds whose cadence fired.  With
    ``masked_aggregate`` it takes the chunk's plan and the participation
    carry too, ``chunk_step(..., seeds, masks, part) -> (state, metrics,
    agg_mask, part)`` (``masks`` fp32 ``[R, n]``, ``part`` fp32 ``[n]``),
    and a round whose window is empty aggregates nothing, while
    ``agg_mask`` still reports the cadence.  ``chunk_step.body`` and
    ``chunk_step.cadence(unit0, r)`` (the flags of ``r`` rounds from
    counter ``unit0``) are what the captured runner uses.
    """
    agg_every = fsl.resolved_agg_every
    per_round = fsl.h // unit_batches

    def cadence(unit0: int, r: int) -> list:
        flags = []
        for i in range(r):
            prev = (unit0 + i * per_round) * unit_batches
            done = prev + per_round * unit_batches
            flags.append(done // agg_every > prev // agg_every)
        return flags

    def body(state, data, lrs, seeds, step, aggregated: bool, windows=None):
        if gather:
            pool, idx = data
            ix = idx.index_select(0, step)[0]
            batch = tree_map(lambda p: p[ix], pool)
        else:
            batch = tree_map(lambda b: b.index_select(0, step)[0], data)
        lr = lrs.index_select(0, step)[0]
        sd = {k: v.index_select(0, step)[0] for k, v in seeds.items()}
        state, metrics = round_step(state, tuple(batch), lr, sd)
        if aggregated and masked_aggregate is not None:
            state = masked_aggregate(
                state, windows.index_select(0, step)[0], sd)
        elif aggregated:
            state = aggregate(state, sd)
        return state, metrics

    def run(state, data, lrs, seeds, fires, windows=None):
        rows = []
        for i, fire in enumerate(fires):
            step = torch.full((1,), i, dtype=torch.int64, device=lrs.device)
            state, m = body(state, data, lrs, seeds, step, fire, windows)
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    def chunk_step(state, *args):
        data, (lrs, seeds) = (args[:2] if gather else args[0]), args[-2:]
        flags = cadence(state["round"], lrs.shape[0])
        state, metrics = run(state, data, lrs, seeds, flags)
        return state, metrics, torch.tensor(flags)

    def masked_chunk_step(state, *args):
        data = args[:2] if gather else args[0]
        lrs, seeds, masks, part = args[-4:]
        flags = cadence(state["round"], lrs.shape[0])
        windows, fires, part_out = participation_windows(
            masks.cpu().numpy(), part.cpu().numpy(), flags)
        state, metrics = run(state, data, lrs, seeds, fires,
                             torch.from_numpy(windows).to(lrs.device))
        return (state, metrics, torch.tensor(flags),
                torch.from_numpy(part_out).to(part.device))

    step_fn = chunk_step if masked_aggregate is None else masked_chunk_step
    step_fn.body, step_fn.cadence = body, cadence
    return step_fn


# ---------------------------------------------------------------------------
# The method interface
# ---------------------------------------------------------------------------


class FSLMethod:
    """Base class: subclasses set the four declarative traits and implement
    the state/step/aggregate factories."""

    name: str = ""
    # Declarative traits — these four booleans fully determine Table II.
    uploads_every_batch: bool = True    # False: once per h batches (CSE-FSL)
    downloads_gradients: bool = True    # True: cut-layer grads per batch
    server_replicated: bool = False     # True: one server copy per client
    has_aux: bool = False               # True: auxiliary head on clients

    def init_state(self, bundle: SplitModelBundle, fsl: FSLConfig,
                   gen: torch.Generator) -> Dict[str, Any]:
        raise NotImplementedError

    def make_async_hooks(self, bundle: SplitModelBundle,
                         fsl: FSLConfig) -> AsyncHooks:
        raise NotImplementedError(
            f"method {self.name!r} defines no hook decomposition")

    def make_round_step(self, bundle: SplitModelBundle, fsl: FSLConfig,
                        transport=None):
        """``round_step(state, batch, lr) -> (state, metrics)`` over the
        ``[n, h, B, ...]`` batch contract, assembled from the hooks."""
        return assemble_round_step(self.make_async_hooks(bundle, fsl), fsl,
                                   transport=transport)

    # The client params' (reference key, port key) pairs where the client
    # tree holds its stage beside the aux head; None: a bare client tree.
    client_keys: Optional[tuple] = None

    @property
    def server_key(self) -> str:
        """The state key of the server: stacked replicas or one model."""
        return "servers" if self.server_replicated else "server"

    @property
    def agg_keys(self) -> tuple:
        """The stacked state subtrees FedAvg averages: the clients and,
        where each client has its own, the server replicas.  The masked
        aggregate touches exactly these too."""
        return ("clients", self.server_key) if self.server_replicated \
            else ("clients",)

    def make_aggregate(self):
        """FedAvg over the stacked client dim (Eq. 14), opt state included,
        over :attr:`agg_keys`."""
        keys = self.agg_keys

        def aggregate(state, seeds=None):
            return {**state, **{k: fedavg(state[k]) for k in keys}}
        return aggregate

    def make_masked_aggregate(self, refresh: bool = True):
        """Participation-aware FedAvg: ``aggregate(state, mask, seeds=None)``
        averages the :attr:`agg_keys` subtrees over the clients the fp32
        ``[n]`` 0/1 ``mask`` admits, weights renormalized over them
        (:func:`fedavg_masked`); ``refresh`` decides whether the clients
        left out receive the average or keep their own state.  Callers
        guard the empty mask (the Trainer warns and skips it)."""
        keys = self.agg_keys

        def aggregate(state, mask, seeds=None):
            return {**state, **{k: fedavg_masked(state[k], mask,
                                                 refresh=refresh)
                                for k in keys}}
        return aggregate

    def make_wire_aggregate(self, bundle: SplitModelBundle, fsl: FSLConfig,
                            transport=None, participation: bool = False,
                            refresh: bool = True):
        """Aggregation behind the model-sync wire: before FedAvg each
        client's model (``state["clients"]["params"]``, what Table II's
        ``2 n alpha |w|`` counts; the opt state stays local) crosses the
        transport's ``model_up`` codec; after FedAvg the average is coded
        ONCE through ``model_down`` and broadcast to every client.  Server
        replicas never cross the client link, so they aggregate uncoded.
        Each leaf is coded in the JAX package's checkpoint layout
        (``bundle.wire_axes``), with the seeds ``seeds["model_up"]`` and
        ``seeds["model_down"]`` of ``aggregate(state, seeds)``.  With the
        identity model codecs this is :meth:`make_aggregate` unchanged.

        ``participation=True`` returns the masked variant ``aggregate(state,
        mask, seeds=None)`` (:meth:`make_masked_aggregate` behind the same
        wire): every client's model is coded up, as the JAX package codes
        it; the participants' coded params are averaged, renormalized
        (:func:`masked_mean0`), and the average is coded down once.  With
        ``refresh`` every client takes the coded average; without it the
        clients the mask leaves out keep their own params bit for bit."""
        from repro_torch.transport import resolve_transport
        tp = resolve_transport(transport, fsl)
        agg = self.make_masked_aggregate(refresh) if participation \
            else self.make_aggregate()
        if tp.model_identity:
            return agg
        axes = bundle.wire_axes(self.client_param_specs(bundle, fsl))

        def lead(a):
            return (0,) + tuple(1 + i for i in a)

        def to_wire(params):
            return [x if a is None else x.permute(lead(a))
                    for x, a in zip(tree_leaves(params), axes)]

        def from_wire(leaves, like):
            it = iter(zip(leaves, axes))

            def back(_):
                x, a = next(it)
                if a is None:
                    return x
                inv = tuple(sorted(range(len(a)), key=a.__getitem__))
                return x.permute(lead(inv)).contiguous()
            return tree_map(back, like)

        def with_params(state, params):
            return {**state, "clients": {**state["clients"],
                                         "params": params}}

        def coded_up(state, seeds):
            params = state["clients"]["params"]
            return from_wire(tp.code_model_up(
                to_wire(params), state["round"],
                seeds=seeds.get("model_up")), params)

        def coded_down(avg, state, seeds):
            return from_wire(tp.code_model_down(
                to_wire(avg), state["round"],
                seeds=seeds.get("model_down")), avg)

        if participation:
            def masked_aggregate(state, mask, seeds=None):
                seeds = seeds or {}
                orig = state["clients"]["params"]
                coded = coded_up(state, seeds)
                # the params' FedAvg is the explicit average below: run
                # the masked aggregate on the rest (opt state, replicas)
                rest = {k: v for k, v in state["clients"].items()
                        if k != "params"}
                st = agg({**state, "clients": rest}, mask)
                w = mask_weights(mask)
                avg = coded_down(tree_map(lambda x: masked_mean0(x, w),
                                          coded), state, seeds)
                sel = mask > 0

                def place(d, x):
                    b = d.expand(x.shape).to(x.dtype)
                    if refresh:
                        return b.contiguous()
                    s = sel.reshape((-1,) + (1,) * (x.dim() - 1))
                    return torch.where(s, b, x)
                return with_params(st, tree_map(place, avg, orig))
            return masked_aggregate

        def aggregate(state, seeds=None):
            seeds = seeds or {}
            state = agg(with_params(state, coded_up(state, seeds)))
            # post-FedAvg the stacked clients are identical: code the
            # average once and broadcast the same coded copy to all n
            params = state["clients"]["params"]
            avg = coded_down(tree_map(lambda x: x[:1], params), state,
                             seeds)
            params = tree_map(
                lambda d, x: d.expand(x.shape).to(x.dtype).contiguous(),
                avg, params)
            return with_params(state, params)
        return aggregate

    def make_chunk_step(self, bundle: SplitModelBundle, fsl: FSLConfig,
                        transport=None, participation: bool = False,
                        refresh: bool = True, gather: bool = False):
        """``chunk_step`` over a chunk of rounds of this method's round
        step and wire aggregate (:func:`make_chunk_step`);
        ``participation=True`` builds the masked variant over
        ``make_wire_aggregate(..., participation=True, refresh=refresh)``."""
        magg = self.make_wire_aggregate(
            bundle, fsl, transport=transport, participation=True,
            refresh=refresh) if participation else None
        return make_chunk_step(
            self.make_round_step(bundle, fsl, transport=transport),
            self.make_wire_aggregate(bundle, fsl, transport=transport),
            fsl, self.unit_batches(fsl), gather=gather,
            masked_aggregate=magg)

    def merged_params(self, state) -> Dict[str, Any]:
        raise NotImplementedError

    def unit_batches(self, fsl: FSLConfig) -> int:
        """Per-client mini-batches covered by ONE increment of
        ``state["round"]``: 1 for per-batch methods, h for CSE-FSL."""
        return 1 if self.uploads_every_batch else fsl.h

    def batches_trained(self, fsl: FSLConfig, state) -> int:
        """Local mini-batches each client has trained so far, recovered
        from ``state["round"]`` — a resumed run keeps the C-batch and lr
        schedules."""
        return int(state["round"]) * self.unit_batches(fsl)

    def hook_arg_specs(self, bundle: SplitModelBundle, fsl: FSLConfig,
                       batch):
        """Shape-only arguments for running the hooks on their own:
        ``(hooks, state, cslice, unit, lr)`` -- the hooks,
        :meth:`meta_state`, ONE client's slice of its stacked subtrees,
        ONE upload unit of ``batch`` (``[n,(h,)B, ...]`` with the leading
        dims dropped per ``unit_has_h_axis``) and the lr."""
        hooks = self.make_async_hooks(bundle, fsl)
        state = self.meta_state(bundle, fsl)
        cslice = {k: _one_client(state[k]) for k in stacked_keys(hooks)}
        drop = 1 if hooks.unit_has_h_axis else 2            # [n,(h,)B,...]
        unit = tree_map(lambda x: torch.empty(
            tuple(x.shape[drop:]), dtype=torch.as_tensor(x).dtype,
            device="meta"), tuple(batch))
        return hooks, state, cslice, unit, 0.0

    def payload_specs(self, bundle: SplitModelBundle, fsl: FSLConfig,
                      batch):
        """``(upload_spec, reply_spec)`` of ONE client's ONE upload unit,
        as ``meta`` tensors: the hooks run on shape-only tensors, so the
        specs are the exact shapes the codecs see.  ``reply_spec`` is None
        for non-blocking methods."""
        hooks, state, cslice, unit, lr = self.hook_arg_specs(bundle, fsl,
                                                             batch)
        _, upload, _, _ = hooks.client_compute(cslice, unit, lr)
        reply = None
        if hooks.client_receive is not None:
            sstate = state[hooks.server_key] if hooks.server_shared \
                else cslice[hooks.server_key]
            _, reply, _ = hooks.server_consume(sstate, upload, lr)
        return upload, reply

    def meta_state(self, bundle: SplitModelBundle, fsl: FSLConfig):
        """The method's own ``init_state`` on ``meta`` tensors (drawn from
        ``bundle.specs``, so any state layout works)."""
        specs = bundle.specs
        meta = dataclasses.replace(
            bundle, init=lambda gen: tree_map(lambda x: x, specs))
        return self.init_state(meta, fsl, None)

    def client_param_specs(self, bundle: SplitModelBundle, fsl: FSLConfig):
        """ONE client's ``state["clients"]["params"]`` as ``meta``
        tensors."""
        return _one_client(self.meta_state(bundle, fsl)["clients"]["params"])

    def model_sync_specs(self, bundle: SplitModelBundle, fsl: FSLConfig):
        """ONE client's model-sync payload as ``meta`` tensors, in the
        layout the wire codes it in (``bundle.wire_axes``): a list, one
        entry per leaf of the client's params."""
        tree = self.client_param_specs(bundle, fsl)
        return [x if a is None else x.permute(a)
                for x, a in zip(tree_leaves(tree), bundle.wire_axes(tree))]

    def comm_profile(self, cm: CostModel, fsl: FSLConfig, batch_size: int,
                     transport=None, payload_specs=None,
                     model_specs=None) -> CommProfile:
        n, q, lb = cm.n, cm.q, cm.label_bytes
        uploads = fsl.h if self.uploads_every_batch else 1
        smashed = n * uploads * q * batch_size
        labels = n * uploads * lb * batch_size
        grads = smashed if self.downloads_gradients else 0
        aux = cm.aux if self.has_aux else 0
        sync = 2 * n * (cm.w_client + aux)
        server = (n if self.server_replicated else 1) * (cm.w_server + aux)
        total = n * (cm.w_client + aux) + server
        wire_up = wire_down = wire_sync = -1
        if (transport is not None and payload_specs is not None
                and not transport.is_identity):
            up_spec, reply_spec = payload_specs
            wire_up = n * uploads * transport.uplink_wire_bytes(up_spec)
            if self.downloads_gradients and reply_spec is not None:
                wire_down = n * uploads * transport.downlink_wire_bytes(
                    reply_spec)
        if (transport is not None and model_specs is not None
                and not transport.model_identity):
            wire_sync = n * (transport.model_up_wire_bytes(model_specs)
                             + transport.model_down_wire_bytes(model_specs))
        return CommProfile(uplink_smashed=smashed, uplink_labels=labels,
                           downlink_grads=grads, model_sync=sync,
                           server_storage=server, total_storage=total,
                           uplink_smashed_wire=wire_up,
                           downlink_grads_wire=wire_down,
                           model_sync_wire=wire_sync)

    def __repr__(self):
        return f"<FSLMethod {self.name}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, FSLMethod] = {}


def register(cls):
    """Class decorator: ``@register`` on an FSLMethod subclass makes it
    resolvable by ``get_method(cls.name)``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate FSL method name {cls.name!r}")
    _REGISTRY[cls.name] = cls()
    return cls


def get_method(name: str) -> FSLMethod:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown FSL method {name!r}; registered: "
                       f"{available_methods()}") from None


def available_methods() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Shared helpers for implementations
# ---------------------------------------------------------------------------


def stack_clients(tree, n: int):
    """Replicate a param/opt tree onto a leading ``num_clients`` dim."""
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape)).clone(), tree)


def _mean0(x: torch.Tensor) -> torch.Tensor:
    """fp32 mean over dim 0 as the JAX package's ``jnp.mean`` comes out of
    XLA on the CPU: the clients' sum in order (client 0, then each next one
    added) times the fp32 reciprocal of n (``Tensor.mean`` rounds
    differently in the last bit, and a reduction kernel on the card may
    add the clients in another order, which depends on the tensor's shape
    and alignment).  Elementwise, so any slice of ``x`` gives the same
    bits as the whole."""
    acc = x[:1].float()
    for i in range(1, x.shape[0]):
        acc = acc + x[i:i + 1].float()
    return acc * (1.0 / x.shape[0])


def _avg_broadcast(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mean0` of ``x`` in its dtype, broadcast back to every client.
    A leaf of ``SLICE_NUMEL`` elements or more a client is averaged in
    slices of dim 1, each written into one output: the same bits (the
    mean is elementwise), but no temporary widens the whole leaf to fp32
    (qwen2-vl-72b's ``[4, 152064, 8192]`` embedding: 19.9 GB, beside a
    state of 25 GB and its update)."""
    if x.dim() < 2 or x[0].numel() < SLICE_NUMEL:
        return _mean0(x).expand(x.shape).to(x.dtype).contiguous()
    out = torch.empty_like(x)
    rows = max(1, x.shape[1] * (SLICE_NUMEL // 2) // x[0].numel())
    for i in range(0, x.shape[1], rows):
        out[:, i:i + rows] = _mean0(x[:, i:i + rows]).to(x.dtype)
    return out


def fedavg(tree):
    """Mean over the stacked client dim, broadcast back (Eq. 14)."""
    return tree_map(_avg_broadcast, tree)


def mask_weights(mask: torch.Tensor) -> torch.Tensor:
    """FedAvg's weights over a fp32 ``[n]`` 0/1 participation mask:
    ``mask / max(sum(mask), 1)``, summing to 1 over the participants."""
    return mask.float() / mask.float().sum().clamp(min=1.0)


def masked_mean0(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i x_i`` over dim 0 in fp32, ``[1, ...]``, rounded as the JAX
    package's ``jnp.tensordot(w, x, axes=1)`` comes out of XLA's CPU dot:
    client 0's product, then one fused multiply-add a client, in client
    order.  Each step runs in fp64, where the product of two fp32 values
    is exact, and the sum is rounded to odd there (round to nearest, then
    one fp64 ulp towards the exact sum, from Knuth's TwoSum, wherever that
    makes the last bit odd); rounding that to fp32 is the correctly
    rounded fused multiply-add.  (``torch.tensordot`` and a sum of
    products differ from XLA's dot in the last bit, at n = 8 and n = 4.)"""
    acc = x[:1].to(torch.float64, copy=True).mul_(w[0].double()).float()
    for i in range(1, x.shape[0]):
        a = acc.double()
        b = x[i:i + 1].to(torch.float64, copy=True).mul_(w[i].double())
        s = a + b
        bb = s - a
        err = torch.sub(a, s - bb).add_(b.sub_(bb))   # TwoSum: a + b - s
        del b, bb
        toward = torch.where(err > 0, math.inf, -math.inf).to(s)
        step = (err != 0) & ((s.view(torch.int64) & 1) == 0)
        del err
        acc = torch.where(step, torch.nextafter(s, toward), s).float()
    return acc


def fedavg_masked(tree, mask: torch.Tensor, refresh: bool = True):
    """Partial-participation FedAvg: the average over the clients the fp32
    ``[n]`` 0/1 ``mask`` admits, weights renormalized over them
    (:func:`masked_mean0`).  With ``refresh`` the average is broadcast to
    every client; without it the clients left out keep their own rows bit
    for bit.  Callers guard the all-zero mask (its "average" is zeros)."""
    w = mask_weights(mask)
    sel = mask > 0

    def avg(x):
        b = masked_mean0(x, w).expand(x.shape).to(x.dtype)
        if refresh:
            return b.contiguous()
        return torch.where(sel.reshape((-1,) + (1,) * (x.dim() - 1)), b, x)
    return tree_map(avg, tree)


def client_mean(tree):
    """Mean over the stacked client dim without re-broadcasting."""
    return tree_map(lambda x: _mean0(x)[0].to(x.dtype), tree)
