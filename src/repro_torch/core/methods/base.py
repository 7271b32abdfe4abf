"""The `FSLMethod` interface (``repro.core.methods.base``): one API for
CSE-FSL and the three baselines.

A *method* is a stateless strategy object:

  - ``init_state(bundle, fsl, generator)`` -> state (clients, and server
    replicas where a method has them, stacked on dim 0)
  - ``make_round_step(bundle, fsl, transport=None)``
        -> ``round_step(state, batch, lr) -> (state, metrics)``
  - ``make_aggregate()``                  -> ``aggregate(state)``
  - ``merged_params(state)``              -> deployable params
  - ``comm_profile(cm, fsl, batch_size)`` -> declarative :class:`CommProfile`

All methods share one batch contract: ``batch = (inputs, labels)`` tensors
with leading dims ``[n_clients, h, B, ...]``.  ``state["round"]`` is a
Python int (the upload-unit counter); tensors live on the bundle's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import vmap

from repro_torch.common import tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CostModel
from repro_torch.core.bundle import SplitModelBundle

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
    over the ``h`` units.  With the identity transport no codec op runs.
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

    def unit_step(state, ubatch, lr):
        def client(cs, b):
            cs, upload, pending, m = hooks.client_compute(cs, b, lr)
            return (cs, upload, m, pending) if blocking else (cs, upload, m)

        cstack, uploads, cmetrics, *pendings = vmap(client)(
            {k: state[k] for k in stacked}, ubatch)
        if code_up:
            uploads = tp.code_uplink(uploads, state["round"])
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
                replies = tp.code_downlink(replies, state["round"])
            cstack = vmap(lambda cs, p, r: hooks.client_receive(cs, p, r, lr))(
                cstack, pendings[0], replies)
        new_state = {**state, **cstack, "round": state["round"] + 1}
        if shared:
            new_state[skey] = sstate
        metrics = {k: v.mean() for k, v in cmetrics.items()}
        metrics.update(smetrics)
        return new_state, metrics

    def round_step(state, batch, lr):
        batch = tuple(batch)
        if hooks.unit_has_h_axis:
            # one unit covering the whole [n, h, B, ...] round (CSE-style)
            return unit_step(state, batch, lr)
        # per-mini-batch hooks: one unit per mini-batch of the h axis
        rows = []
        for k in range(fsl.h):
            state, m = unit_step(state, tree_map(lambda x: x[:, k], batch),
                                 lr)
            rows.append(m)
        return state, _mean_metrics(rows)

    return round_step


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

    def make_aggregate(self):
        """FedAvg over the stacked client dim (Eq. 14), opt state included:
        the clients and, where each client has its own, the server
        replicas."""
        keys = ("clients", self.server_key) if self.server_replicated \
            else ("clients",)

        def aggregate(state):
            return {**state, **{k: fedavg(state[k]) for k in keys}}
        return aggregate

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
        ``(hooks, state, cslice, unit, lr)`` -- the hooks, the method's own
        ``init_state`` on ``meta`` tensors (drawn from ``bundle.specs``, so
        any state layout works), ONE client's slice of its stacked
        subtrees, ONE upload unit of ``batch`` (``[n,(h,)B, ...]`` with the
        leading dims dropped per ``unit_has_h_axis``) and the lr."""
        hooks = self.make_async_hooks(bundle, fsl)
        specs = bundle.specs
        meta = dataclasses.replace(
            bundle, init=lambda gen: tree_map(lambda x: x, specs))
        state = self.init_state(meta, fsl, None)
        cslice = {k: tree_map(lambda x: torch.empty(
            tuple(x.shape[1:]), dtype=x.dtype, device="meta"), state[k])
            for k in stacked_keys(hooks)}
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

    def comm_profile(self, cm: CostModel, fsl: FSLConfig, batch_size: int,
                     transport=None, payload_specs=None) -> CommProfile:
        n, q, lb = cm.n, cm.q, cm.label_bytes
        uploads = fsl.h if self.uploads_every_batch else 1
        smashed = n * uploads * q * batch_size
        labels = n * uploads * lb * batch_size
        grads = smashed if self.downloads_gradients else 0
        aux = cm.aux if self.has_aux else 0
        sync = 2 * n * (cm.w_client + aux)
        server = (n if self.server_replicated else 1) * (cm.w_server + aux)
        total = n * (cm.w_client + aux) + server
        wire_up = wire_down = -1
        if (transport is not None and payload_specs is not None
                and not transport.is_identity):
            up_spec, reply_spec = payload_specs
            wire_up = n * uploads * transport.uplink_wire_bytes(up_spec)
            if self.downloads_gradients and reply_spec is not None:
                wire_down = n * uploads * transport.downlink_wire_bytes(
                    reply_spec)
        return CommProfile(uplink_smashed=smashed, uplink_labels=labels,
                           downlink_grads=grads, model_sync=sync,
                           server_storage=server, total_storage=total,
                           uplink_smashed_wire=wire_up,
                           downlink_grads_wire=wire_down)

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


def fedavg(tree):
    """Mean over the stacked client dim, broadcast back (Eq. 14)."""
    def avg(x):
        m = x.float().mean(dim=0, keepdim=True)
        return m.expand(x.shape).to(x.dtype).contiguous()
    return tree_map(avg, tree)


def client_mean(tree):
    """Mean over the stacked client dim without re-broadcasting."""
    return tree_map(lambda x: x.float().mean(dim=0).to(x.dtype), tree)
