"""The `FSLMethod` interface (``repro.core.methods.base``): one API for
CSE-FSL and, in later slices of the port, the baselines.

A *method* is a stateless strategy object:

  - ``init_state(bundle, fsl, generator)`` -> state (clients stacked on
    dim 0 of every client tensor)
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
from repro_torch.optim import make_optimizer

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


def assemble_round_step(hooks: AsyncHooks, fsl: FSLConfig, transport=None):
    """Build the synchronous ``round_step`` from a method's AsyncHooks, for
    a shared server and an uplink-only wire (the CSE-FSL case):

      1. ``vmap(client_compute)`` over the stacked client axis;
      2. the transport codes all clients' uploads (one launch per float
         leaf; labels pass through);
      3. the server consumes the uploads one by one in client-index order
         (the zero-latency arrival order, Eq. 11-13).

    With the identity transport no codec op runs at all.
    """
    from repro_torch.transport import resolve_transport
    tp = resolve_transport(transport, fsl)
    if hooks.uploads_per_round * hooks.batches_per_upload != fsl.h:
        raise ValueError(f"hooks decompose {hooks.uploads_per_round}x"
                         f"{hooks.batches_per_upload} batches per round, "
                         f"but fsl.h={fsl.h}")
    if not (hooks.unit_has_h_axis and hooks.uploads_per_round == 1
            and hooks.server_shared and hooks.client_receive is None):
        raise NotImplementedError(
            "this port assembles only one-upload-per-round, shared-server, "
            "non-blocking hooks (CSE-FSL); the per-batch and blocking "
            "decompositions come with the baselines")
    skey = hooks.server_key
    n = fsl.num_clients

    def round_step(state, batch, lr):
        def client(cs, b):
            cs, upload, _, m = hooks.client_compute(cs, b, lr)
            return cs, upload, m

        cstack, uploads, cmetrics = vmap(client)(
            {"clients": state["clients"]}, tuple(batch))
        if not tp.is_identity:
            uploads = tp.code_uplink(uploads, state["round"])
        sstate, smetrics = state[skey], []
        for i in range(n):
            sstate, _, m = hooks.server_consume(
                sstate, tuple(u[i] for u in uploads), lr)
            smetrics.append(m)
        metrics = {k: v.mean() for k, v in cmetrics.items()}
        metrics.update({k: torch.stack([m[k] for m in smetrics]).mean()
                        for k in smetrics[0]})
        new_state = {**state, **cstack, skey: sstate,
                     "round": state["round"] + 1}
        return new_state, metrics

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

    def make_aggregate(self):
        raise NotImplementedError

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

    def payload_specs(self, bundle: SplitModelBundle, fsl: FSLConfig,
                      batch):
        """``(upload_spec, reply_spec)`` of ONE client's ONE upload unit,
        as ``meta`` tensors: the hooks run on shape-only tensors, so the
        specs are the exact shapes the codecs see.  The client slice is
        the stacked-client layout of this slice's methods: ``{client, aux}``
        params and their optimizer state.  ``reply_spec`` is None for
        non-blocking methods."""
        hooks = self.make_async_hooks(bundle, fsl)
        if hooks.client_receive is not None:
            raise NotImplementedError("reply specs come with the blocking "
                                      "baselines")
        params = {"client": bundle.specs["client"], "aux": bundle.specs["aux"]}
        opt_init, _ = make_optimizer(fsl.optimizer)
        cslice = {"clients": {"params": params, "opt": opt_init(params)}}
        drop = 1 if hooks.unit_has_h_axis else 2            # [n,(h,)B,...]
        unit = tuple(torch.empty(tuple(x.shape[drop:]),
                                 dtype=torch.as_tensor(x).dtype,
                                 device="meta") for x in batch)
        _, upload, _, _ = hooks.client_compute(cslice, unit, 0.0)
        return upload, None

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
        wire_up = -1
        if (transport is not None and payload_specs is not None
                and not transport.is_identity):
            up_spec, _ = payload_specs
            wire_up = n * uploads * transport.uplink_wire_bytes(up_spec)
        return CommProfile(uplink_smashed=smashed, uplink_labels=labels,
                           downlink_grads=grads, model_sync=sync,
                           server_storage=server, total_storage=total,
                           uplink_smashed_wire=wire_up)

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
