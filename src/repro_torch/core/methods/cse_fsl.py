"""CSE-FSL: the paper's protocol (``repro.core.methods.cse_fsl``).

One *global round* t (paper Fig. 2, Algorithms 1 & 2):

  1. clients run ``h`` local mini-batch steps via the auxiliary-head local
     loss (Eq. 8-10) — no server gradients;
  2. each client recomputes and uploads the smashed data of its last batch
     with the *updated* client model (Alg. 1 line 9); the upload crosses
     the transport, where the configured codec compresses it;
  3. the server consumes the smashed batches sequentially in client-index
     order, updating its single model per batch (Eq. 11-13) — or, with
     ``server_update="batched"``, in one fused update;
  4. every C batches, FedAvg of (x_c, a_c) (Eq. 14) as a mean over the
     stacked client dim.

Clients are stacked on dim 0; the client phase is ``torch.func.vmap`` over
``torch.func.grad_and_value`` of the bundle's ``functional_call`` losses.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.func import grad_and_value, vmap

from repro_torch.common import tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.core.methods.base import (AsyncHooks, FSLMethod,
                                           assemble_round_step, client_mean,
                                           fedavg, register, stack_clients)
from repro_torch.optim import make_optimizer

# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_state(bundle: SplitModelBundle, fsl: FSLConfig,
               gen: torch.Generator) -> Dict[str, Any]:
    """clients: stacked replicas of (x_c, a_c) + opt state; server: single."""
    params = bundle.init(gen)
    opt_init, _ = make_optimizer(fsl.optimizer)
    n = fsl.num_clients
    client = {"client": params["client"], "aux": params["aux"]}
    return {
        "clients": {"params": stack_clients(client, n),
                    "opt": stack_clients(opt_init(client), n)},
        "server": {"params": params["server"],
                   "opt": opt_init(params["server"])},
        "round": 0,
    }


# ---------------------------------------------------------------------------
# Client phase
# ---------------------------------------------------------------------------


def make_client_round(bundle: SplitModelBundle, fsl: FSLConfig):
    """One client's local phase (Alg. 1): ``client_round(cstate, cbatch,
    lr) -> (cstate', smashed, last_labels, mean_loss)`` over ``[h, B, ...]``;
    ``vmap``-ed over the stacked clients by the round step."""
    _, opt_update = make_optimizer(fsl.optimizer)

    def client_round(cstate, cbatch, lr):
        inputs, labels = cbatch
        params, opt = cstate["params"], cstate["opt"]
        losses = []
        for k in range(labels.shape[0]):
            binputs = tree_map(lambda x: x[k], inputs)
            grads, (loss, _) = grad_and_value(
                lambda pr: bundle.client_loss(pr["client"], pr["aux"],
                                              binputs, labels[k]),
                has_aux=True)(params)
            params, opt = opt_update(grads, opt, params, lr)
            losses.append(loss)
        # Alg.1 line 9: smashed data of the last batch with *updated* weights
        smashed = bundle.client_smashed(params["client"],
                                        tree_map(lambda x: x[-1], inputs))
        return ({"params": params, "opt": opt}, smashed, labels[-1],
                torch.stack(losses).mean())

    return client_round


# ---------------------------------------------------------------------------
# Round step
# ---------------------------------------------------------------------------


def _make_batched_round_step(bundle: SplitModelBundle, fsl: FSLConfig,
                             transport=None):
    """Beyond-paper mode: one fused server update over the concatenated
    client batch (gradient = mean over clients; lr scaled by n so the step
    magnitude matches n sequential steps to first order).  The uplink codec
    still codes each client before the merge."""
    from repro_torch.transport import resolve_transport
    tp = resolve_transport(transport, fsl)
    _, opt_update = make_optimizer(fsl.optimizer)
    client_round = make_client_round(bundle, fsl)
    n = fsl.num_clients

    def round_step(state, batch, lr):
        cstates, smashed, slabels, closs = vmap(
            lambda cs, b: client_round(cs, b, lr))(state["clients"],
                                                   tuple(batch))
        if not tp.is_identity:
            smashed = tp.code_uplink(smashed, state["round"])
        smashed = smashed.detach()
        merged_sm = smashed.reshape((-1,) + tuple(smashed.shape[2:]))
        merged_lb = slabels.reshape((-1,) + tuple(slabels.shape[2:]))
        grads, loss = grad_and_value(bundle.server_loss)(
            state["server"]["params"], merged_sm, merged_lb)
        params, opt = opt_update(grads, state["server"]["opt"],
                                 state["server"]["params"], lr * n)
        new_state = {"clients": cstates,
                     "server": {"params": params, "opt": opt},
                     "round": state["round"] + 1}
        return new_state, {"client_loss": closs.mean(), "server_loss": loss}

    return round_step


def make_async_hooks(bundle: SplitModelBundle, fsl: FSLConfig) -> AsyncHooks:
    """One upload per client per round — h local steps, then the smashed
    batch crosses the uplink; the single server consumes arrivals in order
    (Eq. 11-13).  Non-blocking: clients never wait for gradients."""
    _, opt_update = make_optimizer(fsl.optimizer)
    client_round = make_client_round(bundle, fsl)

    def client_compute(cslice, cbatch, lr):
        cstate, smashed, labels, loss = client_round(cslice["clients"],
                                                     cbatch, lr)
        return ({"clients": cstate}, (smashed, labels), None,
                {"client_loss": loss})

    def server_consume(sstate, upload, lr):
        smashed, labels = upload
        grads, loss = grad_and_value(bundle.server_loss)(
            sstate["params"], smashed.detach(), labels)
        params, opt = opt_update(grads, sstate["opt"], sstate["params"], lr)
        return {"params": params, "opt": opt}, None, {"server_loss": loss}

    return AsyncHooks(client_compute, server_consume,
                      uploads_per_round=1, batches_per_upload=fsl.h,
                      server_key="server", server_shared=True,
                      unit_has_h_axis=True)


def make_round_step(bundle: SplitModelBundle, fsl: FSLConfig,
                    transport=None):
    """``round_step(state, batch, lr) -> (state, metrics)``; batch:
    ``(inputs, labels)`` with leading dims ``[n_clients, h, B, ...]``."""
    if fsl.server_update == "batched":
        return _make_batched_round_step(bundle, fsl, transport=transport)
    if fsl.server_update != "sequential":
        raise ValueError(f"unknown server_update {fsl.server_update!r}")
    return assemble_round_step(make_async_hooks(bundle, fsl), fsl,
                               transport=transport)


def make_aggregate():
    """FedAvg over the stacked client dim (Eq. 14), opt state included."""
    def aggregate(state):
        return {**state, "clients": fedavg(state["clients"])}
    return aggregate


def merged_params(state) -> Dict[str, Any]:
    """Final model = aggregated client stage + server stage (paper Step 4)."""
    cp = client_mean(state["clients"]["params"])
    return {"client": cp["client"], "aux": cp["aux"],
            "server": state["server"]["params"]}


@register
class CSEFSL(FSLMethod):
    """The paper's method: h-periodic upload, aux head, single server."""
    name = "cse_fsl"
    uploads_every_batch = False
    downloads_gradients = False
    server_replicated = False
    has_aux = True

    def init_state(self, bundle, fsl, gen):
        return init_state(bundle, fsl, gen)

    def make_round_step(self, bundle, fsl, transport=None):
        return make_round_step(bundle, fsl, transport=transport)

    def make_aggregate(self):
        return make_aggregate()

    def merged_params(self, state):
        return merged_params(state)

    def make_async_hooks(self, bundle, fsl):
        return make_async_hooks(bundle, fsl)
