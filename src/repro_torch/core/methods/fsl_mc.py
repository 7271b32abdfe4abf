"""FSL_MC [SplitFed] (``repro.core.methods.fsl_mc``): per-client server
replicas; per-batch smashed upload *and* per-batch gradient download
(end-to-end backprop through the cut).

The sync round step is assembled from the hooks below: the client forwards
the smashed batch up, its own server replica steps and replies with the
cut-layer gradient, and the client back-propagates the reply through its
stage (``torch.func.vjp``) -- the joint end-to-end gradient split by the
chain rule.  The round counter advances per mini-batch
(``unit_batches = 1``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.func import grad_and_value, vjp

from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.core.methods.base import (AsyncHooks, FSLMethod, client_mean,
                                           register, stack_clients)
from repro_torch.optim import clip_by_global_norm, make_optimizer


def init_state(bundle: SplitModelBundle, fsl: FSLConfig, gen: torch.Generator,
               replicated: bool = True) -> Dict[str, Any]:
    """clients: stacked bare client trees + opt state; the server stacked
    per client (``servers``) or single (``server``, FSL_OC)."""
    params = bundle.init(gen)
    opt_init, _ = make_optimizer(fsl.optimizer)
    n = fsl.num_clients
    client, server = params["client"], params["server"]
    state = {"clients": {"params": stack_clients(client, n),
                         "opt": stack_clients(opt_init(client), n)},
             "round": 0}
    if replicated:
        state["servers"] = {"params": stack_clients(server, n),
                            "opt": stack_clients(opt_init(server), n)}
    else:
        state["server"] = {"params": server, "opt": opt_init(server)}
    return state


def make_blocking_hooks(bundle: SplitModelBundle, fsl: FSLConfig,
                        shared: bool, clip: float = 0.0) -> AsyncHooks:
    """h per-batch uploads a round, each BLOCKING on the cut gradient: the
    server computes d loss / d smashed and sends it down; the client
    back-propagates it through its stage.  ``shared``: one server (FSL_OC)
    instead of a replica per client.  ``clip`` > 0 clips the server grads
    before the server step and the client grads after the vjp to that
    global norm."""
    _, opt_update = make_optimizer(fsl.optimizer)

    def clipped(grads):
        return clip_by_global_norm(grads, clip)[0] if clip > 0 else grads

    def client_compute(cslice, cbatch, lr):
        inputs, labels = cbatch
        smashed = bundle.client_smashed(cslice["clients"]["params"], inputs)
        return cslice, (smashed.detach(), labels), inputs, {}

    def server_consume(sstate, upload, lr):
        smashed, labels = upload
        (gs, gsm), loss = grad_and_value(bundle.server_loss, argnums=(0, 1))(
            sstate["params"], smashed, labels)
        sp, sopt = opt_update(clipped(gs), sstate["opt"], sstate["params"],
                              lr)
        return {"params": sp, "opt": sopt}, gsm, {"loss": loss}

    def client_receive(cslice, pending, reply, lr):
        cstate = cslice["clients"]
        _, pull = vjp(lambda p: bundle.client_smashed(p, pending),
                      cstate["params"])
        (gc,) = pull(reply)
        cp, copt = opt_update(clipped(gc), cstate["opt"], cstate["params"],
                              lr)
        return {**cslice, "clients": {"params": cp, "opt": copt}}

    return AsyncHooks(client_compute, server_consume, client_receive,
                      uploads_per_round=fsl.h, batches_per_upload=1,
                      server_key="server" if shared else "servers",
                      server_shared=shared)


@register
class FSLMC(FSLMethod):
    name = "fsl_mc"
    uploads_every_batch = True
    downloads_gradients = True
    server_replicated = True
    has_aux = False

    def init_state(self, bundle, fsl, gen):
        return init_state(bundle, fsl, gen)

    def merged_params(self, state):
        return {"client": client_mean(state["clients"]["params"]),
                "server": client_mean(state["servers"]["params"])}

    def make_async_hooks(self, bundle, fsl):
        return make_blocking_hooks(bundle, fsl, shared=False)
