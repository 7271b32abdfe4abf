"""FSL_AN [Han et al.] (``repro.core.methods.fsl_an``): auxiliary network
(local client update, no gradient download) but per-client server replicas
and per-batch smashed upload.

The sync round step is assembled from the hooks below: per mini-batch the
client takes its local aux-loss step, uploads the smashed batch computed
with the *updated* client model, and the client's own server replica
consumes it -- non-blocking, no reply crosses the wire.  The round counter
advances per mini-batch (``unit_batches = 1``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.func import grad_and_value

from repro_torch.configs.base import FSLConfig
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.core.methods.base import (AsyncHooks, FSLMethod, client_mean,
                                           register, stack_clients)
from repro_torch.optim import make_optimizer


def init_state(bundle: SplitModelBundle, fsl: FSLConfig,
               gen: torch.Generator) -> Dict[str, Any]:
    """clients: stacked ``{params, aux}`` + opt state; servers: stacked
    replicas + opt state."""
    params = bundle.init(gen)
    opt_init, _ = make_optimizer(fsl.optimizer)
    n = fsl.num_clients
    client = {"params": params["client"], "aux": params["aux"]}
    return {"clients": {"params": stack_clients(client, n),
                        "opt": stack_clients(opt_init(client), n)},
            "servers": {"params": stack_clients(params["server"], n),
                        "opt": stack_clients(opt_init(params["server"]), n)},
            "round": 0}


def make_async_hooks(bundle: SplitModelBundle, fsl: FSLConfig) -> AsyncHooks:
    """h per-batch uploads a round, non-blocking (no gradient download),
    each consumed by the client's *own* server replica."""
    _, opt_update = make_optimizer(fsl.optimizer)

    def client_compute(cslice, cbatch, lr):
        inputs, labels = cbatch
        cstate = cslice["clients"]
        gc, (closs, _) = grad_and_value(
            lambda pr: bundle.client_loss(pr["params"], pr["aux"], inputs,
                                          labels),
            has_aux=True)(cstate["params"])
        cp, copt = opt_update(gc, cstate["opt"], cstate["params"], lr)
        smashed = bundle.client_smashed(cp["params"], inputs).detach()
        return ({**cslice, "clients": {"params": cp, "opt": copt}},
                (smashed, labels), None, {"client_loss": closs})

    def server_consume(sstate, upload, lr):
        smashed, labels = upload
        gs, sloss = grad_and_value(bundle.server_loss)(sstate["params"],
                                                      smashed, labels)
        sp, sopt = opt_update(gs, sstate["opt"], sstate["params"], lr)
        return {"params": sp, "opt": sopt}, None, {"server_loss": sloss}

    return AsyncHooks(client_compute, server_consume,
                      uploads_per_round=fsl.h, batches_per_upload=1,
                      server_key="servers", server_shared=False)


@register
class FSLAN(FSLMethod):
    name = "fsl_an"
    uploads_every_batch = True
    downloads_gradients = False
    server_replicated = True
    has_aux = True
    client_keys = (("params", "params"), ("aux", "aux"))

    def init_state(self, bundle, fsl, gen):
        return init_state(bundle, fsl, gen)

    def merged_params(self, state):
        cp = client_mean(state["clients"]["params"])
        return {"client": cp["params"], "aux": cp["aux"],
                "server": client_mean(state["servers"]["params"])}

    def make_async_hooks(self, bundle, fsl):
        return make_async_hooks(bundle, fsl)
