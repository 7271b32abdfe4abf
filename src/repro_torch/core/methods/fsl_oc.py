"""FSL_OC [SplitFed] (``repro.core.methods.fsl_oc``): one shared server
model updated sequentially; clients still wait for cut-layer gradients;
gradient clipping for stability.

The sync round step is assembled from FSL_MC's blocking hooks with a
shared server: per mini-batch, all clients forward in parallel, the ONE
server consumes the uploads in (zero-latency) arrival order emitting each
cut gradient, and the clients back-propagate the replies in parallel.  The
server grads are clipped before the server step and the client grads after
the vjp, to the global norm ``fsl.grad_clip or 1.0``.  The round counter
advances per mini-batch (``unit_batches = 1``).
"""
from __future__ import annotations

from repro_torch.core.methods.base import FSLMethod, client_mean, register
from repro_torch.core.methods.fsl_mc import init_state, make_blocking_hooks


@register
class FSLOC(FSLMethod):
    name = "fsl_oc"
    uploads_every_batch = True
    downloads_gradients = True
    server_replicated = False
    has_aux = False

    def init_state(self, bundle, fsl, gen):
        return init_state(bundle, fsl, gen, replicated=False)

    def merged_params(self, state):
        return {"client": client_mean(state["clients"]["params"]),
                "server": state["server"]["params"]}

    def make_async_hooks(self, bundle, fsl):
        return make_blocking_hooks(bundle, fsl, shared=True,
                                   clip=fsl.grad_clip or 1.0)
