"""Analytic wall-clock of the synchronous engines
(``repro.network.wallclock``).

The :class:`~repro_torch.core.trainer.Trainer` runs clients in lockstep
with no event queue, so its wall-clock is estimated here from a
:class:`NetworkModel` and the per-payload wire bytes, with the barrier
formula the JAX package's event engine reports as its synchronous
counterfactual.

The barrier model per upload unit (each client ships one payload, the
server drains all n uploads back to back):

    max_c(compute_c) + max_c(up_bytes / up_bps_c + rtt_c)
      + n * server_time  [+ max_c(down_bytes / down_bps_c + rtt_c)]

and per aggregation event each client uploads its coded model and
downloads the coded average:

    max_c(ms_up / up_bps_c + ms_down / down_bps_c + 2 rtt_c)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.network.model import NetworkModel


@dataclasses.dataclass(frozen=True)
class WallClockEstimate:
    """Decomposed synchronous wall-clock estimate for one training run."""
    total: float                # seconds end to end
    per_round: float            # seconds per global round (excl. agg)
    compute_time: float         # total client compute
    comm_time: float            # total transfer time (up + down payloads)
    server_time: float          # total server service time
    model_sync_time: float      # total aggregation (model up/download)
    rounds: int
    agg_events: int

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def estimate_sync_wallclock(network: NetworkModel, n: int, num_rounds: int,
                            uploads_per_round: int, up_bytes: int,
                            down_bytes: int = 0, blocking: bool = False,
                            compute: float = 1.0, server_time: float = 0.05,
                            agg_events: int = 0, model_up_bytes: int = 0,
                            model_down_bytes: int = 0) -> WallClockEstimate:
    """Barrier wall-clock for ``num_rounds`` synchronous global rounds.

    ``up_bytes`` / ``down_bytes`` are ONE client's wire bytes per upload
    unit (codec-effective, labels included); ``model_up_bytes`` /
    ``model_down_bytes`` one client's coded model-sync payloads per
    aggregation; ``compute`` the per-unit client compute seconds (the
    compute-only LatencyModel mean).  Uses the network's deterministic
    ``expected_links`` — exact for constant/tiered/trace fleets, mean
    rates for stochastic ones.
    """
    links = network.expected_links(n)
    K = uploads_per_round
    up_xfer = max(l.up_seconds(up_bytes) for l in links)
    down_xfer = max(l.down_seconds(down_bytes) for l in links) \
        if blocking else 0.0
    per_unit = compute + up_xfer + n * server_time + down_xfer
    per_round = K * per_unit
    per_agg = max(model_up_bytes / l.up_bps + model_down_bytes / l.down_bps
                  + 2 * l.rtt for l in links) if agg_events else 0.0
    return WallClockEstimate(
        total=num_rounds * per_round + agg_events * per_agg,
        per_round=per_round,
        compute_time=num_rounds * K * compute,
        comm_time=num_rounds * K * (up_xfer + down_xfer),
        server_time=num_rounds * K * n * server_time,
        model_sync_time=agg_events * per_agg,
        rounds=num_rounds, agg_events=agg_events)
