"""Codec-aware network simulation between transport and time
(``repro.network``): :mod:`repro_torch.network.model` holds the
per-client link models, :mod:`repro_torch.network.wallclock` the
synchronous analytic estimator."""
from repro_torch.network.model import (MBPS, TIERS, ClientLink,
                                       IdealNetwork, LognormalNetwork,
                                       NetworkModel, NetworkTrace,
                                       NETWORK_MODELS, TieredNetwork,
                                       TraceNetwork, UniformNetwork,
                                       make_network, network_from_flags)
from repro_torch.network.wallclock import (WallClockEstimate,
                                           estimate_sync_wallclock)

__all__ = [
    "MBPS", "TIERS", "ClientLink", "IdealNetwork", "LognormalNetwork",
    "NetworkModel", "NetworkTrace", "NETWORK_MODELS", "TieredNetwork",
    "TraceNetwork", "UniformNetwork", "make_network", "network_from_flags",
    "WallClockEstimate", "estimate_sync_wallclock",
]
