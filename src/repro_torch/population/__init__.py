"""Million-client fleets through a C-client cohort (``repro.population``).

See :mod:`repro_torch.population.engine` for the lazy-state cohort engine
and :mod:`repro_torch.population.data` for the device-pool data backends
(README "The population engine and telemetry").
"""
from repro_torch.population.data import FederatedPool, VirtualPool
from repro_torch.population.engine import Population

__all__ = ["FederatedPool", "Population", "VirtualPool"]
