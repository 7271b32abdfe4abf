"""Per-client link models (``repro.network.model``, numpy only): bandwidth
+ RTT -> transfer seconds per payload.

The transport (:mod:`repro_torch.transport`) decides how many bytes cross
the client-server wire; this module decides how long they take.  A
:class:`NetworkModel` describes the fleet's links and draws a
:class:`NetworkTrace` (pre-drawn per-event uplink/downlink rates and base
RTTs, ``[rounds, n, K]``), so runs are reproducible and two runs can
replay identical link conditions.  Draws use the caller's
``np.random.Generator``, so a trace seeded as the JAX package seeds its
own is the same trace, bit for bit.

Presets (``ideal``, ``uniform``, ``lognormal``, ``tiered``, ``trace``):

  - ``ideal``: infinite bandwidth, zero RTT -- the default; transfers take
    exactly 0.0 s.
  - ``uniform``: one constant link for the whole fleet.
  - ``lognormal``: static per-client speed spread x per-event jitter
    around the base rates.
  - ``tiered``: a 3g/4g/wifi-style fleet mix; clients are assigned tiers
    deterministically by quantile, so the mix is exact and seed-free.
  - ``trace``: a cyclic bandwidth time series (e.g. a diurnal pattern)
    applied fleet-wide.

Rates are user-facing in Mbps (1e6 bits/s) and stored in bytes/s;
``rtt`` is the per-transfer base latency in seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

MBPS = 125_000.0            # bytes per second in one Mbps (1e6 bits / 8)


@dataclasses.dataclass(frozen=True)
class ClientLink:
    """One client's access link.  Rates in BYTES per second; ``rtt`` the
    base seconds added to every transfer in that direction."""
    up_bps: float
    down_bps: float
    rtt: float = 0.0

    @classmethod
    def from_mbps(cls, up_mbps: float, down_mbps: float,
                  rtt: float = 0.0) -> "ClientLink":
        return cls(up_mbps * MBPS, down_mbps * MBPS, rtt)

    def up_seconds(self, nbytes: float) -> float:
        return nbytes / self.up_bps + self.rtt

    def down_seconds(self, nbytes: float) -> float:
        return nbytes / self.down_bps + self.rtt


IDEAL_LINK = ClientLink(np.inf, np.inf, 0.0)

# Representative access-link tiers (order-of-magnitude, not a measurement
# campaign): uplink-constrained cellular vs comfortable wifi/fiber.
TIERS: Dict[str, ClientLink] = {
    "3g": ClientLink.from_mbps(0.75, 2.0, rtt=0.15),
    "4g": ClientLink.from_mbps(8.0, 20.0, rtt=0.05),
    "5g": ClientLink.from_mbps(50.0, 200.0, rtt=0.02),
    "wifi": ClientLink.from_mbps(40.0, 100.0, rtt=0.01),
    "fiber": ClientLink.from_mbps(500.0, 500.0, rtt=0.005),
}


@dataclasses.dataclass(frozen=True)
class NetworkTrace:
    """Pre-drawn per-event link conditions, all shaped [rounds, n, K].

    ``up_bps[r, c, k]`` is client c's uplink rate (bytes/s) while shipping
    upload unit k of round r; ``down_bps`` the downlink rate for the
    matching reply; ``rtt`` the base seconds per transfer.  Like
    ``LatencyTrace``, drawing the whole trace up front in an
    arrival-independent order is what makes runs bitwise-reproducible —
    pass the same trace to two runs to replay identical link weather.
    """
    up_bps: np.ndarray
    down_bps: np.ndarray
    rtt: np.ndarray

    @property
    def shape(self):
        return self.up_bps.shape

    def up_seconds(self, nbytes: float, r: int) -> np.ndarray:
        """[n, K] uplink transfer seconds for an ``nbytes`` payload in
        round r.  0 bytes still pays the RTT (inf-bandwidth zero-RTT links
        return exactly 0.0 — the bitwise ideal contract)."""
        return nbytes / self.up_bps[r] + self.rtt[r]

    def down_seconds(self, nbytes: float, r: int) -> np.ndarray:
        return nbytes / self.down_bps[r] + self.rtt[r]


def _full(rounds: int, n: int, k: int, v: float) -> np.ndarray:
    return np.full((rounds, n, k), float(v))


def _from_links(links: List[ClientLink], rounds: int, k: int) -> NetworkTrace:
    up = np.array([l.up_bps for l in links])[None, :, None]
    down = np.array([l.down_bps for l in links])[None, :, None]
    rtt = np.array([l.rtt for l in links])[None, :, None]
    tile = lambda a: np.broadcast_to(a, (rounds, len(links), k)).copy()
    return NetworkTrace(tile(up), tile(down), tile(rtt))


class NetworkModel:
    """Interface: ``draw(rng, rounds, n, k) -> NetworkTrace`` plus the
    deterministic ``expected_links(n)`` the analytic sync wall-clock
    estimator uses (exact for constant models, mean rates otherwise)."""

    is_ideal: bool = False

    def draw(self, rng: np.random.Generator, rounds: int, n: int,
             k: int) -> NetworkTrace:
        raise NotImplementedError

    def expected_links(self, n: int) -> List[ClientLink]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdealNetwork(NetworkModel):
    """Infinite bandwidth, zero RTT: every transfer takes exactly 0.0 s.
    The default: with it the sync trainers plan on compute alone."""

    is_ideal = True

    def draw(self, rng, rounds, n, k):
        return NetworkTrace(_full(rounds, n, k, np.inf),
                            _full(rounds, n, k, np.inf),
                            _full(rounds, n, k, 0.0))

    def expected_links(self, n):
        return [IDEAL_LINK] * n


@dataclasses.dataclass(frozen=True)
class UniformNetwork(NetworkModel):
    """One constant link for the whole fleet (the asymmetric-access
    default: downlink 5x the uplink, like a consumer connection)."""

    up_mbps: float = 10.0
    down_mbps: float = 50.0
    rtt: float = 0.05

    @property
    def link(self) -> ClientLink:
        return ClientLink.from_mbps(self.up_mbps, self.down_mbps, self.rtt)

    def draw(self, rng, rounds, n, k):
        return _from_links([self.link] * n, rounds, k)

    def expected_links(self, n):
        return [self.link] * n


@dataclasses.dataclass(frozen=True)
class LognormalNetwork(NetworkModel):
    """Lognormal per-event rate jitter around static per-client speeds.

    ``spread`` is the sigma of the per-client speed factor (device/link
    heterogeneity, drawn once per trace); ``sigma`` the per-event jitter
    (congestion).  Both are bias-corrected so the expected rates stay the
    configured base rates; RTT is constant."""

    up_mbps: float = 10.0
    down_mbps: float = 50.0
    rtt: float = 0.05
    sigma: float = 0.5
    spread: float = 0.5

    def draw(self, rng, rounds, n, k):
        speed = np.exp(rng.normal(-0.5 * self.spread ** 2, self.spread,
                                  size=n))

        def ln(mean_mbps):
            j = rng.normal(-0.5 * self.sigma ** 2, self.sigma,
                           size=(rounds, n, k))
            return mean_mbps * MBPS * np.exp(j) * speed[None, :, None]

        return NetworkTrace(ln(self.up_mbps), ln(self.down_mbps),
                            _full(rounds, n, k, self.rtt))

    def expected_links(self, n):
        return [ClientLink.from_mbps(self.up_mbps, self.down_mbps,
                                     self.rtt)] * n


@dataclasses.dataclass(frozen=True)
class TieredNetwork(NetworkModel):
    """A fleet mix of named :data:`TIERS` (e.g. 25% 3g / 50% 4g / 25%
    wifi).  Clients are assigned tiers *deterministically* by quantile —
    client c gets the tier whose cumulative fraction covers (c + 0.5)/n —
    so the mix is exact, seed-free, and ``expected_links`` is the truth,
    not an approximation."""

    tiers: Tuple[Tuple[str, float], ...] = (("3g", 0.25), ("4g", 0.5),
                                            ("wifi", 0.25))

    def __post_init__(self):
        total = sum(f for _, f in self.tiers)
        if not np.isclose(total, 1.0):
            raise ValueError(f"tier fractions must sum to 1, got {total}")
        for name, _ in self.tiers:
            if name not in TIERS:
                raise KeyError(f"unknown tier {name!r}; known: "
                               f"{tuple(sorted(TIERS))}")

    def client_tier(self, c: int, n: int) -> str:
        q = (c + 0.5) / n
        cum = 0.0
        for name, frac in self.tiers:
            cum += frac
            if q <= cum:
                return name
        return self.tiers[-1][0]

    def expected_links(self, n):
        return [TIERS[self.client_tier(c, n)] for c in range(n)]

    def tier_ranges(self, n: int) -> List[Tuple[str, int, int]]:
        """Contiguous ``(name, lo, hi)`` client-id ranges per tier (hi
        exclusive), exactly consistent with :meth:`client_tier` — the
        quantile rule assigns tiers monotonically, so each tier is one
        interval.  O(tiers) instead of ``expected_links``'s O(n): this is
        what lets million-client populations resolve tiers without ever
        materializing a per-client list."""
        ranges: List[Tuple[str, int, int]] = []
        lo, cum = 0, 0.0
        for i, (name, frac) in enumerate(self.tiers):
            cum += frac
            if i == len(self.tiers) - 1:
                hi = n
            else:
                # smallest c with (c + 0.5)/n > cum, then nudge across any
                # float-boundary disagreement (client_tier is ground truth)
                hi = min(n, max(lo, int(np.floor(cum * n - 0.5)) + 1))
                while hi > lo and self.client_tier(hi - 1, n) != name:
                    hi -= 1
                while hi < n and self.client_tier(hi, n) == name:
                    hi += 1
            ranges.append((name, lo, hi))
            lo = hi
        return ranges

    def draw(self, rng, rounds, n, k):
        return _from_links(self.expected_links(n), rounds, k)


@dataclasses.dataclass(frozen=True)
class TraceNetwork(NetworkModel):
    """Trace-driven link weather: a cyclic fleet-wide bandwidth series
    (Mbps), indexed by round modulo its length.  ``diurnal`` builds the
    canonical day-curve preset scaled to a mean uplink rate."""

    up_mbps: Tuple[float, ...] = (12.0, 8.0, 4.0, 1.0, 4.0, 8.0)
    down_mbps: Tuple[float, ...] = (60.0, 40.0, 20.0, 5.0, 20.0, 40.0)
    rtt: float = 0.05

    def __post_init__(self):
        if len(self.up_mbps) != len(self.down_mbps):
            raise ValueError("up_mbps and down_mbps series must have equal "
                             f"length, got {len(self.up_mbps)} vs "
                             f"{len(self.down_mbps)}")
        if not self.up_mbps:
            raise ValueError("trace series must be non-empty")

    @classmethod
    def diurnal(cls, scale_mbps: float = 10.0, rtt: float = 0.05,
                down_ratio: float = 5.0) -> "TraceNetwork":
        """The default day curve with mean uplink ``scale_mbps``."""
        base = np.array(cls.__dataclass_fields__["up_mbps"].default)
        up = base * scale_mbps / base.mean()
        return cls(tuple(up), tuple(up * down_ratio), rtt)

    def draw(self, rng, rounds, n, k):
        idx = np.arange(rounds) % len(self.up_mbps)
        shape = lambda s: np.broadcast_to(
            np.asarray(s)[idx][:, None, None] * MBPS, (rounds, n, k)).copy()
        return NetworkTrace(shape(self.up_mbps), shape(self.down_mbps),
                            _full(rounds, n, k, self.rtt))

    def expected_links(self, n):
        return [ClientLink.from_mbps(float(np.mean(self.up_mbps)),
                                     float(np.mean(self.down_mbps)),
                                     self.rtt)] * n


NETWORK_MODELS = {"ideal": IdealNetwork, "uniform": UniformNetwork,
                  "lognormal": LognormalNetwork, "tiered": TieredNetwork,
                  "trace": TraceNetwork}


def make_network(name: str, **kw) -> NetworkModel:
    try:
        return NETWORK_MODELS[name](**kw)
    except KeyError:
        raise KeyError(f"unknown network model {name!r}; registered: "
                       f"{tuple(sorted(NETWORK_MODELS))}") from None


def network_from_flags(name: str, bandwidth_mbps: float = 10.0,
                       rtt: float = 0.05) -> NetworkModel:
    """CLI adapter for ``--network NAME --bandwidth-mbps X``: X is the mean
    uplink rate (downlink 5x, the asymmetric-access default); ``tiered``
    uses its own per-tier rates and ignores the bandwidth flag."""
    if name == "ideal":
        return IdealNetwork()
    if name == "uniform":
        return UniformNetwork(up_mbps=bandwidth_mbps,
                              down_mbps=5.0 * bandwidth_mbps, rtt=rtt)
    if name == "lognormal":
        return LognormalNetwork(up_mbps=bandwidth_mbps,
                                down_mbps=5.0 * bandwidth_mbps, rtt=rtt)
    if name == "tiered":
        return TieredNetwork()
    if name == "trace":
        return TraceNetwork.diurnal(scale_mbps=bandwidth_mbps, rtt=rtt)
    # registry fallback: custom NETWORK_MODELS entries with default args
    return make_network(name)
