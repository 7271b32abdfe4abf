"""Cohort sampling (``repro.sched.cohort``): which C of N clients train in
an aggregation window?  Pure numpy: for the same seed, window, fleet and
network it draws the JAX package's ids exactly.

The population engine (:mod:`repro_torch.population`) simulates fleets of
N >= 10^6 clients but only ever runs a cohort of C of them per
aggregation window.  A :class:`CohortSampler` picks that cohort —
deterministically per ``(seed, window)``, so a resumed run re-draws the
identical cohorts from the window index alone (no sampler state to
checkpoint beyond the seed, which is the whole PRNG-position story of the
checkpoint round-trip contract in tests/test_torch_population.py).

Built-ins (``--sampler {uniform,stratified}``):

  - ``uniform``    — C clients uniformly without replacement.  When
    ``cohort >= population`` it returns ``arange(N)`` — the degenerate
    full-fleet draw the bitwise-equivalence tests ride on (population
    engine == dense Trainer when everyone participates).
  - ``stratified`` — proportional allocation over the
    :class:`~repro_torch.network.TieredNetwork` tier ranges (largest-remainder
    rounding, every nonempty tier keeps >= 1 seat while seats last), then
    uniform within each tier.  Keeps every link class represented in each
    window — the population-scale analogue of the ``stratified``
    scheduling policy.  Falls back to uniform when the network model has
    no tiers.

Cohorts are returned SORTED: the engine consumes per-client data streams
in client-id order, and the sorted order is what makes the full-fleet
draw literally equal to the dense trainer's client axis.

Add your own (the codec/policy recipe)::

    @register_cohort
    class EveryOther(CohortSampler):
        name = "every_other"
        def sample(self, window, population, cohort, network=None):
            import numpy as np
            return (np.arange(cohort, dtype=np.int64) * 2) % population
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type, Union

import numpy as np

# domain-separates cohort draws from every other (seed, ...) stream in the
# repo (scheduler plans use 0x5C4ED, latency traces their own salts)
_COHORT_SALT = 0xC0408


@dataclasses.dataclass(frozen=True)
class CohortSampler:
    """Base class: subclasses set ``name`` and implement ``sample``."""

    seed: int = 0
    name = ""

    def _rng(self, window: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, window, _COHORT_SALT))

    def sample(self, window: int, population: int, cohort: int,
               network=None) -> np.ndarray:
        """Sorted int64 client ids of the window's cohort.  Pure in
        ``(seed, window, population, cohort, network)`` — called twice it
        returns the identical draw."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformCohort(CohortSampler):
    name = "uniform"

    def sample(self, window, population, cohort, network=None):
        if cohort >= population:
            return np.arange(population, dtype=np.int64)
        ids = self._rng(window).choice(population, size=cohort,
                                       replace=False)
        return np.sort(ids.astype(np.int64))


@dataclasses.dataclass(frozen=True)
class StratifiedCohort(CohortSampler):
    name = "stratified"

    def _allocate(self, sizes: np.ndarray, cohort: int) -> np.ndarray:
        """Largest-remainder proportional seats; nonempty tiers get >= 1
        while seats last (small-tier representation is the point)."""
        n = int(sizes.sum())
        exact = cohort * sizes / n
        seats = np.floor(exact).astype(np.int64)
        seats[(sizes > 0) & (seats == 0)] = 1
        seats = np.minimum(seats, sizes)
        # settle to exactly `cohort` seats: give remaining seats by largest
        # fractional remainder, reclaim overshoot from the largest holders
        while seats.sum() < cohort:
            room = seats < sizes
            frac = np.where(room, exact - seats, -np.inf)
            seats[int(np.argmax(frac))] += 1
        while seats.sum() > cohort:
            takeable = seats > (sizes > 0).astype(np.int64)
            if not takeable.any():
                takeable = seats > 0
            frac = np.where(takeable, seats - exact, -np.inf)
            seats[int(np.argmax(frac))] -= 1
        return seats

    def sample(self, window, population, cohort, network=None):
        ranges = getattr(network, "tier_ranges", None)
        if ranges is None:
            return UniformCohort(self.seed).sample(window, population,
                                                   cohort, network)
        if cohort >= population:
            return np.arange(population, dtype=np.int64)
        spans = ranges(population)
        sizes = np.array([hi - lo for _, lo, hi in spans], np.int64)
        seats = self._allocate(sizes, cohort)
        rng = self._rng(window)
        picks = [lo + rng.choice(hi - lo, size=int(k), replace=False)
                 for (_, lo, hi), k in zip(spans, seats) if k > 0]
        return np.sort(np.concatenate(picks).astype(np.int64))


# ---------------------------------------------------------------------------
# Registry (mirrors the codec / policy / network registries)
# ---------------------------------------------------------------------------

COHORT_SAMPLERS: Dict[str, Type[CohortSampler]] = {}


def register_cohort(cls: Type[CohortSampler]) -> Type[CohortSampler]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty `name`")
    COHORT_SAMPLERS[cls.name] = cls
    return cls


for _cls in (UniformCohort, StratifiedCohort):
    register_cohort(_cls)


def get_cohort_sampler(name: str, seed: int = 0) -> CohortSampler:
    try:
        return COHORT_SAMPLERS[name](seed=seed)
    except KeyError:
        raise KeyError(f"unknown cohort sampler {name!r}; registered: "
                       f"{tuple(sorted(COHORT_SAMPLERS))}") from None


def resolve_cohort(sampler: Optional[Union[str, CohortSampler]],
                   seed: int = 0) -> CohortSampler:
    """None -> uniform; a string -> registry lookup; an instance passes
    through (its own seed wins)."""
    if sampler is None:
        return UniformCohort(seed=seed)
    if isinstance(sampler, str):
        return get_cohort_sampler(sampler, seed=seed)
    if isinstance(sampler, CohortSampler):
        return sampler
    raise TypeError(f"sampler must be None, a name, or a CohortSampler; "
                    f"got {type(sampler).__name__}")
