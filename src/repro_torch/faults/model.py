"""Deterministic fault models (``repro.faults.model``, numpy only):
pre-drawn traces of loss, crashes and outages.

A :class:`FaultModel` turns a seed into a :class:`FaultTrace` --
per-``(round, client, unit)`` arrays drawn up front -- and the Trainer's
engines consume the trace instead of rolling dice mid-run, so the same
seed realizes the same retries, crashes, drops, bytes and final params in
``Trainer.run`` and ``Trainer.run_compiled``.  Each round is drawn from
its own ``np.random.default_rng((seed, FAULT_STREAM, round))``, as the
JAX package draws it, so the traces are the same bit for bit.

Trace semantics (indexed by the ABSOLUTE global round, so a resumed run
replays the faults of the uninterrupted one):

  - ``up_attempts[r, c, k]``: how many times client c transmitted upload
    unit k of round r.  1 = clean first try; each extra transmission is a
    detected loss followed by a backoff retransmission; 0 = the client
    crashed before sending this unit.
  - ``up_ok[r, c, k]``: the unit was delivered within the retry budget.
    ``False`` with ``up_attempts == 1 + max_retries`` is a wire drop: the
    bytes are billed, the payload never arrives, and the client drops out
    of the window's aggregation.
  - ``down_attempts`` / ``down_ok``: the same for the gradient reply of
    blocking methods (always drawn, so the trace does not depend on the
    method).
  - ``crash[r, c]``: 0 alive, 1 crash before upload (nothing sent), 2
    crash during upload (one partial transmission of unit 0 billed,
    nothing delivered).  Either way the client sits the round out and
    re-enters at the next aggregation through masked FedAvg.
  - ``outage[r]``: the server is down at the start of round r for
    ``outage_s`` simulated seconds.

``NoFaults.is_null`` sends the Trainer down its untouched unmasked path:
no trace drawn, no mask built, no frame bytes billed.

The event engine's first-attempt corruption seed (:func:`retry_key`)
comes from the port's own seed stream, disjoint from every codec seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np

from repro_torch.core.accounting import Recordable

# Host-RNG stream id for fault traces — distinct from the async engine's
# network-trace stream (0x6E6574 "net") so one seed feeds latency, link
# weather, and faults without coupling the draws.
FAULT_STREAM = 0x666C74          # "flt"

# The retransmission/corruption stream (:func:`retry_key`): its units sit
# at ``RETRY_FOLD + unit``, far above any unit counter a run reaches, and
# its salt past the four ``CHANNEL_SALTS`` of the codec seeds.
RETRY_FOLD = 0x52455452          # "RETR"
RETRY_SALT = 4


def retry_key(transport, unit: int, client: Optional[int] = None) -> int:
    """The seed of the simulated first-attempt corruption of upload
    ``unit`` of ``client`` (:func:`repro_torch.faults.frame.corrupt_frame`):
    ``transport.unit_seed`` at unit ``RETRY_FOLD + unit`` and salt
    ``RETRY_SALT`` (client 0 where None), a splitmix64 chain that shares
    no input with the codec seeds of any unit below ``RETRY_FOLD``.  The
    JAX package folds ``RETRY_FOLD + unit`` into a ``jax.random`` key
    instead; the two streams differ by design."""
    return transport.unit_seed(RETRY_FOLD + unit,
                               0 if client is None else client,
                               RETRY_SALT, 0)


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """Pre-drawn fault realizations, shaped per the module docstring."""

    up_attempts: np.ndarray      # [rounds, n, K] int16
    up_ok: np.ndarray            # [rounds, n, K] bool
    down_attempts: np.ndarray    # [rounds, n, K] int16
    down_ok: np.ndarray          # [rounds, n, K] bool
    crash: np.ndarray            # [rounds, n]    int8 (0 none / 1 pre / 2 mid)
    outage: np.ndarray           # [rounds]       bool

    @property
    def shape(self):
        return self.up_attempts.shape

    def survives(self, blocking: bool) -> np.ndarray:
        """``[rounds, n]`` bool: client c's round-r contribution arrived
        complete and intact — no crash, every upload unit delivered, and
        (blocking methods) every gradient reply received.  This is the
        mask the trainers AND into the scheduler plan; a client that
        fails any round of a C-batch window drops out of that window's
        FedAvg exactly like a scheduler-dropped client."""
        ok = (self.crash == 0) & self.up_ok.all(-1)
        if blocking:
            ok = ok & self.down_ok.all(-1)
        return ok


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Base fault model: independent per-transmission loss, per-(client,
    round) crashes, per-round server outages.  Presets below are just
    named defaults; compose any mixture by instantiating this directly.

    ``loss_rate`` is the probability that ONE transmission is lost or
    corrupted (detected by the checksum frame); a payload is
    retransmitted with exponential backoff (``backoff_base * 2**i``,
    capped at ``backoff_cap`` seconds) up to ``max_retries`` times before the
    sender gives up.  ``crash_rate`` is the per-client per-round crash
    probability (split evenly between crash-before-upload and
    crash-during-upload); ``outage_rate`` the per-round probability the
    server is down for ``outage_s`` seconds at round start."""

    loss_rate: float = 0.0
    crash_rate: float = 0.0
    outage_rate: float = 0.0
    outage_s: float = 30.0
    max_retries: int = 3
    backoff_base: float = 0.1    # seconds before the first retransmission
    backoff_cap: float = 2.0     # per-wait ceiling
    seed: int = 0

    name: str = "fault"
    # True: the trainers bypass ALL fault machinery (legacy bitwise) —
    # the exact analogue of IdealNetwork.is_ideal / wait_all.
    is_null: bool = False
    # Event engine: run the checksum frame for real on faulty events
    # (corrupt the coded payload, assert the frame detects it, deliver
    # the retransmitted clean copy).
    verify_frames: bool = True

    # -- drawing -------------------------------------------------------------
    def draw(self, rng: np.random.Generator, rounds: int, n: int,
             k: int) -> FaultTrace:
        """Draw the trace from an explicit generator (the
        :meth:`repro_torch.network.NetworkModel.draw` signature); prefer
        :meth:`trace`, which seeds the generator from ``(seed,
        FAULT_STREAM)`` — the derivation every engine uses."""
        cap = self.max_retries + 1

        def attempts_of(lost):
            # lost: [rounds, n, k, cap] per-transmission loss bernoullis.
            # attempts = 1 + leading losses, capped; ok = a success within
            # the budget.
            all_lost = lost.all(-1)
            first_ok = lost.argmin(-1)          # index of first success
            att = np.where(all_lost, cap, first_ok + 1).astype(np.int16)
            return att, ~all_lost

        lost_up = rng.random((rounds, n, k, cap)) < self.loss_rate
        lost_down = rng.random((rounds, n, k, cap)) < self.loss_rate
        up_att, up_ok = attempts_of(lost_up)
        down_att, down_ok = attempts_of(lost_down)
        crashed = rng.random((rounds, n)) < self.crash_rate
        mid = rng.random((rounds, n)) < 0.5     # during-upload share
        crash = np.where(crashed, np.where(mid, 2, 1), 0).astype(np.int8)
        outage = rng.random(rounds) < self.outage_rate
        # crashed clients transmit nothing (pre) or one partial unit (mid)
        pre, dur = crash == 1, crash == 2
        up_att[pre] = 0
        up_ok[pre] = False
        up_att[dur] = 0
        up_att[dur, 0] = 1
        up_ok[dur] = False
        down_att[pre | dur] = 0
        down_ok[pre | dur] = False
        return FaultTrace(up_att, up_ok, down_att, down_ok, crash, outage)

    def trace(self, rounds: int, n: int, k: int) -> FaultTrace:
        """The canonical trace for global rounds ``0..rounds-1`` — every
        engine calls this with the ABSOLUTE horizon (``rnd0 +
        num_rounds``) and indexes by the absolute round counter, so a
        resumed run replays the same faults.

        Each round is drawn from its own generator seeded ``(seed,
        FAULT_STREAM, round)`` — NOT one horizon-sized draw — so round
        ``r`` realizes identical faults no matter the horizon it was
        drawn under.  That prefix-consistency is what lets a run killed
        at round k (whose first leg drew ``trace(k)``) and its resumed
        continuation (``trace(k + rest)``) replay the uninterrupted run
        (``trace(rounds)``) bitwise."""
        if rounds <= 0:
            z3 = np.zeros((0, n, k), np.int16)
            b3 = np.zeros((0, n, k), bool)
            return FaultTrace(z3, b3, z3.copy(), b3.copy(),
                              np.zeros((0, n), np.int8), np.zeros(0, bool))
        per = [self.draw(np.random.default_rng((self.seed, FAULT_STREAM, r)),
                         1, n, k) for r in range(rounds)]
        cat = lambda f: np.concatenate([getattr(t, f) for t in per])
        return FaultTrace(cat("up_attempts"), cat("up_ok"),
                          cat("down_attempts"), cat("down_ok"),
                          cat("crash"), cat("outage"))

    # -- analytic expectations (failure-aware wall-clock estimates) ----------
    def expected_attempts(self) -> float:
        """Mean transmissions per delivered payload under the capped
        retry budget — the multiplier the analytic sync wall-clock
        estimate scales its transfer bytes by."""
        p = min(max(self.loss_rate, 0.0), 1.0 - 1e-12)
        cap = self.max_retries + 1
        # E[min(G, cap)] for G ~ Geometric(1-p) counting transmissions
        return float(sum(p ** i for i in range(cap)))

    def expected_backoff(self) -> float:
        """Mean backoff seconds spent per upload unit."""
        p = min(max(self.loss_rate, 0.0), 1.0 - 1e-12)
        return float(sum(p ** (i + 1) * min(self.backoff_base * 2 ** i,
                                            self.backoff_cap)
                         for i in range(self.max_retries)))

    def backoff_schedule(self, attempts: int) -> tuple:
        """The individual waits behind :meth:`backoff_seconds` —
        ``attempts - 1`` values, exponentially grown from
        ``backoff_base`` and capped per-wait at ``backoff_cap``.  The
        telemetry layer places one ``retry_backoff`` span per wait
        between the retransmission attempts, so the rendered timeline
        sums to the billed backoff exactly."""
        return tuple(min(self.backoff_base * 2 ** i, self.backoff_cap)
                     for i in range(max(int(attempts) - 1, 0)))

    def backoff_seconds(self, attempts: int) -> float:
        """Backoff seconds a sender waited across ``attempts``
        transmissions (the sum of :meth:`backoff_schedule`)."""
        return float(sum(self.backoff_schedule(attempts)))

    def __repr__(self):
        return f"<FaultModel {self.name}>"


@dataclasses.dataclass(frozen=True)
class NoFaults(FaultModel):
    """The lossless, immortal, always-up default.  ``is_null`` makes the
    trainers bypass every fault code path — zero extra ops, zero extra
    bytes, bitwise-identical to a faults-free build."""

    name: str = "none"
    is_null: bool = True


@dataclasses.dataclass(frozen=True)
class LossyWire(FaultModel):
    """Per-transmission loss/corruption with retransmission: every
    payload eventually lands intact (or exhausts the retry budget), so
    training numerics follow participation, while the retry bytes and
    backoff seconds show up in CommMeter and the wall-clock."""

    loss_rate: float = 0.1
    name: str = "lossy"


@dataclasses.dataclass(frozen=True)
class CrashyClients(FaultModel):
    """Mid-round client crashes (before/during upload, evenly split):
    the crashed client's round is lost and masked FedAvg renormalizes
    over the survivors — the fault analogue of deadline drops."""

    crash_rate: float = 0.1
    name: str = "crashy"


@dataclasses.dataclass(frozen=True)
class OutageServer(FaultModel):
    """Server outage windows: the server is down for ``outage_s`` at the
    start of afflicted rounds (clients' uploads wait out the recovery),
    and each outage counts a recovery event."""

    outage_rate: float = 0.15
    name: str = "outage"


# ---------------------------------------------------------------------------
# Registry (mirrors the network's NETWORK_MODELS + make_network)
# ---------------------------------------------------------------------------

FAULT_MODELS: Dict[str, type] = {}


def register_fault(cls):
    """Class decorator: makes ``cls.name`` resolvable by
    :func:`make_fault` (and the ``--faults`` flags).  Duplicate names are
    an error, never a silent overwrite — a shadowed preset would change
    the realized fault trace of every run that resolves the name."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if cls.name in FAULT_MODELS:
        raise ValueError(
            f"duplicate fault model name {cls.name!r}: already registered "
            f"by {FAULT_MODELS[cls.name].__name__} — pick a unique .name "
            "(silent overwrites would change fault traces under the same "
            "flag)")
    FAULT_MODELS[cls.name] = cls
    return cls


for _cls in (NoFaults, LossyWire, CrashyClients, OutageServer):
    register_fault(_cls)

NO_FAULTS = NoFaults()


def make_fault(name: str, **kw) -> FaultModel:
    try:
        return FAULT_MODELS[name](**kw)
    except KeyError:
        raise KeyError(f"unknown fault model {name!r}; registered: "
                       f"{tuple(sorted(FAULT_MODELS))}") from None


def resolve_fault(faults) -> FaultModel:
    """Normalize a trainer ``faults=`` argument: ``None`` means no
    faults (the legacy bitwise path), a string names a registered
    preset, an instance passes through."""
    if faults is None:
        return NO_FAULTS
    if isinstance(faults, FaultModel):
        return faults
    return make_fault(faults)


# ---------------------------------------------------------------------------
# Stats + exact retry billing (shared by ALL engines)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultStats(Recordable):
    """What the faults actually did, counted exactly from the realized
    trace: retransmissions, the extra bytes they burned, who crashed how,
    and what the server survived.  Appears in history rows and
    ``participation_summary()`` whenever a non-null fault model is
    active; every derived statistic is guarded against the all-clients-
    crashed degenerate window (zero participating windows divide
    nothing)."""

    retries: int = 0             # retransmissions (attempts beyond the first)
    retransmit_bytes: int = 0    # bytes burned by those retransmissions
    frame_bytes: int = 0         # checksum-trailer bytes across all attempts
    crash_before: int = 0        # crashes before any upload left the client
    crash_during: int = 0        # crashes mid-upload (partial unit billed)
    wire_drops: int = 0          # retry budget spent: (client, round) lost
    deadline_drops: int = 0      # scheduler-induced drops, for contrast
    outages: int = 0             # server-down rounds entered
    recovery_events: int = 0     # server recoveries (== outages survived)
    retry_seconds: float = 0.0   # backoff time spent waiting to retransmit
    windows: int = 0             # aggregation windows seen
    empty_windows: int = 0       # windows with zero surviving participants
    participants: list = dataclasses.field(default_factory=list)

    @property
    def crash_drops(self) -> int:
        return self.crash_before + self.crash_during

    def as_dict(self) -> Dict[str, object]:
        parts = self.participants
        live = [p for p in parts if p > 0]
        return {
            "retries": self.retries,
            "retransmit_bytes": self.retransmit_bytes,
            "frame_bytes": self.frame_bytes,
            "crash_drops": self.crash_drops,
            "crash_before": self.crash_before,
            "crash_during": self.crash_during,
            "wire_drops": self.wire_drops,
            "deadline_drops": self.deadline_drops,
            "outages": self.outages,
            "recovery_events": self.recovery_events,
            "retry_seconds": self.retry_seconds,
            "windows": self.windows,
            "empty_windows": self.empty_windows,
            # guarded: zero participating windows -> None, never 1/0
            "mean_participants": (float(np.mean(parts)) if parts else None),
            "min_live_participants": (min(live) if live else None),
        }


def round_wire_bytes(trace: FaultTrace, rnd: int, per_up: int,
                     per_label: int, per_down: int, blocking: bool,
                     frame_bytes: int,
                     mask: Optional[np.ndarray] = None) -> Dict[str, int]:
    """EXACT per-round wire bytes under the trace — ALL engines bill
    through this one helper, which is what keeps ``run`` ≡
    ``run_compiled`` history rows bitwise and the benchmark's byte
    assertions engine-independent.  ``per_*`` are per-unit payload
    bytes; every transmission attempt pays its payload AND its checksum
    frame, so retransmitted bytes are billed exactly — never averaged.
    ``mask`` (bool [n]) restricts billing to the clients that actually
    hit the wire (the event engine excludes plan-skipped clients)."""
    sel = slice(None) if mask is None else mask
    up_att = int(trace.up_attempts[rnd][sel].sum())
    out = {
        "uplink_smashed": per_up * up_att,
        "uplink_labels": per_label * up_att,
        "downlink_grads": 0,
        "fault_frames": frame_bytes * up_att,
    }
    if blocking:
        down_att = int(trace.down_attempts[rnd][sel].sum())
        out["downlink_grads"] = per_down * down_att
        out["fault_frames"] += frame_bytes * down_att
    return out


def accumulate_round(stats: FaultStats, model: FaultModel,
                     trace: FaultTrace, rnd: int, per_up: int,
                     per_label: int, per_down: int, blocking: bool,
                     frame_bytes: int,
                     mask: Optional[np.ndarray] = None) -> Dict[str, int]:
    """Bill one round: returns the :func:`round_wire_bytes` dict and
    folds the round's retries, retransmit bytes, crashes, wire drops,
    outages, and backoff seconds into ``stats``."""
    wire = round_wire_bytes(trace, rnd, per_up, per_label, per_down,
                            blocking, frame_bytes, mask=mask)
    sel = slice(None) if mask is None else mask
    up_att = trace.up_attempts[rnd][sel]
    crash = trace.crash[rnd][sel]
    up_ok = trace.up_ok[rnd][sel]
    retr_up = np.maximum(up_att - 1, 0)
    retries = int(retr_up.sum())
    retransmit = int(retr_up.sum()) * (per_up + per_label + frame_bytes)
    secs = float(sum(model.backoff_seconds(a) for a in up_att.reshape(-1)))
    drops = (~up_ok.all(-1)) & (crash == 0)
    if blocking:
        down_att = trace.down_attempts[rnd][sel]
        down_ok = trace.down_ok[rnd][sel]
        retr_down = np.maximum(down_att - 1, 0)
        retries += int(retr_down.sum())
        retransmit += int(retr_down.sum()) * (per_down + frame_bytes)
        secs += float(sum(model.backoff_seconds(a)
                          for a in down_att.reshape(-1)))
        drops = drops | ((~down_ok.all(-1)) & (crash == 0) & up_ok.all(-1))
    stats.retries += retries
    stats.retransmit_bytes += retransmit
    stats.frame_bytes += wire["fault_frames"]
    stats.retry_seconds += secs
    stats.crash_before += int((crash == 1).sum())
    stats.crash_during += int((crash == 2).sum())
    stats.wire_drops += int(drops.sum())
    if bool(trace.outage[rnd]):
        stats.outages += 1
        stats.recovery_events += 1
    return wire


def fault_from_flags(name: str, loss_rate: Optional[float] = None,
                     crash_rate: Optional[float] = None,
                     max_retries: Optional[int] = None,
                     seed: int = 0) -> FaultModel:
    """CLI adapter for ``--faults NAME --loss-rate P --crash-rate Q
    --max-retries R`` (mirrors ``network_from_flags`` /
    ``scheduler_from_flags``): None flags keep the preset's defaults."""
    kw: Dict[str, Union[float, int]] = {"seed": seed}
    if name == "none":
        return NO_FAULTS
    if loss_rate is not None:
        kw["loss_rate"] = loss_rate
    if crash_rate is not None:
        kw["crash_rate"] = crash_rate
    if max_retries is not None:
        kw["max_retries"] = max_retries
    return make_fault(name, **kw)
