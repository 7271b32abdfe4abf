"""Method-agnostic host-level trainer (``repro.core.trainer``).

  bundle = cnn_bundle(CIFAR10)              # device="cuda" by default
  trainer = Trainer(bundle, fsl)            # method resolved from fsl.method
  state = trainer.init(seed=0)
  state, history = trainer.run(state, batcher, num_rounds=50,
                               log_every=10, meter=CommMeter(), cost_model=cm)

The Trainer runs on the bundle's device.  It owns the lr schedule, the
aggregation cadence (C), callbacks / history, and — given a
:class:`CostModel` — communication metering from the method's
:class:`CommProfile`.  ``run`` is the per-round loop: one round step per
round, eagerly, with the round's batch moved to the device first.

``batcher.next_round()`` must yield ``(inputs, labels)`` with leading dims
``[n_clients, h, B, ...]``; ``inputs`` is an array or a tree of them
(``{"tokens": ...}`` for transformers).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.common import tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import SplitModelBundle
from repro_torch.core.methods import CommProfile, FSLMethod, get_method
from repro_torch.transport import resolve_transport


class AggregationCadence:
    """The paper's every-C-batches aggregation schedule (Eq. 14 cadence).

    Aggregation fires whenever the cumulative per-client batch count
    crosses a multiple of C — threshold crossing, not ``count % C == 0``,
    so the schedule is right also when C is not a multiple of h (h=3, C=2).
    """

    def __init__(self, agg_every: int, batches_done: int = 0):
        self.agg_every = agg_every
        self.batches_done = batches_done

    def advance(self, num_batches: int) -> bool:
        """Account ``num_batches`` more per-client batches; True if an
        aggregation threshold was crossed."""
        prev = self.batches_done
        self.batches_done += num_batches
        return self.batches_done // self.agg_every > prev // self.agg_every


@dataclasses.dataclass
class Trainer:
    bundle: SplitModelBundle
    fsl: FSLConfig
    method: Optional[Union[str, FSLMethod]] = None  # default: fsl.method
    # wire codec: None resolves fsl.codec; a string names the uplink codec;
    # a repro_torch.transport.Transport passes through.
    transport: Optional[Any] = None

    def __post_init__(self):
        m = self.method if self.method is not None else self.fsl.method
        if isinstance(m, str):
            m = get_method(m)
        self.method = m
        self.device = self.bundle.device
        self.transport = resolve_transport(self.transport, self.fsl)
        self.step_fn = m.make_round_step(self.bundle, self.fsl,
                                         transport=self.transport)
        self.agg_fn = m.make_aggregate()

    # -- public per-round API -------------------------------------------------
    def init(self, seed: int = 0):
        """Initial state on the bundle's device, drawn from a CPU
        ``torch.Generator`` seeded with ``seed`` (so every device starts
        from the same weights)."""
        gen = torch.Generator().manual_seed(seed)
        return self.method.init_state(self.bundle, self.fsl, gen)

    def lr_at(self, rnd: int) -> float:
        steps = rnd // self.fsl.lr_decay_every
        return self.fsl.lr * self.fsl.lr_decay ** steps

    def to_device(self, batch):
        """A round batch (a tuple of trees of numpy arrays or tensors) as
        tensors on the device; labels keep their int32 wire dtype."""
        return tuple(tree_map(lambda x: torch.as_tensor(x).to(self.device),
                              batch))

    def step(self, state, batch, lr: Optional[float] = None, *,
             rnd: Optional[int] = None):
        """One global round.  Pass ``lr`` explicitly or ``rnd`` to use the
        schedule (both None means lr_at(0))."""
        if lr is None:
            lr = self.lr_at(rnd or 0)
        return self.step_fn(state, self.to_device(batch), lr)

    def aggregate(self, state):
        return self.agg_fn(state)

    def merged_params(self, state):
        """Deployable ``{"client", "server"}`` params (with ``"aux"`` for
        the methods that train one) for evaluation."""
        return self.method.merged_params(state)

    def comm_profile(self, cost_model: CostModel, batch_size: int,
                     batch=None) -> CommProfile:
        """With a ``batch``, the profile's uplink and downlink wire bytes
        are exact for this trainer's transport (payload and reply specs
        from the method's hooks run on ``meta`` tensors)."""
        specs = None
        if batch is not None and not self.transport.is_identity:
            specs = self.method.payload_specs(self.bundle, self.fsl, batch)
        return self.method.comm_profile(cost_model, self.fsl, batch_size,
                                        transport=self.transport,
                                        payload_specs=specs)

    def _log_round(self, rnd, rnd0, aggregated, metrics_fn, profile, meter,
                   log_every, callback, history, state):
        """Meter + history row for one finished (post-aggregation) round.
        ``metrics_fn`` lazily yields the float-cast metrics, so device
        scalars are fetched only on logged rounds."""
        if profile is not None:
            meter.log("uplink_smashed", profile.wire_uplink_smashed)
            meter.log("uplink_labels", profile.uplink_labels)
            meter.log("downlink_grads", profile.wire_downlink_grads)
            if aggregated:
                meter.log("model_sync", profile.wire_model_sync)
        if log_every and (rnd + 1 - rnd0) % log_every == 0:
            m = metrics_fn()
            row: dict = {"round": rnd + 1, **m, "aggregated": aggregated}
            if meter is not None:
                row["comm_bytes"] = meter.total
            history.append(row)
            if callback:
                callback(rnd + 1, m, state)

    # -- the loop -------------------------------------------------------------
    def run(self, state, batcher, num_rounds: int, log_every: int = 0,
            callback=None, meter: Optional[CommMeter] = None,
            cost_model: Optional[CostModel] = None):
        """Run ``num_rounds`` global rounds.

        - aggregation fires every C batches (``fsl.resolved_agg_every``) on
          threshold crossing, resumed from ``state["round"]``;
        - ``callback(rnd, metrics, state)`` fires on the ``log_every``
          cadence, after aggregation, with float-cast metrics;
        - with ``meter`` + ``cost_model``, per-round and per-aggregation
          bytes from the method's CommProfile are logged and a
          ``comm_bytes`` running total joins the history rows; each row
          also records whether that round ``aggregated``.
        """
        start_batches = self.method.batches_trained(self.fsl, state)
        cadence = AggregationCadence(self.fsl.resolved_agg_every,
                                     start_batches)
        rnd0 = start_batches // self.fsl.h
        history = []
        profile = None
        for rnd in range(rnd0, rnd0 + num_rounds):
            batch = self.to_device(batcher.next_round())
            if meter is not None and cost_model is not None and profile is None:
                profile = self.comm_profile(cost_model, batch[1].shape[2],
                                            batch=batch)
            state, metrics = self.step_fn(state, batch, self.lr_at(rnd))
            aggregated = cadence.advance(self.fsl.h)
            if aggregated:
                state = self.agg_fn(state)
            self._log_round(rnd, rnd0, aggregated,
                            lambda: {k: float(v) for k, v in metrics.items()},
                            profile, meter, log_every, callback, history,
                            state)
        return state, history
