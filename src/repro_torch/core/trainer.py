"""Method-agnostic host-level trainer (``repro.core.trainer``).

  bundle = cnn_bundle(CIFAR10)              # device="cuda" by default
  trainer = Trainer(bundle, fsl)            # method resolved from fsl.method
  state = trainer.init(seed=0)
  state, history = trainer.run(state, batcher, num_rounds=50,
                               log_every=10, meter=CommMeter(), cost_model=cm)

The Trainer runs on the bundle's device.  It owns the lr schedule, the
aggregation cadence (C), the wire seeds, callbacks / history, and — given
a :class:`CostModel` — communication metering from the method's
:class:`CommProfile`.  Two engines run the same round step:

- ``run`` is the per-round loop: one round step per round, eagerly, with
  the round's batch, lr and wire seeds staged on the device first;
- ``run_compiled(..., chunk=R)`` stages R rounds at once and runs them as
  one chunk program (``FSLMethod.make_chunk_step``): on the card each
  round is a replay of a captured CUDA graph (``repro_torch.core.graphs``)
  with no host work between replays; on the CPU the same program runs
  eagerly.  It is bitwise equal to ``run`` (state and history) on the CPU
  — use it whenever the host loop, not the math, bounds the round.

Aggregation goes through the model-sync wire (``make_wire_aggregate``;
with the identity model codecs it is the plain FedAvg).

``batcher.next_round()`` must yield ``(inputs, labels)`` with leading dims
``[n_clients, h, B, ...]``; ``inputs`` is an array or a tree of them
(``{"tokens": ...}`` for transformers).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core import graphs
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


def _stack_rounds(*xs):
    return np.stack(xs)


@dataclasses.dataclass
class Trainer:
    bundle: SplitModelBundle
    fsl: FSLConfig
    method: Optional[Union[str, FSLMethod]] = None  # default: fsl.method
    # wire codecs: None resolves fsl.codec and fsl.model_codec; a string
    # names the uplink codec; a repro_torch.transport.Transport passes
    # through.
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
        self.agg_fn = m.make_wire_aggregate(self.bundle, self.fsl,
                                            transport=self.transport)
        self.chunk_fn = m.make_chunk_step(self.bundle, self.fsl,
                                          transport=self.transport)
        self.pool_chunk_fn = m.make_chunk_step(
            self.bundle, self.fsl, transport=self.transport, gather=True)
        self.units_per_round = self.fsl.h // m.unit_batches(self.fsl)
        self._wire_leaves = self._model_leaves = None   # see _seed_leaves
        self._captured = None       # graphs.CapturedChunk on the card
        self._mempool = self._stream = None   # its memory pool and stream

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

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _seed_leaves(self, batch) -> dict:
        """Channel -> number of payload leaves, for every channel whose
        codec draws random bits (the seeds :meth:`_round_seeds` stages).
        ``batch`` (any round batch or its spec) sizes the uplink's and
        downlink's payloads once; None asks for the model-sync channels
        only."""
        tp, method = self.transport, self.method
        if self._model_leaves is None:
            nm = 0 if tp.model_identity else len(
                method.model_sync_specs(self.bundle, self.fsl))
            self._model_leaves = {ch: nm for ch in ("model_up", "model_down")
                                  if tp.seeded(ch)}
        if batch is None:
            return self._model_leaves
        if self._wire_leaves is None:
            self._wire_leaves = {}
            if tp.seeded("uplink") or (method.downloads_gradients
                                       and tp.seeded("downlink")):
                up, reply = method.payload_specs(self.bundle, self.fsl,
                                                 batch)
                if tp.seeded("uplink"):
                    self._wire_leaves["uplink"] = len(tree_leaves(up))
                if reply is not None and tp.seeded("downlink"):
                    self._wire_leaves["downlink"] = len(tree_leaves(reply))
        return {**self._wire_leaves, **self._model_leaves}

    def _round_seeds(self, unit0: int, batch) -> dict:
        """Host (numpy) seeds of the round starting at unit ``unit0`` and
        of its aggregation (``batch`` None: the aggregation's only, at
        ``unit0``)."""
        units = 0 if batch is None else self.units_per_round
        return self.transport.stage_seeds(unit0, units, self.fsl.num_clients,
                                          self._seed_leaves(batch))

    def _lr(self, lr: float) -> torch.Tensor:
        """The lr as the 0-d fp32 device tensor the round step takes."""
        return self._put(np.float32(lr))

    def step(self, state, batch, lr: Optional[float] = None, *,
             rnd: Optional[int] = None):
        """One global round.  Pass ``lr`` explicitly or ``rnd`` to use the
        schedule (both None means lr_at(0))."""
        if lr is None:
            lr = self.lr_at(rnd or 0)
        batch = self.to_device(batch)
        seeds = {k: self._put(v) for k, v in
                 self._round_seeds(state["round"], batch).items()}
        return self.step_fn(state, batch, self._lr(lr), seeds)

    def aggregate(self, state):
        """FedAvg behind the model-sync wire, at the state's counter."""
        seeds = {k: self._put(v) for k, v in
                 self._round_seeds(state["round"], None).items()}
        return self.agg_fn(state, seeds)

    def merged_params(self, state):
        """Deployable ``{"client", "server"}`` params (with ``"aux"`` for
        the methods that train one) for evaluation."""
        return self.method.merged_params(state)

    def comm_profile(self, cost_model: CostModel, batch_size: int,
                     batch=None) -> CommProfile:
        """With a ``batch``, the profile's uplink and downlink wire bytes
        are exact for this trainer's transport (payload and reply specs
        from the method's hooks run on ``meta`` tensors); the model-sync
        wire bytes need no batch."""
        specs = mspecs = None
        if batch is not None and not self.transport.is_identity:
            specs = self.method.payload_specs(self.bundle, self.fsl, batch)
        if not self.transport.model_identity:
            mspecs = self.method.model_sync_specs(self.bundle, self.fsl)
        return self.method.comm_profile(cost_model, self.fsl, batch_size,
                                        transport=self.transport,
                                        payload_specs=specs,
                                        model_specs=mspecs)

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
        """Run ``num_rounds`` global rounds, one round step each.

        - aggregation fires every C batches (``fsl.resolved_agg_every``) on
          threshold crossing, resumed from ``state["round"]``;
        - ``callback(rnd, metrics, state)`` fires on the ``log_every``
          cadence, after aggregation, with float-cast metrics;
        - with ``meter`` + ``cost_model``, per-round and per-aggregation
          bytes from the method's CommProfile are logged and a
          ``comm_bytes`` running total joins the history rows; each row
          also records whether that round ``aggregated``.

        For many rounds of a small model, :meth:`run_compiled` runs the
        same rounds without the per-round host dispatch.
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
            seeds = {k: self._put(v) for k, v in
                     self._round_seeds(state["round"], batch).items()}
            state, metrics = self.step_fn(state, batch,
                                          self._lr(self.lr_at(rnd)), seeds)
            aggregated = cadence.advance(self.fsl.h)
            if aggregated:
                state = self.agg_fn(state, seeds)
            self._log_round(rnd, rnd0, aggregated,
                            lambda: {k: float(v) for k, v in metrics.items()},
                            profile, meter, log_every, callback, history,
                            state)
        return state, history

    # -- the compiled loop ----------------------------------------------------
    @staticmethod
    def pool_round_spec(pool, idx_shape):
        """The ``(inputs, labels)`` round batch a device pool and an ``[n,
        h, B]`` index plan imply, as ``meta`` tensors: shape-compatible
        with a staged batch wherever only specs matter (CommProfile's
        payload specs, the seed tables' leaf counts)."""
        lead = tuple(idx_shape)
        return tree_map(lambda p: torch.empty(lead + tuple(p.shape[1:]),
                                              dtype=p.dtype, device="meta"),
                        pool)

    def run_compiled(self, state, batcher, num_rounds: int, chunk: int = 16,
                     log_every: int = 0, callback=None,
                     meter: Optional[CommMeter] = None,
                     cost_model: Optional[CostModel] = None,
                     device_data: bool = True):
        """Run ``num_rounds`` global rounds, ``chunk`` rounds per chunk
        program — bitwise equal to :meth:`run` (state and history) on the
        CPU.

        Each chunk stages ``R = min(chunk, remaining)`` rounds at once: the
        batches (or their index plan), the lrs (computed in double as
        :meth:`lr_at` does, staged as fp32) and the wire seeds.  On the card
        the rounds are replays of one captured round (``core/graphs.py``),
        with and without the aggregation as the cadence says; the per-round
        metrics come back in one fetch a chunk, and the meter and history
        rows are rebuilt on the host from the CommProfile and the cadence.
        On the CPU the same chunk program runs eagerly.  A capture that
        fails raises: the card never falls back to eager rounds.

        Differences from :meth:`run` worth knowing:
        - donation: on the card the state passed in becomes the captured
          program's buffers, overwritten every round — keep no reference to
          it, nor to a state returned earlier, across calls;
        - ``callback(rnd, metrics, state)`` fires on the ``log_every``
          cadence with that round's metrics but the *chunk-final* state
          (mid-chunk states never reach the host).  Pass
          ``chunk=log_every`` when the callback inspects the state;
        - resume: like :meth:`run`, the cadence and the lr schedule restart
          from ``state["round"]``, chunk-aligned or not.

        Data path: with ``device_data=True`` (the default) and a batcher
        that speaks the device-pool protocol (``device_pool(device)`` +
        ``next_round_indices()``), the sample pool is uploaded once and
        each chunk ships only an ``[R, n, h, B]`` index plan; the batches
        are gathered on the device, bitwise equal to staging.  Other
        batchers, or ``device_data=False``, stage the batches.
        """
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk} "
                             "(use Trainer.run for the per-round loop)")
        if self.transport.bits_fn is not None and self.device.type == "cuda":
            raise ValueError("bits_fn reads the unit counter on the host; "
                             "it cannot drive a captured round")
        start_batches = self.method.batches_trained(self.fsl, state)
        rnd0 = start_batches // self.fsl.h
        history, profile, done = [], None, 0
        pooled = (device_data and hasattr(batcher, "device_pool")
                  and hasattr(batcher, "next_round_indices"))
        pool = batcher.device_pool(self.device) if pooled else None
        while done < num_rounds:
            r = min(chunk, num_rounds - done)
            if pooled:
                data = np.stack([batcher.next_round_indices()
                                 for _ in range(r)]).astype(np.int64)
                sample = self.pool_round_spec(pool, data.shape[1:])
            else:
                rounds = [batcher.next_round() for _ in range(r)]
                sample = rounds[0]
                data = tree_map(_stack_rounds, *rounds)
            if meter is not None and cost_model is not None \
                    and profile is None:
                profile = self.comm_profile(
                    cost_model, tree_leaves(sample[1])[0].shape[2],
                    batch=sample)
            lrs = np.array([self.lr_at(rnd0 + done + i) for i in range(r)],
                           dtype=np.float32)
            unit0 = state["round"]
            per = [self._round_seeds(unit0 + i * self.units_per_round, sample)
                   for i in range(r)]
            seeds = {k: np.stack([p[k] for p in per]) for k in per[0]}
            if self.device.type == "cuda":
                state, metrics, agg_mask = self._replay(
                    state, pool, data, lrs, seeds, chunk)
            else:
                fn = self.pool_chunk_fn if pooled else self.chunk_fn
                args = (pool, self._put(data)) if pooled \
                    else (tree_map(self._put, data),)
                state, metrics, agg_mask = fn(
                    state, *args, self._put(lrs),
                    {k: self._put(v) for k, v in seeds.items()})
                metrics = {k: v.tolist() for k, v in metrics.items()}
                agg_mask = agg_mask.tolist()
            for i in range(r):
                self._log_round(
                    rnd0 + done + i, rnd0, bool(agg_mask[i]),
                    lambda: {k: float(v[i]) for k, v in metrics.items()},
                    profile, meter, log_every, callback, history, state)
            done += r
        return state, history

    def _replay(self, state, pool, data, lrs, seeds, chunk: int):
        """One chunk on the card: stage it into the captured program's
        buffers (capturing first where no capture fits) and replay a
        round per row.  Returns ``(state, {name: [r] floats}, flags)``."""
        r, unit0 = lrs.shape[0], state["round"]
        fn = self.pool_chunk_fn if pool is not None else self.chunk_fn
        cap = self._captured
        if graphs.matches(cap, r, pool, data):
            cap.load_state(state)
            cap.stage(data, lrs, seeds)
        else:
            self._captured = cap = None
            if self._mempool is None:
                self._mempool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            cap = graphs.CapturedChunk(fn.body, state, max(chunk, r), data,
                                       lrs, seeds, pool, self._mempool,
                                       self._stream)
            self._captured = cap
        flags = fn.cadence(unit0, r)
        rows = cap.replay(flags)
        metrics = {k: rows[:, j].tolist() for j, k in enumerate(cap.names)}
        state = {**cap.state, "round": unit0 + r * self.units_per_round}
        return state, metrics, flags
