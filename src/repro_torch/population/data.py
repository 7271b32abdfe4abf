"""Population-scale data backends (``repro.population.data``): a device
pool and per-round index plans.

The population engine never stages batch *values*: each chunk ships an
``[R, C, h, B]`` index plan into a sample pool that lives on the device
(``Trainer.pool_chunk_fn`` gathers each round's batches there).  A
backend provides:

  - ``device_pool(device) -> (inputs, labels)``: every leaf ``[S, ...]``,
    uploaded once, shared by every cohort;
  - ``round_indices(ids, rnd) -> [len(ids), h, B]`` int32 global pool
    indices: the cohort's batch plan for global round ``rnd``.

Two backends cover the two regimes:

  - :class:`FederatedPool` wraps the dense
    :class:`~repro_torch.data.FederatedBatcher` (population == an explicit
    per-client :class:`~repro_torch.data.FederatedData`): the SAME shuffled
    cursor stream, so a full-fleet cohort draws bit for bit the dense
    trainer's batches.  Host memory is O(total samples); the draw stream
    is stateful (resume by replay).
  - :class:`VirtualPool` is the million-client backend: clients are
    *virtual* shards of one modest pool (client ``i`` owns a hashed
    contiguous window of ``d_local`` samples), and each round's batch is
    drawn by a stateless ``(seed, client, round)``-keyed numpy generator:
    no per-client host state, O(pool) memory independent of N, and a
    resume that reproduces bitwise from the round counter alone.

For the same seeds both give the JAX package's index plans exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.data import (FederatedBatcher, FederatedData,
                              synthetic_classification)

# Knuth multiplicative hash: spreads client shard starts over the pool so
# neighbouring client ids don't share samples unless d_local demands it.
_SHARD_HASH = 2654435761
_DATA_SALT = 0xDA7A


class FederatedPool:
    """Explicit per-client data (the dense regime, N = data.num_clients)."""

    stateless = False

    def __init__(self, data: FederatedData, batch_size: int, h: int,
                 seed: int = 0):
        self.batcher = FederatedBatcher(data, batch_size, h, seed=seed)
        self.population = data.num_clients

    def device_pool(self, device):
        return self.batcher.device_pool(device)

    def round_indices(self, ids, rnd: int) -> np.ndarray:
        return self.batcher.next_round_indices([int(i) for i in ids])


@dataclasses.dataclass
class VirtualPool:
    """N virtual clients sharding one ``[S, ...]`` sample pool.

    ``round_indices`` is pure in ``(seed, client, round)``: the engine can
    ask for any round's plan at any time, which is what makes resumed
    population runs bitwise without checkpointing any data state.
    """

    pool_x: np.ndarray
    pool_y: np.ndarray
    d_local: int
    batch_size: int
    h: int
    seed: int = 0
    stateless = True

    def __post_init__(self):
        S = len(self.pool_x)
        if len(self.pool_y) != S:
            raise ValueError(f"pool leaves disagree: {S} vs "
                             f"{len(self.pool_y)}")
        if not 0 < self.d_local <= S:
            raise ValueError(f"d_local must be in (0, {S}], got "
                             f"{self.d_local}")
        self._device_pools = {}

    @classmethod
    def synthetic(cls, input_shape: Tuple[int, ...], num_classes: int,
                  pool_size: int, d_local: int, batch_size: int, h: int,
                  seed: int = 0, signal: float = 2.0) -> "VirtualPool":
        x, y = synthetic_classification(pool_size, input_shape, num_classes,
                                        seed=seed, signal=signal)
        return cls(x, y, d_local=d_local, batch_size=batch_size, h=h,
                   seed=seed)

    def shard_start(self, client: int) -> int:
        return (int(client) * _SHARD_HASH) % len(self.pool_x)

    def device_pool(self, device):
        """The pool as tensors on ``device``: uploaded once, cached."""
        key = str(torch.device(device))
        if key not in self._device_pools:
            self._device_pools[key] = (
                torch.from_numpy(np.asarray(self.pool_x)).to(device),
                torch.from_numpy(np.asarray(self.pool_y)).to(device))
        return self._device_pools[key]

    def round_indices(self, ids, rnd: int) -> np.ndarray:
        S = len(self.pool_x)
        out = np.empty((len(ids), self.h, self.batch_size), np.int64)
        for j, cid in enumerate(ids):
            rng = np.random.default_rng((self.seed, int(cid), int(rnd),
                                         _DATA_SALT))
            local = rng.integers(0, self.d_local,
                                 size=(self.h, self.batch_size))
            out[j] = (self.shard_start(cid) + local) % S
        return out.astype(np.int32)
