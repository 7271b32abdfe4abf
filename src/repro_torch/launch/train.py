"""Training-launch helpers (``repro.launch.train``): the federated token
data, the batcher that feeds it to ``Trainer.run`` / ``run_compiled`` and
the adapter that feeds a population data backend's token pool to
:class:`~repro_torch.population.Population`.

The CLI and its flags come in a later slice of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FSLConfig
from repro_torch.data import (FederatedBatcher, FederatedData,
                              partition_dirichlet, synthetic_lm)


def build_data(cfg, fsl: FSLConfig, seq_len: int, samples_per_client: int,
               non_iid: bool, seed: int = 0) -> FederatedData:
    """``samples_per_client`` token sequences of ``seq_len`` (+1 for the
    shifted labels) per client; iid contiguous shards, or a label-skew
    split by leading-token bucket (Dirichlet over 16 buckets)."""
    n = fsl.num_clients
    x, y = synthetic_lm(n * samples_per_client, seq_len + 1, cfg.vocab_size,
                        seed=seed)
    if non_iid:
        fed_idx = partition_dirichlet(np.arange(len(x))[:, None], x[:, 0] % 16,
                                      n, seed=seed)
        return FederatedData([x[ci[:, 0]] for ci in fed_idx.inputs],
                             [y[ci[:, 0]] for ci in fed_idx.inputs])
    shards = np.array_split(np.arange(len(x)), n)
    return FederatedData([x[s] for s in shards], [y[s] for s in shards])


class LMBatcher:
    """Adapts FederatedBatcher token pairs to the transformer's input tree:
    ``next_round() -> ({"tokens": x}, y)``, numpy int32 ``[n, h, B, S]``.

    It speaks the device-pool protocol too (``device_pool(device)`` and
    ``next_round_indices``, the inner batcher's cursor walk), so
    ``Trainer.run_compiled`` uploads the token pool once and gathers each
    round on the device."""

    def __init__(self, cfg, fed: FederatedData, batch_size: int, h: int,
                 seed: int = 0):
        self.cfg = cfg
        self.inner = FederatedBatcher(fed, batch_size, h, seed=seed)
        self.next_round_indices = self.inner.next_round_indices
        self._pools = {}

    def next_round(self):
        x, y = self.inner.next_round()
        return {"tokens": x}, y

    def device_pool(self, device):
        return _token_pool(self, device)


def _token_pool(adapter, device):
    """``adapter.inner``'s device pool as ``({"tokens": px}, py)``, built
    once a device: a captured chunk is reused only with the pool object it
    was captured on."""
    key = str(torch.device(device))
    if key not in adapter._pools:
        px, py = adapter.inner.device_pool(device)
        adapter._pools[key] = ({"tokens": px}, py)
    return adapter._pools[key]


class LMPool:
    """Adapts a population data backend's token pool to the transformer's
    input tree (the leaf mapping of :class:`LMBatcher`)."""

    def __init__(self, cfg, inner):
        self.cfg = cfg
        self.inner = inner
        self.stateless = inner.stateless
        self._pools = {}

    def device_pool(self, device):
        return _token_pool(self, device)

    def round_indices(self, ids, rnd: int):
        return self.inner.round_indices(ids, rnd)
