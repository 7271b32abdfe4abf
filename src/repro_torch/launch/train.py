"""Training-launch helpers (``repro.launch.train``): the federated token
data and the batcher that feeds it to ``Trainer.run``.

The CLI and its flags come in a later slice of the port.
"""
from __future__ import annotations

import numpy as np

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
    ``next_round() -> ({"tokens": x}, y)``, numpy int32 ``[n, h, B, S]``."""

    def __init__(self, cfg, fed: FederatedData, batch_size: int, h: int,
                 seed: int = 0):
        self.cfg = cfg
        self.inner = FederatedBatcher(fed, batch_size, h, seed=seed)

    def next_round(self):
        x, y = self.inner.next_round()
        return {"tokens": x}, y
