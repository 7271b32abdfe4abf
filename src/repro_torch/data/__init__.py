"""Data pipeline: synthetic classification and language-model data +
federated partitioner.

A numpy copy of ``repro.data`` (the reference package is not imported):
for the same seeds it yields the same samples and the same per-round
batches, bit for bit.  Batches stay numpy arrays; the Trainer moves each
round's batch to its device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FederatedData:
    """Per-client datasets.  inputs[i]: [Ni, ...], labels[i]: [Ni]."""
    inputs: List[np.ndarray]
    labels: List[np.ndarray]

    @property
    def num_clients(self) -> int:
        return len(self.inputs)


def synthetic_classification(num_samples: int, input_shape: Tuple[int, ...],
                             num_classes: int, seed: int = 0,
                             signal: float = 2.0):
    """Gaussian noise + a class-template ("blob") signal.

    Each class has a fixed unit-norm template added at strength ``signal``;
    templates come from a fixed-seed generator so train/test splits with
    different ``seed`` share the same classes.
    """
    d = int(np.prod(input_shape))
    trng = np.random.default_rng(12345)          # class templates: shared
    templates = trng.normal(size=(num_classes, d)).astype(np.float32)
    templates /= np.linalg.norm(templates, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    x = rng.normal(size=(num_samples, d)).astype(np.float32)
    x += signal * templates[y]
    return x.reshape((num_samples,) + tuple(input_shape)), y


def synthetic_lm(num_samples: int, seq_len: int, vocab: int, seed: int = 0,
                 order: int = 1):
    """Token sequences from a sparse random order-``order`` Markov chain.

    With probability 0.8 the next token is a fixed permutation of a mix of
    the previous token and the token ``order`` steps back, so next-token
    prediction is learnable above chance.  Returns ``(x, y)`` int32
    ``[num_samples, seq_len - 1]``, ``y`` the next tokens of ``x``.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    toks = rng.integers(0, vocab, size=(num_samples, seq_len)).astype(np.int32)
    for t in range(1, seq_len):
        follow = rng.random(size=num_samples) < 0.8
        ctx = toks[follow, t - 1]
        if order > 1:
            ctx = (ctx + toks[follow, t - min(order, t)]) % vocab
        toks[follow, t] = perm[ctx]
    return toks[:, :-1], toks[:, 1:]


def partition_iid(x, y, num_clients: int, seed: int = 0) -> FederatedData:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    shards = np.array_split(idx, num_clients)
    return FederatedData([x[s] for s in shards], [y[s] for s in shards])


def partition_dirichlet(x, y, num_clients: int, alpha: float = 0.3,
                        seed: int = 0) -> FederatedData:
    """Label-skew non-IID split (Dirichlet over class proportions)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    client_idx: List[List[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx_c = np.where(y == c)[0]
        rng.shuffle(idx_c)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx_c, cuts)):
            client_idx[i].extend(part.tolist())
    # ensure every client has at least one batch worth of data
    for i in range(num_clients):
        if not client_idx[i]:
            client_idx[i] = [int(rng.integers(0, len(x)))]
    return FederatedData([x[np.array(sorted(ci))] for ci in client_idx],
                         [y[np.array(sorted(ci))] for ci in client_idx])


class FederatedBatcher:
    """Yields per-round stacked batches [n_clients, h, B, ...].

    Each client cycles through its own (shuffled) local data; shorter
    datasets wrap around.  :meth:`next_round` and
    :meth:`next_round_indices` share one cursor walk and one RNG stream,
    so ``next_round()`` equals the concatenated pool indexed by
    ``next_round_indices()``.
    """

    def __init__(self, data: FederatedData, batch_size: int, h: int,
                 seed: int = 0):
        self.data = data
        self.bs = batch_size
        self.h = h
        self.rng = np.random.default_rng(seed)
        self._cursors = [0] * data.num_clients
        self._orders = [self.rng.permutation(len(d)) for d in data.inputs]
        sizes = [len(d) for d in data.inputs]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def _client_indices(self, i: int) -> np.ndarray:
        """One batch of LOCAL sample indices for client i."""
        n = len(self.data.inputs[i])
        take = self.bs
        idx = []
        while take > 0:
            if self._cursors[i] >= n:
                self._cursors[i] = 0
                self._orders[i] = self.rng.permutation(n)
            idx.append(self._orders[i][self._cursors[i]])
            self._cursors[i] += 1
            take -= 1
        return np.array(idx)

    def _client_batch(self, i: int):
        idx = self._client_indices(i)
        return self.data.inputs[i][idx], self.data.labels[i][idx]

    def next_round(self, client_ids: Optional[List[int]] = None):
        ids = client_ids if client_ids is not None else list(
            range(self.data.num_clients))
        xs, ys = [], []
        for i in ids:
            bx, by = zip(*[self._client_batch(i) for _ in range(self.h)])
            xs.append(np.stack(bx))
            ys.append(np.stack(by))
        return np.stack(xs), np.stack(ys)     # [n, h, B, ...]

    def next_round_indices(self,
                           client_ids: Optional[List[int]] = None):
        """``[n, h, B]`` int32 indices into the client-ordered concatenation
        of the per-client datasets — the index-plan twin of
        :meth:`next_round` (same cursors, same RNG)."""
        ids = client_ids if client_ids is not None else list(
            range(self.data.num_clients))
        out = [np.stack([self._offsets[i] + self._client_indices(i)
                         for _ in range(self.h)]) for i in ids]
        return np.stack(out).astype(np.int32)
