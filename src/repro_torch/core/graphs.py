"""CUDA-graph replay of the chunk program: the port's counterpart of
``jax.jit`` over the JAX package's ``lax.scan`` of rounds.

:class:`CapturedChunk` captures ONE round of a chunk program's ``body``
(:func:`repro_torch.core.methods.base.make_chunk_step`) twice on the card,
without and with the aggregation, and replays one of the two per round;
the host picks it from the aggregation cadence, which it knows without
reading the card.  Everything a round reads that changes from round to
round lies in static device buffers the body indexes with a device step
counter:

- the chunk's batches (``[R, n, h, B, ...]``) or, on the pooled data path,
  its ``[R, n, h, B]`` index plan into the batcher's device pool;
- the lrs (fp32 ``[R]``) and the wire seeds (channel -> ``[R, ...]``);
- under partial participation, each round's cohort (fp32 ``[R, n]``, the
  windows of ``participation_windows``), which the aggregating round's
  masked FedAvg reads; the host replays the aggregating graph only where
  the cadence fires and the cohort is not empty (the JAX chunk's
  ``lax.cond`` no-op), so an empty window launches no model-sync kernel;
- the step counter itself (int64 ``[1]``), which the captured round adds
  one to at its end, so R replays run back to back with no host work
  between them;
- the stacked metrics, written per round into a float64 ``[R, K]`` buffer
  (exact for fp32 and bf16 values) that the host fetches once a chunk.

The state's tensors are static buffers too: the captured round runs the
round step and copies its result back into them.  The state passed in is
adopted as those buffers (donated: keep no reference to it); the captured
round runs under ``donated_state()``, so the CSE-FSL clients' SGD steps
update the static params in place (the same bits: no second copy of the
clients' params beside their gradients), where the eager warm-up and
``Trainer.run`` keep the functional step.

Warm-up runs one round and its aggregation eagerly on a side stream
before the captures, as PyTorch's graph rules require (lazy cuBLAS and
cuDNN set-up, the kernels' one-time attributes); its result is dropped.
Both captures share one private memory pool, so the two graphs hold the
memory of one round.  The Trainer keeps one side stream for all its
captures (each new stream would hold a cuBLAS workspace of its own for
good) and gives each capture a fresh pool: once a pool's graphs are
freed, the caching allocator refuses to capture into it again.  A
capture that fails raises; nothing falls back to eager rounds on the
card.  (After a failed capture, torch 2.11's caching allocator keeps
every block freed later reserved for the rest of the process.)
"""
from __future__ import annotations

import gc
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common import tree_leaves, tree_map
from repro_torch.core.methods.base import donated_state


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


def state_leaves(state) -> list:
    """The state's tensors (every key but the host counter ``round``)."""
    return tree_leaves({k: v for k, v in state.items() if k != "round"})


class CapturedChunk:
    """One round of ``body`` captured on the card, with and without the
    aggregation, for chunks of up to ``rows`` rounds.

    ``state`` is adopted as the static state; ``data`` (numpy ``[r, ...]``
    batches as ``(inputs, labels)``, or, with ``pool``, the int64 ``[r, n,
    h, B]`` index plan), ``lrs`` (fp32 ``[r]``), ``seeds`` (channel ->
    int64 ``[r, ...]``) and, for a masked body, ``windows`` (fp32 ``[r,
    n]`` cohorts) are the first chunk, which sizes the static buffers and
    feeds the warm-up.  ``mempool`` (the graphs' private memory pool) and
    ``stream`` (the side stream) are the Trainer's."""

    def __init__(self, body, state, rows: int, data, lrs: np.ndarray,
                 seeds: Dict[str, np.ndarray], pool, mempool, stream,
                 windows: Optional[np.ndarray] = None):
        self.body, self.rows, self.pooled = body, rows, pool is not None
        self.masked = windows is not None
        self.state = state
        dev = state_leaves(state)[0].device

        def buf(a):
            return torch.zeros((rows,) + a.shape[1:], dtype=_torch_dtype(a),
                               device=dev)

        self.staged = tree_map(buf, data)       # the batches or index plan
        self.data = (pool, self.staged) if self.pooled else self.staged
        self.lrs = buf(lrs)
        self.seeds = {k: buf(v) for k, v in seeds.items()}
        self.windows = buf(windows) if self.masked else None
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.stage(data, lrs, seeds, windows)
        self.stream = stream
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            self.names = list(body(state, self.data, self.lrs, self.seeds,
                                   self.step, True, self.windows)[1])
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        torch.cuda.synchronize(dev)
        # torch.cuda.graph no longer collects before a capture: a dead cycle
        # holding warm-up tensors would stay beside the graph's pool
        gc.collect()
        torch.cuda.empty_cache()
        self.metrics = torch.zeros((rows, len(self.names)),
                                   dtype=torch.float64, device=dev)
        self._host = None           # pinned landing rows of the metrics
        self.mempool = mempool
        self.graphs = {}
        for aggregated in (True, False):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=self.mempool, stream=self.stream):
                self._round(aggregated)
            self.graphs[aggregated] = g

    def _round(self, aggregated: bool):
        """The captured round: the body at ``step``, its metrics into row
        ``step``, its state into the static state, ``step + 1``."""
        with donated_state():       # the static state, overwritten below
            new, m = self.body(self.state, self.data, self.lrs, self.seeds,
                               self.step, aggregated, self.windows)
        if list(m) != self.names:
            raise RuntimeError(f"round metrics {list(m)} != {self.names}")
        row = torch.stack([m[k].to(torch.float64) for k in self.names])
        self.metrics.index_copy_(0, self.step, row[None])
        static, fresh = state_leaves(self.state), state_leaves(new)
        if len(static) != len(fresh) or any(
                s.shape != x.shape or s.dtype != x.dtype
                for s, x in zip(static, fresh)):
            raise RuntimeError("the round step changed the state's layout")
        held = {s.untyped_storage().data_ptr() for s in static}
        pairs = []
        for s, x in zip(static, fresh):
            if x is s:
                continue
            if x.untyped_storage().data_ptr() in held:   # a view of a buffer
                x = x.clone()
            pairs.append((s, x))
        for s, x in pairs:
            s.copy_(x)
        self.step.add_(1)

    def load_state(self, state):
        """Copy ``state``'s tensors into the static state (those that are
        not the static buffers already)."""
        for s, x in zip(state_leaves(self.state), state_leaves(state)):
            if x is not s:
                s.copy_(x)

    def stage(self, data, lrs: np.ndarray, seeds: Dict[str, np.ndarray],
              windows: Optional[np.ndarray] = None):
        """Copy one chunk's host arrays into the first rows of the static
        buffers (once a chunk, before its replays)."""
        def put(b, a):
            b[:a.shape[0]].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        tree_map(put, self.staged, data)
        put(self.lrs, lrs)
        for k, v in seeds.items():
            put(self.seeds[k], v)
        if self.masked:
            put(self.windows, windows)

    def replay(self, flags, fetch: bool = True):
        """Replay one round per entry of ``flags`` (True: the aggregating
        variant; for a masked body, where the cadence fires on a non-empty
        cohort) from step 0, then fetch the ``[len(flags), K]`` metrics
        once.  With ``fetch=False`` the copy only starts, into pinned host
        rows behind the replays, and a function that waits for it and
        returns the rows comes back at once: the host works on while the
        card replays.  Call it before the next replay."""
        self.step.zero_()
        for aggregated in flags:
            self.graphs[bool(aggregated)].replay()
        rows = self.metrics[:len(flags)]
        if fetch:
            return rows.cpu().numpy()
        if self._host is None:
            self._host = torch.empty(self.metrics.shape, dtype=torch.float64,
                                     pin_memory=True)
        host = self._host[:len(flags)]
        host.copy_(rows, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record()

        def wait() -> np.ndarray:
            landed.synchronize()
            return host.numpy().copy()

        return wait


def matches(cap: Optional[CapturedChunk], rows: int, pool, data,
            masked: bool = False) -> bool:
    """``cap`` can run a chunk of ``rows`` rounds of this data (the same
    device pool, or staged batches of the same shapes) with the same
    aggregate (masked or not)."""
    if cap is None or cap.rows < rows or cap.pooled != (pool is not None) \
            or cap.masked != masked:
        return False
    if pool is not None and cap.data[0] is not pool:
        return False
    same = []
    tree_map(lambda b, a: same.append(tuple(b.shape[1:]) == a.shape[1:]
                                      and b.dtype == _torch_dtype(a)),
             cap.staged, data)
    return all(same)
