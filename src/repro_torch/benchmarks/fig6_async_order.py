"""Paper Fig. 6 on the port: event-driven client arrivals in permuted
orders (``benchmarks/fig6_async_order.py``).

The ``AsyncTrainer`` consumes smashed uploads in arrival order; Fig. 6
claims the final accuracy is insensitive to that order.  The same CSE-FSL
model (same init seed, same batch stream, one trainer) trains under
several latency traces -- each yields different per-round arrival
permutations -- and the final accuracies and server params are compared.
In CSE-FSL the client side never waits on the server, so the client
trajectories are the same across traces and the whole spread is server
update-order noise.

As in the JAX script, a reduced CNN and a stronger planted signal (4
clients, h = 5, B = 24, adam lr 3e-3, 50 rounds, latency seeds 1-3,
``LognormalLatency(sigma=1, spread=1)``), where the protocol trains to
convergence and the claim is measurable at the 1e-3 level.  Keeps the JAX
script's claims as assertions: the traces permute the first round's
consumption order, and the accuracy spread across them is below 1e-3.
``--smoke`` trains 30 rounds (the JAX script has no smoke set): the
protocol has converged there too (spreads of 0 at 20, 30 and 40 rounds,
0.0005 at 25, 0.05 at 15 and fewer, on the CPU).  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig6_async_order \\
        [--device cpu] [--smoke | --rounds R]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import accuracy, banner, save, table
from repro_torch.common import tree_map
from repro_torch.configs.base import FSLConfig
from repro_torch.core.async_trainer import AsyncTrainer, LognormalLatency
from repro_torch.core.bundle import cnn_bundle
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim import global_norm

LATENCY_SEEDS = (1, 2, 3)
ROUNDS, N, H = 50, 4, 5
SMOKE_ROUNDS = 30
CNN = CNNConfig("fig6_cnn", (12, 12, 3), 10, conv_channels=(16, 32),
                kernel=3, server_widths=(64,), lrn=False)


def main(device="cuda", rounds=None):
    rounds = rounds or ROUNDS
    bundle = cnn_bundle(CNN, device=device)
    x, y = synthetic_classification(1200, CNN.in_shape, 10, signal=20.0)
    fed = partition_iid(x, y, N)
    xt, yt = synthetic_classification(4000, CNN.in_shape, 10, seed=99,
                                      signal=20.0)
    fsl = FSLConfig(num_clients=N, h=H, lr=3e-3, optimizer="adam")
    latency = LognormalLatency(sigma=1.0, spread=1.0)
    trainer = AsyncTrainer(bundle, fsl)

    accs, servers, orders = {}, {}, {}
    for ls in LATENCY_SEEDS:
        trace = latency.draw(np.random.default_rng(ls), rounds, N,
                             trainer.hooks.uploads_per_round)
        state = trainer.init(0)
        batcher = FederatedBatcher(fed, 24, H, seed=0)
        state, _ = trainer.run(state, batcher, rounds, trace=trace)
        accs[ls] = accuracy(bundle, CNN, trainer.merged_params(state), xt,
                            yt)
        servers[ls] = state["server"]["params"]
        orders[ls] = tuple(trainer.stats.arrival_order)

    # the latency traces must actually permute the consumption order,
    # otherwise the invariance claim is vacuous
    assert len(set(orders.values())) > 1, orders
    ref = LATENCY_SEEDS[0]
    rows = []
    for ls in LATENCY_SEEDS:
        diff = tree_map(lambda a, b: a.float() - b.float(), servers[ref],
                        servers[ls])
        rel = float(global_norm(diff)) / float(global_norm(servers[ref]))
        rows.append({"arrival_order": "".join(map(str, orders[ls])),
                     "acc": round(accs[ls], 4),
                     "server_rel_dist": round(rel, 5)})
    banner(f"Fig 6 — asynchronous arrival-order invariance (AsyncTrainer; "
           f"{bundle.device})")
    table(rows, ["arrival_order", "acc", "server_rel_dist"])
    spread = max(accs.values()) - min(accs.values())
    print(f"final-accuracy spread across {len(LATENCY_SEEDS)} arrival "
          f"permutations: {spread:.5f}")
    assert spread < 1e-3, accs
    out = {"accs": {str(k): v for k, v in accs.items()},
           "orders": {str(k): "".join(map(str, v))
                      for k, v in orders.items()},
           "accuracy_spread": spread}
    save("torch_fig6_async_order", {**out, "device": str(bundle.device)})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_ROUNDS} rounds (still asserts the claims)")
    ap.add_argument("--rounds", type=int, default=None)
    args = ap.parse_args()
    main(args.device, rounds=SMOKE_ROUNDS if args.smoke else args.rounds)
