"""End-to-end driver: CSE-FSL training of a ~100M-param transformer.

Builds qwen3-0.6b at a ~100M-parameter scale (half width/depth, full vocab
via the low-rank aux head), partitions a synthetic LM corpus over federated
clients, and runs CSE-FSL rounds with the Table II meter.  The attention
and the LM heads go through the port's kernels on the card (on the CPU,
their plain versions).

  python -m repro_torch.examples.train_federated_lm \
      [--rounds 12] [--clients 4] [--h 5] [--non-iid] [--device cpu]
"""
import argparse
import time

from repro_torch.common import bytes_of, tree_leaves
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.launch.train import LMBatcher, build_data
from repro_torch.models.model import abstract_params
from repro_torch.transport import available_codecs


def build_100m_config():
    """qwen3-0.6b scaled to ~100M params (still the same family/blocks)."""
    return get_config("qwen3-0.6b").with_(
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=4, d_ff=2048,
        vocab_size=32_000, cut_layer=2, aux_rank=64, use_pallas=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)  # 12 rounds x h=5 x 4 clients = 240 optimizer steps
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--h", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--codec", default="none",
                    choices=list(available_codecs()),
                    help="uplink wire codec (the meter reports wire bytes)")
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card)")
    args = ap.parse_args(argv)

    cfg = build_100m_config()
    n_params = sum(t.numel() for t in tree_leaves(abstract_params(cfg)))
    print(f"model: {cfg.name}-100m  params={n_params / 1e6:.1f}M  "
          f"cut={cfg.resolved_cut}/{cfg.num_layers}")

    fsl = FSLConfig(num_clients=args.clients, h=args.h, lr=args.lr,
                    codec=args.codec)
    bundle = transformer_bundle(cfg, device=args.device)
    fed = build_data(cfg, fsl, args.seq, args.batch * args.h * 8,
                     args.non_iid)
    batcher = LMBatcher(cfg, fed, args.batch, args.h)

    pa = bundle.specs
    cm = CostModel(n=args.clients,
                   q=bundle.smashed_bytes_per_sample * args.seq,
                   d_local=args.batch * args.h * 8,
                   w_client=bytes_of(pa["client"]),
                   w_server=bytes_of(pa["server"]), aux=bytes_of(pa["aux"]))
    meter = CommMeter()

    trainer = Trainer(bundle, fsl)
    state = trainer.init(seed=0)
    t0 = time.time()

    def report(rnd, m, _state):
        if rnd % 20 == 0:
            print(f"round {rnd:4d}  "
                  f"client_loss={m['client_loss']:.4f}  "
                  f"server_loss={m['server_loss']:.4f}  "
                  f"comm={meter.total / 2 ** 20:.0f} MiB  "
                  f"({(time.time() - t0) / rnd:.2f}s/round)")

    state, history = trainer.run(state, batcher, args.rounds, log_every=1,
                                 callback=report, meter=meter, cost_model=cm)
    first_loss = history[0]["client_loss"]
    last_loss = history[-1]["client_loss"]
    print(f"\n{args.rounds} rounds x h={args.h} batches: "
          f"loss {first_loss:.3f} -> {last_loss:.3f}; "
          f"total comm {meter.total / 2 ** 20:.0f} MiB "
          f"(FSL_AN would need ~{args.h}x the smashed uplink)")
    assert last_loss < first_loss, "training did not reduce the loss"
    return history, meter


if __name__ == "__main__":
    main()
