"""CSE-FSL training driver (``repro.launch.train``): the CLI, the
federated token data, the batcher that feeds it to ``Trainer.run`` /
``run_compiled`` and the adapter that feeds a population data backend's
token pool to :class:`~repro_torch.population.Population`.

  python -m repro_torch.launch.train --arch qwen3-0.6b \
      --rounds 50 --clients 4 --h 5 [--size {reduced,full}] [--method cse_fsl]

It runs on the card (``--device cuda``, the default); ``--device cpu``
asks for the CPU, and without a card nothing else runs there.  The flags,
their defaults and the printouts are the JAX driver's, and ``--out``
writes the same JSON.

Population mode (``--population N``) swaps the dense trainer for the
cohort engine (:mod:`repro_torch.population`): N virtual clients sharding
one device-resident token pool, a cohort of ``--cohort`` (default
``--clients``) sampled per aggregation window by ``--sampler``, server
memory independent of N:

  python -m repro_torch.launch.train --arch qwen3-0.6b \
      --population 10000 --cohort 8 --sampler stratified --network tiered

Differences from the JAX driver:
- hubert-xlarge (audio: frame features, not tokens) is refused with a
  message; the JAX driver gives its token batches to the model and dies
  with ``KeyError: 'features'``;
- the model's hot spots (attention, the selective scan, the fused LM-head
  cross-entropy) always go through the port's kernels
  (``ModelConfig.use_pallas``): the JAX driver leaves its Pallas kernels
  off, since they are TPU kernels;
- ``--mesh host`` over one device is the run without a mesh; over more it
  exits, since the port has no mesh yet (ROADMAP Queue 1 item 5);
- ``--profile-dir`` brackets the run with ``torch.profiler`` and writes a
  Chrome trace under the given folder;
- the JAX driver's ``assert_x64_disabled`` guard has no PyTorch meaning
  (nothing here widens to 64 bits on its own) and is left out.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.common import bytes_of, resolve_device
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.core.accounting import CommMeter, CostModel, flat_record
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.methods import available_methods
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, FederatedData,
                              partition_dirichlet, synthetic_lm)
from repro_torch.faults import FAULT_MODELS, fault_from_flags
from repro_torch.launch.serve import add_size_args
from repro_torch.network import NETWORK_MODELS, network_from_flags
from repro_torch.population import Population, VirtualPool
from repro_torch.sched import (COHORT_SAMPLERS, available_policies,
                               scheduler_from_flags)
from repro_torch.telemetry import Telemetry
from repro_torch.transport import available_codecs


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
    ``next_round() -> ({"tokens": x}, y)``, numpy int32 ``[n, h, B, S]``;
    the vlm's inputs also carry zero ``image_embeds`` ``[n, h, B, P, d]``
    (fp32), as the reference's batcher gives them.

    For token-only archs it speaks the device-pool protocol too
    (``device_pool(device)`` and ``next_round_indices``, the inner
    batcher's cursor walk), so ``Trainer.run_compiled`` uploads the token
    pool once and gathers each round on the device.  ``run_compiled``
    probes for the protocol with ``hasattr``, so the vlm's batcher does
    not expose it (a pool would carry each sample's image embeddings) and
    its batches are staged from the host."""

    def __init__(self, cfg, fed: FederatedData, batch_size: int, h: int,
                 seed: int = 0):
        self.cfg = cfg
        self.inner = FederatedBatcher(fed, batch_size, h, seed=seed)
        self._pools = {}
        if cfg.family != "vlm":
            self.device_pool = lambda device: _token_pool(self, device)
            self.next_round_indices = self.inner.next_round_indices

    def next_round(self):
        x, y = self.inner.next_round()
        inputs = {"tokens": x}
        if self.cfg.family == "vlm":
            inputs["image_embeds"] = np.zeros(
                x.shape[:3] + (self.cfg.num_image_tokens, self.cfg.d_model),
                np.float32)
        return inputs, y


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
    input tree (the leaf mapping of :class:`LMBatcher`); the vlm's inputs
    are not poolable, and it refuses them with the reference's message."""

    def __init__(self, cfg, inner):
        if cfg.family == "vlm":
            raise ValueError("population mode needs poolable (token-only) "
                             f"inputs; {cfg.name} is a vlm")
        self.cfg = cfg
        self.inner = inner
        self.stateless = inner.stateless
        self._pools = {}

    def device_pool(self, device):
        return _token_pool(self, device)

    def round_indices(self, ids, rnd: int):
        return self.inner.round_indices(ids, rnd)


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's flags, names, defaults and choices, and
    ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help=f"one of {arch_names()}")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--h", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--method", default="cse_fsl",
                    choices=list(available_methods()))
    ap.add_argument("--codec", default="none",
                    choices=list(available_codecs()),
                    help="uplink wire codec (CommMeter reports the "
                         "compressed wire bytes)")
    ap.add_argument("--model-codec", default="none",
                    choices=list(available_codecs()),
                    help="model-sync (FedAvg up/download) wire codec")
    ap.add_argument("--network", default="ideal",
                    choices=sorted(NETWORK_MODELS),
                    help="per-client link model for the analytic "
                         "wall-clock estimate printed after training")
    ap.add_argument("--bandwidth-mbps", type=float, default=10.0,
                    help="mean uplink rate for --network uniform/lognormal/"
                         "trace (downlink 5x; tiered has per-tier rates)")
    ap.add_argument("--scheduler", default="wait_all",
                    choices=list(available_policies()),
                    help="aggregation-barrier scheduling policy (wait_all "
                         "= everyone participates)")
    ap.add_argument("--deadline-s", type=float, default=30.0,
                    help="wall-clock budget per round for "
                         "--scheduler deadline (arrivals past it are "
                         "dropped, FedAvg renormalizes over participants)")
    ap.add_argument("--faults", default="none",
                    choices=sorted(FAULT_MODELS),
                    help="deterministic fault model (repro_torch.faults): "
                         "lossy wire with checksum-framed retransmission, "
                         "mid-round client crashes, server outages")
    ap.add_argument("--loss-rate", type=float, default=None,
                    help="per-transmission loss/corruption probability "
                         "(default: the --faults preset's)")
    ap.add_argument("--crash-rate", type=float, default=None,
                    help="per-client per-round crash probability "
                         "(default: the --faults preset's)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="retransmission budget per payload before the "
                         "sender gives up (wire drop)")
    ap.add_argument("--population", type=int, default=0,
                    help="fleet size N: run the cohort engine "
                         "(repro_torch.population) instead of the dense "
                         "trainer; --clients becomes the cohort size C")
    ap.add_argument("--cohort", type=int, default=0,
                    help="cohort size C for --population (default: "
                         "--clients)")
    ap.add_argument("--sampler", default="uniform",
                    choices=sorted(COHORT_SAMPLERS),
                    help="per-window cohort sampler (stratified draws "
                         "proportionally over --network tiered tiers)")
    ap.add_argument("--mesh", default="none", choices=["none", "host"],
                    help="'host': every local device (one device: the run "
                         "without a mesh)")
    add_size_args(ap)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--server-update", default="sequential")
    ap.add_argument("--chunk", type=int, default=10,
                    help="rounds a chunk of run_compiled (CUDA-graph "
                         "replay on the card); 0 = the per-round loop")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write the round-record stream (JSONL, one "
                         "validated record per line) to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON timeline to PATH "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--prom", default=None, metavar="PATH",
                    help="write Prometheus text exposition of telemetry "
                         "counters/gauges to PATH")
    ap.add_argument("--profile-dir", default=None, metavar="PATH",
                    help="bracket training with torch.profiler and write "
                         "a Chrome trace under PATH")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' asks for "
                         "the CPU)")
    return ap


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), train, report; returns
    ``(state, history)``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    if args.mesh == "host" and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        raise SystemExit("error: --mesh host over more than one device "
                         "needs the sharded launch, not ported yet (ROADMAP "
                         "Queue 1 item 5)")

    cfg = get_config(args.arch)
    if args.size == "reduced":
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit(
            f"error: {cfg.name} trains on frame features, and this driver's "
            "data are token sequences; the JAX driver fails here too, with "
            "KeyError: 'features' at its first round (ROADMAP Queue 3, "
            "\"Noted\"); launch.specs.train_batch_specs builds its inputs")
    # the hot spots go through the port's kernels: launched on the card, on
    # the CPU each wrapper runs its plain version
    cfg = cfg.with_(use_pallas=True)
    # population mode: the chunk programs see a C-client fleet a window;
    # N only exists on the host (sampler + lazy state)
    cohort = (args.cohort or args.clients) if args.population \
        else args.clients
    fsl = FSLConfig(num_clients=cohort, h=args.h, lr=args.lr,
                    method=args.method, server_update=args.server_update,
                    codec=args.codec, model_codec=args.model_codec)
    bundle = transformer_bundle(cfg, device=device)
    d_local = args.samples
    if args.population:
        if args.scheduler != "wait_all":
            ap.error("--population replaces barrier scheduling with cohort "
                     "sampling; use --scheduler wait_all")
        # N virtual clients sharding one token pool, stateless draws
        x, y = synthetic_lm(args.samples, args.seq + 1, cfg.vocab_size)
        d_local = max(args.batch * args.h, args.samples // 8)
        pool_data = LMPool(cfg, VirtualPool(
            x, y, d_local=d_local, batch_size=args.batch, h=args.h))
        batcher = None
    else:
        fed = build_data(cfg, fsl, args.seq, args.samples, args.non_iid)
        batcher = LMBatcher(cfg, fed, args.batch, args.h)

    # Table II meter, from the parameters' shapes (meta tensors: nothing
    # is allocated)
    specs = bundle.specs
    cm = CostModel(
        n=fsl.num_clients, q=bundle.smashed_bytes_per_sample * args.seq,
        d_local=d_local, w_client=bytes_of(specs["client"]),
        w_server=bytes_of(specs["server"]), aux=bytes_of(specs["aux"]))
    meter = CommMeter()

    network = network_from_flags(args.network, args.bandwidth_mbps)
    faults = fault_from_flags(args.faults, args.loss_rate, args.crash_rate,
                              args.max_retries)
    # an observation-only recorder: state and history are bitwise the
    # same with it on and off
    tele = Telemetry() if args.telemetry or args.trace or args.prom \
        else None
    pop = None
    if args.population:
        pop = Population(bundle, fsl, population=args.population,
                         data=pool_data, sampler=args.sampler,
                         network=network, faults=faults, telemetry=tele)
        trainer = pop.trainer
        pop.init()
    else:
        scheduler = scheduler_from_flags(args.scheduler, args.deadline_s)
        trainer = Trainer(bundle, fsl, scheduler=scheduler, network=network,
                          faults=faults, telemetry=tele)
        state = trainer.init()
    prof = contextlib.nullcontext()
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)

    def cb(rnd, metrics, _state):
        print(f"round {rnd:4d} lr={trainer.lr_at(rnd):.4f} "
              + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

    # the compiled chunk runner by default (CUDA-graph replay on the card,
    # bitwise the loop); --chunk 0 runs the per-round loop
    with prof:
        t0 = time.time()
        if pop is not None:
            state, history = pop.run(args.rounds, chunk=max(args.chunk, 1),
                                     log_every=args.log_every, callback=cb,
                                     meter=meter, cost_model=cm)
        elif args.chunk:
            state, history = trainer.run_compiled(
                state, batcher, args.rounds, chunk=args.chunk,
                log_every=args.log_every, callback=cb, meter=meter,
                cost_model=cm)
        else:
            state, history = trainer.run(state, batcher, args.rounds,
                                         log_every=args.log_every,
                                         callback=cb, meter=meter,
                                         cost_model=cm)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"torch.profiler trace written to {path}")
    print(f"\n{args.rounds} rounds in {dt:.1f}s; "
          f"total comm = {meter.total/2**20:.1f} MiB "
          f"({json.dumps({k: round(v/2**20, 2) for k, v in meter.counts.items()})} MiB)")
    pop_summary = pop_memory = None
    if pop is not None:
        pop_summary = pop.population_summary(history)
        pop_memory = pop.memory_report()
        print(f"population {args.population:,} via {args.sampler!r} "
              f"cohorts of {fsl.num_clients}: "
              f"{pop_summary['unique_clients']} unique clients over "
              f"{pop_summary['windows']} windows"
              + (f", per tier { {k: v['participants'] for k, v in pop_summary['per_tier'].items()} }"
                 if pop_summary["per_tier"] else ""))
        if "straggler_seconds" in pop_summary:
            s = pop_summary["straggler_seconds"]
            print(f"cohort straggler seconds: p50={s['p50']:.1f} "
                  f"p90={s['p90']:.1f} p99={s['p99']:.1f} "
                  f"max={s['max']:.1f}")
        print(f"engine memory {pop_memory['engine_total']/2**20:.2f} MiB "
              f"(independent of N) vs dense per-client extrapolation "
              f"{pop_memory['dense_extrapolated']/2**20:.1f} MiB")
    wallclock = None
    if args.network != "ideal" and pop is None:
        # analytic barrier wall-clock under the selected links: the time
        # model the AsyncTrainer measures event for event
        est = trainer.wallclock_estimate(cm, args.batch, args.rounds,
                                         network,
                                         batch=batcher.next_round())
        wallclock = est.as_dict()
        print(f"simulated sync wall-clock ({args.network}, "
              f"{args.bandwidth_mbps:g} Mbps up): {est.total:.1f}s "
              f"({est.comm_time:.1f}s transfer, "
              f"{est.model_sync_time:.1f}s model sync over "
              f"{est.agg_events} aggregations)")
    participation = trainer.participation_summary()
    if participation is not None and "mean_cohort" in participation:
        print(f"scheduler {args.scheduler!r} participation: "
              f"mean cohort {participation['mean_cohort']}/{fsl.num_clients}"
              + (f", per tier {participation['tier_participation']}"
                 if "tier_participation" in participation else ""))
    fault_summary = (participation or {}).get("faults")
    if fault_summary is not None:
        mean_p = fault_summary["mean_participants"]
        print(f"faults {args.faults!r}: {fault_summary['retries']} "
              f"retransmissions "
              f"({fault_summary['retransmit_bytes']/2**20:.2f} MiB burned, "
              f"{fault_summary['retry_seconds']:.1f}s backoff), "
              f"{fault_summary['crash_drops']} crashes, "
              f"{fault_summary['wire_drops']} wire drops, "
              f"{fault_summary['outages']} outages survived; "
              f"mean participants "
              + ("n/a" if mean_p is None else f"{mean_p:.2f}")
              + f"/{fsl.num_clients} over {fault_summary['windows']} windows"
              + (f" ({fault_summary['empty_windows']} empty)"
                 if fault_summary["empty_windows"] else ""))
    if args.out:
        # one flat record with sorted keys (flat_record), the shape the
        # telemetry run summary uses, whichever engine ran
        record = meter.to_record("comm.")
        for prefix, section in (("wallclock.", wallclock),
                                ("participation.", participation),
                                ("population.", pop_summary),
                                ("memory.", pop_memory)):
            if section:
                record.update(flat_record(section, prefix))
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "history": history,
                       "comm": meter.as_dict(), "wallclock": wallclock,
                       "participation": participation,
                       "faults": fault_summary,
                       "population": pop_summary,
                       "memory": pop_memory,
                       "record": record}, f, indent=1)
    if tele is not None:
        if args.telemetry:
            tele.export_jsonl(args.telemetry)
            print(f"telemetry: {len(tele.records)} records -> "
                  f"{args.telemetry}")
        if args.trace:
            tele.export_trace(args.trace)
            print(f"telemetry: {len(tele.spans)} spans -> {args.trace} "
                  f"(open in Perfetto)")
        if args.prom:
            tele.export_prometheus(args.prom)
            print(f"telemetry: {len(tele.counters) + len(tele.gauges)} "
                  f"series -> {args.prom}")
    return state, history


if __name__ == "__main__":
    main()
