#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check
it end to end.  Run from the repo root:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit
   and turns TF32 off for convolutions and matmuls (fp32 comparisons below
   need full fp32);
2. build: compiles the kernels in ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a into ``build/``;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on
   the same inputs, bitwise;
4. main path: CSE-FSL on the full-width CIFAR-10 split CNN through
   ``Trainer.run`` with the int8 uplink codec (then fp8, then deterministic
   int8), checking which kernels each run launched, that losses are finite
   and that the metered bytes equal the analytic CommProfile;
5. CPU vs card: the first rounds on both devices, which draw the same
   Philox bits, agree;
6. times: CUDA-event medians of the kernels, their plain versions and a
   main-path round, beside each kernel's bound.

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the last
``{"ok": true, "device": {...}}``.  The script imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.common import bytes_of  # noqa: E402
from repro_torch.configs.base import FSLConfig  # noqa: E402
from repro_torch.core.accounting import CommMeter, CostModel  # noqa: E402
from repro_torch.core.bundle import cnn_bundle  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.data import (FederatedBatcher, partition_iid,  # noqa: E402
                              synthetic_classification)
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.models.cnn import CIFAR10, stages  # noqa: E402
from repro_torch.transport import Int8Codec, Transport  # noqa: E402

# Main path (benchmarks/fig9_codec_tradeoff.py): CIFAR-10 CNN, 4 clients,
# h=5, B=24, lr=0.15, sgd, int8 uplink -> smashed [24, 6, 6, 64] per client.
N, H, B, LR, SAMPLES, ROUNDS = 4, 5, 24, 0.15, 1200, 10
# H100 SXM published peaks (NVIDIA data sheet): HBM 3.35 TB/s, fp32 outside
# the tensor cores 67 TFLOP/s; int32 at half that (64 INT32 lanes per SM
# beside 128 FP32, Hopper white paper).
HBM_BPS, FP32_OPS, INT32_OPS = 3.35e12, 67e12, 33.5e12
KERNEL_SRC = "src/repro_torch/kernels/csrc/quantize.cu"


def phase(name: str):
    print(f"\n== {name}", flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)
    print(f"  ok  {what}", flush=True)


def fsl_for(codec: str) -> FSLConfig:
    return FSLConfig(num_clients=N, h=H, lr=LR, codec=codec)


def make_data():
    x, y = synthetic_classification(SAMPLES, CIFAR10.in_shape,
                                    CIFAR10.num_classes, signal=12.0)
    return partition_iid(x, y, N)


def payload(n, r, c, seed, wide=False):
    """fp32 [n, r, c] on the CPU; ``wide`` spreads magnitudes over eight
    decades so fp8 codes reach e4m3 subnormals."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, r, c), generator=g) * 2
    if wide:
        x = x * 10.0 ** (-8 * torch.rand((n, r, c), generator=g))
    bits = torch.randint(-2**31, 2**31, (n, r, c), generator=g,
                         dtype=torch.int64).to(torch.int32)
    return x, bits


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors of one dtype, any device."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


def max_abs(q1, s1, q2, s2) -> float:
    """Largest difference of the dequantized payloads."""
    d = qk.dequantize_2d(q1.cpu(), s1.cpu()) - qk.dequantize_2d(q2.cpu(),
                                                                 s2.cpu())
    return float(d.abs().max()) if d.numel() else 0.0


def event_ms(fn, reps: int = 21, inner: int = 50) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls
    between two CUDA events (host launch overhead included)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int = 21, inner: int = 50) -> float:
    """Median device time per call: ``inner`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (no host overhead)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_device():
    """Phase 1: the card's name and power limit; TF32 off."""
    phase("1 device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("  TF32 off for cuDNN convolutions and cuBLAS matmuls (fp32 "
          "comparisons with the CPU need full fp32)")
    return card


def phase_build():
    """Phase 2: nvcc every kernel source (in parallel) into build/."""
    phase("2 build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"  built {sorted(built) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")


def phase_kernels(dev: torch.device):
    """Phase 3: each kernel bitwise against its plain version.  Returns the
    largest dequantized difference seen per kernel."""
    phase("3 kernels vs plain (bitwise)")
    err = {"quantize_bits": 0.0, "quantize_philox": 0.0}
    cases = [((4, 864, 64), False), ((1, 13, 200), False), ((2, 7, 5), False),
             ((2, 16, 256), True)]
    for fmt in ("int8", "fp8"):
        for k, (shape, wide) in enumerate(cases):
            x, bits = payload(*shape, seed=k, wide=wide)
            xd, bd = x.to(dev), bits.to(dev)
            tag = f"{fmt} {list(shape)}{' wide' if wide else ''}"
            for stochastic in (True, False):
                q, s = qk.quantize_2d(xd, bd, fmt=fmt, stochastic=stochastic)
                sync(dev)
                pq, ps = ref.quantize_2d(x, bits, fmt=fmt,
                                         stochastic=stochastic)
                err["quantize_bits"] = max(err["quantize_bits"],
                                           max_abs(q, s, pq, ps))
                check(same(q, pq) and same(s, ps),
                      f"quantize_bits {tag} stochastic={stochastic} == plain")
            seeds = torch.from_numpy(np.random.default_rng(k).integers(
                -2**63, 2**63 - 1, size=shape[0], dtype=np.int64))
            pbits = ref.philox_bits(seeds, *shape[1:])
            q2, s2 = qk.quantize_2d(xd, seeds=seeds.to(dev), fmt=fmt)
            q1, s1 = qk.quantize_2d(xd, pbits.to(dev), fmt=fmt)
            pq, ps = ref.quantize_2d(x, pbits, fmt=fmt)
            sync(dev)
            err["quantize_philox"] = max(err["quantize_philox"],
                                         max_abs(q2, s2, pq, ps))
            check(same(q2, q1) and same(s2, s1),
                  f"quantize_philox {tag} == quantize_bits fed philox_bits")
            check(same(q2, pq) and same(s2, ps),
                  f"quantize_philox {tag} == plain on the CPU fed the CPU's "
                  "philox_bits")
    return err


def drive(bundle, fed, cm, tag, codec, rounds, transport=None):
    """``Trainer.run`` for ``rounds`` rounds with the launch counts set to 0
    just before and read just after; checks losses, device and meter."""
    dev = bundle.device
    tr = Trainer(bundle, fsl_for(codec), transport=transport)
    meter = CommMeter()
    state = tr.init(0)
    batcher = FederatedBatcher(fed, B, H, seed=0)
    sync(dev)
    qk.reset_launches()
    t = time.perf_counter()
    state, hist = tr.run(state, batcher, rounds, log_every=1, meter=meter,
                         cost_model=cm)
    sync(dev)
    dt = time.perf_counter() - t
    launches = dict(qk.LAUNCHES)
    print(f"  [{tag}] {rounds} rounds in {dt:.3f} s; launches {launches}")
    for row in hist:
        print(f"    round {row['round']:2d} client_loss "
              f"{row['client_loss']:.6f} server_loss "
              f"{row['server_loss']:.6f} aggregated {row['aggregated']}")
    check(all(math.isfinite(row[k]) for row in hist
              for k in ("client_loss", "server_loss")),
          f"[{tag}] losses finite")
    check(all(t.device.type == dev.type
              for t in state["server"]["params"].values()),
          f"[{tag}] state stayed on {dev}")
    prof = tr.comm_profile(cm, B, batch=batcher.next_round())
    want = {"uplink_smashed": rounds * prof.wire_uplink_smashed,
            "uplink_labels": rounds * prof.uplink_labels,
            "downlink_grads": 0,
            "model_sync": sum(r["aggregated"] for r in hist)
            * prof.wire_model_sync}
    want["total"] = sum(want.values())
    check(meter.as_dict() == want,
          f"[{tag}] CommMeter {meter.as_dict()} == CommProfile")
    return tr, state, hist, meter, launches


def phase_main(dev: torch.device):
    """Phase 4: the main path and its variants through Trainer.run."""
    phase("4 main path: CSE-FSL, CIFAR-10 CNN full width, Trainer.run")
    bundle = cnn_bundle(CIFAR10, device=dev)
    fed = make_data()
    cm = CostModel(n=N, q=bundle.smashed_bytes_per_sample,
                   d_local=SAMPLES // N,
                   w_client=bytes_of(bundle.specs["client"]),
                   w_server=bytes_of(bundle.specs["server"]),
                   aux=bytes_of(bundle.specs["aux"]))
    launches = {}
    tr8, state8, hist8, meter8, launches["int8"] = drive(
        bundle, fed, cm, "int8", "int8", ROUNDS)
    check(launches["int8"] == {"quantize_bits": 0,
                               "quantize_philox": ROUNDS},
          f"int8 main path: quantize_philox launched once per round "
          f"({ROUNDS}), quantize_bits never")
    check(meter8.counts["uplink_smashed"] == ROUNDS * N * 55_728,
          f"int8 uplink = {ROUNDS} rounds x {N} clients x 55,728 B")
    check(sum(r["aggregated"] for r in hist8) == ROUNDS,
          "FedAvg every round (C = h)")
    *_, launches["fp8"] = drive(bundle, fed, cm, "fp8", "fp8", 3)
    check(launches["fp8"] == {"quantize_bits": 0, "quantize_philox": 3},
          "fp8 path: quantize_philox once per round")
    *_, launches["int8-deterministic"] = drive(
        bundle, fed, cm, "int8-deterministic", "int8", 2,
        transport=Transport(uplink=Int8Codec(stochastic=False)))
    check(launches["int8-deterministic"] == {"quantize_bits": 2,
                                             "quantize_philox": 0},
          "deterministic int8 path: quantize_bits once per round")
    xt, yt = synthetic_classification(400, CIFAR10.in_shape, 10, seed=99,
                                      signal=12.0)
    mp = tr8.merged_params(state8)
    with torch.no_grad():
        sm = bundle.client_smashed(mp["client"], torch.from_numpy(xt).to(dev))
        logits = torch.func.functional_call(stages(CIFAR10)["server"],
                                            mp["server"], (sm,))
    acc = float((logits.argmax(-1).cpu().numpy() == yt).mean())
    print(f"  held-out accuracy after {ROUNDS} int8 rounds: {acc:.4f}")
    return launches, tr8, state8, fed


def phase_cpu_vs(dev: torch.device, fed):
    """Phase 5: the same first rounds on the CPU and on ``dev``."""
    phase("5 CPU vs card: the same 2 rounds, the same Philox bits")
    hists = {}
    for d in ("cpu", dev):
        tr = Trainer(cnn_bundle(CIFAR10, device=d), fsl_for("int8"))
        _, hists[str(d)] = tr.run(tr.init(0),
                                  FederatedBatcher(fed, B, H, seed=0), 2,
                                  log_every=1)
    for rc, rg in zip(hists["cpu"], hists[str(dev)]):
        for k in ("client_loss", "server_loss"):
            print(f"    round {rc['round']} {k}: cpu {rc[k]:.7f} "
                  f"{dev} {rg[k]:.7f}")
            check(math.isclose(rc[k], rg[k], rel_tol=1e-3),
                  f"round {rc['round']} {k} agrees at rtol 1e-3")


def phase_times(dev: torch.device, err, launches, tr, state, fed):
    """Phase 6: kernel, plain-version and round times beside the bounds."""
    phase("6 times (CUDA events, medians)")
    n, r, c = N, B * 6 * 6, 64
    x, bits = payload(n, r, c, seed=7)
    xd, bd = x.to(dev), bits.to(dev)
    seeds = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    elems = n * r * c
    tiles = n * -(-r // ref.BT) * -(-c // ref.BC)
    # bytes each input read once, each output written once
    io = {"quantize_bits": elems * (4 + 4 + 1) + tiles * 4,
          "quantize_philox": elems * (4 + 1) + tiles * 4 + n * 8}
    # fp32 per element: |x|, max, divide, u scale, add, floor, 2 clamps;
    # int32 per element: shift/mask of the bits and the store index, plus,
    # for Philox4x32-10, per 4 elements 10 rounds of 2 mulhi + 2 mullo +
    # 4 xor + 2 key adds
    fp_ops = 8 * elems
    int_ops = {"quantize_bits": 2 * elems,
               "quantize_philox": 2 * elems + (elems // 4) * 10 * 10}
    run = {"quantize_bits": lambda: qk.quantize_2d(xd, bd),
           "quantize_philox": lambda: qk.quantize_2d(xd, seeds=seeds)}
    plain = {"quantize_bits": lambda: ref.quantize_2d(xd, bd),
             "quantize_philox": lambda: ref.quantize_2d(
                 xd, ref.philox_bits(seeds.cpu(), r, c).to(dev))}
    replaces = {"quantize_bits": "src/repro/kernels/quantize.py:174",
                "quantize_philox": "src/repro/kernels/quantize.py:162"}
    path_of = {"quantize_bits": "int8-deterministic",
               "quantize_philox": "int8"}
    records = []
    for name in ("quantize_bits", "quantize_philox"):
        ms = graph_ms(run[name])
        eager = event_ms(run[name])
        plain_ms = event_ms(plain[name], reps=11, inner=10)
        bytes_ms = io[name] / HBM_BPS * 1e3
        ops_ms = (fp_ops / FP32_OPS + int_ops[name] / INT32_OPS) * 1e3
        bound = max(bytes_ms, ops_ms)
        records.append({
            "name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": replaces[name],
            "launches": launches[path_of[name]][name],
            "launches_path": path_of[name],
            "max_abs_err": err[name], "ms": ms, "eager_ms": eager,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": io[name], "library_ms": None})
        print(f"  {name}: {ms * 1e3:.3f} us/launch on device (graph replay),"
              f" {eager * 1e3:.3f} us per wrapper call, plain "
              f"{plain_ms * 1e3:.3f} us, bound {bound * 1e3:.3f} us "
              f"({records[-1]['bound_by']})")

    batch = tr.to_device(FederatedBatcher(fed, B, H, seed=1).next_round())
    for _ in range(2):
        state, _ = tr.step(state, batch, LR)
    sync(dev)
    per = []
    for _ in range(7):
        t = time.perf_counter()
        state, m = tr.step(state, batch, LR)
        state = tr.aggregate(state)
        float(m["server_loss"])
        sync(dev)
        per.append((time.perf_counter() - t) * 1e3)
    round_ms = statistics.median(per)
    print(f"  main-path round (int8, n={N}, h={H}, B={B}, step + FedAvg, "
          f"host clock after synchronize): median {round_ms:.3f} ms of "
          f"{[round(p, 3) for p in per]}")

    # where the time goes: device kernel time per round (kernel events
    # only; CPU-side aten events also carry their children's device time)
    # against the unprofiled round time above
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            state, m = tr.step(state, batch, LR)
            state = tr.aggregate(state)
        sync(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    if busy_ms > 0:
        print(f"  profiler: {busy_ms:.3f} ms of device kernel time per round"
              f" ({sum(e.count for e in kernels) / 3:.0f} kernels) -> device"
              f" idle share {1 - busy_ms / round_ms:.4f} of the {round_ms:.3f}"
              " ms round")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / 3e3:8.3f} ms/round "
                  f"{e.count / 3:6.1f}x  {e.key[:80]}")
    else:
        print("  profiler recorded no device time: idle share not measured")
    return records, round_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = phase_device()
    phase_build()
    err = phase_kernels(dev)
    launches, tr, state, fed = phase_main(dev)
    phase_cpu_vs(dev, fed)
    records, round_ms = phase_times(dev, err, launches, tr, state, fed)
    print(card)
    print(json.dumps({"kernels": records, "round_ms": round_ms,
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
