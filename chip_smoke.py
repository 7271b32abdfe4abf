#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check
it end to end.  Run from the repo root:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit
   and turns TF32 off for convolutions and matmuls (fp32 comparisons below
   need full fp32);
2. build: compiles the kernels in ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a into ``build/``, one nvcc per source, all at once;
3. quantizer vs plain: both quantize kernels against their plain PyTorch
   version on the same inputs, bitwise;
4. CNN main path: CSE-FSL on the full-width CIFAR-10 split CNN through
   ``Trainer.run`` with the int8 uplink codec (then fp8, then deterministic
   int8), checking which kernels each run launched, that losses are finite
   and that the metered bytes equal the analytic CommProfile;
5. CNN CPU vs card: the first rounds on both devices, which draw the same
   Philox bits, agree;
6. CNN times: CUDA-event medians of the quantize kernels, their plain
   versions and a CNN round, beside each kernel's bound;
7. LM kernels vs plain: the fused cross-entropy kernels (K3 forward, K4a
   dx, K4b dw; bf16 also at d = 100, which runs zero-padded) and
   sliding-window attention (K6: the tensor-core kernel in bf16, the
   CUDA-core one in fp32 and at zamba2-7b's hd = 112 in bf16) against their
   plain versions at the main path's shapes and at ragged small ones, K3
   and the bf16 K6 bitwise repeatable, and ``fused_ce_bwd`` at every case
   bitwise repeatable, bitwise equal to K4a and K4b run alone and so held
   against the same plain versions;
8. LM main path: CSE-FSL on full-width Qwen3-0.6B (bf16, the kernels on)
   through ``Trainer.run``, with per-round launch counts of every kernel,
   finite losses, state on the card and the meter equal to CommProfile;
9. LM CPU vs card: reduced Qwen3 in fp32, the kernels on the card (the
   CUDA-core K6) and the plain versions on the CPU, agree over 2 rounds;
10. LM times: the kernels and ``fused_ce_bwd``, their plain versions and
   library yardsticks (SDPA with the band mask and, where the window
   covers the sequence, ``is_causal`` for K6; ``cross_entropy(linear(x,
   w^T))`` for K3/K4) at the main shapes, the CUDA-core K6 in fp32 at the
   server's shape, and a main-path round with its device time, idle
   share, top kernels and peak memory;
11. Mamba kernels vs plain: the selective scan's forward (K5, y and the
   saved boundary states) and backward (its scan kernel and the kernel
   adding its partials: all six gradients) at the main path's shapes (4
   clients folded with their own a and d; one server sequence), at
   tests/test_kernels.py's fp32 cases and at ragged fp32 ones (S, D off
   the tiles; N in {1, 5, 64}), each bitwise repeatable, and the fused CE
   kernels at falcon-mamba's server and aux heads and at ragged shapes
   past d = 1024 (d = 1536, 4096, 8192) in both dtypes, ``fused_ce_bwd``
   as in phase 7;
12. Mamba main path: CSE-FSL on full-width falcon-mamba-7b (16 layers cut
   at 8, S = 2048, bf16, the kernels on) through ``Trainer.run``, with
   per-round launch counts (the scan's backward kernels included, and the
   plain scan backward never called), finite losses, state on the card,
   the meter equal to CommProfile and the peak device memory;
13. Mamba CPU vs card: reduced falcon-mamba in fp32, the kernels on the
   card (K5's backward included) and the plain versions on the CPU, agree
   over 2 rounds;
14. Mamba times: K5's forward, its backward's two kernels and the d = 4096
   fused CE kernels beside their bounds, plain versions and library
   yardsticks, at the server's and the folded clients' shapes, and a
   main-path round with its device time, idle share, top kernels and peak
   memory.

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

# Before torch starts the card's caching allocator: the Mamba main path's
# round leaves 30 GB reserved but unallocated in fragments when its update
# needs one 8 GiB block, so let segments grow instead.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.common import bytes_of, tree_leaves  # noqa: E402
from repro_torch.configs.base import FSLConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.accounting import CommMeter, CostModel  # noqa: E402
from repro_torch.core.bundle import cnn_bundle, transformer_bundle  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.data import (FederatedBatcher, partition_iid,  # noqa: E402
                              synthetic_classification)
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import fused_ce as ce  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402
from repro_torch.kernels import swa_attention as swa  # noqa: E402
from repro_torch.launch.train import LMBatcher, build_data  # noqa: E402
from repro_torch.models.cnn import CIFAR10, stages  # noqa: E402
from repro_torch.transport import Int8Codec, Transport  # noqa: E402

# CNN main path (benchmarks/fig9_codec_tradeoff.py): CIFAR-10 CNN, 4
# clients, h=5, B=24, lr=0.15, sgd, int8 uplink -> smashed [24, 6, 6, 64].
N, H, B, LR, SAMPLES, ROUNDS = 4, 5, 24, 0.15, 1200, 10
# LM main path: full-width qwen3-0.6b (configs/qwen3_0_6b.py) with the
# kernels on, bf16, swa_window 4096; n=4 clients, h=2, B=1, S=4096, sgd at
# the training CLI's default lr 0.1, int8 uplink, 3 rounds, 8 sequences
# per client.
LM_N, LM_H, LM_B, LM_S, LM_LR, LM_ROUNDS, LM_SAMPLES = 4, 2, 1, 4096, 0.1, 3, 8
# Mamba main path: full-width falcon-mamba-7b (configs/falcon_mamba_7b.py)
# cut from 64 to 16 layers (8 client, 8 server) with the kernels on, bf16,
# and the LM path's n, h, B, lr, codec, rounds and data, at S = 2048: at
# S = 4096 the client phase (4 clients x 8 layers of saved activations,
# no remat, and torch.func.grad's create_graph=True keeping every
# backward temporary until the backward ends) does not fit in 80 GB.
MB_LAYERS, MB_S = 16, 2048
# H100 SXM published peaks (NVIDIA data sheet): HBM 3.35 TB/s, bf16 tensor
# cores 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s; int32 at
# half that (64 INT32 lanes per SM beside 128 FP32, Hopper white paper);
# exp on the special-function units, 16 per clock per SM (NVIDIA's
# arithmetic-throughput table, compute capability 9.0) at the 1.98 GHz
# boost clock on 132 SMs.
HBM_BPS, BF16_OPS, FP32_OPS, INT32_OPS = 3.35e12, 989e12, 67e12, 33.5e12
SFU_EXPS = 16 * 132 * 1.98e9
CSRC = "src/repro_torch/kernels/csrc/"
REPLACES = {"quantize_bits": "src/repro/kernels/quantize.py:174",
            "quantize_philox": "src/repro/kernels/quantize.py:162",
            "fused_ce_fwd": "src/repro/kernels/fused_ce.py:87",
            "fused_ce_dx": "src/repro/kernels/fused_ce.py:186",
            "fused_ce_dw": "src/repro/kernels/fused_ce.py:201",
            "fused_ce_bwd": "src/repro/kernels/fused_ce.py:186",
            "swa_attention": "src/repro/kernels/swa_attention.py:94",
            "swa_attention_tc": "src/repro/kernels/swa_attention.py:94",
            "ssm_scan": "src/repro/kernels/ssm_scan.py:63",
            # no TPU kernel: the JAX package's jax.vjp of selective_scan
            "ssm_scan_bwd": "src/repro/kernels/ops.py:113",
            "ssm_scan_bwd_sum": "src/repro/kernels/ops.py:113"}
SOURCE = {"quantize_bits": "quantize.cu", "quantize_philox": "quantize.cu",
          "fused_ce_fwd": "fused_ce.cu", "fused_ce_dx": "fused_ce.cu",
          "fused_ce_dw": "fused_ce.cu", "fused_ce_bwd": "fused_ce.cu",
          "swa_attention": "swa_attention.cu",
          "swa_attention_tc": "swa_attention.cu",
          "ssm_scan": "ssm_scan.cu", "ssm_scan_bwd": "ssm_scan.cu",
          "ssm_scan_bwd_sum": "ssm_scan.cu"}
# K3/K4 cases (G, T, d, V): the aux head's and the server head's, then
# ragged ones in both dtypes (bf16 and fp32 take different kernels; bf16 at
# d = 100 runs zero-padded to 104); K6 cases (B, S, H, KH, hd, W): the main
# path's and a longer one the window cuts, ragged ones for the tensor-core
# kernel (S not a multiple of 128, windows that cut the kv tiles, hd = 64),
# zamba2-7b's attention (hd = 112, the CUDA-core kernel in bf16), then
# tests/test_kernels.py's four in fp32.
CE_CASES = [((4, 4096, 128, 151936), torch.bfloat16),
            ((1, 4096, 1024, 151936), torch.bfloat16),
            ((2, 100, 72, 1000), torch.bfloat16),
            ((3, 37, 16, 130), torch.bfloat16),
            ((2, 100, 100, 1000), torch.bfloat16),
            ((1, 100, 72, 1000), torch.float32),
            ((3, 37, 16, 130), torch.float32)]
# falcon-mamba's heads (G, T, d, V), then ragged cases past d = 1024.
MB_CE_CASES = [((1, MB_S, 4096, 65024), torch.bfloat16),
               ((4, MB_S, 128, 65024), torch.bfloat16),
               ((1, 4096, 4096, 65024), torch.bfloat16),
               ((1, 100, 1536, 1000), torch.bfloat16),
               ((2, 37, 8192, 130), torch.bfloat16),
               ((1, 100, 1536, 1000), torch.float32),
               ((1, 64, 4096, 300), torch.float32),
               ((2, 37, 8192, 130), torch.float32)]
# K5 cases (B, S, D, N, G): the client fold (4 clients, each its own a and
# d) and one server sequence, at the main path's S and at S = 4096, then
# tests/test_kernels.py's four in fp32, then ragged ones in fp32: S not a
# multiple of the 128-step chunk, D not a multiple of the 32-channel slab,
# N in {1, 5, 64} (64: two groups of 32 states, summed in fp32).
SSM_CASES = [((4, MB_S, 8192, 16, 4), torch.bfloat16),
             ((1, MB_S, 8192, 16, 1), torch.bfloat16),
             ((4, 4096, 8192, 16, 4), torch.bfloat16)] + [
    ((b, s, d, n, 1), torch.float32) for b, s, d, n in
    ((1, 16, 8, 4), (2, 64, 32, 16), (2, 128, 64, 16), (1, 32, 128, 8))] + [
    ((b, s, d, n, g), torch.float32) for b, s, d, n, g in
    ((2, 300, 100, 5, 2), (1, 200, 40, 1, 1), (2, 130, 70, 64, 1))]
SSM_GRADS = ("du", "ddt", "da", "db", "dc", "dd")
SWA_CASES = [((4, 4096, 16, 8, 128, 4096), torch.bfloat16),
             ((1, 8192, 16, 8, 128, 4096), torch.bfloat16),
             ((1, 777, 8, 2, 128, 200), torch.bfloat16),
             ((2, 1000, 4, 2, 64, 300), torch.bfloat16),
             ((1, 4096, 32, 32, 112, 4096), torch.bfloat16)] + [
    (c, torch.float32) for c in ((1, 128, 2, 2, 16, 32),
                                 (1, 256, 4, 2, 32, 64),
                                 (2, 128, 4, 1, 16, 128),
                                 (1, 256, 2, 2, 64, 200))]


def phase(name: str):
    print(f"\n== {name}", flush=True)
    return time.perf_counter()


def done(t0: float):
    print(f"  phase wall time {time.perf_counter() - t0:.3f} s", flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)
    print(f"  ok  {what}", flush=True)


def reset_counts():
    for mod in (qk, ce, swa, ssm):
        mod.reset_launches()


def counts() -> dict:
    return {**qk.LAUNCHES, **ce.LAUNCHES, **swa.LAUNCHES, **ssm.LAUNCHES}


def only(**kw) -> dict:
    """All launch counts 0 except ``kw``."""
    return {**{k: 0 for k in counts()}, **kw}


def fsl_for(codec: str) -> FSLConfig:
    return FSLConfig(num_clients=N, h=H, lr=LR, codec=codec)


def make_data():
    x, y = synthetic_classification(SAMPLES, CIFAR10.in_shape,
                                    CIFAR10.num_classes, signal=12.0)
    return partition_iid(x, y, N)


def cost_model(bundle, n, d_local):
    return CostModel(n=n, q=bundle.smashed_bytes_per_sample, d_local=d_local,
                     w_client=bytes_of(bundle.specs["client"]),
                     w_server=bytes_of(bundle.specs["server"]),
                     aux=bytes_of(bundle.specs["aux"]))


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


def diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def event_ms(fn, reps: int = 21, inner: int = 50, warm: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls
    between two CUDA events (host launch overhead included)."""
    for _ in range(warm):
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
    del g
    return statistics.median(times)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def phase_device():
    """Phase 1: the card's name and power limit; TF32 off."""
    t0 = phase("1 device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}; {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("  TF32 off for cuDNN convolutions and cuBLAS matmuls (fp32 "
          "comparisons with the CPU need full fp32)")
    done(t0)
    return card


def phase_build():
    """Phase 2: nvcc every kernel source (in parallel) into build/."""
    t0 = phase("2 build")
    built = _build.build()
    print(f"  built {sorted(built) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "warning",
                                       "wgmma")):
                print(f"  ptxas[{name}] {line.strip()}")
    done(t0)


def phase_kernels(dev: torch.device):
    """Phase 3: each quantize kernel bitwise against its plain version.
    Returns the largest dequantized difference seen per kernel."""
    t0 = phase("3 quantizer vs plain (bitwise)")
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
    done(t0)
    return err


def drive(tr, make_batcher, cm, tag, rounds, batch_size):
    """``Trainer.run`` for ``rounds`` rounds with the launch counts set to 0
    just before and read just after (and after every round); checks losses,
    device and meter.  Returns the state, history, meter, the run's launch
    counts and each round's."""
    dev = tr.device
    meter = CommMeter()
    state = tr.init(0)
    batcher = make_batcher()
    after = []
    sync(dev)
    reset_counts()
    t = time.perf_counter()
    state, hist = tr.run(state, batcher, rounds, log_every=1, meter=meter,
                         cost_model=cm,
                         callback=lambda *_: after.append(counts()))
    sync(dev)
    dt = time.perf_counter() - t
    launches = counts()
    per_round = [{k: c[k] - (after[i - 1][k] if i else 0) for k in c}
                 for i, c in enumerate(after)]
    print(f"  [{tag}] {rounds} rounds in {dt:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    for row in hist:
        print(f"    round {row['round']:2d} client_loss "
              f"{row['client_loss']:.6f} server_loss "
              f"{row['server_loss']:.6f} aggregated {row['aggregated']}")
    check(all(math.isfinite(row[k]) for row in hist
              for k in ("client_loss", "server_loss")),
          f"[{tag}] losses finite")
    check(all(t.device.type == torch.device(dev).type
              for t in tree_leaves(state["server"]["params"])
              + tree_leaves(state["clients"]["params"])),
          f"[{tag}] state stayed on {dev}")
    prof = tr.comm_profile(cm, batch_size, batch=batcher.next_round())
    want = {"uplink_smashed": rounds * prof.wire_uplink_smashed,
            "uplink_labels": rounds * prof.uplink_labels,
            "downlink_grads": 0,
            "model_sync": sum(r["aggregated"] for r in hist)
            * prof.wire_model_sync}
    want["total"] = sum(want.values())
    check(meter.as_dict() == want,
          f"[{tag}] CommMeter {meter.as_dict()} == CommProfile")
    return state, hist, meter, launches, per_round


def phase_main(dev: torch.device):
    """Phase 4: the CNN main path and its variants through Trainer.run."""
    t0 = phase("4 CNN main path: CSE-FSL, CIFAR-10 CNN full width, "
               "Trainer.run")
    bundle = cnn_bundle(CIFAR10, device=dev)
    fed = make_data()
    cm = cost_model(bundle, N, SAMPLES // N)

    def run(tag, codec, rounds, transport=None):
        tr = Trainer(bundle, fsl_for(codec), transport=transport)
        return (tr, *drive(tr, lambda: FederatedBatcher(fed, B, H, seed=0),
                           cm, tag, rounds, B))

    launches = {}
    tr8, state8, hist8, meter8, launches["int8"], _ = run("int8", "int8",
                                                          ROUNDS)
    check(launches["int8"] == only(quantize_philox=ROUNDS),
          f"int8 main path: quantize_philox launched once per round "
          f"({ROUNDS}), no other kernel")
    check(meter8.counts["uplink_smashed"] == ROUNDS * N * 55_728,
          f"int8 uplink = {ROUNDS} rounds x {N} clients x 55,728 B")
    check(sum(r["aggregated"] for r in hist8) == ROUNDS,
          "FedAvg every round (C = h)")
    *_, launches["fp8"], _ = run("fp8", "fp8", 3)
    check(launches["fp8"] == only(quantize_philox=3),
          "fp8 path: quantize_philox once per round")
    *_, launches["int8-deterministic"], _ = run(
        "int8-deterministic", "int8", 2,
        transport=Transport(uplink=Int8Codec(stochastic=False)))
    check(launches["int8-deterministic"] == only(quantize_bits=2),
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
    done(t0)
    return launches, tr8, state8, fed


def compare_rounds(hists, dev, rtol):
    for rc, rg in zip(hists["cpu"], hists[str(dev)]):
        for k in ("client_loss", "server_loss"):
            print(f"    round {rc['round']} {k}: cpu {rc[k]:.7f} "
                  f"{dev} {rg[k]:.7f}")
            check(math.isclose(rc[k], rg[k], rel_tol=rtol),
                  f"round {rc['round']} {k} agrees at rtol {rtol:g}")


def phase_cpu_vs(dev: torch.device, fed):
    """Phase 5: the same first CNN rounds on the CPU and on ``dev``."""
    t0 = phase("5 CNN CPU vs card: the same 2 rounds, the same Philox bits")
    hists = {}
    for d in ("cpu", dev):
        tr = Trainer(cnn_bundle(CIFAR10, device=d), fsl_for("int8"))
        _, hists[str(d)] = tr.run(tr.init(0),
                                  FederatedBatcher(fed, B, H, seed=0), 2,
                                  log_every=1)
    compare_rounds(hists, dev, 1e-3)
    done(t0)


def profile_round(step, rounds: int, round_ms: float, top: int = 8):
    """Device kernel time per round over ``rounds`` profiled rounds against
    the unprofiled round time.  Traces the card only: host-side op events
    add nothing to the kernel times and, at the Mamba round's 100,000
    launches, minutes of the profiler's own time."""
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"  profiled {rounds} round(s) in {time.perf_counter() - t0:.3f} s")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / rounds
    if busy_ms <= 0:
        print("  profiler recorded no device time: idle share not measured")
        return None, None
    idle = 1 - busy_ms / round_ms
    print(f"  profiler: {busy_ms:.3f} ms of device kernel time per round"
          f" ({sum(e.count for e in kernels) / rounds:.0f} kernels) -> device"
          f" idle share {idle:.4f} of the {round_ms:.3f} ms round")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / rounds / 1e3:10.3f} ms/round "
              f"{e.count / rounds:7.1f}x  {e.key[:80]}")
    return busy_ms, idle


def time_rounds(step, n: int):
    per = []
    for _ in range(n):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t) * 1e3)
    return statistics.median(per), per


def record(name, launches, err, ms, eager, plain_ms, bytes_, ops, peak,
           library_ms=None, **extra):
    bytes_ms = bytes_ / HBM_BPS * 1e3
    ops_ms = ops / peak * 1e3
    return {"name": name, "route": "cuda", "source": CSRC + SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "eager_ms": eager,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_, "library_ms": library_ms, **extra}


def print_record(r):
    lib = "null" if r["library_ms"] is None \
        else f"{r['library_ms'] * 1e3:.3f} us"
    print(f"  {r['name']}: {r['ms'] * 1e3:.3f} us/launch on device (graph "
          f"replay), {r['eager_ms'] * 1e3:.3f} us per wrapper call, plain "
          f"{r['plain_ms'] * 1e3:.3f} us, bound {r['bound_ms'] * 1e3:.3f} us "
          f"({r['bound_by']}), library {lib}")


def phase_times(dev: torch.device, err, launches, tr, state, fed):
    """Phase 6: quantize kernel, plain-version and CNN round times beside
    the bounds."""
    t0 = phase("6 CNN times (CUDA events, medians)")
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
    # 4 xor + 2 key adds; expressed as fp32-rate operations
    fp_ops = 8 * elems
    int_ops = {"quantize_bits": 2 * elems,
               "quantize_philox": 2 * elems + (elems // 4) * 10 * 10}
    run = {"quantize_bits": lambda: qk.quantize_2d(xd, bd),
           "quantize_philox": lambda: qk.quantize_2d(xd, seeds=seeds)}
    plain = {"quantize_bits": lambda: ref.quantize_2d(xd, bd),
             "quantize_philox": lambda: ref.quantize_2d(
                 xd, ref.philox_bits(seeds.cpu(), r, c).to(dev))}
    path_of = {"quantize_bits": "int8-deterministic",
               "quantize_philox": "int8"}
    records = []
    for name in ("quantize_bits", "quantize_philox"):
        ops = fp_ops + int_ops[name] * FP32_OPS / INT32_OPS
        records.append(record(
            name, launches[path_of[name]][name], err[name],
            graph_ms(run[name]), event_ms(run[name]),
            event_ms(plain[name], reps=11, inner=10), io[name], ops,
            FP32_OPS, launches_path=path_of[name]))
        print_record(records[-1])

    batch = tr.to_device(FederatedBatcher(fed, B, H, seed=1).next_round())
    box = {"state": state}

    def step():
        st, m = tr.step(box["state"], batch, LR)
        box["state"] = tr.aggregate(st)
        float(m["server_loss"])

    for _ in range(2):
        step()
    round_ms, per = time_rounds(step, 7)
    print(f"  CNN round (int8, n={N}, h={H}, B={B}, step + FedAvg, "
          f"host clock after synchronize): median {round_ms:.3f} ms of "
          f"{[round(p, 3) for p in per]}")
    profile_round(step, 3, round_ms)
    done(t0)
    return records, round_ms


# ---------------------------------------------------------------------------
# The LM path: full-width Qwen3-0.6B
# ---------------------------------------------------------------------------


def ce_inputs(g, t, d, v, dtype, seed, dev):
    """x ~ N(0, 1), w ~ N(0, 1/d) (the head's init scale), random labels,
    per-group loss cotangents g in [0.5, 1.5]."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((g, t, d), generator=gen).to(dtype)
    w = (torch.randn((g, d, v), generator=gen) * d ** -0.5).to(dtype)
    lab = torch.randint(0, v, (g, t), generator=gen).to(torch.int32)
    gs = torch.linspace(0.5, 1.5, g) if g > 1 else torch.ones(1)
    return [a.to(dev) for a in (x, w, lab, gs)]


def swa_inputs(b, s, h, kh, hd, dtype, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, n, hd), generator=gen).to(dtype).to(dev)
            for n in (h, kh, kh)]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, ulps: int = 2) -> bool:
    """|a - b| within ``ulps`` bf16 ulps of max|b|."""
    m = float(b.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0
    return diff(a, b) <= ulps * ulp


def worst_ratio(got: torch.Tensor, want: torch.Tensor,
                bound: torch.Tensor) -> float:
    """max over elements of |got - want| / bound (<= 1 passes)."""
    return float(((got.float() - want).abs_() / bound).max())


def ce_abs_grads(x, w, lab, lse, gs):
    """fp32 ``(|P| |w|^T, |x|^T |P|)`` per element, P as the kernels
    recompute it: rounding every entry of P to bf16 moves dx and dw by at
    most 2^-8 of these."""
    wf = w.float()
    wa = wf.abs().transpose(1, 2)
    adx = []
    adw = torch.zeros(wf.shape, dtype=torch.float32, device=w.device)
    for xc, p in ref._ce_p(x, wf, lab, lse, gs):
        p.abs_()
        adx.append(p @ wa)
        adw += xc.abs().transpose(1, 2) @ p
    return {"fused_ce_dx": torch.cat(adx, 1), "fused_ce_dw": adw}


def check_ce(cases, err, dev):
    """K3/K4a/K4b at ``cases`` against their plain versions (phase 7's
    bounds, see ``phase_lm_kernels``); the largest differences go into
    ``err``."""
    for k, ((g, t, d, v), dtype) in enumerate(cases):
        x, w, lab, gs = ce_inputs(g, t, d, v, dtype, k, dev)
        tag = f"[{g}, {t}, {d}, {v}] {str(dtype)[6:]}"
        lse, picked = ce.fused_ce_fwd(x, w, lab)
        plse, ppicked = ref.fused_ce_fwd(x, w, lab)
        sync(dev)
        # tests/test_kernels.py: fp32 1e-5; bf16 2e-3
        tol = 1e-5 if dtype == torch.float32 else 2e-3
        e = max(diff(lse, plse), diff(picked, ppicked))
        err["fused_ce_fwd"] = max(err["fused_ce_fwd"], e)
        check(torch.allclose(lse, plse, rtol=tol, atol=tol)
              and torch.allclose(picked, ppicked, rtol=tol, atol=tol),
              f"fused_ce_fwd {tag} == plain at {tol:g} (max |diff| {e:.3g})")
        if dtype == torch.bfloat16:
            check(e <= 1e-4, f"fused_ce_fwd {tag} lse, picked within 1e-4 "
                  f"(max |diff| {e:.3g})")
        again = ce.fused_ce_fwd(x, w, lab)
        sync(dev)
        check(same(lse, again[0]) and same(picked, again[1]),
              f"fused_ce_fwd {tag} bitwise equal lse and picked on two calls")
        del again
        absg = ce_abs_grads(x, w, lab, plse, gs) \
            if dtype == torch.bfloat16 else None
        bwd = ce.fused_ce_bwd(x, w, lab, plse, gs)
        again = ce.fused_ce_bwd(x, w, lab, plse, gs)
        sync(dev)
        check(all(same(a, b) for a, b in zip(bwd, again)),
              f"fused_ce_bwd {tag} bitwise equal dx and dw on two calls")
        del again
        for i, name in enumerate(("fused_ce_dx", "fused_ce_dw")):
            got = getattr(ce, name)(x, w, lab, plse, gs)
            want = getattr(ref, name)(x, w, lab, plse, gs)
            sync(dev)
            check(same(bwd[i], got), f"fused_ce_bwd {tag} {name[-2:]} "
                  f"(one shared P pass) bitwise equal to {name} alone")
            e = diff(got, want)
            err[name] = max(err[name], e)
            err["fused_ce_bwd"] = max(err["fused_ce_bwd"],
                                      diff(bwd[i], want))
            if dtype == torch.float32:       # tests/test_kernels.py grads
                ok, how = torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
                    "rtol 1e-4 atol 1e-5"
            else:
                ok, how = bf16_ulps(got, want), "2 bf16 ulps of max|plain|"
            check(ok and got.dtype == want.dtype,
                  f"{name} {tag} == plain within {how} (max |diff| {e:.3g})")
            if dtype == torch.bfloat16:
                del want
                want = getattr(ref, name)(x.float(), w.float(), lab, plse, gs)
                bound = absg.pop(name).add_(want.abs()).mul_(2.0 ** -7)
                r = worst_ratio(got, want, bound)
                check(r <= 1.0, f"{name} {tag} per element within 2^-7 "
                      f"(|plain fp32| + |P| products) (worst |diff|/bound "
                      f"{r:.3g})")
                del bound
            del got, want
        del bwd
        del x, w, lab, lse, picked, plse, ppicked
        torch.cuda.empty_cache()



def phase_lm_kernels(dev):
    """Phase 7: K3/K4a/K4b/K6 against their plain versions on the card.
    Returns the largest difference seen per kernel.

    Each case first meets the tolerance of tests/test_kernels.py.  bf16
    cases then meet a bound per element against the plain version in fp32
    on the same inputs, tight enough that the small terms (the softmax part
    of the CE gradients, one kv tile of a window) must be right:
    * K3: lse and picked within 1e-4.  Both sum exact products of the bf16
      inputs in fp32, so only the order of summation separates them; one
      128-column vocab tile left out moves lse by about 128/V, >= 8e-4 at
      the main path's heads.
    * K4a/K4b: |got - plain| <= 2^-7 (|plain| + |P||w|^T) for dx and
      2^-7 (|plain| + |x|^T|P|) for dw.  The kernels round P to bf16 and
      their output to bf16, each at most 2^-8 of those; the bound allows
      twice that.  In a dw column no label lands in (all but ~4,000 of
      the 151,936) the softmax part is the whole value, and in dx it is
      larger than 2^-7 of the one-hot part for most elements.  At every
      case fused_ce_bwd (one P pass shared by dx and dw) must give the same
      bits on two calls and the bits of K4a and K4b alone (every output
      has one owner and a fixed summation order), so it meets their
      bounds; its max_abs_err is its own outputs' against the plain.
    * K6 in bf16 (the tensor-core kernel): |got - plain| <= 2^-7 |plain|
      + (2^-7 + 2^-10) sum_k w_k |v_k|, with w the plain's softmax weights
      of the row (the plain run on |v| gives the sum).  The kernel rounds
      each p_k = exp(s_k - m) to bf16, p~_k = p_k (1 + e_k) with |e_k| <=
      2^-8, and divides by l = sum p~ (the rounded values), so its weights
      are w~_k = w_k (1 + e_k) / (1 + e), e = sum_j w_j e_j, and |w~_k -
      w_k| <= w_k 2^-7 / (1 - 2^-8): o moves by at most 2^-7 (1 + 2^-7)
      sum w|v| before it is rounded.  The rest is smaller: fp32 sums of up
      to W = 4096 products in the tensor cores and in l (<= W 2^-24 =
      2^-12 of sum w|v|), scores from exact bf16 products summed in fp32
      and exps with the scale folded into exp2 (~1e-6 relative in p), and
      the bf16 output rounding (<= 2^-8 |o|, within 2^-7 |plain| with a
      factor 2 to spare); 2^-10 covers 2^-14 + 2^-12 and those.  One
      128-key tile left out at W = 4096 moves an output by about 1/32 of
      that tile's mean of v (sd ~0.15), the size of the bound itself
      (~7e-3 at sum w|v| ~ 0.8), so over millions of outputs the worst
      ratio lies several times past 1; chip_mutants.py shows it for a tile
      at the window's edge and one inside.  The fp32 cases (the CUDA-core
      kernel, fp32 P) keep tests/test_kernels.py's 2e-5.  The CUDA-core
      kernel in bf16 (zamba2-7b's hd = 112) keeps P in fp32 and rounds only
      its output, so it meets the same bf16 bound with room.  K6 launches
      the kernel that swa_attention.kernel_for names, and its bf16 cases
      give the same bits on two calls.
    * K3/K4 at d = 100 (bf16): the wrappers zero-pad x's rows and w's d
      rows to 104 and slice dx and dw back; the case meets the bounds
      above."""
    t0 = phase("7 LM kernels vs plain (fused CE K3/K4a/K4b, SWA K6)")
    err = {"fused_ce_fwd": 0.0, "fused_ce_dx": 0.0, "fused_ce_dw": 0.0,
           "fused_ce_bwd": 0.0, "swa_attention": 0.0, "swa_attention_tc": 0.0}
    check_ce(CE_CASES, err, dev)
    for k, ((b, s, h, kh, hd, win), dtype) in enumerate(SWA_CASES):
        q, kk, vv = swa_inputs(b, s, h, kh, hd, dtype, 100 + k, dev)
        name = swa.kernel_for(dtype, hd)
        tag = f"[{b}, {s}, {h}, {kh}, {hd}] W={win} {str(dtype)[6:]}"
        reset_counts()
        got = swa.swa_attention_fwd(q, kk, vv, win)
        sync(dev)
        check(counts() == only(**{name: 1}), f"{name} {tag} launched "
              f"(kernel_for)")
        want = ref.swa_attention(q, kk, vv, win)
        tol = 2e-5 if dtype == torch.float32 else 3e-2  # tests/test_kernels
        e = diff(got, want)
        err[name] = max(err[name], e)
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"{name} {tag} == plain at {tol:g} (max |diff| {e:.3g})")
        if dtype == torch.bfloat16:
            again = swa.swa_attention_fwd(q, kk, vv, win)
            sync(dev)
            check(same(got, again), f"{name} {tag} bitwise equal on two "
                  f"calls")
            del want, again
            want = ref.swa_attention(q.float(), kk, vv, win)
            bound = ref.swa_attention(q.float(), kk, vv.abs(), win)
            bound.mul_(2.0 ** -7 + 2.0 ** -10).add_(want.abs(),
                                                     alpha=2.0 ** -7)
            r = worst_ratio(got, want, bound)
            check(r <= 1.0, f"{name} {tag} per element within 2^-7 "
                  f"|plain fp32| + (2^-7 + 2^-10) sum w|v| (worst "
                  f"|diff|/bound {r:.3g})")
            del bound
        del q, kk, vv, got, want
        torch.cuda.empty_cache()
    done(t0)
    return err


def lm_cfg():
    return get_config("qwen3-0.6b").with_(use_pallas=True)


def phase_lm_main(dev):
    """Phase 8: CSE-FSL on full-width Qwen3-0.6B through Trainer.run."""
    t0 = phase("8 LM main path: CSE-FSL, Qwen3-0.6B full width, bf16, "
               "kernels on, Trainer.run")
    cfg = lm_cfg()
    bundle = transformer_bundle(cfg, device=dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, codec="int8")
    fed = build_data(cfg, fsl, LM_S, LM_SAMPLES, non_iid=False, seed=0)
    cm = cost_model(bundle, LM_N, LM_SAMPLES)
    tr = Trainer(bundle, fsl)
    torch.cuda.reset_peak_memory_stats(dev)
    state, hist, meter, launches, per_round = drive(
        tr, lambda: LMBatcher(cfg, fed, LM_B, LM_H, seed=0), cm,
        "qwen3-0.6b int8", LM_ROUNDS, LM_B)
    peak = torch.cuda.max_memory_allocated(dev)
    cut = cfg.resolved_cut
    # one fused_ce_fwd and one fused_ce_bwd (a P pass, the dx and the dw
    # products) per head: h client steps (vmapped) + n server updates
    heads = LM_H + LM_N
    # K6 (bf16, hd = 128: the tensor-core kernel) once per client layer a
    # client step (vmapped: h steps and the smashed pass) and once per
    # server layer a server update
    want = only(quantize_philox=1, fused_ce_fwd=heads, fused_ce_dx=heads,
                fused_ce_dw=heads, fused_ce_p=heads,
                swa_attention_tc=cut * (LM_H + 1)
                + (cfg.num_layers - cut) * LM_N)
    for i, c in enumerate(per_round):
        check(c == want, f"round {i + 1} launches {c} == {want}")
    wire = LM_S * cfg.d_model + (LM_S // 8) * (cfg.d_model // 128) * 4
    check(wire == 4_210_688 and meter.counts["uplink_smashed"]
          == LM_ROUNDS * LM_N * wire,
          f"int8 uplink = {LM_ROUNDS} rounds x {LM_N} clients x 4,210,688 B "
          f"(raw bf16 {LM_S * cfg.d_model * 2:,} B)")
    print(f"  peak device memory over the run: {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    done(t0)
    return tr, state, fed, launches, peak


def phase_lm_cpu_vs(dev):
    """Phase 9: reduced Qwen3 in fp32, 2 rounds on the CPU (plain versions)
    and on the card (kernels)."""
    t0 = phase("9 LM CPU vs card: reduced Qwen3, fp32, 2 rounds")
    cfg = get_config("qwen3-0.6b").reduced().with_(
        dtype="float32", use_pallas=True, swa_window=64)
    fsl = FSLConfig(num_clients=2, h=2, lr=0.1, codec="int8")
    fed = build_data(cfg, fsl, 256, 4, non_iid=False, seed=0)
    hists, runs = {}, {}
    for d in ("cpu", dev):
        tr = Trainer(transformer_bundle(cfg, device=d), fsl)
        reset_counts()
        _, hists[str(d)] = tr.run(tr.init(0), LMBatcher(cfg, fed, 1, 2), 2,
                                  log_every=1)
        sync(d)
        runs[str(d)] = counts()
    check(sum(runs["cpu"].values()) == 0, "CPU run launched no kernel")
    check(all(runs[str(dev)][k] > 0 for k in (
        "quantize_philox", "fused_ce_fwd", "fused_ce_dx", "fused_ce_dw",
        "swa_attention")) and runs[str(dev)]["swa_attention_tc"] == 0,
          f"card run launched every LM kernel, fp32 K6 on the CUDA cores: "
          f"{runs[str(dev)]}")
    compare_rounds(hists, dev, 1e-3)
    done(t0)
    return runs[str(dev)]


def phase_lm_times(dev, err, launches, fp32_launches, tr, state, fed,
                   peak):
    """Phase 10: K3/K4a/K4b/K6 and a main-path round, timed.  The bf16 K6
    (the tensor-core kernel) at the server's and the 4 folded clients'
    shapes, the CUDA-core K6 at the server's in fp32 (its launches are
    phase 9's, ``fp32_launches``; its bound at the fp32 rate) and in bf16
    at zamba2-7b's heads (32 of width 112; no path here runs zamba2,
    so its record sits beside the fp32 one)."""
    t0 = phase("10 LM times (CUDA events, medians)")
    ce_times = time_ce({"server": (1, LM_S, 1024, 151936),
                        "aux": (LM_N, LM_S, 128, 151936)},
                       launches, err, dev)
    records = []
    for name, rec in ce_times["server"].items():
        rec["aux"] = {k: ce_times["aux"][name][k] for k in (
            "shape", "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        records.append(rec)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    win = 4096
    # (tag, B, dtype, H, KH, hd): Qwen3's server and folded clients, the
    # CUDA-core kernel in fp32 there, and at zamba2-7b's heads in bf16
    cases = (("server", 1, torch.bfloat16, 16, 8, 128),
             ("client", LM_N, torch.bfloat16, 16, 8, 128),
             ("fp32", 1, torch.float32, 16, 8, 128),
             ("zamba2", 1, torch.bfloat16, 32, 32, 112))
    for tag, b, dtype, hh, kh, hd in cases:
        s = LM_S
        name = swa.kernel_for(dtype, hd)
        q, k, v = swa_inputs(b, s, hh, kh, hd, dtype, 9, dev)
        pairs = sum(min(i + 1, win) for i in range(s))
        flops = 4 * hd * hh * b * pairs
        io = q.element_size() * (2 * q.numel() + 2 * k.numel())
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        pos = torch.arange(s, device=dev)
        band = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - win)
        lib = {"band": event_ms(lambda: sdpa(qt, kt, vt, attn_mask=band,
                                             enable_gqa=True),
                                reps=5, inner=3, warm=2)}
        if win >= s:            # the band is plain causal attention
            lib["causal"] = event_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True),
                                     reps=5, inner=3, warm=2)
        fp32 = dtype == torch.float32
        cuda_core = name == "swa_attention"
        rec = record(name, fp32_launches[name] if cuda_core else
                     launches[name],
                     err[name],
                     graph_ms(lambda: swa.swa_attention_fwd(q, k, v, win),
                              reps=3 if cuda_core else 5,
                              inner=3 if cuda_core else 5),
                     event_ms(lambda: swa.swa_attention_fwd(q, k, v, win),
                              reps=3 if cuda_core else 5,
                              inner=3 if cuda_core else 5),
                     event_ms(lambda: ref.swa_attention(q, k, v, win),
                              reps=3, inner=1, warm=1),
                     io, flops, FP32_OPS if fp32 else BF16_OPS,
                     library_ms=min(lib.values()),
                     library_band_ms=lib["band"],
                     library_causal_ms=lib.get("causal"),
                     shape=[b, s, hh, kh, hd, win], dtype=str(dtype)[6:])
        if fp32:
            rec["launches_path"] = "qwen3-0.6b reduced fp32 (phase 9)"
        print(f"  [{tag}]", end="")
        print_record(rec)
        print(f"    SDPA {str(dtype)[6:]}: band mask "
              f"{lib['band'] * 1e3:.3f} us, is_causal "
              + (f"{lib['causal'] * 1e3:.3f} us" if "causal" in lib
                 else "n/a (W < S)")
              + f"; {flops / rec['ms'] / 1e9:.1f} TFLOP/s, "
              f"{rec['bound_ms'] / rec['ms']:.4f} of the bound")
        if tag in ("client", "zamba2"):      # beside the kernel's record
            records[-1][tag] = {k_: rec[k_] for k_ in (
                "shape", "dtype", "ms", "eager_ms", "plain_ms", "bound_ms",
                "library_ms", "library_band_ms", "library_causal_ms")}
        else:
            records.append(rec)
        del q, k, v, qt, kt, vt, band
        torch.cuda.empty_cache()

    batch = tr.to_device(LMBatcher(lm_cfg(), fed, LM_B, LM_H,
                                   seed=1).next_round())
    box = {"state": state}

    def step():
        st, m = tr.step(box["state"], batch, LM_LR)
        box["state"] = tr.aggregate(st)
        float(m["server_loss"])

    step()
    round_ms, per = time_rounds(step, 3)
    print(f"  LM round (int8, n={LM_N}, h={LM_H}, B={LM_B}, S={LM_S}, step + "
          f"FedAvg, host clock after synchronize): median {round_ms:.3f} ms "
          f"of {[round(p, 3) for p in per]}")
    busy, idle = profile_round(step, 1, round_ms, top=12)
    done(t0)
    return records, {"round_ms": round_ms, "rounds_ms": per,
                     "device_ms": busy, "idle_share": idle,
                     "peak_bytes": peak}


# ---------------------------------------------------------------------------
# The Mamba path: full-width falcon-mamba-7b
# ---------------------------------------------------------------------------


def ssm_inputs(b, s, d, n, grp, dtype, seed, dev):
    """u, dt, a, b, c, d as tests/test_kernels.py draws them (u, b, c, d ~
    N(0, 1), dt = 0.1 softplus(N(0, 1)), a = -exp(0.3 N(0, 1))), with
    ``grp`` groups of a and d; u, dt, b, c in ``dtype``, a and d fp32."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn((b, s, d), generator=gen)
    dt = 0.1 * torch.nn.functional.softplus(torch.randn((b, s, d),
                                                        generator=gen))
    a = -torch.exp(0.3 * torch.randn((grp, d, n), generator=gen))
    bm, cm = (torch.randn((b, s, n), generator=gen) for _ in range(2))
    dv = torch.randn((grp, d), generator=gen)
    return [t.to(dtype).to(dev) if i in (0, 1, 3, 4) else t.to(dev)
            for i, t in enumerate((u, dt, a, bm, cm, dv))]


def ssm_cotangent(b, s, d, dtype, seed, dev):
    """gy ~ N(0, 1) [B, S, D] in ``dtype``, the output cotangent."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, d), generator=gen).to(dtype).to(dev)


def ssm_envelopes(f, gy):
    """Per element, the sum of |terms| of each gradient of the scan at the
    fp32 inputs ``f`` (u, dt, a, b, c, d) and cotangent ``gy``: the plain
    backward on |u|, |b|, |c|, |d|, |gy| (dt > 0 and a < 0 unchanged, so
    exp(dt a) is too) has every term of du, da, db, dc and dd nonnegative,
    with h and the adjoint g bounded by their own absolute values.  Its
    ddt is |u| S1 - S2 (a < 0), with S1 = sum_n g|b| = (du - |d||gy|) / dt
    and S2 = sum_n g h_{t-1} exp(dt a) |a|, so ddt's envelope is
    |u| S1 + S2 = 2 |u| S1 - ddt."""
    u, dt, a, bm, cm, dv = f
    check(bool((dt > 0).all()) and bool((a < 0).all()),
          "ssm envelopes: dt > 0 and a < 0")
    env = list(ref.ssm_scan_bwd(u.abs(), dt, a, bm.abs(), cm.abs(),
                                dv.abs(), gy.float().abs()))
    drows = dv.abs().repeat_interleave(u.shape[0] // dv.shape[0], 0)
    s1 = (env[0] - drows[:, None, :] * gy.float().abs()).div_(dt)
    env[1] = s1.clamp_min_(0).mul_(u.abs()).mul_(2).sub_(env[1])
    return env


def check_ssm(k, b, s, d, n, grp, dtype, err, dev):
    """K5 forward and backward at one case against the plain versions
    (``phase_mamba_kernels`` states the bounds)."""
    args = ssm_inputs(b, s, d, n, grp, dtype, 200 + k, dev)
    tag = f"[{b}, {s}, {d}, {n}] G={grp} {str(dtype)[6:]}"
    got, hs = ssm.ssm_scan_fwd(*args)
    f = [t.float() for t in args]
    want, whs = ref.ssm_scan(*f, ssm.CHUNK)
    sync(dev)
    e = diff(got, want)
    err["ssm_scan"] = max(err["ssm_scan"], e)
    check(got.dtype == args[0].dtype and got.shape == want.shape
          and hs.shape == whs.shape, f"ssm_scan {tag} dtype and shapes")
    if dtype == torch.float32:
        check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
              f"ssm_scan {tag} == plain at 2e-4 (max |diff| {e:.3g})")
    else:
        r = worst_ratio(got, want, want.abs().mul_(2.0 ** -7).add_(1e-4))
        check(r <= 1.0, f"ssm_scan {tag} per element within 2^-7 "
              f"|plain fp32| + 1e-4 (mean |plain| "
              f"{float(want.abs().mean()):.3g}; worst |diff|/bound "
              f"{r:.3g})")
    del want
    _, env = ref.ssm_scan(f[0].abs(), f[1], f[2], f[3].abs(), f[4], f[5],
                          ssm.CHUNK)
    r = worst_ratio(hs, whs, env.mul_(2.0 ** -13).clamp_min_(1e-30))
    check(r <= 1.0, f"ssm_scan {tag} boundary states per element within "
          f"2^-13 sum|terms| (worst |diff|/bound {r:.3g})")
    del whs, env
    again = ssm.ssm_scan_fwd(*args)
    sync(dev)
    check(same(got, again[0]) and same(hs, again[1]),
          f"ssm_scan {tag} bitwise equal y and states on two calls")
    del got, again
    gy = ssm_cotangent(b, s, d, dtype, 300 + k, dev)
    grads = ssm.ssm_scan_bwd(*args, gy, hs)
    again = ssm.ssm_scan_bwd(*args, gy, hs)
    sync(dev)
    check(all(same(x, y) for x, y in zip(grads, again)),
          f"ssm_scan_bwd {tag} bitwise equal grads on two calls")
    del again
    wants = ref.ssm_scan_bwd(*f, gy.float())
    envs = ssm_envelopes(f, gy)
    for i, name in enumerate(SSM_GRADS):
        g, w, e = grads[i], wants[i], envs[i]
        kern = "ssm_scan_bwd" if i < 2 else "ssm_scan_bwd_sum"
        err[kern] = max(err[kern], diff(g, w))
        rt = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        r = worst_ratio(g, w, e.mul_(2.0 ** -13).add_(w.abs(), alpha=rt)
                        .clamp_min_(1e-30))
        check(g.dtype == args[i].dtype and g.shape == w.shape and r <= 1.0,
              f"ssm_scan_bwd {tag} {name} per element within {rt:g} "
              f"|plain fp32| + 2^-13 sum|terms| (max |diff| "
              f"{diff(g, w):.3g}; worst |diff|/bound {r:.3g})")
    torch.cuda.empty_cache()


def phase_mamba_kernels(dev):
    """Phase 11: K5 forward and backward and the fused CE kernels at
    falcon-mamba's shapes against their plain versions.  Returns the
    largest difference seen per kernel.

    * K5 forward, fp32 cases: within tests/test_kernels.py's 2e-4.
    * K5 forward, bf16 cases, per element against the plain version in fp32
      on the same inputs: |got - plain| <= 2^-7 |plain| + 1e-4.  The kernel
      keeps the state in fp32 as the plain version does, so they differ by
      the bf16 rounding of y (<= 2^-8 |y|), fp32 order of operations, and
      the exps: ex2.approx of dt (a log2 e) against expf of dt a differ by
      at most about 2^-21 relative (2^-22 for each, plus |dt a| 2^-23 from
      the rounded argument), and a state carries the products of the exps
      over its memory, 1 / (dt |a|) steps, under 50 here (a =
      -exp(0.3 N(0, 1)) >= -exp(-1.35), dt about 0.08): about 2.4e-5 of
      |y| at worst, about 1 on average here; 1e-4 covers it near y = 0.  A
      state lost at a 128-step chunk boundary moves the next steps' y by
      O(0.1), far outside the bound.
    * K5 boundary states (both dtypes): |got - plain| <= 2^-13 sum|terms|,
      the terms' envelope being the states of the plain run on |u| and |b|
      (every term then >= 0); the exps' 2.4e-5 is 0.2 of that.
    * K5 backward (both dtypes): for each of du, ddt, da, db, dc, dd,
      |got - plain| <= r |plain| + 2^-13 sum|terms|, with r = 2^-7 for a
      bf16 output (its rounding, <= 2^-8, twice) and 0 for an fp32 one,
      and sum|terms| per element from ``ssm_envelopes``.  The kernel adds
      in another order than the plain version wherever it sums: over the
      states for du and ddt, over the channels for db and dc (a warp's 32
      in a tree, then the slabs in order), over time and batch rows for da
      and dd; reordering an fp32 sum of m terms moves it by about sqrt(m)
      2^-24 of its envelope (m <= 8192: 5.4e-6; the kernel's own chains,
      32 channels in a tree then 256 slabs in order, stay under 1.6e-5 even
      at worst), and its h and g carry the exps' 2.4e-5 as the forward
      does: 2^-13 = 1.2e-4 holds both with room.  A
      slab of 32 channels left out of db moves it by about sqrt(32 / 8192)
      = 1/16 of |plain| at D = 8192, some 4 times the bound; an adjoint
      lost at a tile boundary moves du and ddt of that tile's slowly
      decaying channels by O(1) of |plain|.  Both gradients' bits repeat on
      two calls, as do the forward's y and states.
    * K3/K4a/K4b: phase 7's bounds, at the server head (d = 4096), the aux
      head (d = 128), the server head at S = 4096 and ragged shapes past
      d = 1024."""
    t0 = phase("11 Mamba kernels vs plain (selective scan K5 forward and "
               "backward; fused CE K3/K4a/K4b at d > 1024)")
    err = {"ssm_scan": 0.0, "ssm_scan_bwd": 0.0, "ssm_scan_bwd_sum": 0.0,
           "fused_ce_fwd": 0.0, "fused_ce_dx": 0.0, "fused_ce_dw": 0.0,
           "fused_ce_bwd": 0.0}
    for k, ((b, s, d, n, grp), dtype) in enumerate(SSM_CASES):
        check_ssm(k, b, s, d, n, grp, dtype, err, dev)
    check_ce(MB_CE_CASES, err, dev)
    done(t0)
    return err


def mb_cfg():
    return get_config("falcon-mamba-7b").with_(num_layers=MB_LAYERS,
                                               use_pallas=True)


def phase_mamba_main(dev):
    """Phase 12: CSE-FSL on full-width falcon-mamba-7b through
    Trainer.run."""
    t0 = phase(f"12 Mamba main path: CSE-FSL, falcon-mamba-7b full width "
               f"({MB_LAYERS} layers), bf16, kernels on, Trainer.run")
    cfg = mb_cfg()
    bundle = transformer_bundle(cfg, device=dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, codec="int8")
    fed = build_data(cfg, fsl, MB_S, LM_SAMPLES, non_iid=False, seed=0)
    cm = cost_model(bundle, LM_N, LM_SAMPLES)
    tr = Trainer(bundle, fsl)
    torch.cuda.reset_peak_memory_stats(dev)
    plain_bwd, plain_calls = ref.ssm_scan_bwd, []

    def counted(*a, **kw):
        plain_calls.append(1)
        return plain_bwd(*a, **kw)

    ref.ssm_scan_bwd = counted
    try:
        state, hist, meter, launches, per_round = drive(
            tr, lambda: LMBatcher(cfg, fed, LM_B, LM_H, seed=0), cm,
            "falcon-mamba-7b int8", LM_ROUNDS, LM_B)
    finally:
        ref.ssm_scan_bwd = plain_bwd
    peak = torch.cuda.max_memory_allocated(dev)
    cut = cfg.resolved_cut
    heads = LM_H + LM_N                 # as in phase 8
    # K5 forward once per client layer a client step (vmapped: h steps and
    # the smashed pass) and once per server layer a server update; its
    # backward (the scan kernel and the kernel adding its partials) once
    # per client layer a client step and per server layer an update
    bwd = cut * LM_H + (cfg.num_layers - cut) * LM_N
    want = only(quantize_philox=1, fused_ce_fwd=heads, fused_ce_dx=heads,
                fused_ce_dw=heads, fused_ce_p=heads,
                ssm_scan=cut * (LM_H + 1) + (cfg.num_layers - cut) * LM_N,
                ssm_scan_bwd=bwd, ssm_scan_bwd_sum=bwd)
    for i, c in enumerate(per_round):
        check(c == want, f"round {i + 1} launches {c} == {want}")
    check(not plain_calls, "the plain scan backward (ref.ssm_scan_bwd) ran "
          "no time on the main path")
    wire = MB_S * cfg.d_model + (MB_S // 8) * (cfg.d_model // 128) * 4
    check(wire == 8_421_376 and meter.counts["uplink_smashed"]
          == LM_ROUNDS * LM_N * wire,
          f"int8 uplink = {LM_ROUNDS} rounds x {LM_N} clients x 8,421,376 "
          f"B (raw bf16 {MB_S * cfg.d_model * 2:,} B)")
    print(f"  peak device memory over the run: {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    done(t0)
    return tr, state, fed, launches, peak


def phase_mamba_cpu_vs(dev):
    """Phase 13: reduced falcon-mamba in fp32, 2 rounds on the CPU (plain
    versions) and on the card (kernels)."""
    t0 = phase("13 Mamba CPU vs card: reduced falcon-mamba, fp32, 2 rounds")
    cfg = get_config("falcon-mamba-7b").reduced().with_(dtype="float32",
                                                        use_pallas=True)
    fsl = FSLConfig(num_clients=2, h=2, lr=0.1, codec="int8")
    fed = build_data(cfg, fsl, 256, 4, non_iid=False, seed=0)
    hists, runs = {}, {}
    for d in ("cpu", dev):
        tr = Trainer(transformer_bundle(cfg, device=d), fsl)
        reset_counts()
        _, hists[str(d)] = tr.run(tr.init(0), LMBatcher(cfg, fed, 1, 2), 2,
                                  log_every=1)
        sync(d)
        runs[str(d)] = counts()
    check(sum(runs["cpu"].values()) == 0, "CPU run launched no kernel")
    check(all(runs[str(dev)][k] > 0 for k in (
        "ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_sum", "fused_ce_fwd",
        "fused_ce_dx", "fused_ce_dw", "quantize_philox")),
          f"card run launched K5 and its backward, K3, K4a, K4b and K2: "
          f"{runs[str(dev)]}")
    compare_rounds(hists, dev, 1e-3)
    done(t0)


# The library yardstick of K3/K4, timed only: one linear and one
# cross_entropy per group, logits in memory.
LIB_CE = "cross_entropy(linear(x, w^T))"


def library_ce_ms(x, w, lab, gs) -> dict:
    """The library's time per kernel record, summed over the groups as the
    kernels serve them (``sum_i g_i * CE(x_i w_i)``): its forward for K3;
    with ``autograd.grad`` (forward included) to x for K4a, to w for K4b,
    to both for fused_ce_bwd."""
    fn = torch.nn.functional
    labs = lab.long()

    def loss(xx, ww):
        return sum(gs[i] * fn.cross_entropy(fn.linear(xx[i], ww[i].t()),
                                            labs[i])
                   for i in range(x.shape[0]))

    def fwd():
        with torch.no_grad():
            loss(x, w)

    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    fns = {"fused_ce_fwd": fwd,
           "fused_ce_dx": lambda: torch.autograd.grad(loss(xr, w), xr),
           "fused_ce_dw": lambda: torch.autograd.grad(loss(x, wr), wr),
           "fused_ce_bwd": lambda: torch.autograd.grad(loss(xr, wr),
                                                       (xr, wr))}
    return {k: event_ms(f, reps=3, inner=2, warm=1) for k, f in fns.items()}


def time_ce(cases, launches, err, dev):
    """K3, K4a (its own P pass + dx), K4b (its own P pass + dw) and
    fused_ce_bwd (one shared P pass + both) timed at ``cases``
    ``{tag: (G, T, d, V)}`` in bf16, beside their plain versions and the
    library call; returns ``{tag: {name: record}}``."""
    out = {}
    for tag, (g, t, d, v) in cases.items():
        x, w, lab, gs = ce_inputs(g, t, d, v, torch.bfloat16, 7, dev)
        lse, _ = ce.fused_ce_fwd(x, w, lab)
        io_in = 2 * (g * t * d + g * d * v) + 4 * g * t
        io_bwd = io_in + 4 * g * t + 4 * g
        mm = 2 * g * t * d * v
        work = {"fused_ce_fwd": (io_in + 8 * g * t, mm),
                "fused_ce_dx": (io_bwd + 2 * g * t * d, 2 * mm),
                "fused_ce_dw": (io_bwd + 2 * g * d * v, 2 * mm),
                "fused_ce_bwd": (io_bwd + 2 * g * t * d + 2 * g * d * v,
                                 3 * mm)}
        run = {"fused_ce_fwd": lambda: ce.fused_ce_fwd(x, w, lab),
               "fused_ce_dx": lambda: ce.fused_ce_dx(x, w, lab, lse, gs),
               "fused_ce_dw": lambda: ce.fused_ce_dw(x, w, lab, lse, gs),
               "fused_ce_bwd": lambda: ce.fused_ce_bwd(x, w, lab, lse, gs)}
        plain = {"fused_ce_fwd": lambda: ref.fused_ce_fwd(x, w, lab),
                 "fused_ce_dx": lambda: ref.fused_ce_dx(x, w, lab, lse, gs),
                 "fused_ce_dw": lambda: ref.fused_ce_dw(x, w, lab, lse, gs),
                 "fused_ce_bwd": lambda: ref.fused_ce_bwd(x, w, lab, lse,
                                                          gs)}
        lib = library_ce_ms(x, w, lab, gs)
        torch.cuda.empty_cache()
        out[tag] = {}
        for name in run:
            # fused_ce_bwd: its launches are the main path's P passes
            rec = record(name, launches["fused_ce_p" if name == "fused_ce_bwd"
                                        else name], err[name],
                         graph_ms(run[name], reps=5, inner=2),
                         event_ms(run[name], reps=5, inner=2, warm=1),
                         event_ms(plain[name], reps=3, inner=1, warm=1),
                         *work[name], BF16_OPS, library_ms=lib[name],
                         library=LIB_CE, shape=[g, t, d, v])
            print(f"  [{tag}]", end="")
            print_record(rec)
            print(f"    {work[name][1] / rec['ms'] / 1e9:.1f} TFLOP/s, "
                  f"{rec['bound_ms'] / rec['ms']:.4f} of the bound")
            out[tag][name] = rec
        del x, w, lab, gs, lse
        torch.cuda.empty_cache()
    return out


def time_ssm(b, grp, launches, err, dev) -> dict:
    """K5 forward (with the boundary states the main path saves), the
    backward's scan kernel and its partial-sum kernel at ``[b, MB_S,
    8192, 16]`` with ``grp`` groups in bf16: times, plain times and bounds.
    A backward call launches both kernels (``call_ms``); the scan kernel
    is timed alone through ``ssm_scan._bwd_partials``, the partial sums
    through ``ssm_scan.sum_partials``."""
    s, d, n = MB_S, 8192, 16
    args = ssm_inputs(b, s, d, n, grp, torch.bfloat16, 11, dev)
    gy = ssm_cotangent(b, s, d, torch.bfloat16, 12, dev)
    _, hs = ssm.ssm_scan_fwd(*args)
    el = b * s * d * n
    nc, slabs = hs.shape[1], -(-d // ssm.SLAB)
    io_ad = grp * d * (n + 1) * 4                # a and d, or da and dd
    # the states the forward saves for the backward, and the partials a
    # backward call holds until its second kernel has run
    states_bytes = b * nc * d * n * 4
    part = 2 * slabs * b * s * n * 4 + b * d * (n + 1) * 4
    shape = [b, s, d, n, grp]
    out = {}
    fwd = lambda: ssm.ssm_scan_fwd(*args)   # noqa: E731
    terms = {"sfu": el / SFU_EXPS * 1e3, "fp32": 6 * el / FP32_OPS * 1e3}
    r = record("ssm_scan", launches["ssm_scan"], err["ssm_scan"],
               graph_ms(fwd, reps=5, inner=5), event_ms(fwd, reps=5, inner=5),
               event_ms(lambda: ref.ssm_scan(*args, ssm.CHUNK), reps=3,
                        inner=1, warm=1),
               b * s * d * 2 * 3 + b * s * n * 2 * 2 + io_ad + states_bytes,
               el, SFU_EXPS, shape=shape)
    r["bound_terms_ms"] = {"bytes": r["bytes"] / HBM_BPS * 1e3, **terms}
    out["ssm_scan"] = r
    bwd = lambda: ssm.ssm_scan_bwd(*args, gy, hs)      # noqa: E731
    scan = lambda: ssm._bwd_partials(*args, gy, hs)    # noqa: E731
    # 19 fp32 flops an element: the recurrence 4, the adjoint 3, the
    # gradient terms 12; one exp an element on the SFUs
    terms = {"sfu": el / SFU_EXPS * 1e3, "fp32": 19 * el / FP32_OPS * 1e3}
    io = b * s * d * 2 * 5 + b * s * n * 2 * 2 + io_ad + states_bytes + part
    r = record("ssm_scan_bwd", launches["ssm_scan_bwd"],
               err["ssm_scan_bwd"], graph_ms(scan, reps=5, inner=2),
               event_ms(scan, reps=5, inner=2),
               event_ms(lambda: ref.ssm_scan_bwd(*args, gy), reps=3,
                        inner=1, warm=1),
               io, *max(((el, SFU_EXPS), (19 * el, FP32_OPS)),
                        key=lambda o: o[0] / o[1]),
               shape=shape, call_ms=graph_ms(bwd, reps=5, inner=2),
               call_eager_ms=event_ms(bwd, reps=5, inner=2),
               states_bytes=states_bytes, partials_bytes=part)
    r["bound_terms_ms"] = {"bytes": r["bytes"] / HBM_BPS * 1e3, **terms}
    out["ssm_scan_bwd"] = r
    print(f"  {shape}: the forward saves {states_bytes / 1e6:.1f} MB of "
          f"states a layer; a backward call holds {part / 1e6:.1f} MB of "
          f"partials")
    gen = torch.Generator().manual_seed(13)
    pt = torch.randn((2, slabs, b, n, s), generator=gen).to(dev)
    ra = torch.randn((b, d, n), generator=gen).to(dev)
    rd = torch.randn((b, d), generator=gen).to(dev)
    sums = lambda: ssm.sum_partials(pt, ra, rd, grp, torch.bfloat16)  # noqa
    got = sums()
    want = ref.ssm_scan_bwd_sum(pt, ra, rd, grp, torch.float32)
    env = ref.ssm_scan_bwd_sum(pt.abs(), ra.abs(), rd.abs(), grp,
                               torch.float32)
    ok = True
    for i, name in enumerate(("db", "dc", "da", "dd")):
        rt = 2.0 ** -7 if got[i].dtype == torch.bfloat16 else 0.0
        ratio = worst_ratio(got[i], want[i], env[i].mul_(2.0 ** -13)
                            .add_(want[i].abs(), alpha=rt).clamp_min_(1e-30))
        ok = ok and ratio <= 1.0
    check(ok, f"ssm_scan_bwd_sum {shape} == its plain version within "
          f"r |plain| + 2^-13 sum|partials| (r 2^-7 bf16, 0 fp32)")
    r = record("ssm_scan_bwd_sum", launches["ssm_scan_bwd_sum"],
               err["ssm_scan_bwd_sum"], graph_ms(sums, reps=5, inner=5),
               event_ms(sums, reps=5, inner=5),
               event_ms(lambda: ref.ssm_scan_bwd_sum(pt, ra, rd, grp,
                                                     torch.bfloat16),
                        reps=3, inner=2, warm=1),
               part + 2 * b * s * n * 2 + io_ad, 2 * slabs * b * s * n,
               FP32_OPS, shape=shape)
    r["bound_terms_ms"] = {"bytes": r["bytes"] / HBM_BPS * 1e3}
    out["ssm_scan_bwd_sum"] = r
    return out


def phase_mamba_times(dev, err, launches, lm_records, tr, state, fed, peak):
    """Phase 14: K5 forward and backward, the d = 4096 fused CE kernels
    and a Mamba round, timed.  Returns the K5 kernels' records and the
    round's numbers; the CE times go into ``lm_records`` under
    ``"mamba"``."""
    t0 = phase("14 Mamba times (CUDA events, medians)")
    ce_times = time_ce({"server": (1, MB_S, 4096, 65024),
                        "aux": (LM_N, MB_S, 128, 65024)}, launches, err, dev)
    for rec in lm_records:
        if rec["name"] in ce_times["server"]:
            rec["mamba"] = {tag: {k: t[rec["name"]][k] for k in (
                "shape", "launches", "max_abs_err", "ms", "eager_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for tag, t in ce_times.items()}
    recs = {}
    for tag, (b, grp) in (("server", (1, 1)), ("client", (LM_N, LM_N))):
        for name, r in time_ssm(b, grp, launches, err, dev).items():
            print(f"  [{tag}]", end="")
            print_record(r)
            if name in recs:
                recs[name]["client"] = {k: r[k] for k in (
                    "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "bound_terms_ms", "call_ms", "states_bytes",
                    "partials_bytes") if k in r}
            else:
                recs[name] = r
        torch.cuda.empty_cache()

    batch = tr.to_device(LMBatcher(mb_cfg(), fed, LM_B, LM_H,
                                   seed=1).next_round())
    box = {"state": state}

    def step():
        st, m = tr.step(box["state"], batch, LM_LR)
        box["state"] = tr.aggregate(st)
        float(m["server_loss"])

    round_ms, per = time_rounds(step, 5)
    print(f"  Mamba round (int8, n={LM_N}, h={LM_H}, B={LM_B}, S={MB_S}, "
          f"{MB_LAYERS} layers, step + FedAvg, host clock after "
          f"synchronize): median {round_ms:.3f} ms of "
          f"{[round(p, 3) for p in per]}")
    busy, idle = profile_round(step, 1, round_ms, top=12)
    done(t0)
    return list(recs.values()), {"round_ms": round_ms, "rounds_ms": per,
                                 "device_ms": busy, "idle_share": idle,
                                 "peak_bytes": peak}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = phase_device()
    phase_build()
    err = phase_kernels(dev)
    launches, tr, state, fed = phase_main(dev)
    phase_cpu_vs(dev, fed)
    records, round_ms = phase_times(dev, err, launches, tr, state, fed)
    del tr, state
    lm_err = phase_lm_kernels(dev)
    ltr, lstate, lfed, llaunches, peak = phase_lm_main(dev)
    fp32_launches = phase_lm_cpu_vs(dev)
    lm_records, lm = phase_lm_times(dev, lm_err, llaunches, fp32_launches,
                                    ltr, lstate, lfed, peak)
    del ltr, lstate
    torch.cuda.empty_cache()
    mb_err = phase_mamba_kernels(dev)
    mtr, mstate, mfed, mlaunches, mpeak = phase_mamba_main(dev)
    phase_mamba_cpu_vs(dev)
    ssm_records, mb = phase_mamba_times(dev, mb_err, mlaunches, lm_records,
                                        mtr, mstate, mfed, mpeak)
    print(f"\n  total wall time {time.perf_counter() - t_start:.3f} s")
    print(card)
    print(json.dumps({"kernels": records + lm_records + ssm_records,
                      "round_ms": round_ms, "lm": lm, "mamba": mb,
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
