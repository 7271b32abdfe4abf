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
   sliding-window attention (K6: the tensor-core kernel in bf16, zamba2-
   7b's hd = 112 included, the CUDA-core one in fp32; o and its lse)
   against their plain versions at the main path's shapes and at ragged
   small ones, K3 and the bf16 K6 bitwise repeatable, ``fused_ce_bwd`` at
   every case bitwise repeatable, bitwise equal to K4a and K4b run alone
   and so held against the same plain versions; and K6's backward (the
   delta, dK/dV and dQ kernels) per element against the plain backward at
   the Qwen3 shapes, at hd 112 and 64, banded and ragged, bitwise
   repeatable;
8. LM main path: CSE-FSL on full-width Qwen3-0.6B (bf16, the kernels on)
   through ``Trainer.run``, with per-round launch counts of every kernel
   (K6's backward kernels 104 times a round, the plain attention backward
   no time), finite losses, state on the card and the meter equal to
   CommProfile;
9. LM CPU vs card: reduced Qwen3 in fp32, the kernels on the card (the
   CUDA-core K6, the plain backward) and the plain versions on the CPU,
   agree over 2 rounds;
10. LM times: the kernels and ``fused_ce_bwd``, their plain versions and
   library yardsticks (SDPA with the band mask and, where the window
   covers the sequence, ``is_causal`` for K6 and, through autograd, for
   its backward; ``cross_entropy(linear(x, w^T))`` for K3/K4) at the main
   shapes and at zamba2-7b's heads, the CUDA-core K6 in fp32 at the
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
   memory;
15. CNN baselines: FSL_MC, FSL_OC and FSL_AN on the full-width CIFAR-10
   CNN through ``Trainer.run`` (int8 up, and down for the blocking two),
   with K2 launched once per coded channel a unit and no other kernel, the
   meter (downlink included) equal to CommProfile and the unit counter;
   FSL_AN again with the ``topk`` uplink (no kernel); and the topk codec
   where magnitudes tie (bf16 and few-valued payloads at the LM wire
   shape): the card's wire and decoded payload bitwise the CPU's, the
   indices in the reference's lower-index-first order;
16. CNN baselines CPU vs card: the first 2 rounds of each, unit by unit
   from the CPU's states with the same Philox bits on both wires: the
   card's losses and updates agree with the CPU's, and so do, hook by hook
   from the CPU's inputs, its coding (bitwise), smashed data, replies and
   updates;
17. Qwen3 baselines: FSL_OC on full-width Qwen3-0.6B and FSL_MC on it cut
   to 20 layers (bf16, the kernels on, int8 up and down) through
   ``Trainer.run``, with per-round launch counts derived from the hooks
   (the server's input gradient and the clients' vjp through K3, K4 and
   K6's backward; the plain attention backward never called), the meter
   and the peak device memory;
18. baseline times: a round of each baseline path with its device time
   and idle share, and K2 at the Qwen3 wire shape beside its bound;
19. compiled runner: ``Trainer.run_compiled`` (each round a replay of a
   captured CUDA graph) against ``Trainer.run`` from the same state, under
   deterministic algorithms, on the CNN (CSE-FSL and the three
   baselines), Qwen3 (CSE-FSL, FSL_OC) and falcon-mamba (CSE-FSL, phase
   12's cut), int8 on every wire channel including the model-sync wire:
   the states bitwise, the history rows and meters equal, the meter
   equal to CommProfile (model-sync bytes included), an LM path's
   launches a round as stated before the run and its warm-up and
   captures calling the layer kernels 3 rounds' worth, its own replays
   (profiled inside the call) launching every kernel of the loop's round
   as often (K2 on the uplink,
   the downlink and the model-sync channels) with no wrapper called; the
   LM paths gather their batches from the device pool, and Qwen3 CSE-FSL
   also runs the staged data path (``device_data=False``), bitwise
   against the loop and the pooled run (STAGED_PATHS); and
   (run after phase 21) a kernel wrapper made to synchronize makes the
   capture raise;
20. loop vs compiled: each path's round in both engines (CUDA-event
   medians, deterministic algorithms on in both), device time from the
   profiled rounds, idle share and peak memory;
21. scheduling and faults: ``Trainer.run`` against ``run_compiled`` under
   a scheduler, the tiered network and fault injection, masked FedAvg
   behind the int8 model-sync wire, on six paths (SCHED_PATHS: CSE-FSL on
   the CNN under a deadline with faults, under bandwidth_h with
   refresh=False and under a policy that admits nobody in one round;
   FSL_OC under the lossy preset; FSL_MC stratified; CSE-FSL on
   full-width Qwen3 under a deadline with faults): the states bitwise,
   rows, meters and participation summaries equal, the participants the
   plan AND the trace's survival, the meter the trace's exact bytes plus
   the cohorts' model sync, the CPU's aggregates fed to the card's
   (coding bitwise, params within HOOK_RTOL, dropped clients refreshed or
   kept bit for bit), K2 in each captured graph as in phase 19, an empty
   window replaying the graph without FedAvg (no model-sync K2), and
   (last of all, with phase 19's) a syncing wrapper making the masked
   capture raise; two paths' rounds timed as in phase 20 beside the
   unmasked path's (phase 19's run of it); the Qwen3 path also through
   the staged data path, its masked chunk program on staged batches,
   bitwise against the loop and the pooled run;
22. layer recompute (``cfg.remat``), every path through phase 19's
   checks with remat on: CSE-FSL on full-width Qwen3 (S = 4096) and on
   phase 12's falcon-mamba cut (S = 2048), against phase 19's runs of
   the same paths without it: the states, losses and meters bitwise
   equal, the launches a round stated before the run (with remat each
   layer's forward kernel once more per backward, every other kernel as
   often), the capture calling the recomputed forwards, ms a round (one
   timed round a path) and peak memory in both engines; then, in both
   engines too, the cuts
   remat lifts: the Mamba path at S = 4096 and FSL_MC on Qwen3 at all 28
   layers (the largest size that fits; a size that runs out of memory is
   recorded);
23. the paper's figure scripts (``repro_torch.benchmarks``: Tables III/IV,
   Figs 4/5, Figs 7/8, the fault figure, Fig 9) at their own settings on
   the card, each asserting the JAX script's claims, with their tables and
   seconds.  Figs 4/5, 7/8 and the fault figure compare accuracies near
   chance and run under deterministic algorithms; each runs twice, and
   the second run must end on the first's rows.  Fig 9's cheapest-uplink claim fails in the JAX script too at
   these settings: the phase holds the port's failure to the reference's
   row (FIG9_REFERENCE_FAILURE) and lists it, open, under
   ``"known_reference_failures"`` in the JSON record;
24. the event engine (``core/async_trainer.py``, ``AsyncTrainer``): on the
   full-width CIFAR-10 CNN (int8 uplink and model sync) every method at
   zero latency against ``Trainer.run`` -- the aggregation schedule, the
   meter, the consumption order (Trainer.run's), AsyncStats and meter
   equal to the CPU engine's, K2 once per client and unit on one client's
   payload (the per-client coding bitwise the stacked coding's rows), each
   unit's update within UNIT_RTOL of Trainer.run's from its state; CSE-FSL
   under a lognormal latency and the lossy wire: the order permuted,
   retries, every corrupted copy caught by its frame, the host stats equal
   to the CPU run's; CSE-FSL on full-width Qwen3 against ``Trainer.run``:
   launches a round with nothing folded, at one client's shapes, losses
   at rtol 1e-3, updates within UNIT_RTOL; then the three drivers
   (``fig6_async_order``, ``fig_sched``, ``fig_wallclock``) at their own
   settings, claims asserted; ms a round of the engine and the loop;
25. the population engine (``repro_torch.population``) and telemetry:
   on the full-width CIFAR-10 CNN (int8 on every channel) ``Population``
   with C == N over a FederatedPool against ``run_compiled``, bitwise
   (state, history, meter), each method, a population round launching
   phase 19's replayed round's kernels; a VirtualPool fleet of 10^6
   (stratified on the tiered network, refresh=False): cohorts and index
   plans against plain draws, one shared cache row a finished window, the
   default row untouched by the replays, a checkpoint saved mid-window
   and restored into a fresh engine resuming bitwise, ``engine_total`` the
   same at N = 10^4; the lossy and crashy presets against the same engine
   on the CPU (participants, drops, retries, wire bytes); telemetry on
   and off in ``run``,
   ``run_compiled``, ``AsyncTrainer.run`` and ``Population.run``: bitwise,
   the same number of synchronizing calls, every exported record valid,
   and ``run`` at ``log_every=0``: its records those of a run logging
   every round, one synchronizing call added (the one fetch at its end);
   then ``fig_population`` at its own settings, its three claims
   asserted.  Its Qwen3 fleet (full-width Qwen3-0.6B through
   ``LMPool(VirtualPool)`` at N = 10^6 for 3 rounds: launches, ms a round,
   peak, the memory report and the population summary) runs when asked
   for (``parts=("lm",)``): phase 26's CLI population run drives the same
   engine on Qwen3 at N = 10^6;
26. the entry points, called in this process: the training CLI
   (``repro_torch.launch.train.main``) on full-width Qwen3-0.6B at phase
   20's flags (int8 uplink and model sync, chunk 3; the config's remat
   on), its state, rows and meter bitwise a direct ``run_compiled`` built
   the same way, its warm-up and captures calling the layer kernels 3
   rounds' worth and its own replayed rounds (profiled inside the CLI
   call) launching phase 22's kernels with remat, no wrapper called; K2
   at the largest model-sync leaf (the embedding, ``[4, 151936, 1024]``:
   its launches a round counted in the captured aggregating round, whose
   K2 calls add up to the replayed round's; its first and last 1024 rows
   bitwise the plain version's, its time beside its bound); the CLI's
   population mode at N = 10^6; qwen2-1.5b at full width (28 layers, K6
   at a GQA group of 6; its parameters drawn on the card): round 1's
   losses near ln V, peak and a replayed round's ms; glm4-9b and
   qwen2-72b reduced on the card against the same CLI run on the CPU;
   ``Trainer.run_compiled`` on the CNN under lossy faults saved
   mid-window and restored into a fresh Trainer, bitwise the
   uninterrupted run (the window's cohort kept); falcon-mamba (phase 12's
   cut, remat) through ``Population`` at C == N, bitwise
   ``run_compiled``, the default row untouched, and through the event
   engine for a round against ``Trainer.run`` within UNIT_RTOL; then
   ``perf_bench --smoke`` with its two bars;
27. serving the merged model at full depth (``models.model.prefill``,
   ``decode_step``, ``launch.serve``): full-width Qwen3-0.6B's prefill of
   4 x 4,096 tokens at window 4,096, K6 launched once a layer and its
   plain version never, against the plain attention's prefill (logits and
   caches within SERVE_BOUND); 32 decode steps past the ring's wrap, the
   captured decode (``make_serving_fns``) bitwise the eager one, in place,
   no kernel launched, the last logits against ``full_forward`` on the
   4,128 tokens and layer 0's ring against that layer's k and v of the
   decoded tokens; the ``long_500k`` decode (B = 1, pos 524,287); the
   serving CLI at its defaults; falcon-mamba-7b at 64 layers (drawn on
   the card): its prefill of 4 x 2,048 with no K5 launch, 16 captured
   steps bitwise eager, the last logits against ``full_forward`` (K5),
   layer 0's conv window against its last inputs, the CLI; the reduced
   configs' card against the CPU; the serving example; prefill ms, decode
   ms a token, tokens/s and peaks;
28. the MoE family (``models.layers.moe_*``, the ``moe`` block, the aux
   loss through ``Remat``): K3/K4 and K6 (and its backward) at
   olmoe-1b-7b's shapes against their plain versions; CSE-FSL on
   full-width olmoe-1b-7b (16 layers, d 2048, 64 experts top 8, V 50,304,
   bf16, remat as configured, its parameters drawn on the card) through
   phase 19's checks (a loop round and a replayed round bitwise, launches
   a round as stated before the run, the meter CommProfile's, the trained
   model's aux losses finite and > 0, ms a round in both engines, idle and
   peak); one MoE layer on 1,024 tokens against the host CPU from the
   card's router probabilities (expert ids, slots and kept flags equal, a
   zero row to experts 0..7, the output within MOE_LAYER_BOUND) and the
   block with remat bitwise without it (output, aux loss, gradients);
   serving: the windowed prefill of 4 x 2,048 (K6 once a layer, layer 0's
   drops at the config's factor counted), 32 captured decode steps
   bitwise eager and the last against ``full_forward`` with drops
   disabled; phi3.5-moe reduced: a round and a captured decode;
29. the hybrid family (``models.layers.ssd_scan``/``ssd_decode``, the
   ``mamba2`` block, the shared attention site of a hybrid stage): K3/K4
   at zamba2-7b's heads and K6 at its 4 folded clients against their
   plain versions; CSE-FSL on zamba2-7b at full width (d 3,584, 112 SSD
   heads, a shared block of hd 112 after every 6 layers, V 32,000, bf16,
   remat, its parameters drawn on the card) cut to 27 layers through
   phase 19's checks (a loop round and a replayed round bitwise, K6
   launched once a shared site a pass, K5 never, the meter
   CommProfile's, ms a round in both engines, idle and peak); one mamba2
   layer and one shared site on 1,024 tokens against the host CPU; and
   serving at all 81 layers: the windowed prefill of 4 x 1,920 (K6 once a
   site, 13 times), 128 captured decode steps (the first 32 bitwise the
   eager ones), the last against ``full_forward`` and every cache leaf
   (each site's own ring) against a prefill of the whole sequence;
30. the VLM and audio families (M-RoPE, the image-embedding and frame
   frontends, encoder-only attention): K3/K4 at qwen2-vl-72b's heads (d
   8,192 x V 152,064 and r 256) and hubert-xlarge's (d 1,280 and r 64 x V
   504, a ragged last vocabulary tile) against their plain versions, timed
   at the two server heads, and FedAvg in slices bitwise the whole leaf's;
   CSE-FSL on qwen2-vl-72b at full width cut to 4 layers (cut 1; its
   batches staged with zero image embeddings, the model sync uncoded)
   and on hubert-xlarge at all 48 layers (train_batch_specs features,
   int8 model sync, no K6) through phase 19's checks; one attention
   sub-block of each against an attention written out here (rotation by
   ``torch.polar`` per M-RoPE section) on the host CPU; serving qwen2-vl
   at 16 layers: the image merge bitwise, the prefill of 4 x 4,096 with
   256 image embeddings (K6 once a layer), 32 captured decode steps
   bitwise the eager ones, layer 0's ring, the last step against
   ``full_forward`` and every cache leaf against a prefill of the whole
   sequence.

Phases 18 (5 timed CNN rounds, 1 LM), 19 and 21 (one timed LM round or
chunk) and 24 (``fig_sched`` and ``fig_wallclock`` at their own
``--smoke`` settings) cut repetition to make room for phase 26; for
phase 27, phase 24 runs ``fig6_async_order`` at its ``--smoke`` 30 rounds
and phase 25 leaves out its Qwen3 fleet (the CLI's population run in
phase 26 drives that engine on Qwen3); for phase 28, phase 22 times no
loop round, phase 18 one LM round a path (two before), phase 26 runs
perf_bench's telemetry protocols once each (three before) and phase 27
decodes 32 Qwen3 and 16 Mamba steps (64 and 32 before); for phase 29,
phases 19, 21 and 22 hold states by 64-bit digests on the card
(``state_digests``) instead of host copies, phase 19's Qwen3 FSL_OC and
phase 22's lifted cuts run one round (two before) and phase 26's Mamba
``Population`` one round (two before); so do
phases 19 and 22 (a path's kernels a replayed round read from its
``run_compiled``'s own replays, not from one more profiled chunk), 21
(its timed paths' unmasked twins are phase 19's runs) and 26 (qwen2-1.5b
drawn on the card; the CLI's own replays profiled, not a second run).
For phase 30, the LM paths draw their parameters on the card
(``lm_bundle``; the host's generator took tens of seconds for the
16-layer Mamba cut, Qwen3 and its 20-layer cut, 3.6 B parameters),
phase 26's Mamba ``Population`` is held to phase 22's run of the same
path (its digests, rows and meter) instead of a ``run_compiled`` of its
own and its event-engine check keeps the initial state on the card (no
host copy), phase 18 times K2's plain version once (twice before), and
phase 10 qwen2-vl's plain attention once.  No check or kernel comparison
went, and every path is still driven at its depth.

Phases 7-21 pin ``remat=False``, which the Qwen3 and falcon-mamba configs
now set, so their sizes, counts and peaks stay as they were.

The second-to-last line is the ``{"kernels": [...]}`` JSON record (with
``"sched"``, ``"remat"``, ``"figures"``, ``"engine"``, ``"population"``,
``"telemetry"``, ``"cli"``, ``"serve"``, ``"moe"``, ``"hybrid"``,
``"families"`` and ``"known_reference_failures"``: phases 21-30's
numbers; K6's record adds ``serve_prefill_launches`` (and the olmoe,
zamba2 and qwen2-vl prefills'), and the records of the kernels the MoE,
hybrid, VLM and audio paths run ``olmoe_launches_per_round``,
``olmoe_max_abs_err``, ``zamba2_launches_per_round``,
``zamba2_max_abs_err``, ``qwen2_vl_launches_per_round``,
``qwen2_vl_max_abs_err``, ``hubert_launches_per_round`` and
``hubert_max_abs_err``; K3/K4's records ``qwen2_vl_server`` and
``hubert_server``, their times at those heads), the
last ``{"ok": true, "device":
{...}}``.  The script imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

# Before torch starts the card's caching allocator: the Mamba main path's
# round leaves 30 GB reserved but unallocated in fragments when its update
# needs one 8 GiB block, so let segments grow instead.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
# Before the first cuBLAS call: deterministic algorithms (phase 19's run
# against run_compiled) need a fixed cuBLAS workspace.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.common import bytes_of, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.base import SHAPES, FSLConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import async_trainer  # noqa: E402
from repro_torch.core.accounting import CommMeter, CostModel  # noqa: E402
from repro_torch.core.async_trainer import (AsyncTrainer,  # noqa: E402
                                            ConstantLatency,
                                            LognormalLatency)
from repro_torch.core.bundle import cnn_bundle, transformer_bundle  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.graphs import state_leaves  # noqa: E402
from repro_torch.core.methods import get_method  # noqa: E402
from repro_torch.core.methods.base import fedavg, stacked_keys  # noqa: E402
from repro_torch.core import trainer as trainer_mod  # noqa: E402
from repro_torch.core.trainer import Trainer  # noqa: E402
from repro_torch.data import (FederatedBatcher, partition_iid,  # noqa: E402
                              synthetic_classification, synthetic_lm)
from repro_torch.faults import (FRAME_BYTES, FaultModel,  # noqa: E402
                                LossyWire, make_fault, round_wire_bytes)
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import fused_ce as ce  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402
from repro_torch.kernels import swa_attention as swa  # noqa: E402
from repro_torch.examples import serve_split_model  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import LMBatcher, LMPool, build_data  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import layers as tf_layers  # noqa: E402
from repro_torch.models import model as tf_mod  # noqa: E402
from repro_torch.models.blocks import Ctx  # noqa: E402
from repro_torch.models.cnn import CIFAR10, stages  # noqa: E402
from repro_torch.network import TieredNetwork  # noqa: E402
from repro_torch.optim import SLICE_NUMEL  # noqa: E402
from repro_torch.population import (FederatedPool, Population,  # noqa: E402
                                    VirtualPool)
from repro_torch.sched import (BandwidthHPolicy, DeadlinePolicy,  # noqa: E402
                               SchedContext, SchedulerPolicy,
                               StratifiedPolicy, available_policies,
                               register_policy)
from repro_torch.telemetry import Telemetry, validate_record  # noqa: E402
from repro_torch.transport import (Int8Codec, Transport,  # noqa: E402
                                   get_codec, make_transport)

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
# S = 4096 the client phase (4 clients x 8 layers of saved activations
# without remat, and torch.func.grad's create_graph=True keeping every
# backward temporary until the backward ends) does not fit in 80 GB.
# Phase 22 runs it at S = 4096 with remat.
MB_LAYERS, MB_S = 16, 2048
# The baselines (FSL_MC, FSL_OC, FSL_AN): the CNN path's setup and data for
# 3 rounds each, int8 on the uplink and, for the blocking methods, on the
# gradient downlink; the Qwen3 paths take the LM path's setup for 2 rounds,
# FSL_OC at full depth and FSL_MC cut to 20 layers (4 client, 16 server):
# its 4 server replicas' saved activations (without remat) run out of the
# card's 79.18 GiB at 28 and at 24 layers; 20 peak at 68.0 GiB.  Phase 22
# runs it at 28 layers with remat.
BASELINES, BL_ROUNDS, BL_LM_ROUNDS = ("fsl_mc", "fsl_oc", "fsl_an"), 3, 2
BL_LM_PATHS = (("fsl_oc", None), ("fsl_mc", 20))     # (method, layers)
# Phase 16's bounds on the card against the CPU, relative in 2-norm: a
# unit's update (each state key's params) and, hook by hook from the same
# inputs, the smashed data, the replies and each update.  On an H100 the
# sound runs read up to 0.0558 and 7.0e-4; a skipped, zeroed or misrouted
# update reads about 1.
UNIT_RTOL, HOOK_RTOL = 0.2, 3e-3
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
            # no TPU kernel: the JAX package's jax.vjp of its reference
            "swa_attention_bwd_delta": "src/repro/kernels/ops.py:140",
            "swa_attention_bwd_dkdv": "src/repro/kernels/ops.py:140",
            "swa_attention_bwd_dq": "src/repro/kernels/ops.py:140",
            "ssm_scan": "src/repro/kernels/ssm_scan.py:63",
            # no TPU kernel: the JAX package's jax.vjp of selective_scan
            "ssm_scan_bwd": "src/repro/kernels/ops.py:113",
            "ssm_scan_bwd_sum": "src/repro/kernels/ops.py:113"}
SOURCE = {"quantize_bits": "quantize.cu", "quantize_philox": "quantize.cu",
          "fused_ce_fwd": "fused_ce.cu", "fused_ce_dx": "fused_ce.cu",
          "fused_ce_dw": "fused_ce.cu", "fused_ce_bwd": "fused_ce.cu",
          "swa_attention": "swa_attention.cu",
          "swa_attention_tc": "swa_attention.cu",
          "swa_attention_bwd_delta": "swa_attention.cu",
          "swa_attention_bwd_dkdv": "swa_attention.cu",
          "swa_attention_bwd_dq": "swa_attention.cu",
          "ssm_scan": "ssm_scan.cu", "ssm_scan_bwd": "ssm_scan.cu",
          "ssm_scan_bwd_sum": "ssm_scan.cu"}
# K3/K4 cases (G, T, d, V): the aux head's, the server head's and FSL_MC's
# four server replicas' heads folded into one call, then ragged ones in
# both dtypes (bf16 and fp32 take different kernels; bf16 at d = 100 runs
# zero-padded to 104); K6 cases (B, S, H, KH, hd, W): the main
# path's and a longer one the window cuts, ragged ones for the tensor-core
# kernel (S not a multiple of 128, windows that cut the kv tiles, hd = 64),
# zamba2-7b's attention (hd = 112, on the tensor cores), qwen2-1.5b's and
# glm4-9b's (GQA groups of 6 and 16: 12 and 32 heads over 2), qwen2-vl-72b's
# server (a group of 8: 64 heads over 8), then tests/test_kernels.py's four
# in fp32.
CE_CASES = [((4, 4096, 128, 151936), torch.bfloat16),
            ((1, 4096, 1024, 151936), torch.bfloat16),
            ((4, 4096, 1024, 151936), torch.bfloat16),
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
             ((1, 4096, 32, 32, 112, 4096), torch.bfloat16),
             ((1, 4096, 12, 2, 128, 4096), torch.bfloat16),
             ((1, 4096, 32, 2, 128, 4096), torch.bfloat16),
             ((1, 4096, 64, 8, 128, 4096), torch.bfloat16)] + [
    (c, torch.float32) for c in ((1, 128, 2, 2, 16, 32),
                                 (1, 256, 4, 2, 32, 64),
                                 (2, 128, 4, 1, 16, 128),
                                 (1, 256, 2, 2, 64, 200))]
# K6 backward cases (B, S, H, KH, hd, W): the Qwen3 main path's (one server
# sequence, 4 folded clients), zamba2-7b's heads, a longer sequence the
# window cuts (W < S), ragged ones (S off the 64- and 128-row tiles,
# windows that cut them) at hd 128, 64 and 112 with GQA, qwen2-1.5b's,
# glm4-9b's and qwen2-vl-72b's heads (groups of 6, 16 and 8); then the plain
# backward's routes on the card (bf16 at hd 32, fp32).
SWA_BWD_CASES = [((1, 4096, 16, 8, 128, 4096), torch.bfloat16),
                 ((4, 4096, 16, 8, 128, 4096), torch.bfloat16),
                 ((1, 4096, 32, 32, 112, 4096), torch.bfloat16),
                 ((1, 8192, 16, 8, 128, 4096), torch.bfloat16),
                 ((1, 777, 8, 2, 128, 200), torch.bfloat16),
                 ((2, 1000, 4, 2, 64, 300), torch.bfloat16),
                 ((1, 1000, 4, 2, 112, 1000), torch.bfloat16),
                 ((1, 4096, 12, 2, 128, 4096), torch.bfloat16),
                 ((1, 4096, 32, 2, 128, 4096), torch.bfloat16),
                 ((1, 4096, 64, 8, 128, 4096), torch.bfloat16),
                 ((1, 256, 4, 2, 32, 64), torch.bfloat16),
                 ((1, 256, 2, 2, 64, 200), torch.float32)]
SWA_GRADS = ("dq", "dk", "dv")


PHASE = [""]            # the phase running, named in an out-of-memory report


def phase(name: str):
    PHASE[0] = name
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
    """Bitwise equality of two tensors of one dtype, any device: where
    both lie on one device, compared there (no copy to the host), 2^26
    bytes at a time (so the comparison's own memory stays small beside
    full-width states on the card)."""
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    x = a.contiguous().reshape(-1).view(torch.uint8)
    y = b.contiguous().reshape(-1).view(torch.uint8)
    step = 1 << 26
    return all(torch.equal(x[i:i + step], y[i:i + step])
               for i in range(0, x.numel(), step))


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


def metric_keys(row) -> list:
    """The method's metric names in a history row (CSE-FSL and FSL_AN:
    client_loss, server_loss; FSL_MC and FSL_OC: loss)."""
    return [k for k in row if k not in (
        "round", "aggregated", "comm_bytes", "participants",
        "dropped_updates", "fault_retries", "fault_drops")]


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
        print(f"    round {row['round']:2d} " + " ".join(
            f"{k} {row[k]:.6f}" for k in metric_keys(row))
            + f" aggregated {row['aggregated']}")
    check(all(math.isfinite(row[k]) for row in hist
              for k in metric_keys(row)),
          f"[{tag}] losses finite")
    check(all(t.device.type == torch.device(dev).type
              for k in sorted(state) if k != "round"
              for t in tree_leaves(state[k]["params"])),
          f"[{tag}] state stayed on {dev}")
    prof = tr.comm_profile(cm, batch_size, batch=batcher.next_round())
    want = {"uplink_smashed": rounds * prof.wire_uplink_smashed,
            "uplink_labels": rounds * prof.uplink_labels,
            "downlink_grads": rounds * prof.wire_downlink_grads,
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
        for k in metric_keys(rc):
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
    kernels = cuda_events(prof)
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
    per-group loss cotangents g in [0.5, 1.5].  Drawn on the host, except
    where w has more than 2^30 elements (qwen2-vl's d 8192 x V 152,064
    head: seconds on the host), drawn on the card."""
    on = dev if g * d * v > 2 ** 30 else "cpu"
    gen = torch.Generator(device=on).manual_seed(seed)
    x = torch.randn((g, t, d), generator=gen, device=on).to(dtype)
    w = (torch.randn((g, d, v), generator=gen, device=on)
         * d ** -0.5).to(dtype)
    lab = torch.randint(0, v, (g, t), generator=gen, device=on).to(
        torch.int32)
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



def check_swa(cases, err, dev, seed=100):
    """K6's forward at ``cases`` against its plain version (phase 7's
    bounds, see ``phase_lm_kernels``); the largest differences go into
    ``err``."""
    for k, ((b, s, h, kh, hd, win), dtype) in enumerate(cases):
        q, kk, vv = swa_inputs(b, s, h, kh, hd, dtype, seed + k, dev)
        name = swa.kernel_for(dtype, hd)
        tag = f"[{b}, {s}, {h}, {kh}, {hd}] W={win} {str(dtype)[6:]}"
        reset_counts()
        got, lse = swa.swa_attention_fwd(q, kk, vv, win)
        sync(dev)
        check(counts() == only(**{name: 1}), f"{name} {tag} launched "
              f"(kernel_for)")
        want, wlse = ref.swa_attention_fwd(q, kk, vv, win)
        tol = 2e-5 if dtype == torch.float32 else 3e-2  # tests/test_kernels
        e = diff(got, want)
        err[name] = max(err[name], e)
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"{name} {tag} == plain at {tol:g} (max |diff| {e:.3g})")
        ltol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        check(lse.shape == wlse.shape and diff(lse, wlse) <= ltol,
              f"{name} {tag} lse (base 2) == plain within {ltol:g} (max "
              f"|diff| {diff(lse, wlse):.3g})")
        if dtype == torch.bfloat16:
            again = swa.swa_attention_fwd(q, kk, vv, win)
            sync(dev)
            check(same(got, again[0]) and same(lse, again[1]),
                  f"{name} {tag} bitwise equal o and lse on two calls")
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
        del q, kk, vv, got, want, lse, wlse
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
      kernel, fp32 P) keep tests/test_kernels.py's 2e-5.  At zamba2-7b's
      hd = 112 the tensor-core kernel multiplies 16 zero columns more and
      meets the same bound.  K6 launches the kernel that
      swa_attention.kernel_for names, and its bf16 cases give the same bits
      on two calls.  Its lse (base 2) is within 2^-7 of the plain one's in
      bf16: the kernel's l sums P rounded to bf16, each within 2^-8 of
      p, so log2 l moves by at most log2(1 + 2^-8) = 0.0056; 1e-4 in fp32.
    * The K6 backward (bf16, hd 64/112/128: the delta, dK/dV and dQ
      kernels; swa_attention.bwd_kernel_for) against the plain backward in
      fp32 on the same inputs, per element: |got - plain| <= 2^-7 |plain|
      + env, with env from ``swa_bwd_envelopes``: each term of dS = P (dP
      - delta) may move by A = P (c_ds |dP - delta| + c_delta |delta|' +
      c_dp |dP|'), where |dP|' = |g| |v|^T and |delta|' = rowsum(P
      |dP|'); dq's env is A |k| / sqrt(hd), dk's A^T |q| / sqrt(hd), dv's
      c_dv P^T |g|.  The kernels' P is the plain P times a row factor
      1 + a, |a| <= 2^-8 (1 + 2^-8): the forward's lse sums P rounded to
      bf16.  dV's P is rounded to bf16 (2^-8) and dS before dK and dQ
      (2^-8), so c_dv = c_ds = 2^-7 + 2^-10 (2^-10 for fp32 sums of up to
      8,192 products, 2^-11 at worst, and second-order terms).  delta =
      rowsum(g o) takes the forward kernel's bf16 o, whose error is at
      most (2^-7 + 2^-8 + 2^-11) sum_k P|v| (P's rounding in o and l, o's
      rounding; the forward bound's derivation), so delta moves by at most
      that times |delta|': c_delta = 2^-7 + 2^-8 + 2^-9.  dP sums hd <= 128
      exact products in fp32: c_dp = 2^-14.  The bf16 outputs' rounding,
      2^-8 |got|, lies within 2^-7 |plain| with room.  dS's rows sum to 0,
      so at a sequence's first rows a dS without its delta term moves dq
      by |delta| against c_delta |delta|'; a q tile left out of the dK/dV
      kernel drops all of one head's terms of the keys near its end;
      chip_mutants.py shows both caught at main-path shapes.  The
      delta kernel is within 2^-16 rowsum|g o| of its plain version (fp32
      sums of at most 128 exact products), the bits of all three outputs
      repeat on two calls, and the plain backward's routes on the card
      (fp32, hd 32) are the plain backward bit for bit.
    * K3/K4 at d = 100 (bf16): the wrappers zero-pad x's rows and w's d
      rows to 104 and slice dx and dw back; the case meets the bounds
      above."""
    t0 = phase("7 LM kernels vs plain (fused CE K3/K4a/K4b, SWA K6)")
    err = {"fused_ce_fwd": 0.0, "fused_ce_dx": 0.0, "fused_ce_dw": 0.0,
           "fused_ce_bwd": 0.0, "swa_attention": 0.0, "swa_attention_tc": 0.0,
           **{n: 0.0 for n in swa.BWD_KERNELS}}
    check_ce(CE_CASES, err, dev)
    check_swa(SWA_CASES, err, dev)
    check_swa_bwd(SWA_BWD_CASES, err, dev)
    done(t0)
    return err


def swa_bwd_envelopes(q, k, v, g, window):
    """Per element, the error the K6 backward's kernels may make in dq, dk
    and dv at fp32 q, k, v, g (``phase_lm_kernels`` derives it), head by
    head: with P the softmax weights, dP = g v^T, delta = rowsum(P dP),
    |dP|' = |g| |v|^T and |delta|' = rowsum(P |dP|'), each dS term may
    move by A = P (c_ds |dP - delta| + c_delta |delta|' + c_dp |dP|'), so
    dq by A |k| / sqrt(hd) and dk by A^T |q| / sqrt(hd); dv by c_dv P^T
    |g| (the GQA groups summed onto their kv head)."""
    c = SWA_BWD_C
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    eq = torch.empty_like(q)
    ek, ev = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(h):
        j = i // rep
        p = ref._swa_probs(q[:, :, i:i + 1], k[:, :, j:j + 1], window)[:, 0]
        ev[:, :, j] += (p.transpose(1, 2) @ g[:, :, i].abs()).mul_(c["dv"])
        dpa = g[:, :, i].abs() @ v[:, :, j].abs().transpose(1, 2)
        ds = g[:, :, i] @ v[:, :, j].transpose(1, 2)
        ds.sub_((p * ds).sum(-1, keepdim=True)).abs_().mul_(c["ds"])
        ds.add_((p * dpa).sum(-1, keepdim=True), alpha=c["delta"])
        a = p.mul_(ds.add_(dpa, alpha=c["dp"]))
        del dpa, ds
        eq[:, :, i] = (a @ k[:, :, j].abs()).mul_(scale)
        ek[:, :, j] += (a.transpose(1, 2) @ q[:, :, i].abs()).mul_(scale)
        del p, a
    return eq, ek, ev


# The K6 backward's per-element bound (see phase_lm_kernels): 2^-7 |plain|
# (the bf16 outputs) plus ``swa_bwd_envelopes``, whose coefficients these
# are: dS's rounding and the lse's row factor (c_ds), the saved o's error
# through delta (c_delta), dP's fp32 sums (c_dp), and dv's (c_dv).
SWA_BWD_C = {"ds": 2.0 ** -7 + 2.0 ** -10,
             "delta": 2.0 ** -7 + 2.0 ** -8 + 2.0 ** -9,
             "dp": 2.0 ** -14,
             "dv": 2.0 ** -7 + 2.0 ** -10}


def check_swa_bwd(cases, err, dev):
    """The K6 backward at ``cases`` against the plain backward in fp32
    (``phase_lm_kernels`` states the bounds); the largest differences go
    into ``err``."""
    for k, ((b, s, h, kh, hd, win), dtype) in enumerate(cases):
        q, kk, vv = swa_inputs(b, s, h, kh, hd, dtype, 400 + k, dev)
        g = swa_inputs(b, s, h, kh, hd, dtype, 500 + k, dev)[0]
        tag = f"[{b}, {s}, {h}, {kh}, {hd}] W={win} {str(dtype)[6:]}"
        names = swa.bwd_kernel_for(dtype, hd)
        o, lse = swa.swa_attention_fwd(q, kk, vv, win)
        reset_counts()
        grads = swa.swa_attention_bwd(q, kk, vv, o, lse, g, win)
        sync(dev)
        check(counts() == only(**{n: 1 for n in names}),
              f"swa_attention_bwd {tag} launched {names} (bwd_kernel_for)")
        if names == (swa.BWD_PLAIN,):
            want = ref.swa_attention_bwd(q, kk, vv, g, win)
            check(all(same(x, y) for x, y in zip(grads, want)),
                  f"swa_attention_bwd {tag} is the plain backward, bitwise")
            continue
        delta = swa._bwd_delta(o, g)
        wdelta = ref.swa_attention_bwd_delta(o, g)
        bound = ref.swa_attention_bwd_delta(o.abs(), g.abs()).mul_(2.0 ** -16)
        r = worst_ratio(delta, wdelta, bound.clamp_min_(1e-30))
        err["swa_attention_bwd_delta"] = max(
            err["swa_attention_bwd_delta"], diff(delta, wdelta))
        check(r <= 1.0, f"swa_attention_bwd_delta {tag} within 2^-16 "
              f"rowsum|g o| (worst |diff|/bound {r:.3g})")
        del delta, wdelta, bound
        again = swa.swa_attention_bwd(q, kk, vv, o, lse, g, win)
        sync(dev)
        check(all(same(x, y) for x, y in zip(grads, again)),
              f"swa_attention_bwd {tag} bitwise equal dq, dk, dv on two "
              f"calls")
        del again, o, lse
        f = [t.float() for t in (q, kk, vv, g)]
        wants = ref.swa_attention_bwd(*f, win)
        envs = swa_bwd_envelopes(*f, win)
        del f
        for i, name in enumerate(SWA_GRADS):
            got, want, env = grads[i], wants[i], envs[i]
            kern = "swa_attention_bwd_dq" if name == "dq" \
                else "swa_attention_bwd_dkdv"
            err[kern] = max(err[kern], diff(got, want))
            r = worst_ratio(got, want, env.add_(want.abs(), alpha=2.0 ** -7)
                            .clamp_min_(1e-30))
            check(got.dtype == dtype and got.shape == want.shape
                  and r <= 1.0,
                  f"swa_attention_bwd {tag} {name} per element within "
                  f"2^-7 |plain fp32| + its envelope (max |diff| "
                  f"{diff(got, want):.3g}; worst |diff|/bound {r:.3g})")
        del q, kk, vv, g, grads, wants, envs
        torch.cuda.empty_cache()


# The LM paths' bundles (by config) and their token data (by vocabulary,
# clients and S), built once for every phase that runs the path (8, 12,
# 17, 19-22, 24); the bundles draw their parameters on the card.
BUNDLES, DATA = {}, {}


def lm_bundle(cfg, dev):
    """``transformer_bundle(cfg, dev)`` whose ``init(gen)`` is
    ``init_params``' draw made on the card from a generator seeded with
    ``gen``'s seed (card_bundle's), moved to the bundle's device: every
    init of a config and seed gives the same bits, on the card and on the
    CPU (phase 26's reduced CLI runs compare the two).  Each method's
    ``init_state`` draws nothing else.  A draw on the host's generator
    takes about 13 s a billion parameters (card_bundle), so the 16-layer
    Mamba cut's took tens of seconds."""
    key = (repr(cfg), str(dev))
    if key not in BUNDLES:
        bundle = transformer_bundle(cfg, device=dev)

        def init(gen, bundle=bundle):
            params = serve_mod.draw_params(cfg, gen.initial_seed(), "cuda")
            return tree_map(lambda t: t.to(bundle.device), params)
        BUNDLES[key] = dataclasses.replace(bundle, init=init)
    return BUNDLES[key]


def lm_data(cfg, fsl, seq: int):
    """``build_data`` of an LM path (LM_SAMPLES iid sequences a client)."""
    key = (cfg.vocab_size, fsl.num_clients, seq)
    if key not in DATA:
        DATA[key] = build_data(cfg, fsl, seq, LM_SAMPLES, non_iid=False,
                               seed=0)
    return DATA[key]


def lm_cfg():
    # the earlier phases keep their sizes, counts and peaks without remat;
    # phase 22 turns it on
    return get_config("qwen3-0.6b").with_(use_pallas=True, remat=False)


def lm_launches(cfg, method: str, k2: int) -> dict:
    """A round's wrapper launches on an LM path (n = 4, h = 2), ``k2`` K2
    launches (the coded wire channels' units and model-sync leaves).

    CSE-FSL: one fused_ce_fwd and one fused_ce_bwd (a P pass, the dx and
    the dw products) per head, h client steps (vmapped) + n server updates;
    the layer's kernel (K6, the tensor-core one at bf16 hd 128, or K5) once
    per client layer a client step (vmapped: h steps and the smashed pass)
    and once per server layer a server update (a hybrid's K6: once per
    shared site, where the layers count); its backward (K6's delta,
    dK/dV and dQ kernels, or K5's scan kernel and the kernel adding its
    partials) once per client layer a client step and per server layer an
    update.  The blocking methods, a unit (h a round): the clients' forward
    (vmapped: one a client layer), the server's update(s) with the
    gradient to its input (one K3 and one K4 pass a head, the layer's
    kernel and its backward a server layer), n of them one after another
    with the shared server (FSL_OC), one vmapped over the replicas
    (FSL_MC), then the clients' vjp (recomputing the forward: the kernel
    and its backward a client layer).  With ``cfg.remat`` each recomputed
    layer reruns its forward in its backward: the forward kernel once more
    per backward."""
    cut = cfg.resolved_cut
    srv = cfg.num_layers - cut
    if cfg.family == "hybrid":      # K6 runs at the shared sites alone
        cplan, splan = tf_mod.stage_plans(cfg)
        cut, srv = cplan.n_shared_sites, splan.n_shared_sites
    if method == "cse_fsl":
        heads = LM_H + LM_N
        fwd = cut * (LM_H + 1) + srv * LM_N
        bwd = cut * LM_H + srv * LM_N
    else:
        passes = 1 if get_method(method).server_replicated else LM_N
        heads = LM_H * passes
        fwd = LM_H * (2 * cut + passes * srv)
        bwd = LM_H * (cut + passes * srv)
    if cfg.remat:
        fwd += bwd
    want = only(quantize_philox=k2, fused_ce_fwd=heads, fused_ce_dx=heads,
                fused_ce_dw=heads, fused_ce_p=heads)
    if cfg.family == "ssm":
        want.update(ssm_scan=fwd, ssm_scan_bwd=bwd, ssm_scan_bwd_sum=bwd)
    elif cfg.swa_window and not cfg.encoder_only:   # hubert: no K6
        want.update(swa_attention_tc=fwd, **{n: bwd for n in swa.BWD_KERNELS})
    return want


def phase_lm_main(dev):
    """Phase 8: CSE-FSL on full-width Qwen3-0.6B through Trainer.run."""
    t0 = phase("8 LM main path: CSE-FSL, Qwen3-0.6B full width, bf16, "
               "kernels on, Trainer.run")
    cfg = lm_cfg()
    bundle = lm_bundle(cfg, dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, codec="int8")
    fed = lm_data(cfg, fsl, LM_S)
    cm = cost_model(bundle, LM_N, LM_SAMPLES)
    tr = Trainer(bundle, fsl)
    torch.cuda.reset_peak_memory_stats(dev)
    plain_bwd, plain_calls = ref.swa_attention_bwd, []

    def counted(*a, **kw):
        plain_calls.append(1)
        return plain_bwd(*a, **kw)

    ref.swa_attention_bwd = counted
    try:
        state, hist, meter, launches, per_round = drive(
            tr, lambda: LMBatcher(cfg, fed, LM_B, LM_H, seed=0), cm,
            "qwen3-0.6b int8", LM_ROUNDS, LM_B)
    finally:
        ref.swa_attention_bwd = plain_bwd
    peak = torch.cuda.max_memory_allocated(dev)
    cut = cfg.resolved_cut
    want = lm_launches(cfg, "cse_fsl", 1)
    bwd = want["swa_attention_bwd_dq"]
    check(bwd == 104, f"{bwd} == 104 attention backward calls a round "
          f"({cut} client layers x h = {LM_H}, {cfg.num_layers - cut} server "
          f"layers x n = {LM_N})")
    for i, c in enumerate(per_round):
        check(c == want, f"round {i + 1} launches {c} == {want}")
    check(not plain_calls, "the plain attention backward "
          "(ref.swa_attention_bwd) ran no time on the main path")
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
        "swa_attention", swa.BWD_PLAIN)) and not any(
            runs[str(dev)][k] for k in ("swa_attention_tc",)
            + swa.BWD_KERNELS),
          f"card run launched every LM kernel, fp32 K6 on the CUDA cores "
          f"and its backward plain (bwd_kernel_for): {runs[str(dev)]}")
    compare_rounds(hists, dev, 1e-3)
    done(t0)
    return runs[str(dev)]


def sdpa_ms(q, k, v, win, dev, backward=False) -> dict:
    """SDPA's time on [B, H, S, hd] copies of q, k, v with GQA: with the
    band mask and, where the window covers the sequence, ``is_causal``.
    ``backward``: the backward's time, through autograd (the forward and
    backward under one ``autograd.grad``, less the forward alone with
    inputs that require grad)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s = q.shape[1]
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(backward)
                  for a in (q, k, v))
    pos = torch.arange(s, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    kws = {"band": {"attn_mask": band}}
    if win >= s:                 # the band is plain causal attention
        kws["causal"] = {"is_causal": True}
    out = {}
    for key, kw in kws.items():
        def fwd(kw=kw):
            return sdpa(qt, kt, vt, enable_gqa=True, **kw)
        t_fwd = event_ms(fwd, reps=5, inner=3, warm=2)
        if backward:
            go = torch.randn_like(qt)
            t_both = event_ms(lambda: torch.autograd.grad(
                fwd(), (qt, kt, vt), go), reps=5, inner=3, warm=2)
            out[key] = t_both - t_fwd
        else:
            out[key] = t_fwd
    return out


def time_swa_bwd(b, hh, kh, hd, win, launches, err, dev) -> dict:
    """The K6 backward's three kernels at ``[b, LM_S, hh, kh, hd]`` in bf16,
    each alone (``swa_attention._bwd_delta`` / ``_bwd_dkdv`` /
    ``_bwd_dq``), with its bound; the dK/dV record also carries the whole
    backward call (``call``: device and call time, the plain backward, the
    5-product bound and SDPA's backward).  The dK/dV and dQ records' plain
    time is the whole plain backward's."""
    s = LM_S
    q, k, v = swa_inputs(b, s, hh, kh, hd, torch.bfloat16, 9, dev)
    g = swa_inputs(b, s, hh, kh, hd, torch.bfloat16, 10, dev)[0]
    o, lse = swa.swa_attention_fwd(q, k, v, win)
    delta = swa._bwd_delta(o, g)
    pairs = sum(min(i + 1, win) for i in range(s))
    mm = 2 * hd * hh * b * pairs              # flops of one product
    eq, ek, rows = 2 * q.numel(), 2 * k.numel(), 4 * b * hh * s
    work = {"swa_attention_bwd_delta": (2 * eq + rows, 2 * q.numel(),
                                        FP32_OPS),
            "swa_attention_bwd_dkdv": (2 * eq + 2 * ek + 2 * rows + 2 * ek,
                                       4 * mm, BF16_OPS),
            "swa_attention_bwd_dq": (2 * eq + 2 * ek + 2 * rows + eq,
                                     3 * mm, BF16_OPS)}
    run = {"swa_attention_bwd_delta": lambda: swa._bwd_delta(o, g),
           "swa_attention_bwd_dkdv": lambda: swa._bwd_dkdv(q, k, v, g, lse,
                                                           delta, win),
           "swa_attention_bwd_dq": lambda: swa._bwd_dq(q, k, v, g, lse,
                                                       delta, win)}
    call = lambda: swa.swa_attention_bwd(q, k, v, o, lse, g, win)  # noqa
    plain_ms = event_ms(lambda: ref.swa_attention_bwd(q, k, v, g, win),
                        reps=3, inner=1, warm=1)
    torch.cuda.empty_cache()
    lib = sdpa_ms(q, k, v, win, dev, backward=True)
    torch.cuda.empty_cache()
    shape = [b, s, hh, kh, hd, win]
    out = {}
    for name, fn in run.items():
        io, ops, peak = work[name]
        out[name] = record(
            name, launches[name], err[name], graph_ms(fn, reps=5, inner=5),
            event_ms(fn, reps=5, inner=5),
            event_ms(lambda: ref.swa_attention_bwd_delta(o, g), reps=5,
                     inner=5) if name == "swa_attention_bwd_delta"
            else plain_ms, io, ops, peak, shape=shape)
    call_io = 3 * eq + 2 * ek + rows + eq + 2 * ek
    out["swa_attention_bwd_dkdv"]["call"] = {
        "ms": graph_ms(call, reps=5, inner=5),
        "eager_ms": event_ms(call, reps=5, inner=5), "plain_ms": plain_ms,
        "bound_ms": max(call_io / HBM_BPS, 5 * mm / BF16_OPS) * 1e3,
        "library_ms": min(lib.values()), "library_band_ms": lib["band"],
        "library_causal_ms": lib.get("causal"),
        "library": "SDPA backward: autograd.grad of forward + backward, "
                   "less the forward"}
    return out


def phase_lm_times(dev, err, launches, fp32_launches, tr, state, fed,
                   peak):
    """Phase 10: K3/K4a/K4b/K6, K6's backward and a main-path round,
    timed.  The bf16 K6 (the tensor-core kernel) at the server's and the 4
    folded clients' shapes, at zamba2-7b's heads (32 of width 112; no
    path here runs zamba2, so its record sits beside the server's) and at
    qwen2-vl-72b's (64 over 8 kv heads, the forward only), the
    CUDA-core K6 at the server's in fp32 (its launches are phase 9's,
    ``fp32_launches``; its bound at the fp32 rate); the backward's three
    kernels and the whole backward call at the same bf16 shapes, beside
    SDPA's backward."""
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

    win = 4096
    # (tag, B, dtype, H, KH, hd): Qwen3's server and folded clients, the
    # CUDA-core kernel in fp32 there, and zamba2-7b's heads in bf16
    cases = (("server", 1, torch.bfloat16, 16, 8, 128),
             ("client", LM_N, torch.bfloat16, 16, 8, 128),
             ("fp32", 1, torch.float32, 16, 8, 128),
             ("zamba2", 1, torch.bfloat16, 32, 32, 112),
             ("qwen2_vl", 1, torch.bfloat16, 64, 8, 128))
    by_name = {}
    for tag, b, dtype, hh, kh, hd in cases:
        s = LM_S
        name = swa.kernel_for(dtype, hd)
        q, k, v = swa_inputs(b, s, hh, kh, hd, dtype, 9, dev)
        pairs = sum(min(i + 1, win) for i in range(s))
        flops = 4 * hd * hh * b * pairs
        io = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
            + 4 * b * hh * s
        lib = sdpa_ms(q, k, v, win, dev)
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
                     # qwen2-vl's 64 heads: one plain call, not three
                     event_ms(lambda: ref.swa_attention(q, k, v, win),
                              reps=1 if hh == 64 else 3, inner=1,
                              warm=int(hh != 64)),
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
        if name in by_name:             # beside the kernel's record
            by_name[name][tag] = {k_: rec[k_] for k_ in (
                "shape", "dtype", "ms", "eager_ms", "plain_ms", "bound_ms",
                "library_ms", "library_band_ms", "library_causal_ms")}
        else:
            by_name[name] = rec
            records.append(rec)
        del q, k, v
        torch.cuda.empty_cache()

    bwd = {}
    for tag, b, hh, kh, hd in (("server", 1, 16, 8, 128),
                               ("client", LM_N, 16, 8, 128),
                               ("zamba2", 1, 32, 32, 112)):
        for name, rec in time_swa_bwd(b, hh, kh, hd, win, launches, err,
                                      dev).items():
            print(f"  [{tag}]", end="")
            print_record(rec)
            if "call" in rec:
                c = rec["call"]
                print(f"    whole backward call: {c['ms'] * 1e3:.3f} us on "
                      f"device, {c['eager_ms'] * 1e3:.3f} us a call, plain "
                      f"{c['plain_ms'] * 1e3:.3f} us, bound "
                      f"{c['bound_ms'] * 1e3:.3f} us (5 products), "
                      f"{c['bound_ms'] / c['ms']:.4f} of it; SDPA backward "
                      f"(autograd, its forward taken off) "
                      f"{c['library_ms'] * 1e3:.3f} us (band "
                      f"{c['library_band_ms'] * 1e3:.3f}, is_causal "
                      + (f"{c['library_causal_ms'] * 1e3:.3f})"
                         if c["library_causal_ms"] is not None else "n/a)"))
            if name in bwd:
                bwd[name][tag] = {k_: rec[k_] for k_ in (
                    "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "call") if k_ in rec}
            else:
                bwd[name] = rec
        torch.cuda.empty_cache()
    records += list(bwd.values())

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
                                               use_pallas=True, remat=False)


def phase_mamba_main(dev):
    """Phase 12: CSE-FSL on full-width falcon-mamba-7b through
    Trainer.run."""
    t0 = phase(f"12 Mamba main path: CSE-FSL, falcon-mamba-7b full width "
               f"({MB_LAYERS} layers), bf16, kernels on, Trainer.run")
    cfg = mb_cfg()
    bundle = lm_bundle(cfg, dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, codec="int8")
    fed = lm_data(cfg, fsl, MB_S)
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
    want = lm_launches(cfg, "cse_fsl", 1)
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


def library_ce_ms(x, w, lab, gs, reps=3) -> dict:
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
    return {k: event_ms(f, reps=reps, inner=2 if reps > 1 else 1, warm=1)
            for k, f in fns.items()}


def time_ce(cases, launches, err, dev, plain_reps=3, reps=5, inner=2,
            warm=1):
    """K3, K4a (its own P pass + dx), K4b (its own P pass + dw) and
    fused_ce_bwd (one shared P pass + both) timed at ``cases``
    ``{tag: (G, T, d, V)}`` in bf16 (medians of ``reps`` times of
    ``inner`` calls, after ``warm`` calls), beside their plain versions
    (``plain_reps`` calls after ``warm``) and the library call; returns
    ``{tag: {name: record}}``."""
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
        lib = library_ce_ms(x, w, lab, gs, reps=min(reps, 3))
        torch.cuda.empty_cache()
        out[tag] = {}
        for name in run:
            # fused_ce_bwd: its launches are the main path's P passes
            rec = record(name, launches["fused_ce_p" if name == "fused_ce_bwd"
                                        else name], err[name],
                         graph_ms(run[name], reps=reps, inner=inner),
                         event_ms(run[name], reps=reps, inner=inner,
                                  warm=warm),
                         event_ms(plain[name], reps=plain_reps, inner=1,
                                  warm=warm),
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


# ---------------------------------------------------------------------------
# The baselines: FSL_MC, FSL_OC, FSL_AN
# ---------------------------------------------------------------------------


def baseline_transport(method: str, uplink: str = "int8") -> Transport:
    """``uplink`` up; int8 down for the blocking methods (gradient
    download), nothing down for FSL_AN."""
    return make_transport(uplink, "int8" if get_method(method)
                          .downloads_gradients else "none")


def baseline_fsl(method: str, lm: bool = False) -> FSLConfig:
    if lm:
        return FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, method=method)
    return FSLConfig(num_clients=N, h=H, lr=LR, method=method)


def phase_baselines(dev, fed):
    """Phase 15: FSL_MC, FSL_OC and FSL_AN on the full-width CIFAR-10 CNN
    through Trainer.run, int8 up (and down for the blocking two): K2 once
    per coded channel a unit, the meter, the unit counter; then FSL_AN with
    the topk uplink (no kernel).  Returns each path's trainer, state and
    launch counts."""
    t0 = phase("15 CNN baselines: FSL_MC, FSL_OC, FSL_AN, CIFAR-10 CNN full "
               "width, Trainer.run")
    bundle = cnn_bundle(CIFAR10, device=dev)
    cm = cost_model(bundle, N, SAMPLES // N)
    wire = 55_728                       # int8 [24, 6, 6, 64] per client unit
    out = {}
    for method in BASELINES:
        blocking = get_method(method).downloads_gradients
        tr = Trainer(bundle, baseline_fsl(method),
                     transport=baseline_transport(method))
        state, hist, meter, launches, per_round = drive(
            tr, lambda: FederatedBatcher(fed, B, H, seed=0), cm,
            f"{method} int8", BL_ROUNDS, B)
        k2 = (2 if blocking else 1) * H
        for i, c in enumerate(per_round):
            check(c == only(quantize_philox=k2),
                  f"{method} round {i + 1}: quantize_philox {k2} times "
                  f"(h = {H} units x {2 if blocking else 1} coded "
                  f"channel(s)), no other kernel")
        up = BL_ROUNDS * N * H * wire
        check(meter.counts["uplink_smashed"] == up
              and meter.counts["downlink_grads"] == (up if blocking else 0),
              f"{method} int8 uplink = {BL_ROUNDS} rounds x {N} clients x "
              f"{H} units x 55,728 B, downlink "
              + ("the same" if blocking else "0"))
        check(state["round"] == BL_ROUNDS * H,
              f"{method} state['round'] = {BL_ROUNDS} rounds x h = "
              f"{BL_ROUNDS * H} units")
        out[method] = {"trainer": tr, "state": state, "launches": launches}
    tr = Trainer(bundle, baseline_fsl("fsl_an"),
                 transport=baseline_transport("fsl_an", "topk"))
    _, _, meter, launches, _ = drive(
        tr, lambda: FederatedBatcher(fed, B, H, seed=0), cm, "fsl_an topk",
        2, B)
    check(launches == only(), "fsl_an topk: no kernel launched")
    check(meter.counts["uplink_smashed"] == 2 * N * H * 41_472,
          f"fsl_an topk uplink = 2 rounds x {N} clients x {H} units x 864 "
          f"rows x 6 of 64 kept x 8 B = 41,472 B a client unit")
    check_topk_ties(dev)
    done(t0)
    return out


def check_topk_ties(dev):
    """The topk codec where magnitudes tie, at the LM paths' smashed shape
    (bf16 ``[2, 64, 1024]``, about 2 elements a bf16 magnitude in a row) and
    on integers from [-8, 8]: the card's wire (indices in their order,
    values) and decoded payload equal the CPU's bitwise, and the indices
    are the reference's order (``jax.lax.top_k``: magnitude descending, the
    lower index first among equals), computed here with numpy's stable
    lexsort."""
    g = torch.Generator().manual_seed(3)
    cases = (("bf16", torch.randn((2, 64, 1024), generator=g)
              .to(torch.bfloat16)),
             ("ints", torch.randint(-8, 9, (2, 64, 1024), generator=g)
              .float()))
    for kind, x in cases:
        for ratio in (0.1, 0.5):
            codec = dataclasses.replace(get_codec("topk"), ratio=ratio)
            k = codec._k(x.shape[-1])
            mag = x.float().abs().numpy()
            order = np.lexsort((np.broadcast_to(np.arange(mag.shape[-1]),
                                                mag.shape), -mag))[..., :k]
            srt = -np.sort(-mag, axis=-1)
            straddle = int((srt[..., k - 1] == srt[..., k]).sum())
            cw, gw = codec.encode(x), codec.encode(x.to(dev))
            check(straddle > 0 and same(gw["indices"], cw["indices"])
                  and same(gw["values"], cw["values"])
                  and same(codec.decode(gw, x.to(dev)), codec.decode(cw, x))
                  and np.array_equal(cw["indices"].numpy(), order),
                  f"topk ties ({kind} [2, 64, 1024], ratio {ratio}, k {k}; "
                  f"{straddle} of 128 rows tie across the k-th place): the "
                  "card's wire and decoded payload == the CPU's bitwise, "
                  "indices in the reference's order")


def rel_error(got, want, before=None) -> float:
    """``|got - want| / |want - before|`` (``before`` None: ``/ |want|``),
    2-norms over all the tensors of the trees ``got`` (any device) and
    ``want``, ``before`` (both on one device, the CPU or the card).  With
    ``before`` (an update read back as new params less old) each element's
    difference first drops one ulp of ``want``: the rounding of the new
    params, which differs between the two sides wherever their updates
    differ at all."""
    num, den = rel_sums(got, want, before)
    return (num / den) ** 0.5


def rel_sums(got, want, before=None) -> tuple:
    """:func:`rel_error`'s squared numerator and denominator."""
    num = den = 0.0
    olds = tree_leaves(before) if before is not None else None
    for j, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        d = (g.to(w.device) - w).abs()
        if olds is not None:
            a = w.abs()
            d = (d - (torch.nextafter(a, torch.full_like(a, math.inf)) - a)
                 ).clamp_(min=0)
        num += float(d.double().square().sum())
        w = w.double()
        den += float((w if olds is None else w - olds[j].double())
                     .square().sum())
    return num, den


def update_error(before, want, got) -> float:
    """Largest over the state's keys of the card's unit update against the
    CPU's (:func:`rel_error` of each key's params)."""
    return max(rel_error(got[k]["params"], want[k]["params"],
                         before[k]["params"])
               for k in want if k != "round")


def hook_errors(hooks, tps, state, unit, dev):
    """One unit of a baseline, hook by hook, the card fed the CPU's inputs
    at every hook: the CPU's state, batch and coded payloads.  Returns
    whether the card's coding of the CPU's uploads and replies is bitwise
    the CPU's (the unit's seeds, salt 0 up and 1 down), and the largest
    :func:`rel_error` of the card's smashed data, replies and updates."""
    def put(tree):
        return tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t,
                        tree)

    h, hc = hooks["cpu"], hooks[dev]
    rnd, shared, stacked = state["round"], h.server_shared, stacked_keys(h)
    worst, coded_same = 0.0, True

    def code(channel, payload):
        nonlocal coded_same
        want = getattr(tps["cpu"], channel)(payload, rnd)
        got = getattr(tps[dev], channel)(put(payload), rnd)
        coded_same &= all(same(g, w) for g, w in zip(tree_leaves(got),
                                                     tree_leaves(want)))
        return want

    slices, uploads, pendings = [], [], []
    for i in range(N):
        cs = {k: tree_map(lambda t: t[i], state[k]) for k in stacked}
        cb = (torch.as_tensor(unit[0][i, 0]), torch.as_tensor(unit[1][i, 0]))
        want = h.client_compute(cs, cb, LR)
        got = hc.client_compute(put(cs), put(cb), LR)
        worst = max(worst, rel_error(got[1][0], want[1][0]),
                    rel_error(got[0]["clients"]["params"],
                              want[0]["clients"]["params"],
                              cs["clients"]["params"])
                    if h.client_receive is None else 0.0)
        slices.append(want[0])
        uploads.append(want[1])
        pendings.append(want[2])
    coded = code("code_uplink", tuple(torch.stack(u) for u in
                                      zip(*uploads)))
    sstate, replies = state[h.server_key] if shared else None, []
    for i in range(N):
        up = tuple(t[i] for t in coded)
        before = sstate if shared else slices[i][h.server_key]
        want = h.server_consume(before, up, LR)
        got = hc.server_consume(put(before), put(up), LR)
        worst = max(worst, rel_error(got[0]["params"], want[0]["params"],
                                     before["params"]))
        if h.client_receive is not None:
            worst = max(worst, rel_error(got[1], want[1]))
            replies.append(want[1])
        if shared:
            sstate = want[0]
    if h.client_receive is not None:
        coded = code("code_downlink", torch.stack(replies))
        for i in range(N):
            args = (slices[i], pendings[i], coded[i])
            want = h.client_receive(*args, LR)
            got = hc.client_receive(*put(args), LR)
            worst = max(worst, rel_error(got["clients"]["params"],
                                         want["clients"]["params"],
                                         slices[i]["clients"]["params"]))
    return coded_same, worst


def phase_baselines_cpu_vs(dev, fed):
    """Phase 16: each baseline's first 2 rounds (10 units), one unit at a
    time along the CPU's trajectory, with the same Philox bits on every
    coded channel.  Free-running runs are no test here: at lr 0.15 this
    CNN's per-batch methods amplify an fp32 difference by a large factor
    each unit, on the identity wire too and between the JAX package and
    the port on the CPU alike.  So each unit is checked from one state, at
    two depths:
    * the unit step (``Trainer.step``, the main path): the card's losses
      within phase 5's rtol 1e-3 of the CPU's, and its update (new params
      less old, each state key) within UNIT_RTOL of the CPU's in 2-norm.
      That bound is coarse: a stochastic-rounding step that one side takes
      and the other does not moves an element by a whole quantum, and
      FSL_OC's four server steps a unit build on each other; a skipped,
      zeroed or misrouted update reads about 1;
    * hook by hook (:func:`hook_errors`), the card fed the CPU's inputs:
      the coded uploads and replies bitwise the CPU's, and the smashed
      data, the replies (the server's input gradient) and every update
      within HOOK_RTOL of the CPU's."""
    t0 = phase("16 CNN baselines CPU vs card: 2 rounds, unit by unit from "
               "the CPU's states, the same Philox bits")
    for method in BASELINES:
        fsl = FSLConfig(num_clients=N, h=1, agg_every=H, lr=LR, method=method)
        trs = {d: Trainer(cnn_bundle(CIFAR10, device=d), fsl,
                          transport=baseline_transport(method))
               for d in ("cpu", dev)}
        hooks = {d: tr.method.make_async_hooks(tr.bundle, fsl)
                 for d, tr in trs.items()}
        tps = {d: tr.transport for d, tr in trs.items()}
        state = trs["cpu"].init(0)
        batcher = FederatedBatcher(fed, B, H, seed=0)
        worst_loss = worst_upd = worst_hook = 0.0
        rounds_agree = coded_same = True
        for _ in range(2):
            x, y = batcher.next_round()
            for k in range(H):
                unit = (x[:, k:k + 1], y[:, k:k + 1])
                want, wm = trs["cpu"].step(state, unit, LR)
                got, gm = trs[dev].step(tree_map(
                    lambda t: t.to(dev) if torch.is_tensor(t) else t, state),
                    unit, LR)
                worst_loss = max(worst_loss, *(
                    abs(float(gm[m]) - float(wm[m])) / abs(float(wm[m]))
                    for m in wm))
                worst_upd = max(worst_upd, update_error(state, want, got))
                same_k, hook_k = hook_errors(hooks, tps, state, unit, dev)
                coded_same &= same_k
                worst_hook = max(worst_hook, hook_k)
                rounds_agree &= got["round"] == want["round"]
                state = want
            state = trs["cpu"].aggregate(state)
        check(rounds_agree and state["round"] == 2 * H,
              f"{method}: the same unit counter on both, {2 * H} units")
        check(worst_loss <= 1e-3, f"{method}: every unit's losses agree at "
              f"rtol 1e-3 (worst {worst_loss:.3g})")
        check(worst_upd <= UNIT_RTOL, f"{method}: every unit's update within "
              f"{UNIT_RTOL:g} of the CPU's in 2-norm (worst {worst_upd:.3g})")
        check(coded_same, f"{method}: the card codes the CPU's uploads"
              + (" and replies" if get_method(method).downloads_gradients
                 else "") + " bitwise as the CPU does, every unit")
        check(worst_hook <= HOOK_RTOL, f"{method}: hook by hook from the "
              f"CPU's inputs, smashed data, replies and updates within "
              f"{HOOK_RTOL:g} of the CPU's in 2-norm (worst "
              f"{worst_hook:.3g})")
    done(t0)


def phase_lm_baselines(dev):
    """Phase 17: FSL_OC on full-width Qwen3-0.6B (28 layers) and FSL_MC on
    it cut to 20 layers, bf16, the kernels on, int8 up and down, through
    Trainer.run, with per-round launch counts derived from the hooks, the
    plain attention backward never called, the meter and the peak device
    memory.  Returns each path's trainer, data, launches and peak."""
    t0 = phase("17 Qwen3 baselines: FSL_OC (28 layers) and FSL_MC (20 "
               "layers), full width, bf16, kernels on, int8 up and down")
    out = {}
    for method, layers in BL_LM_PATHS:
        cfg = lm_cfg() if layers is None else lm_cfg().with_(
            num_layers=layers)
        bundle = lm_bundle(cfg, dev)
        fsl = baseline_fsl(method, lm=True)
        fed = lm_data(cfg, fsl, LM_S)
        cm = cost_model(bundle, LM_N, LM_SAMPLES)
        tr = Trainer(bundle, fsl, transport=baseline_transport(method))
        tag = f"qwen3-0.6b {cfg.num_layers} layers {method} int8"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        plain_bwd, plain_calls = ref.swa_attention_bwd, []

        def counted(*a, **kw):
            plain_calls.append(1)
            return plain_bwd(*a, **kw)

        ref.swa_attention_bwd = counted
        try:
            state, hist, meter, launches, per_round = drive(
                tr, lambda: LMBatcher(cfg, fed, LM_B, LM_H, seed=0), cm, tag,
                BL_LM_ROUNDS, LM_B)
        finally:
            ref.swa_attention_bwd = plain_bwd
        peak = torch.cuda.max_memory_allocated(dev)
        # K2 once on the uplink and once on the downlink a unit
        want = lm_launches(cfg, method, 2 * LM_H)
        for i, c in enumerate(per_round):
            check(c == want, f"{method} round {i + 1} launches {c} == {want}")
        check(not plain_calls, f"{method}: the plain attention backward "
              "(ref.swa_attention_bwd) ran no time")
        wire = LM_S * cfg.d_model + (LM_S // 8) * (cfg.d_model // 128) * 4
        per = BL_LM_ROUNDS * LM_N * LM_H * wire
        check(wire == 4_210_688 and meter.counts["uplink_smashed"] == per
              and meter.counts["downlink_grads"] == per,
              f"{method} int8 uplink = downlink = {BL_LM_ROUNDS} rounds x "
              f"{LM_N} clients x {LM_H} units x 4,210,688 B")
        check(state["round"] == BL_LM_ROUNDS * LM_H,
              f"{method} state['round'] = {BL_LM_ROUNDS * LM_H} units")
        print(f"  [{method}] peak device memory over the run: "
              f"{peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
        out[f"qwen3-{cfg.num_layers}L-{method}"] = {
            "trainer": tr, "fed": fed, "cfg": cfg, "launches": launches,
            "per_round": want, "peak_bytes": peak}
        del state, hist, meter
        torch.cuda.empty_cache()
    done(t0)
    return out


def phase_baseline_times(dev, fed, records, cnn_paths, lm_paths):
    """Phase 18: a round of each baseline path on the host clock (median,
    ending in synchronize) with its device time and idle share, and K2 at
    the Qwen3 uplink/downlink shape [4, 4096, 1024] beside its bound, its
    plain version and the CNN shape's record.  Returns each path's
    numbers."""
    t0 = phase("18 baseline times (host clock medians, profiler device time)")
    out = {}

    def timed(tag, tr, state, batch, lr, n_time, n_prof, warm):
        box = {"state": state}

        def step():
            st, m = tr.step(box["state"], batch, lr)
            box["state"] = tr.aggregate(st)
            for v in m.values():
                float(v)

        for _ in range(warm):
            step()
        round_ms, per = time_rounds(step, n_time)
        print(f"  [{tag}] round (step + FedAvg, host clock after "
              f"synchronize): median {round_ms:.3f} ms of "
              f"{[round(p, 3) for p in per]}")
        busy, idle = profile_round(step, n_prof, round_ms)
        del box
        return {"round_ms": round_ms, "rounds_ms": per, "device_ms": busy,
                "idle_share": idle}

    for method, p in cnn_paths.items():
        tr = p["trainer"]
        batch = tr.to_device(FederatedBatcher(fed, B, H, seed=1).next_round())
        out[f"cnn-{method}"] = {**timed(f"cnn {method}", tr, p["state"],
                                        batch, LR, 5, 3, 2),
                                "launches": {k: v for k, v in
                                             p["launches"].items() if v}}
    for tag, p in lm_paths.items():
        tr = p["trainer"]
        batch = tr.to_device(LMBatcher(p["cfg"], p["fed"], LM_B, LM_H,
                                       seed=1).next_round())
        torch.cuda.empty_cache()
        # one timed LM round (two until phase 28 took the room)
        out[tag] = {**timed(tag, tr, tr.init(0), batch, LM_LR, 1, 1, 1),
                    "peak_bytes": p["peak_bytes"],
                    "launches_per_round": {k: v for k, v in
                                           p["per_round"].items() if v}}
        torch.cuda.empty_cache()

    # K2 at the Qwen3 wire shape: the bf16 smashed data and its gradient,
    # cast to fp32, 4 clients a launch
    n, r, c = LM_N, LM_S, 1024
    x, _ = payload(n, r, c, seed=8)
    xd = x.to(dev)
    seeds = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    elems, tiles = n * r * c, n * -(-r // ref.BT) * -(-c // ref.BC)
    io = elems * (4 + 1) + tiles * 4 + n * 8
    ops = 8 * elems + (2 * elems + (elems // 4) * 10 * 10) \
        * FP32_OPS / INT32_OPS
    q, s = qk.quantize_2d(xd, seeds=seeds)
    pbits = ref.philox_bits(seeds.cpu(), r, c)
    pq, ps = ref.quantize_2d(x, pbits)
    sync(dev)
    check(same(q, pq) and same(s, ps), f"quantize_philox [{n}, {r}, {c}] == "
          "plain on the CPU fed the CPU's philox_bits")
    err = max_abs(q, s, pq, ps)
    del q, s, pq, ps, pbits
    run = lambda: qk.quantize_2d(xd, seeds=seeds)       # noqa: E731
    rec = record("quantize_philox", lm_paths["qwen3-28L-fsl_oc"]["launches"]
                 ["quantize_philox"], err, graph_ms(run), event_ms(run),
                 event_ms(lambda: ref.quantize_2d(xd, ref.philox_bits(
                     seeds.cpu(), r, c).to(dev)), reps=1, inner=1, warm=0),
                 io, ops, FP32_OPS, shape=[n, r, c],
                 launches_path="qwen3-0.6b fsl_oc int8 up and down "
                               "(phase 17)")
    print("  [qwen3 wire]", end="")
    print_record(rec)
    for r_ in records:
        if r_["name"] == "quantize_philox":
            r_["qwen3_wire"] = {k: rec[k] for k in (
                "shape", "launches", "launches_path", "max_abs_err", "ms",
                "eager_ms", "plain_ms", "bound_ms", "bound_by", "bytes",
                "library_ms")}
    done(t0)
    return out


# ---------------------------------------------------------------------------
# The compiled chunk runner: Trainer.run_compiled as CUDA-graph replay
# ---------------------------------------------------------------------------

# The kernels' symbols as the profiler names them (K1 .. K6 and the K5/K6
# backwards; fused_ce's bf16 kernels are one templated GEMM and a combine).
PROFILED = ("quantize_bits_kernel", "quantize_philox_kernel",
            "ce_gemm_kernel", "ce_combine_kernel", "ce_fwd_kernel",
            "ce_dx_kernel", "ce_dw_kernel", "swa_fwd_kernel", "swa_tc_kernel",
            "swa_bwd_delta_kernel", "swa_bwd_dkdv_kernel",
            "swa_bwd_dq_kernel", "ssm_fwd_kernel", "ssm_bwd_kernel",
            "ssm_bwd_sum_kernel")
# Phase 19's paths: (tag, model, method, rounds, chunk).  Every path codes
# the uplink, the blocking methods' downlink and the model-sync wire with
# int8; the lr decays every round, so a round that read another round's lr
# shows.  The Mamba path is the phase-12 cut (16 layers, S = 2048).
# The Mamba path goes first: its loop rounds peak within half a GiB of the
# card's memory, so it runs before the other paths leave anything behind.
# Qwen3 FSL_OC runs one round (two until phase 29 took the room).
COMPILED_PATHS = (("mamba-cse_fsl", "mamba", "cse_fsl", 2, 2),
                  ("qwen3-cse_fsl", "qwen3", "cse_fsl", 2, 2),
                  ("qwen3-fsl_oc", "qwen3", "fsl_oc", 1, 1),
                  ("cnn-cse_fsl", "cnn", "cse_fsl", 4, 3),
                  ("cnn-fsl_mc", "cnn", "fsl_mc", 3, 2),
                  ("cnn-fsl_oc", "cnn", "fsl_oc", 3, 2),
                  ("cnn-fsl_an", "cnn", "fsl_an", 3, 2))
# The LM paths of phases 19 and 21 that also run the staged data path
# (``device_data=False``): since the LM batchers speak the device-pool
# protocol, ``run_compiled`` gathers their batches on the card by default.
STAGED_PATHS = ("qwen3-cse_fsl", "qwen3-cse-deadline")


class DeviceEvents:
    """One name's device activities in a profile: ``key``, ``count`` and
    ``self_device_time_total`` (µs), as ``key_averages`` gives them."""

    __slots__ = ("key", "count", "self_device_time_total")

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def cuda_events(prof) -> list:
    """A profile's device activities (kernels, copies), summed by name
    from the profiler's raw events: ``key_averages`` first builds every
    event's tree, which took 12-21 s to read a Qwen3 path's profile in
    phase 19 (H100 80GB HBM3, 700.00 W); a device activity has no
    children, so its self time is its duration."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        d = out.get(e.name())
        if d is None:
            d = out[e.name()] = DeviceEvents(e.name())
        d.count += 1
        d.self_device_time_total += e.duration_ns() / 1e3
    return list(out.values())


def kernel_counts(ev) -> dict:
    """Launches of each of the port's kernels in ``cuda_events``' list, by
    symbol."""
    out = {k: 0 for k in PROFILED}
    for e in ev:
        for k in PROFILED:
            if re.search(rf"\b{k}\b", e.key):
                out[k] += e.count
    return out


def device_ms(ev, tag="", per: int = 1, top: int = 0) -> float:
    """Kernel time in ``cuda_events``' list (ms, divided by ``per``);
    prints the ``top`` kernels."""
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {tag} {e.self_device_time_total / per / 1e3:9.3f} ms "
              f"{e.count / per:7.1f}x  {e.key[:70]}")
    return sum(e.self_device_time_total for e in ev) / 1e3 / per


def cuda_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def close_profile(dev):
    """The end of a profiled region: the card synchronized, 16 small
    kernels, synchronized again, and a 0.2 s wait.  A profiled loop of
    two Qwen3 rounds with remat came back with 59 K2 launches where its
    wrappers had counted 62, the rounds' last kernels (the model-sync
    wire's); the padding and the wait keep such a lost tail off the
    kernels counted."""
    sync(dev)
    pad = torch.zeros(1, device=dev)
    for _ in range(16):
        pad.add_(1)
    sync(dev)
    time.sleep(0.2)


class ReplayWatch:
    """The captured chunks (``graphs.CapturedChunk``) of the calls made
    inside it, watched: the wrapper launches of the warm-ups and captures
    (``at_capture``); with ``shapes``, each K2 call's shape in the
    aggregating and the other captured round (``k2_shapes[True]`` and
    ``[False]``: shape -> calls); and every replay profiled: the device
    activities (``events``, summed by name as :func:`cuda_events` gives
    them), the rounds replayed (``flags``, True where the aggregating
    graph ran), the wrapper calls made during the replays
    (``replay_calls``: 0 where the graphs launch the kernels) and the wall
    seconds the watching added around them (``added_s``: profiler start,
    read and :func:`close_profile`).  So a run's own replays are read,
    with no replayed chunk of its own for the count."""

    def __init__(self, dev, shapes: bool = False, profile: bool = True):
        self.dev, self.shapes, self.profile = dev, shapes, profile
        self.at_capture, self.k2_shapes = {}, {True: {}, False: {}}
        self.events, self.flags, self.replay_calls = {}, [], 0
        self.added_s = 0.0

    def _fold(self):
        for k, v in counts().items():
            if v:
                self.at_capture[k] = self.at_capture.get(k, 0) + v
        reset_counts()

    def __enter__(self):
        cls, watch = graphs.CapturedChunk, self
        self._orig = replay, round_, quant = (cls.replay, cls._round,
                                              qk.quantize_2d)
        variant = [None]

        def seen(x, *a, **kw):
            if variant[0] is not None:
                d = watch.k2_shapes[variant[0]]
                d[tuple(x.shape)] = d.get(tuple(x.shape), 0) + 1
            return quant(x, *a, **kw)

        def watched_round(cap, aggregated):
            variant[0] = bool(aggregated)
            try:
                return round_(cap, aggregated)
            finally:
                variant[0] = None

        def watched_replay(cap, flags, fetch=True):
            t0 = time.perf_counter()
            watch._fold()
            with cuda_profile() if watch.profile \
                    else contextlib.nullcontext() as prof:
                t1 = time.perf_counter()
                rows = replay(cap, flags, True)
                t2 = time.perf_counter()
                if watch.profile:
                    close_profile(watch.dev)
            for e in cuda_events(prof) if watch.profile else ():
                d = watch.events.setdefault(e.key, DeviceEvents(e.key))
                d.count += e.count
                d.self_device_time_total += e.self_device_time_total
            watch.flags += [bool(f) for f in flags]
            watch.replay_calls += sum(counts().values())
            reset_counts()
            watch.added_s += time.perf_counter() - t0 - (t2 - t1)
            return rows if fetch else (lambda: rows)

        cls.replay, cls._round = watched_replay, watched_round
        if self.shapes:
            qk.quantize_2d = seen
        return self

    def __exit__(self, *exc):
        self._fold()
        cls = graphs.CapturedChunk
        cls.replay, cls._round, qk.quantize_2d = self._orig
        return False

    def per_round(self) -> dict:
        """The port's kernels launched a replayed round."""
        return {k: v / max(len(self.flags), 1) for k, v in kernel_counts(
            list(self.events.values())).items() if v}

    def device_ms(self, tag: str = "", top: int = 0) -> float:
        """Device ms a replayed round (:func:`device_ms`)."""
        return device_ms(list(self.events.values()), tag,
                         max(len(self.flags), 1), top=top)


def path_cfg(model, remat=False, layers=None):
    """The LM path's config: phase 8's Qwen3, phase 12's Mamba cut,
    phase 28's olmoe, phase 29's zamba2 or phase 30's qwen2-vl cut and
    hubert, with ``remat`` and at depth ``layers`` (None: the path's
    own)."""
    cfg = {"qwen3": lm_cfg, "mamba": mb_cfg, "olmoe": moe_cfg,
           "zamba2": zamba_cfg, "qwen2vl": vlm_cfg,
           "hubert": hubert_cfg}[model]().with_(remat=remat)
    return cfg if layers is None else cfg.with_(num_layers=layers)


def path_seq(model) -> int:
    return MB_S if model == "mamba" else LM_S


def compiled_trainer(model, method, dev, remat=False, seq=None, layers=None):
    """``(trainer, make_batcher, cost model, batch size)`` of a phase-19
    path; the LM paths with ``remat``, at sequence ``seq`` (default their
    phase-19 S) and depth ``layers`` for phase 22."""
    down = "int8" if get_method(method).downloads_gradients else "none"
    tp = make_transport("int8", down, model_sync=MODEL_SYNC.get(model,
                                                                "int8"))
    if model == "cnn":
        bundle = cnn_bundle(CIFAR10, device=dev)
        fsl = FSLConfig(num_clients=N, h=H, lr=LR, lr_decay_every=1,
                        method=method)
        fed = make_data()
        return (Trainer(bundle, fsl, transport=tp),
                lambda: FederatedBatcher(fed, B, H, seed=0),
                cost_model(bundle, N, SAMPLES // N), B)
    cfg = path_cfg(model, remat, layers)
    s = seq or path_seq(model)
    # olmoe's 6.9 B, zamba2's 7.0 B, the qwen2-vl cut's 6.3 B and hubert's
    # 1.3 B parameters are drawn on the card (a host draw would take
    # minutes)
    bundle = card_bundle(cfg, dev) if model in ("olmoe", "zamba2",
                                                "qwen2vl", "hubert") \
        else lm_bundle(cfg, dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, lr_decay_every=1,
                    method=method)
    if cfg.family == "audio":       # frame features, as train_batch_specs
        def batcher():
            return SpecBatcher(cfg, fsl, s)
    else:
        fed = lm_data(cfg, fsl, s)

        def batcher():
            return LMBatcher(cfg, fed, LM_B, LM_H, seed=0)
    return (Trainer(bundle, fsl, transport=tp), batcher,
            cost_model(bundle, LM_N, LM_SAMPLES), LM_B)


def events_ms(fn, reps: int, per: int) -> list:
    """CUDA-event times of ``reps`` calls of ``fn``, divided by ``per``."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / per)
    return out


def state_on_cpu(state) -> list:
    return [t.cpu() for t in state_leaves(state)]


def bits_digest(t: torch.Tensor) -> int:
    """A 64-bit digest of ``t``'s bits, computed on its device: its bytes as
    int64 words (zero-padded), each times its own odd weight (a splitmix64
    hash of its index), summed modulo 2^64.  An odd weight is invertible
    modulo 2^64, so a change in any one word always changes the digest;
    changes in several words cancel with probability about 2^-64."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 8:               # a copy only where words need padding
        b = torch.cat([b, b.new_zeros((-b.numel()) % 8)])
    b = b.view(torch.int64)
    total, step = 0, 1 << 26
    for i in range(0, b.numel(), step):
        z = torch.arange(i, min(i + step, b.numel()), dtype=torch.int64,
                         device=b.device) * -7046029254386353131   # golden
        z = (z ^ ((z >> 30) & 0x3FFFFFFFF)) * -4658895280553007687
        z = (z ^ ((z >> 27) & 0x1FFFFFFFFF)) * -7723592293110705685
        z = z ^ ((z >> 31) & 0x1FFFFFFFF)
        total += int((b[i:i + step] * (z | 1)).sum())
    return total % 2 ** 64


def state_digests(state) -> list:
    """``bits_digest`` of every state leaf: a state compared without a
    copy of it (olmoe's 19.6 GB state: two copies to the host and a host
    comparison took about 17 of phase 28's seconds on an H100 80GB HBM3
    at 700 W; phases 19, 21 and 22 compare their states this way since
    phase 29 took their host copies' seconds)."""
    return [(tuple(t.shape), t.dtype, bits_digest(t))
            for t in state_leaves(state)]


class Laps:
    """Wall seconds of a path's steps in order (``lap(name)`` closes the
    step running since the last lap): where phases 19 and 22 spend their
    time."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, name: str):
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f}" for k, v in self.s.items())


def check_staged(lab, tr, make_batcher, rounds, chunk, want, hist, meter,
                 cm, dev, masked=False) -> dict:
    """The staged data path, ``run_compiled(..., device_data=False)``: the
    rounds' batches stacked on the host (counted at ``_stack_rounds``) and
    copied into the capture's buffers, the masked chunk program on staged
    data with ``masked``.  The same rounds from ``init(0)`` as the loop's
    run (``want``: its state's ``state_digests``, ``hist``, ``meter``),
    which the pooled run equals too: state, history rows and meter
    bitwise."""
    stacks, orig = [], trainer_mod._stack_rounds

    def counting(*xs):
        stacks.append(len(xs))
        return orig(*xs)

    m = CommMeter()
    tr._captured = None             # the pooled capture's memory first
    gc.collect()
    torch.cuda.empty_cache()
    trainer_mod._stack_rounds = counting
    t = time.perf_counter()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            state, shist = tr.run_compiled(tr.init(0), make_batcher(), rounds,
                                           chunk=chunk, log_every=1, meter=m,
                                           cost_model=cm, device_data=False)
        sync(dev)
    finally:
        trainer_mod._stack_rounds = orig
    secs = time.perf_counter() - t
    cap = tr._captured
    check(bool(stacks) and not cap.pooled and cap.masked == masked,
          f"{lab} device_data=False staged the batches: {len(stacks)} "
          f"stacked leaves, a staged {'masked ' if masked else ''}capture "
          f"({secs:.3f} s for warm-up, captures, {rounds} replays)")
    check(state_digests(state) == want and shist == hist
          and m.counts == meter,
          f"{lab} the staged run_compiled == run == the pooled "
          f"run_compiled, bitwise (state, history rows, meter; "
          f"{len(want)} leaves, 64-bit digests of their bits)")
    del state, cap
    tr._captured = None
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": secs, "stacked_leaves": len(stacks)}


def check_compiled_path(tag, model, method, rounds, chunk, dev, keep=False,
                        remat=False, seq=None, layers=None, want=None,
                        reps=None, staged=False, time_loop=True,
                        after_loop=None, profile=True):
    """Phase 19 for one path, with the measurements phase 20 prints; phase
    22 runs its paths through it with ``remat`` (at sequence ``seq`` and
    depth ``layers``).

    ``run`` for ``rounds`` rounds from ``init(0)`` (lm_bundle's params),
    profiled,
    an LM path's wrapper launches counted round by round against
    lm_launches, then timed on for a few more; ``run_compiled`` for the
    same rounds from the same state (warm-up, the two captures, the
    replays), both under deterministic algorithms: the states bitwise, the
    history rows and the meters equal, the meters equal to CommProfile, an
    LM path's warm-up and two captured rounds calling each layer kernel's
    wrapper 3 rounds' worth (so with remat the captured backward holds the
    recompute); its replays profiled inside the call (ReplayWatch): the
    same kernels as often as a loop round, and no wrapper call; then a few
    chunks timed.  ``want``: a run without remat (the state's digests,
    history, meter) that the loop's run must equal, bitwise.  With
    ``keep``, the loop's run is returned under ``"loop_run"`` for phase
    22.  ``reps``: the loop rounds and compiled chunks timed (default 5 on
    the CNN, 2 on an LM path; one LM round or chunk since phase 26 made
    room, PERF.md §7).  With ``staged``, last, the same rounds through the
    staged data path (check_staged).  Without ``time_loop`` no loop round
    is timed (phase 22, whose ratios PERF.md quotes from the compiled
    rounds): ``loop_ms`` and ``loop_idle`` are None.  ``after_loop(tr,
    state, batcher)`` runs on the loop's final state before it is
    freed (phase 28's aux losses).  Without ``profile`` (hubert, whose
    round launches about 100,000 kernels) neither engine's rounds are
    profiled: the launches a round and the replays' wrapper calls are
    counted as before, but the kernels by symbol, the device time and the
    loop's idle are not read, the loop's ms a round is its run's host
    time (``loop_run_ms``), and no replayed round is timed alone
    (``replay_ms`` and ``compiled_idle`` are None).  The loop's state is kept as its
    leaves' ``bits_digest`` on the card (``state_digests``), not as a host
    copy: run_compiled's, the staged run's and a remat run's states are
    held to those digests."""
    lab = f"[{tag}{' remat' if remat else ''}]"
    print(f"  {lab} at the start: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated",
          flush=True)
    lap = Laps()
    tr, make_batcher, cm, bsz = compiled_trainer(model, method, dev, remat,
                                                 seq, layers)
    lap("setup (bundle, data, trainer)")
    nm = len(tr.method.model_sync_specs(tr.bundle, tr.fsl))
    synced = not tr.transport.model_identity    # an int8 model-sync wire
    k2 = tr.units_per_round * (
        2 if get_method(method).downloads_gradients else 1) + 2 * nm * synced
    lcfg = None if model == "cnn" else path_cfg(model, remat, layers)
    expect = None if lcfg is None else lm_launches(lcfg, method, k2)
    if lcfg is not None:
        seq = seq or path_seq(model)
        print(f"  {lab} S {seq}, {lcfg.num_layers} layers; expected "
              f"launches a round { {k: v for k, v in expect.items() if v} }",
              flush=True)
    # deterministic algorithms for the whole path: the graphs captured here
    # keep their kernels, so the loop is timed under the same setting
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    meters, after = [CommMeter(), CommMeter()], []
    reps = reps or (5 if model == "cnn" else 1)
    batcher, state = make_batcher(), tr.init(0)
    lap("initial state")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t = time.perf_counter()
    with cuda_profile() if profile else contextlib.nullcontext() as prof:
        state, lhist = tr.run(state, batcher, rounds, log_every=1,
                              meter=meters[0], cost_model=cm,
                              callback=lambda *_: after.append(counts()))
        sync(dev)
        loop_s = time.perf_counter() - t
        lap("loop rounds" + (" (profiled)" if profile else ""))
        if profile:
            close_profile(dev)
    loop_counts = loop_dev = None
    if profile:
        ev = cuda_events(prof)
        loop_counts = kernel_counts(ev)
        loop_dev = device_ms(ev, "loop", rounds, top=5)
        del ev
        lap("loop profile read")
    del prof
    if expect is not None:
        for i, c in enumerate(after):
            c = {k: v - (after[i - 1][k] if i else 0) for k, v in c.items()}
            check(c == expect, f"{lab} round {i + 1} launches "
                  f"{ {k: v for k, v in c.items() if v} } == expected")
    check(all(math.isfinite(row[k]) for row in lhist
              for k in metric_keys(row)), f"{lab} losses finite: "
          f"{[round(row[k], 6) for row in lhist for k in metric_keys(row)]}")
    copy = state_digests(state)
    loop_run = {"state": copy, "hist": lhist, "meter": dict(meters[0].counts)}
    if want is not None:
        check(copy == want["state"] and lhist == want["hist"]
              and meters[0].counts == want["meter"],
              f"[{tag}] run with remat == run without, bitwise (state, "
              "losses, meter)")
    if after_loop is not None:
        after_loop(tr, state, batcher)
        lap("after the loop")
    box = {"state": state}

    def loop_round():
        box["state"], _ = tr.run(box["state"], batcher, 1)

    loop_ms = events_ms(loop_round, reps, 1) if time_loop else []
    loop_peak = torch.cuda.max_memory_allocated(dev)
    lap("loop timed rounds")
    del state, box
    gc.collect()
    torch.cuda.empty_cache()
    lap("free")

    print(f"  {lab} before run_compiled: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    batcher, state = make_batcher(), tr.init(0)
    lap("initial state")
    t = time.perf_counter()
    with ReplayWatch(dev, profile=profile) as watch:
        state, chist = tr.run_compiled(state, batcher, rounds, chunk=chunk,
                                       log_every=1, meter=meters[1],
                                       cost_model=cm)
        sync(dev)
    first_s = time.perf_counter() - t - watch.added_s
    lap("run_compiled (warm-up, captures, replays profiled)")
    at_capture = {k: v for k, v in watch.at_capture.items() if v}
    bitwise = state_digests(state) == copy
    print(f"  {lab} run: {rounds} rounds in {loop_s:.3f} s (profiled); "
          f"run_compiled (warm-up, two captures, {rounds} replays at chunk "
          f"{chunk}): {first_s:.3f} s, less the {watch.added_s:.3f} s its "
          f"replays' profiling added; wrapper launches at warm-up and "
          f"capture {at_capture}")
    check(bitwise, f"{lab} run_compiled's state == run's, bitwise, under "
          f"deterministic algorithms ({len(copy)} leaves, 64-bit digests "
          "of their bits)")
    check(chist == lhist, f"{lab} history rows (losses, aggregated, "
          "comm_bytes) == run's, bitwise")
    prof_ = tr.comm_profile(cm, bsz, batch=make_batcher().next_round())
    aggs = sum(r["aggregated"] for r in chist)
    wire = {"uplink_smashed": rounds * prof_.wire_uplink_smashed,
            "uplink_labels": rounds * prof_.uplink_labels,
            "downlink_grads": rounds * prof_.wire_downlink_grads,
            "model_sync": aggs * prof_.wire_model_sync}
    check(meters[1].counts == meters[0].counts == wire
          and (0 < prof_.wire_model_sync < prof_.model_sync if synced
               else prof_.wire_model_sync == prof_.model_sync),
          f"{lab} meter {meters[1].counts} == run's == CommProfile "
          f"(model sync {prof_.wire_model_sync:,} B "
          f"{'int8' if synced else 'uncoded'} of {prof_.model_sync:,} B "
          f"raw, {aggs} aggregations)")
    if expect is not None:
        layer = [k for k in expect if expect[k] and not k.startswith(
            ("quantize", "fused_ce"))]
        check(all(at_capture.get(k) == 3 * expect[k] for k in layer),
              f"{lab} the warm-up and the two captured rounds called the "
              f"layer kernels 3 rounds' worth "
              f"{ {k: at_capture.get(k) for k in layer} }" + (
                  " (the captured backward reruns the forward)"
                  if remat else ""))

    lap("checks")
    wrapper_calls = watch.replay_calls
    replay_dev = per_replay = None
    if profile:
        # the run's own replays, profiled inside it (ReplayWatch)
        replay_dev = watch.device_ms("replay", top=5)
        per_loop = {k: v / rounds for k, v in loop_counts.items() if v}
        per_replay = watch.per_round()
        print(f"  {lab} kernels a round, profiled: loop {per_loop}; "
              f"replayed {per_replay}")
        check(per_replay == per_loop and len(watch.flags) == rounds
              and all(watch.flags) and all(r["aggregated"] for r in chist),
              f"{lab} a replayed round launches every kernel a loop round "
              f"does, as often ({len(per_replay)} kernels; every round "
              "aggregates)")
        check(per_replay.get("quantize_philox_kernel") == k2,
              f"{lab} K2 {k2} times a replayed round: {tr.units_per_round} "
              f"unit(s) x the coded wire channel(s)"
              + (f", {nm} model leaves up, {nm} down" if synced
                 else ", the model sync uncoded"))
    check(wrapper_calls == 0 and len(watch.flags) == rounds,
          f"{lab} the replays called no kernel wrapper: the graphs launch "
          "the kernels")

    box = {"state": state}

    def compiled_chunk():
        box["state"], _ = tr.run_compiled(box["state"], batcher, chunk,
                                          chunk=chunk)

    compiled_ms = events_ms(compiled_chunk, reps, chunk)
    cap = tr._captured

    def replay_round():             # one aggregating round, device only
        cap.step.zero_()
        cap.graphs[True].replay()

    graph_ms_ = events_ms(replay_round, reps, 1) if profile else []
    peak = torch.cuda.max_memory_allocated(dev)
    lap("compiled timed rounds")
    out = {"rounds": rounds, "chunk": chunk, "remat": remat,
           "seq": seq, "layers": lcfg and lcfg.num_layers,
           "loop_ms": statistics.median(loop_ms) if loop_ms else None,
           "loop_rounds_ms": loop_ms,
           "compiled_ms": statistics.median(compiled_ms),
           "compiled_rounds_ms": compiled_ms, "loop_device_ms": loop_dev,
           "compiled_device_ms": replay_dev,
           "replay_ms": statistics.median(graph_ms_) if graph_ms_ else None,
           "loop_peak_bytes": loop_peak, "compiled_peak_bytes": peak,
           "kernels_per_round": per_replay, "model_leaves": nm,
           "run_compiled_first_s": first_s, "launches_per_round": expect,
           "loop_run_ms": loop_s * 1e3 / rounds}
    # idle: the loop's from its kernel time; the compiled round's from one
    # replayed round alone (inside a graph the profiler's kernel times can
    # add up to more than the replay: short kernels read long there)
    out["loop_idle"] = 1 - loop_dev / out["loop_ms"] \
        if loop_ms and profile else None
    out["compiled_idle"] = 1 - out["replay_ms"] / out["compiled_ms"] \
        if graph_ms_ else None
    if keep:
        out["loop_run"] = loop_run
    del box, state, cap
    gc.collect()
    torch.cuda.empty_cache()
    if staged:
        out["staged"] = check_staged(lab, tr, make_batcher, rounds, chunk,
                                     copy, lhist, meters[0].counts, cm, dev)
        lap("staged run_compiled")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    lap("free")
    out["laps_s"] = lap.s
    print(f"  {lab} seconds: {lap.line()}", flush=True)
    return out


def check_capture_raises(dev, masked=False):
    """A wrapper made to synchronize the card: the capture (of the masked
    graphs with ``masked``) raises, and run_compiled does not fall back to
    eager rounds."""
    if masked:
        tr, _, make_batcher, _, _ = sched_trainer(
            "cnn-cse-deadline", "cnn", "cse_fsl", dev)
    else:
        tr, make_batcher, _, _ = compiled_trainer("cnn", "cse_fsl", dev)
    launch = qk._launch

    def syncing(*a, **kw):
        torch.cuda.synchronize()
        return launch(*a, **kw)

    qk._launch = syncing
    raised = None
    try:
        tr.run_compiled(tr.init(0), make_batcher(), 2, chunk=2)
    except Exception as e:      # noqa: BLE001 -- any error of the capture
        raised = e
    finally:
        qk._launch = launch
    check(raised is not None and tr._captured is None,
          f"a syncing kernel wrapper makes the "
          f"{'masked ' if masked else ''}capture raise "
          f"({type(raised).__name__}: {str(raised).splitlines()[0][:90]}), "
          "no eager fallback")
    x = torch.ones(64, 64, device=dev)
    check(float((x @ x).sum()) == 64.0 ** 3, "the card computes after the "
          "failed capture")


def phase_compiled(dev, paths=None, keep=()):
    """Phases 19 and 20: each path of COMPILED_PATHS (or of ``paths``, tags)
    through check_compiled_path (the paths in ``keep`` return their loop
    run); phase 20 prints the loop and compiled rounds measured on the
    way."""
    t0 = phase("19 compiled runner: Trainer.run_compiled as CUDA-graph "
               "replay against Trainer.run")
    env = os.environ.get
    print(f"  PYTORCH_CUDA_ALLOC_CONF={env('PYTORCH_CUDA_ALLOC_CONF')} (the "
          f"graphs' private pool takes it), CUBLAS_WORKSPACE_CONFIG="
          f"{env('CUBLAS_WORKSPACE_CONFIG')}")
    held = torch.cuda.memory_allocated(dev)
    # the earlier phases' timing streams each keep a cuBLAS workspace
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  held at the start: {held / 2**30:.3f} GiB allocated, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB after "
          f"clearing cuBLAS workspaces")
    out = {}
    for tag, model, method, rounds, chunk in COMPILED_PATHS:
        if paths is None or tag in paths:
            out[tag] = check_compiled_path(tag, model, method, rounds, chunk,
                                           dev, keep=tag in keep,
                                           staged=tag in STAGED_PATHS)
    done(t0)
    t0 = phase("20 loop vs compiled rounds (CUDA-event medians; device time "
               "from the profiled rounds)")
    for tag, r in out.items():
        print(f"  [{tag}] loop {r['loop_ms']:.3f} ms of "
              f"{[round(x, 3) for x in r['loop_rounds_ms']]}, device "
              f"{r['loop_device_ms']:.3f} ms, idle {r['loop_idle']:.4f}, "
              f"peak {r['loop_peak_bytes'] / 2**30:.3f} GiB | compiled "
              f"{r['compiled_ms']:.3f} ms of "
              f"{[round(x, 3) for x in r['compiled_rounds_ms']]}, one "
              f"replayed round alone {r['replay_ms']:.3f} ms, idle "
              f"{r['compiled_idle']:.4f} (kernel time "
              f"{r['compiled_device_ms']:.3f} ms), peak "
              f"{r['compiled_peak_bytes'] / 2**30:.3f} GiB; "
              f"{r['loop_ms'] / r['compiled_ms']:.2f}x")
    done(t0)
    return out


# ---------------------------------------------------------------------------
# Partial participation: scheduling and faults on the sync path
# ---------------------------------------------------------------------------

# Phase 21's paths: (tag, model, method, rounds, chunk).  Each runs int8 on
# every channel, the model sync included, with phase 19's trainer (its lr
# decaying every round) and one of these participation settings:
# - cnn-cse-deadline, qwen3-cse-deadline: a deadline between the two
#   slowest clients' analytic round times on the tiered network (n = 4:
#   3g, 4g, 4g, wifi; it drops the 3g client) and SCHED_FAULTS, whose seed
#   gives both paths' rounds retries, crashes and wire drops, a cohort
#   that changes from round to round within a chunk, and (the CNN path's
#   round 4) an empty one;
# - cnn-cse-bwh: bandwidth_h on the tiered network capped at stride 2
#   (strides 2, 2, 2, 1: rounds 1 and 3 only the wifi client, rounds 2 and
#   4 all), refresh=False; the default cap's strides (8, 5, 5, 1) would
#   leave three clients out of all 4 rounds;
# - cnn-fsl_oc-lossy: wait_all with the lossy preset (seed 0: a gradient
#   reply lost for good in round 1, so a blocking client drops out);
# - cnn-fsl_mc-strat: stratified (seed 2: one of the two 4g clients a
#   round, not the same one in rounds 1 and 2), FSL_MC's server replicas
#   masked with the clients;
# - cnn-empty: a registered policy admitting nobody in round 3.
SCHED_PATHS = (("cnn-cse-deadline", "cnn", "cse_fsl", 4, 3),
               ("cnn-cse-bwh", "cnn", "cse_fsl", 4, 3),
               ("cnn-fsl_oc-lossy", "cnn", "fsl_oc", 3, 2),
               ("cnn-fsl_mc-strat", "cnn", "fsl_mc", 3, 2),
               ("cnn-empty", "cnn", "cse_fsl", 3, 2),
               ("qwen3-cse-deadline", "qwen3", "cse_fsl", 3, 2))
SCHED_FAULTS = dict(loss_rate=0.3, crash_rate=0.15, max_retries=1, seed=2,
                    name="chip-mix")
SCHED_TIMED = ("cnn-cse-deadline", "qwen3-cse-deadline")
# each timed path's unmasked twin: phase 19's path of the same trainer
# (compiled_trainer), chunk and timing, whose compiled rounds stand beside
# the masked ones when phase 19 ran in this process
SCHED_TWIN = {"cnn-cse-deadline": "cnn-cse_fsl",
              "qwen3-cse-deadline": "qwen3-cse_fsl"}


class NobodyInRound3(SchedulerPolicy):
    """Admits every client but in round 3, where it admits nobody."""
    name = "chip_nobody_round3"

    def plan(self, ctx, num_rounds):
        masks = np.ones((num_rounds, ctx.fsl.num_clients), bool)
        masks[2:3] = False
        return masks


def sched_context(tr, batch, net) -> SchedContext:
    """The SchedContext ``tr`` plans against (``Trainer._plan_schedule``'s)."""
    up, reply = tr.method.payload_specs(tr.bundle, tr.fsl, batch)
    return SchedContext(
        fsl=tr.fsl, network=net,
        up_bytes=tr.transport.uplink_payload_bytes(up),
        down_bytes=tr.transport.downlink_payload_bytes(reply)
        if reply is not None else 0, blocking=tr.method.downloads_gradients,
        uploads_per_round=tr._uploads_per_round())


def sched_trainer(tag, model, method, dev):
    """``(masked trainer, unmasked trainer, make_batcher, cost model, batch
    size)`` of a phase-21 path on ``dev``; prints what the settings
    produce."""
    base, make_batcher, cm, bsz = compiled_trainer(model, method, dev)
    net, fm = TieredNetwork(), None
    n = base.fsl.num_clients
    if tag.endswith("deadline"):
        ctx = sched_context(base, make_batcher().next_round(), net)
        secs = np.sort(DeadlinePolicy().client_seconds(ctx))
        pol = DeadlinePolicy(deadline_s=float(0.5 * (secs[-2] + secs[-1])))
        fm = FaultModel(**SCHED_FAULTS)
        print(f"  [{tag}] analytic client round times "
              f"{DeadlinePolicy().client_seconds(ctx).round(4).tolist()} s "
              f"({ctx.up_bytes:,} B up a unit); deadline "
              f"{pol.deadline_s:.4f} s")
    elif tag.endswith("bwh"):
        pol = BandwidthHPolicy(max_stride=2)
        ctx = sched_context(base, make_batcher().next_round(), net)
        print(f"  [{tag}] strides {pol.strides(ctx).tolist()}")
    elif tag.endswith("lossy"):
        pol, fm = "wait_all", LossyWire()
    elif tag.endswith("strat"):
        pol = StratifiedPolicy(seed=2)
    else:
        if NobodyInRound3.name not in available_policies():
            register_policy(NobodyInRound3)
        pol = NobodyInRound3.name
    tr = Trainer(base.bundle, base.fsl, transport=base.transport,
                 scheduler=pol, network=net, faults=fm)
    if fm is not None:
        blocking = tr.method.downloads_gradients
        t = fm.trace(12, n, tr._uploads_per_round())
        print(f"  [{tag}] faults {fm.name}: loss_rate {fm.loss_rate}, "
              f"crash_rate {fm.crash_rate}, max_retries {fm.max_retries}, "
              f"seed {fm.seed}; survival of rounds 1-4 "
              f"{t.survives(blocking)[:4].astype(int).tolist()}")
    return tr, base, make_batcher, cm, bsz


def window_participants(masks, flags):
    """Each aggregating round's cohort size: the AND of ``masks`` since the
    last aggregation (all True at the start)."""
    part, out = np.ones(masks.shape[1], bool), []
    for m, f in zip(masks, flags):
        part &= m
        if f:
            out.append(int(part.sum()))
            part[:] = True
    return out


def expected_meter(tr, cm, bsz, sample, rounds, flags, parts) -> dict:
    """The meter the trace and the cohorts imply: per round the fault
    trace's ``round_wire_bytes`` (or the profile's round without faults),
    per aggregation ``k up + recv down`` model-sync bytes (``recv = n``
    where the scheduler refreshes the dropped clients, else ``k``)."""
    n, K = tr.fsl.num_clients, tr._uploads_per_round()
    prof = tr.comm_profile(cm, bsz, batch=sample)
    out = {"uplink_smashed": 0, "uplink_labels": 0, "downlink_grads": 0,
           "model_sync": 0}
    trace = None if tr.faults.is_null else tr.faults.trace(rounds, n, K)
    for r in range(rounds):
        if trace is None:
            out["uplink_smashed"] += prof.wire_uplink_smashed
            out["uplink_labels"] += prof.uplink_labels
            out["downlink_grads"] += prof.wire_downlink_grads
        else:
            for k, v in round_wire_bytes(
                    trace, r, *prof.unit_wire_bytes(n, K),
                    tr.method.downloads_gradients, FRAME_BYTES).items():
                out[k] = out.get(k, 0) + v
    up, down = tr._model_sync_wire_pair()
    recv = (lambda k: n) if tr.scheduler.refresh_dropped else (lambda k: k)
    out["model_sync"] = sum(0 if k == 0 else k * up + recv(k) * down
                            for k in parts)
    return out


def rel_change_error(got, want, before) -> float:
    """:func:`rel_error` of an update, 0 where neither side moved."""
    moved = sum(float((w.double() - b.double()).square().sum())
                for w, b in zip(tree_leaves(want), tree_leaves(before)))
    if moved == 0.0:
        return 0.0 if all(same(g, w) for g, w in zip(tree_leaves(got),
                                                      tree_leaves(want))) \
            else math.inf
    return rel_error(got, want, before)


def check_aggregates_cpu_vs(tag, tr, make_batcher, rounds, dev):
    """The CPU's run of the path, its state at each aggregation fed to the
    card's masked aggregate: the model upload's coding bitwise, the
    aggregate's params (each averaged subtree) within HOOK_RTOL of the
    CPU's, and on the card the participants' rows equal, the others the
    cohort average (refresh) or their own params bit for bit."""
    cpu = Trainer(cnn_bundle(CIFAR10, device="cpu"), tr.fsl,
                  transport=tr.transport, scheduler=tr.scheduler,
                  network=tr.network, faults=tr.faults)
    records, agg = [], cpu.masked_agg_fn

    def recording(state, mask, seeds=None):
        out = agg(state, mask, seeds)
        records.append((state, mask, seeds, out))
        return out

    cpu.masked_agg_fn = recording
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cpu.run(cpu.init(0), make_batcher(), rounds)
    axes = tr.bundle.wire_axes(tr.method.client_param_specs(tr.bundle,
                                                            tr.fsl))
    keys = tr.method.agg_keys
    worst, coded_same, rows_ok, bitwise = 0.0, True, True, True

    def put(t):
        return t.to(dev) if torch.is_tensor(t) else t

    for state, mask, seeds, want in records:
        leaves = [x if a is None else x.permute((0,) + tuple(1 + i for i in a))
                  for x, a in zip(tree_leaves(state["clients"]["params"]),
                                  axes)]
        cw = cpu.transport.code_model_up(leaves, state["round"],
                                         seeds=seeds["model_up"])
        cd = tr.transport.code_model_up([put(x) for x in leaves],
                                        state["round"],
                                        seeds=put(seeds["model_up"]))
        coded_same &= all(same(g, w) for g, w in zip(cd, cw))
        got = tr.masked_agg_fn(tree_map(put, state), put(mask),
                               {k: put(v) for k, v in seeds.items()})
        for k in keys:
            worst = max(worst, rel_change_error(got[k]["params"],
                                                want[k]["params"],
                                                state[k]["params"]))
            bitwise &= all(same(g, w) for g, w in zip(
                tree_leaves(got[k]), tree_leaves(want[k])))
        sel = mask.bool()
        p0 = int(sel.nonzero()[0, 0])
        for g, x in zip(tree_leaves(got["clients"]["params"]),
                        tree_leaves(state["clients"]["params"])):
            g = g.cpu()
            for c in range(sel.numel()):
                if sel[c] or tr.scheduler.refresh_dropped:
                    rows_ok &= same(g[c], g[p0])
                else:
                    rows_ok &= same(g[c], x[c])
    check(len(records) > 0, f"[{tag}] the CPU's run aggregated "
          f"{len(records)} time(s); each state fed to the card's aggregate")
    check(coded_same, f"[{tag}] the card codes the CPU's model uploads "
          "bitwise as the CPU does, at every aggregation")
    check(worst <= HOOK_RTOL, f"[{tag}] the card's masked aggregate within "
          f"{HOOK_RTOL:g} of the CPU's in 2-norm, every averaged subtree "
          f"{keys} (worst {worst:.3g}; bitwise: {bitwise})")
    check(rows_ok, f"[{tag}] on the card the cohort's rows are equal and "
          + ("every other client takes the average (refresh)"
             if tr.scheduler.refresh_dropped else
             "every other client keeps its own params bit for bit "
             "(refresh=False)"))


def check_sched_path(tag, model, method, rounds, chunk, dev):
    """Phase 21 for one path: ``run`` against ``run_compiled`` under the
    path's scheduler and faults, the meter against the trace, the
    participants against the plan and survival, the CPU's aggregates
    against the card's (CNN), K2 in the replayed graphs, and, for
    SCHED_TIMED, the rounds' times beside the unmasked path's."""
    print(f"  [{tag}] at the start: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated")
    tr, base, make_batcher, cm, bsz = sched_trainer(tag, model, method, dev)
    del base
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    meters = [CommMeter(), CommMeter()]
    warned = [[], []]
    sample = make_batcher().next_round()
    batcher = make_batcher()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        state, lhist = tr.run(tr.init(0), batcher, rounds, log_every=1,
                              meter=meters[0], cost_model=cm)
        sync(dev)
        warned[0] = [str(x.message) for x in w]
    loop_summary = tr.participation_summary()
    want = state_digests(state)
    out = {"rounds": rounds, "chunk": chunk}
    reps = 5 if model == "cnn" else 1       # one LM round: room for 26
    if tag in SCHED_TIMED:          # phase 20's cadence
        box = {"state": state}

        def loop_round():
            box["state"], _ = tr.run(box["state"], batcher, 1)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out["loop_rounds_ms"] = events_ms(loop_round, reps, 1)
        out["loop_ms"] = statistics.median(out["loop_rounds_ms"])
        del box
    del state
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    batcher = make_batcher()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        state, chist = tr.run_compiled(tr.init(0), batcher, rounds,
                                       chunk=chunk, log_every=1,
                                       meter=meters[1], cost_model=cm)
        sync(dev)
        warned[1] = [str(x.message) for x in w]
    at_capture = {k: v for k, v in counts().items() if v}
    got = state_leaves(state)
    bitwise = state_digests(state) == want
    flags = [r["aggregated"] for r in lhist]
    parts = [r["participants"] for r in lhist if r["aggregated"]]
    print(f"  [{tag}] rows: " + "; ".join(
        f"r{r['round']} " + " ".join(f"{k} {r[k]:.5f}" for k in
                                     metric_keys(r))
        + f" agg {int(r['aggregated'])}"
        + (f" k {r['participants']} dropped {r['dropped_updates']}"
           if r["aggregated"] else "")
        + (f" retries {r['fault_retries']} drops {r['fault_drops']}"
           if "fault_retries" in r else "") for r in lhist))
    print(f"  [{tag}] wrapper launches at warm-up and capture {at_capture}; "
          f"empty-cohort warnings: loop {len(warned[0])}, compiled "
          f"{len(warned[1])}")
    check(bitwise, f"[{tag}] run_compiled's state == run's, bitwise, under "
          f"deterministic algorithms ({len(want)} leaves, 64-bit digests of "
          "their bits)")
    check(chist == lhist, f"[{tag}] history rows (losses, aggregated, "
          "participants, dropped updates, fault retries and drops, "
          "comm_bytes) == run's")
    check(meters[1].counts == meters[0].counts,
          f"[{tag}] meter {meters[1].counts} == run's")
    summary = tr.participation_summary()
    check(summary == loop_summary, f"[{tag}] participation_summary() == "
          f"run's: {json.dumps(summary)}")
    check(warned[0] == warned[1], f"[{tag}] the same {len(warned[0])} "
          "empty-cohort warning(s) in both engines")
    K = tr._uploads_per_round()
    trace = None if tr.faults.is_null else tr.faults.trace(
        rounds, tr.fsl.num_clients, K)
    masks = tr._effective_masks(sample, rounds, trace)
    want_parts = window_participants(masks, flags)
    check(parts == want_parts, f"[{tag}] participants {parts} == the plan "
          f"AND survival over each window ({want_parts})")
    exp = expected_meter(tr, cm, bsz, sample, rounds, flags, parts)
    check(meters[0].counts == exp, f"[{tag}] meter == the trace's "
          "round_wire_bytes + the cohorts' model-sync bytes "
          f"({exp['model_sync']:,} B model sync)")
    if trace is not None:
        f = summary["faults"]
        check(f["retries"] > 0 and f["crash_drops"] + f["wire_drops"] > 0,
              f"[{tag}] the faults bit: {f['retries']} retries, "
              f"{f['crash_drops']} crashes, {f['wire_drops']} wire drops, "
              f"{f['retransmit_bytes']:,} B retransmitted")
    if model == "cnn":
        check_aggregates_cpu_vs(tag, tr, make_batcher, rounds, dev)

    if tag in SCHED_TIMED:
        box = {"state": state}

        def compiled_chunk():
            box["state"], _ = tr.run_compiled(box["state"], batcher, chunk,
                                              chunk=chunk)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out["compiled_rounds_ms"] = events_ms(compiled_chunk, reps,
                                                  chunk)
        out["compiled_ms"] = statistics.median(out["compiled_rounds_ms"])
        state = box["state"]
        del box
    out["compiled_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # K2 in each captured graph, one replay of it alone (the staged chunk's
    # row 0), then the replays of a chunk holding an empty window
    cap = tr._captured
    blocking = tr.method.downloads_gradients
    nm = len(tr.method.model_sync_specs(tr.bundle, tr.fsl))
    k2_plain = tr.units_per_round * (2 if blocking else 1)
    k2 = {}
    for aggregated in (True, False):
        reset_counts()
        with cuda_profile() as prof:
            cap.step.zero_()
            cap.graphs[aggregated].replay()
            close_profile(dev)      # the profiler can lose a tail kernel
        k2[aggregated] = kernel_counts(cuda_events(prof))[
            "quantize_philox_kernel"]
        check(sum(counts().values()) == 0, f"[{tag}] the replay called no "
              "kernel wrapper")
        if aggregated:
            out["replay_ms"] = statistics.median(events_ms(
                lambda: (cap.step.zero_(), cap.graphs[True].replay()),
                reps, 1))
    check(k2[True] == k2_plain + 2 * nm and k2[False] == k2_plain,
          f"[{tag}] K2 (profiled) {k2[True]} times in the aggregating graph, "
          f"as phase 19's unmasked round of {method} ({k2_plain} on the "
          f"wire + {nm} model leaves up + {nm} down), {k2[False]} in the "
          "other")
    out["k2_per_round"] = {"aggregating": k2[True], "other": k2[False]}
    out["k2_at_capture"] = at_capture.get("quantize_philox", 0)
    check(out["k2_at_capture"] == 2 * (k2_plain + 2 * nm) + k2_plain,
          f"[{tag}] K2's launch counter at warm-up and capture "
          f"{out['k2_at_capture']}: the warm-up's aggregating round, the "
          "aggregating capture and the other")
    del state, cap, got
    if tag in STAGED_PATHS:
        out["staged"] = check_staged(f"[{tag}]", tr, make_batcher, rounds,
                                     chunk, want, lhist, meters[0].counts,
                                     cm, dev, masked=True)
    del want
    if tag == "cnn-empty":
        check_empty_window(tag, tr, make_batcher, dev, k2_plain)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    return out


def time_unmasked(model, method, chunk, dev) -> dict:
    """A phase-21 path without scheduling or faults (phase 19's trainer),
    ``run_compiled`` timed as check_sched_path times the masked one."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    base, make_batcher, _, _ = compiled_trainer(model, method, dev)
    batcher = make_batcher()
    box = {"state": base.run_compiled(base.init(0), batcher, chunk,
                                      chunk=chunk)[0]}

    def plain_chunk():
        box["state"], _ = base.run_compiled(box["state"], batcher, chunk,
                                            chunk=chunk)

    ms = events_ms(plain_chunk, 5 if model == "cnn" else 1, chunk)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    return {"unmasked_rounds_ms": ms, "unmasked_ms": statistics.median(ms)}


def release(dev):
    """Free what the last path left: collect, empty the cache, drop the
    cuBLAS workspaces each side stream kept; prints what is held."""
    gc.collect()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    torch.cuda.empty_cache()
    print(f"  held: {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB "
          f"allocated, {torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB "
          "reserved")


def check_empty_window(tag, tr, make_batcher, dev, k2_plain):
    """Round 3 admits nobody: ``run_compiled`` for rounds 1-2 (from a new
    batcher, whose device pool makes this trainer capture a second time),
    then round 3 alone, profiled: only the wire's K2 (no model-sync
    launch), and the state bitwise the loop's round 3 step without any
    aggregation."""
    batcher = make_batcher()
    state, _ = tr.run_compiled(tr.init(0), batcher, 2, chunk=2)
    with warnings.catch_warnings(record=True) as w, cuda_profile() as prof:
        warnings.simplefilter("always")
        state, hist = tr.run_compiled(state, batcher, 1, chunk=2,
                                      log_every=1)
        close_profile(dev)
    n_k2 = kernel_counts(cuda_events(prof))["quantize_philox_kernel"]
    lb = make_batcher()
    ref_state, _ = tr.run(tr.init(0), lb, 2)
    ref_state, _ = tr.step(ref_state, lb.next_round(), rnd=2)
    sync(dev)
    check(tr._captured.data[0] is batcher.device_pool(tr.device),
          f"[{tag}] a second capture on this trainer (a new batcher's "
          "device pool) ran")
    check(hist[0]["aggregated"] and hist[0]["participants"] == 0
          and len(w) == 1, f"[{tag}] round 3's cadence fires on an empty "
          f"cohort: participants 0, one warning ({str(w[0].message)[:60]})")
    check(n_k2 == k2_plain, f"[{tag}] the empty round replays the "
          f"aggregation-free graph: K2 {n_k2} time(s) (the wire's), no "
          "model-sync launch")
    check(all(same(a, b) for a, b in zip(state_leaves(state),
                                          state_leaves(ref_state))),
          f"[{tag}] its state == round 3's step alone (Trainer.step after "
          "2 loop rounds, no FedAvg), bitwise")


def phase_sched(dev, paths=None, plain=None):
    """Phase 21: each path of SCHED_PATHS (or of ``paths``, tags) through
    check_sched_path; prints the timed paths' rounds beside their unmasked
    twins' (SCHED_TWIN: from ``plain``, phase 19's numbers, where it holds
    the twin; else timed here by time_unmasked).  Returns each path's
    numbers."""
    t0 = phase("21 scheduling and faults: masked FedAvg behind the "
               "model-sync wire, Trainer.run against run_compiled")
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for tag, model, method, rounds, chunk in SCHED_PATHS:
        if paths is None or tag in paths:
            out[tag] = check_sched_path(tag, model, method, rounds, chunk,
                                        dev)
            release(dev)
            twin = (plain or {}).get(SCHED_TWIN.get(tag))
            if tag in SCHED_TIMED and twin is not None:
                check(twin["chunk"] == chunk, f"[{tag}] phase 19's "
                      f"{SCHED_TWIN[tag]} ran at chunk {chunk} too")
                out[tag].update(unmasked_rounds_ms=twin["compiled_rounds_ms"],
                                unmasked_ms=twin["compiled_ms"],
                                unmasked_from="phase 19")
            elif tag in SCHED_TIMED:
                out[tag].update(time_unmasked(model, method, chunk, dev))
                release(dev)
    for tag, r in out.items():
        if "loop_ms" in r:
            print(f"  [{tag}] loop {r['loop_ms']:.3f} ms of "
                  f"{[round(x, 3) for x in r['loop_rounds_ms']]} | compiled "
                  f"{r['compiled_ms']:.3f} ms of "
                  f"{[round(x, 3) for x in r['compiled_rounds_ms']]}, one "
                  f"aggregating replay alone {r['replay_ms']:.3f} ms, peak "
                  f"{r['compiled_peak_bytes'] / 2**30:.3f} GiB | unmasked "
                  f"compiled {r['unmasked_ms']:.3f} ms of "
                  f"{[round(x, 3) for x in r['unmasked_rounds_ms']]}"
                  + (" (phase 19's run)" if r.get("unmasked_from") else ""))
    done(t0)
    return out


# ---------------------------------------------------------------------------
# Layer recompute (cfg.remat)
# ---------------------------------------------------------------------------

# Phase 22's paths: (tag, model, method, S, depth), through phase 19's
# check_compiled_path with remat (int8 uplink, downlink and model sync,
# deterministic algorithms, both engines).  The first two are phase 19's
# CSE-FSL paths, against phase 19's runs without remat (run here when
# phase 19's are not at hand).  The others are the cuts remat lifts: the
# Mamba path at train_4k's S = 4096 (phase 12: S = 2048, out of memory at
# 4096 without remat) and FSL_MC on full-width Qwen3 at all 28 layers
# (phase 17: 20 layers, out of memory at 24 and 28 without remat), in
# phase 19's setup; a path lists its sizes largest first, and a size that
# runs out of memory is recorded and the next one tried.  The Mamba paths
# go first, as in phase 19.
REMAT_PATHS = (("mamba-cse_fsl", "mamba", "cse_fsl", (MB_S,), None),
               ("qwen3-cse_fsl", "qwen3", "cse_fsl", (LM_S,), None),
               ("mamba-cse_fsl-s4096", "mamba", "cse_fsl", (4096, 3072),
                None),
               ("qwen3-fsl_mc-28L", "qwen3", "fsl_mc", (LM_S,), (28, 24)))
# The two main paths run phase 19's 2 rounds (their states are held to
# phase 19's); the lifted cuts one (two until phase 29 took the room).
REMAT_ROUNDS, REMAT_LIFT_ROUNDS = 2, 1
# Phase 22 times one compiled chunk a path (phase 19 times two) and no loop
# round (PERF.md quotes its compiled ratios): the room phases 25 and 28
# take in the script's time limit.
REMAT_REPS = 1


def remat_line(tag, r) -> str:
    loop = "not timed" if r["loop_ms"] is None else \
        f"{r['loop_ms']:.3f} ms/round"
    return (f"[{tag} remat={r['remat']}] loop {loop}, peak "
            f"{r['loop_peak_bytes'] / 2**30:.3f} GiB | compiled "
            f"{r['compiled_ms']:.3f} ms/round of "
            f"{[round(x, 3) for x in r['compiled_rounds_ms']]}, peak "
            f"{r['compiled_peak_bytes'] / 2**30:.3f} GiB")


def phase_remat(dev, paths=None, plain=None):
    """Phase 22: layer recompute.  Each path of REMAT_PATHS (or of
    ``paths``, tags) through check_compiled_path with remat: the two main
    paths bitwise equal to the same path without it, the lifted cuts at
    the largest size that fits.  ``plain``: phase 19's numbers of the main
    paths, with their ``"loop_run"``; a path missing from it runs without
    remat here first.  Returns each path's numbers."""
    t0 = phase("22 layer recompute (cfg.remat): against the runs without "
               "it, run and run_compiled, deterministic algorithms; the cuts "
               "it lifts")
    release(dev)
    r = REMAT_ROUNDS
    out = {}
    for tag, model, method, seqs, depths in REMAT_PATHS:
        if paths is not None and tag not in paths:
            continue
        if len(seqs) == 1 and depths is None:
            base = (plain or {}).get(tag) or check_compiled_path(
                tag, model, method, r, r, dev, keep=True, seq=seqs[0],
                time_loop=False)
            print("  " + remat_line(tag, base) + (
                " (phase 19's run)" if plain and tag in plain else ""))
            release(dev)
            withr = check_compiled_path(tag, model, method, r, r, dev,
                                        keep=True, remat=True, seq=seqs[0],
                                        want=base["loop_run"],
                                        reps=REMAT_REPS, time_loop=False)
            print("  " + remat_line(tag, withr), flush=True)
            out[tag] = {"plain": {k: v for k, v in base.items()
                                  if k != "loop_run"}, "remat": withr}
            print(f"  [{tag}] remat costs "
                  f"{withr['compiled_ms'] / base['compiled_ms']:.3f}x "
                  f"compiled; peak {base['loop_peak_bytes'] / 2**30:.3f} -> "
                  f"{withr['loop_peak_bytes'] / 2**30:.3f} GiB loop, "
                  f"{base['compiled_peak_bytes'] / 2**30:.3f} -> "
                  f"{withr['compiled_peak_bytes'] / 2**30:.3f} GiB compiled")
            release(dev)
            continue
        tried, r1 = [], REMAT_LIFT_ROUNDS
        for seq in seqs:
            for layers in depths or (None,):
                try:
                    res = check_compiled_path(tag, model, method, r1, r1, dev,
                                              remat=True, seq=seq,
                                              layers=layers, reps=REMAT_REPS,
                                              time_loop=False)
                except torch.OutOfMemoryError:
                    res = {"seq": seq, "fits": False,
                           "layers": path_cfg(model, True, layers).num_layers,
                           "peak_bytes": torch.cuda.max_memory_allocated(
                               dev)}
                    torch.use_deterministic_algorithms(False)
                    torch.backends.cudnn.deterministic = False
                else:
                    res["fits"] = True
                    print("  " + remat_line(tag, res), flush=True)
                tried.append(res)
                release(dev)
                if res["fits"]:
                    break
                print(f"  [{tag}] S {seq}, layers {layers}: out of memory "
                      f"at {res['peak_bytes'] / 2**30:.3f} GiB allocated")
            if tried[-1]["fits"]:
                break
        check(tried[-1]["fits"], f"[{tag}] runs with remat in both engines "
              f"at S {tried[-1]['seq']}, {tried[-1]['layers']} layers "
              f"(tried {[(t['seq'], t['layers']) for t in tried]})")
        out[tag] = {"tried": tried}
    done(t0)
    return out


# ---------------------------------------------------------------------------
# The paper's figure scripts
# ---------------------------------------------------------------------------

# Phase 23: each script of repro_torch.benchmarks at its own settings, on
# the card, in this order; each asserts the JAX script's claims.
FIGURES = ("table34_aux_params", "fig45_convergence", "fig78_aux_arch",
           "fig_faults", "fig9_codec_tradeoff")
# The scripts whose claims compare accuracies near chance run under
# deterministic algorithms (benchmarks.common.deterministic): each runs
# twice here, and the second run must end on the first's rows.
REPEATED_FIGURES = ("fig45_convergence", "fig78_aux_arch", "fig_faults")
# Fig 9's last claim, "the cheapest uplink of the sweep is CSE-FSL with a
# codec" (benchmarks/fig9_codec_tradeoff.py:132-135), fails in the JAX
# script itself at its own settings: at equal rounds every method uploads
# once a round, the four topk rows tie at 1.424 MiB, and min() takes the
# first, FSL_MC's.  The port keeps the claim as it is and fails the same
# way; this phase holds that failure to the reference's (the row the JAX
# script's run on the CPU names), so a port that failed otherwise, or
# passed, fails here.
FIG9_REFERENCE_FAILURE = {"method": "fsl_mc(h=1)", "codec": "topk",
                          "uplink_MiB": 1.424}


def figure_summary(name: str, res) -> dict:
    """The rows a script's table ends on (its final points)."""
    if name == "fig45_convergence":
        return {k: v[-1] for k, v in res.items()}
    if name == "table34_aux_params":
        return {"cifar10_mlp": res["cifar10"][0],
                "transformers": res["transformers"]}
    return res


def fig9_against_reference(mod, dev) -> dict:
    """Fig 9 at its own settings; its claims as the JAX script's fare: the
    int8 ratio holds and the cheapest-uplink claim fails on
    FIG9_REFERENCE_FAILURE's row.  Returns the open failure, for the
    record's ``known_reference_failures``."""
    failed = None
    try:
        mod.main(dev)
    except AssertionError as e:     # the claim's own assert, reported below
        failed = e.args[0] if e.args else None
    got = {k: failed.get(k) for k in FIG9_REFERENCE_FAILURE} \
        if isinstance(failed, dict) else failed
    print(f"  fig9_codec_tradeoff: the claim 'the cheapest uplink is "
          f"CSE-FSL with a codec' FAILS on the card: cheapest {failed}")
    check(got == FIG9_REFERENCE_FAILURE, "fig9_codec_tradeoff: its claims "
          "fare as in the JAX script (int8 uplink 3.5-4.05x below fp32 for "
          "every method holds; the cheapest-uplink claim fails in both "
          f"packages on {FIG9_REFERENCE_FAILURE})")
    return {"script": "fig9_codec_tradeoff",
            "claim": "the cheapest uplink is CSE-FSL with a codec",
            "reference": "benchmarks/fig9_codec_tradeoff.py:132-135",
            "failed_on": failed}


def phase_figures(dev):
    """Phase 23: the five figure scripts' ``main`` on the card (table34
    counts shapes on the meta device and takes no device).  A script whose
    claim fails raises, and so does this phase, but for fig9's claim that
    fails in the JAX script too (fig9_against_reference).  The
    REPEATED_FIGURES run a second time, which must end on the first run's
    rows.  Returns each script's seconds (of its first run) and final
    rows, and the claims that fail in both packages."""
    t0 = phase("23 the paper's figure scripts on the card (Figs 4/5, 7/8, "
               "9, Tables III/IV, the fault figure)")
    import importlib
    out, known = {}, []
    for name in FIGURES:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        t = time.perf_counter()
        if name == "fig9_codec_tradeoff":
            known.append(fig9_against_reference(mod, dev))
            res = known[-1]["failed_on"]
        else:
            res = mod.main() if name == "table34_aux_params" \
                else mod.main(dev)
            print(f"  {name}: ran to its end, its claims held",
                  flush=True)
        sync(dev)
        secs = time.perf_counter() - t
        print(f"  {name}: {secs:.3f} s", flush=True)
        out[name] = {"seconds": secs, "final": figure_summary(name, res)}
        if name in REPEATED_FIGURES:
            check(mod.main(dev) == res, f"{name}: a second run ends on the "
                  "same rows as the first (deterministic algorithms)")
            print(f"  {name}: a second run ends on the same rows, bit for "
                  "bit", flush=True)
        release(dev)
    for k in known:
        print(f"  OPEN, in both packages: {k['script']}'s claim "
              f"'{k['claim']}' ({k['reference']}) fails on {k['failed_on']}")
    done(t0)
    return out, known


# ---------------------------------------------------------------------------
# The event engine (AsyncTrainer)
# ---------------------------------------------------------------------------

# Phase 24: the event engine against Trainer.run at zero latency, on the
# CNN main path's setup (int8 uplink, int8 model sync; every method) and
# on phase 19's Qwen3 CSE-FSL path (int8 uplink and model sync, lr decaying
# every round), then CSE-FSL on the CNN under a lognormal latency and the
# lossy wire with its frames verified, then the three drivers at their own
# settings.  The CNN rounds aggregate every round (C = h).
ENGINE_ROUNDS = 2
ENGINE_FAULTS = dict(loss_rate=0.5, seed=0)
ENGINE_DRIVERS = ("fig6_async_order", "fig_sched", "fig_wallclock")
# fig_sched and fig_wallclock at their own ``--smoke`` settings (4 rounds;
# the tiered network with wait_all and deadline, and 4g with none and
# int8), which assert the same claims: room for phase 26; fig6_async_order
# at its ``--smoke`` 30 rounds, converged as at 50: room for phase 27
DRIVER_KW = {"fig6_async_order": dict(rounds=30),
             "fig_sched": dict(rounds=4, nets=("tiered",),
                               policies=("wait_all", "deadline")),
             "fig_wallclock": dict(rounds=4, tiers=("4g",),
                                   codecs=("none", "int8"))}


class Shapes:
    """Records what an engine run hands its wire and kernel wrappers: each
    uplink coding's client and payload shape (``Transport.code_uplink``),
    and the input shapes of K3/K4 (x) and of K6 and its backward (q), by
    wrapping what the engine and the ops call (nothing where not
    ``active``)."""

    SITES = ((Transport, "code_uplink", "uplink",
              lambda tp, payload, *a, client=None, **kw:
              (client, tuple(tree_leaves(payload)[0].shape))),
             (ce, "fused_ce_fwd", "fused_ce_fwd",
              lambda x, *a, **kw: tuple(x.shape)),
             (ce, "fused_ce_bwd", "fused_ce_bwd",
              lambda x, *a, **kw: tuple(x.shape)),
             (swa, "swa_attention_fwd", "swa_attention",
              lambda q, *a, **kw: tuple(q.shape)),
             (swa, "swa_attention_bwd", "swa_attention_bwd",
              lambda q, *a, **kw: tuple(q.shape)))

    def __init__(self, active: bool = True):
        self.active, self.saved = active, []
        self.seen = {key: set() for _, _, key, _ in self.SITES}

    def __enter__(self):
        for obj, attr, key, what in self.SITES if self.active else ():
            fn = getattr(obj, attr)
            self.saved.append((obj, attr, fn))

            def wrapped(*a, _fn=fn, _key=key, _what=what, **kw):
                self.seen[_key].add(_what(*a, **kw))
                return _fn(*a, **kw)
            setattr(obj, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in self.saved:
            setattr(obj, attr, fn)


def engine_lm_launches(cfg, k2: int) -> dict:
    """A CSE-FSL round's wrapper launches through the event engine on an LM
    path (n = 4, h = 2), each client on its own (nothing folded): the aux
    head's fused CE (one fwd, one bwd) per local step per client and the
    server head's per consumed upload; the layer kernel (K6 or K5) once per
    client layer a local step and the smashed pass, per server layer an
    update; its backward once per client layer a step and per server layer
    an update (with ``cfg.remat`` the forward once more a backward);
    ``k2`` K2 launches."""
    cut = cfg.resolved_cut
    srv = cfg.num_layers - cut
    heads = LM_N * LM_H + LM_N
    fwd = LM_N * (cut * (LM_H + 1) + srv)
    bwd = LM_N * (cut * LM_H + srv)
    if cfg.remat:
        fwd += bwd
    want = only(quantize_philox=k2, fused_ce_fwd=heads, fused_ce_dx=heads,
                fused_ce_dw=heads, fused_ce_p=heads)
    if cfg.family == "ssm":
        want.update(ssm_scan=fwd, ssm_scan_bwd=bwd, ssm_scan_bwd_sum=bwd)
    else:
        want.update(swa_attention_tc=fwd,
                    **{n: bwd for n in swa.BWD_KERNELS})
    return want


def engine_cpu_run(fsl, tp, make_batcher, rounds, cm, **kw):
    """The same engine run on the CPU (full width, the same Philox bits):
    its AsyncStats, arrival order, FaultStats and meter."""
    eng = AsyncTrainer(cnn_bundle(CIFAR10, device="cpu"), fsl, transport=tp,
                       **kw)
    meter = CommMeter()
    eng.run(eng.init(0), make_batcher(), rounds, meter=meter, cost_model=cm)
    return eng.stats.as_dict(), eng.stats.arrival_order, (
        eng.fault_stats.as_dict() if eng.fault_stats is not None
        else None), meter.counts


def run_pair(tr, eng, state0, make_batcher, rounds, cm, reps):
    """``Trainer.run`` then ``AsyncTrainer.run`` for ``rounds`` rounds from
    copies of ``state0``, each with its launches counted a round, then
    ``reps`` more rounds of each timed alone (CUDA events).  Returns both
    runs' (state, history, meter, per-round launches), ms a round, and the
    engine's kernel-wrapper input shapes (Shapes.seen) and AsyncStats of
    its checked run."""
    out, ms = [], []
    for t in (tr, eng):
        meter, after = CommMeter(), []
        state = tree_map(lambda x: x.clone() if torch.is_tensor(x) else x,
                         state0)
        batcher = make_batcher()
        sync(t.device)
        reset_counts()
        with Shapes(active=t is eng) as shapes:
            state, hist = t.run(state, batcher, rounds, log_every=1,
                                meter=meter, cost_model=cm,
                                callback=lambda *_: after.append(counts()))
            sync(t.device)
        per_round = [{k: c[k] - (after[i - 1][k] if i else 0) for k in c}
                     for i, c in enumerate(after)]
        out.append((state, hist, meter, per_round))
        stats = getattr(t, "stats", None)       # each run draws new stats
        box = {"state": tree_map(lambda x: x.clone() if torch.is_tensor(x)
                                 else x, state)}

        def one_round(t=t, box=box, batcher=batcher):
            box["state"], _ = t.run(box["state"], batcher, 1)

        ms.append(events_ms(one_round, reps, 1))
        del box
    # the engine's (it runs second)
    return out, ms, shapes.seen, stats


def states_agree(a, b, rtol=1e-5):
    """``(bitwise, worst |a - b| - rtol |b|)`` over two states' tensors."""
    xs = [x for k in sorted(a) if k != "round" for x in tree_leaves(a[k])]
    ys = [y for k in sorted(b) if k != "round" for y in tree_leaves(b[k])]
    bitwise = all(same(x, y) for x, y in zip(xs, ys))
    worst = max(float(((x.float() - y.float()).abs()
                       - rtol * y.float().abs()).max())
                for x, y in zip(xs, ys))
    return bitwise, worst


def zero_latency_order(method: str) -> list:
    """The first round's consumption order of the engine at zero latency
    (every event at t = 0 and the heap FIFO on ties): a unit at a time in
    client order where the client waits for its reply or uploads once a
    round (Trainer.run's order), every unit of a client in turn where it
    streams its h uploads (FSL_AN, whose servers are per client)."""
    m = get_method(method)
    k = H if m.uploads_every_batch else 1
    if m.downloads_gradients or k == 1:
        return [c for _ in range(k) for c in range(N)]
    return [c for c in range(N) for _ in range(k)]


def check_client_coding(dev):
    """The engine's per-client coding (``Transport.code_uplink(...,
    client=c)``, and the downlink's) against the stacked round step's, on
    the card at the CNN's and Qwen3's wire shapes: client c's row bitwise
    the stacked call's row c, from the staged seed table and from seeds
    derived on the host."""
    tp = make_transport("int8", "int8")
    g = torch.Generator().manual_seed(0)
    for shape, dtype in (((N, B, 6, 6, 64), torch.float32),
                         ((LM_N, LM_B, LM_S, 1024), torch.bfloat16)):
        x = torch.randn(shape, generator=g).to(dev, dtype)
        lab = torch.randint(0, 10, shape[:2], generator=g,
                            dtype=torch.int32).to(dev)
        n, unit = shape[0], 7
        table = {k: torch.from_numpy(v).to(dev) for k, v in tp.stage_seeds(
            unit, 1, n, {"uplink": 2, "downlink": 1}).items()}
        up = tp.code_uplink((x, lab), unit, seeds=table["uplink"][0])
        down = tp.code_downlink(x, unit, seeds=table["downlink"][0])
        rows = [(tp.code_uplink((x[c], lab[c]), unit, client=c,
                                seeds=table["uplink"][0]),
                 tp.code_uplink((x[c], lab[c]), unit, client=c),
                 tp.code_downlink(x[c], unit, client=c,
                                  seeds=table["downlink"][0]))
                for c in range(n)]
        ok = all(same(r[0][0], up[0][c]) and same(r[0][1], lab[c])
                 and same(r[1][0], up[0][c]) and same(r[2], down[c])
                 for c, r in enumerate(rows))
        check(ok and not same(up[0][0], up[0][1]),
              f"one client's coding (client=c) == row c of the stacked "
              f"coding, bitwise, uplink and downlink, at {list(shape)} "
              f"{str(dtype)[6:]}")


def check_engine_cnn(dev, fed, out):
    """Phase 24 (a): every method on the CNN at zero latency against
    Trainer.run, and (b): CSE-FSL under a lognormal latency and the lossy
    wire with its frames verified."""
    check_client_coding(dev)
    bundle = cnn_bundle(CIFAR10, device=dev)
    cm = cost_model(bundle, N, SAMPLES // N)
    tp = make_transport("int8", model_sync="int8")
    zero = ConstantLatency(0.0, 0.0, 0.0)

    def make_batcher(skip=0, h=H):
        batcher = FederatedBatcher(fed, B, h, seed=0)
        for _ in range(skip):
            batcher.next_round()
        return batcher

    r = ENGINE_ROUNDS
    for method in ("cse_fsl",) + BASELINES:
        fsl = FSLConfig(num_clients=N, h=H, lr=LR, method=method)
        tr = Trainer(bundle, fsl, transport=tp)
        eng = AsyncTrainer(bundle, fsl, transport=tp, latency=zero)
        state0 = tr.init(0)
        ((s_sync, h_sync, m_sync, _), (s_eng, h_eng, m_eng, per_round)), \
            (sync_ms, eng_ms), seen, stats = run_pair(
                tr, eng, state0, make_batcher, r, cm, 3)
        K = eng.hooks.uploads_per_round
        nm = len(tr.method.model_sync_specs(bundle, fsl))
        k2 = N * K + 2 * nm
        tag = f"[cnn-{method}]"
        check([x["aggregated"] for x in h_eng]
              == [x["aggregated"] for x in h_sync] == [True] * r,
              f"{tag} the engine's aggregation schedule == Trainer.run's "
              "(every round)")
        check(m_eng.counts == m_sync.counts and [x["comm_bytes"] for x in
                                                 h_eng]
              == [x["comm_bytes"] for x in h_sync],
              f"{tag} meter {m_eng.counts} == Trainer.run's, row by row")
        check(stats.arrival_order == zero_latency_order(method),
              f"{tag} zero latency consumes in Trainer.run's order "
              f"(first round {stats.arrival_order})")
        cpu_stats, order, _, cpu_meter = engine_cpu_run(
            fsl, tp, make_batcher, r, cm, latency=zero)
        check(stats.as_dict() == cpu_stats and stats.arrival_order == order
              and cpu_meter == m_eng.counts,
              f"{tag} AsyncStats and meter == the CPU engine's "
              f"({stats.events} events, async {stats.async_time:.3f} s, "
              f"barrier {stats.sync_time:.3f} s)")
        for i, c in enumerate(per_round):
            check(c == only(quantize_philox=k2),
                  f"{tag} round {i + 1}: K2 {k2} times, nothing else: "
                  f"{N} clients x {K} unit(s) one at a time + {nm} "
                  f"model leaves up + {nm} down")
        check(seen["uplink"] == {(c, (B, 6, 6, 64)) for c in range(N)},
              f"{tag} the uplink codes one client's [{B}, 6, 6, 64] upload "
              f"a call, as that client: {sorted(seen['uplink'])}")
        # numerics, unit by unit from Trainer.run's states as phase 16
        # holds the card: the free runs part by fp32 rounding (per-client
        # against vmapped convolutions), which lr 0.15 amplifies step by
        # step and the int8 wires' rounding boundaries turn into whole
        # quantization steps.  So each unit is one mini-batch (h = 1
        # rounds, C = h not crossed) on the identity wire (the coding is
        # held bitwise above).
        bitwise, worst = states_agree(s_eng, s_sync)
        fsl_u = FSLConfig(num_clients=N, h=1, lr=LR, method=method,
                          agg_every=H)
        tr_u = Trainer(bundle, fsl_u, transport="none")
        eng_u = AsyncTrainer(bundle, fsl_u, transport="none", latency=zero)
        start, errs = state0, []
        for i in range(r):
            want, _ = tr_u.run(start, make_batcher(i, 1), 1)
            got, _ = eng_u.run(start, make_batcher(i, 1), 1)
            errs.append(max(rel_change_error(got[k]["params"],
                                             want[k]["params"],
                                             start[k]["params"])
                            for k in want if k != "round"))
            start = want
        check(max(errs) <= UNIT_RTOL,
              f"{tag} each unit's update from Trainer.run's state within "
              f"{UNIT_RTOL} of Trainer.run's (relative 2-norm, worst key: "
              f"{[f'{e:.3g}' for e in errs]}); after {r} free rounds "
              + ("bitwise" if bitwise else f"|diff| - 1e-5 |ref| up to "
                 f"{worst:.3g}"))
        out[f"cnn-{method}"] = {
            "engine_ms": statistics.median(eng_ms), "engine_rounds_ms": eng_ms,
            "loop_ms": statistics.median(sync_ms), "loop_rounds_ms": sync_ms,
            "k2_per_round": k2, "unit_update_rel_err": errs,
            "free_bitwise": bitwise, "free_worst_excess": worst}
        print(f"  {tag} engine {out[f'cnn-{method}']['engine_ms']:.3f} ms a "
              f"round of {[round(x, 3) for x in eng_ms]} | Trainer.run "
              f"{out[f'cnn-{method}']['loop_ms']:.3f} ms of "
              f"{[round(x, 3) for x in sync_ms]}", flush=True)
        del tr, eng, tr_u, eng_u, state0, s_sync, s_eng, start, want, got
    # (b) arrival order, retries and the frame on the card
    fsl = FSLConfig(num_clients=N, h=H, lr=LR)
    kw = dict(latency=LognormalLatency(sigma=1.0, spread=1.0),
              faults=LossyWire(**ENGINE_FAULTS), seed=3)
    eng = AsyncTrainer(bundle, fsl, transport=tp, **kw)
    tag = "[cnn-cse-lognormal-lossy]"
    checked, raised = [], None
    check_frame = async_trainer.check_frame

    def counted(tree, frame):
        checked.append(check_frame(tree, frame))
        return checked[-1]

    async_trainer.check_frame = counted
    try:
        meter = CommMeter()
        eng.run(eng.init(0), make_batcher(), r, meter=meter, cost_model=cm)
        sync(dev)
    except RuntimeError as e:       # an undetected corruption
        raised = e
    finally:
        async_trainer.check_frame = check_frame
    trace = eng.faults.trace(r, N, 1)
    retried = int((trace.up_attempts > 1).sum())
    check(raised is None and eng.fault_stats.retries > 0 and retried > 0
          and len(checked) == retried and not any(checked),
          f"{tag} {eng.fault_stats.retries} retries; each of the "
          f"{retried} retransmitted units' corrupted copy failed its frame "
          f"({len(checked)} checks, {sum(checked)} passed"
          + (f"; the engine raised: {raised}" if raised else "") + ")")
    if raised is not None:
        return
    stats, order, fstats, cpu_meter = engine_cpu_run(fsl, tp, make_batcher,
                                                     r, cm, **kw)
    check(eng.stats.arrival_order != list(range(N)),
          f"{tag} the arrival order permutes: {eng.stats.arrival_order}")
    check(eng.stats.as_dict() == stats and eng.fault_stats.as_dict()
          == fstats and eng.stats.arrival_order == order
          and meter.counts == cpu_meter,
          f"{tag} AsyncStats, FaultStats and meter == the CPU run's of the "
          f"same traces (async {eng.stats.async_time:.3f} s against the "
          f"barrier's {eng.stats.sync_time:.3f} s)")
    out["cnn-cse-lognormal-lossy"] = {
        "stats": eng.stats.as_dict(), "arrival_order": eng.stats.arrival_order,
        "faults": eng.fault_stats.as_dict(), "frames_checked": len(checked),
        "meter": dict(meter.counts)}
    del eng


def check_engine_lm(dev, out):
    """Phase 24 (c): CSE-FSL on full-width Qwen3-0.6B, the engine against
    Trainer.run at zero latency on phase 19's trainer: losses at rtol 1e-3,
    each state key's update within UNIT_RTOL, launches a round as
    engine_lm_launches states them, at one client's shapes."""
    tr, make_batcher, cm, _ = compiled_trainer("qwen3", "cse_fsl", dev)
    eng = AsyncTrainer(tr.bundle, tr.fsl, transport=tr.transport,
                       latency=ConstantLatency(0.0, 0.0, 0.0))
    state0 = tr.init(0)
    nm = len(tr.method.model_sync_specs(tr.bundle, tr.fsl))
    cfg = lm_cfg()
    want = engine_lm_launches(cfg, LM_N + 2 * nm)
    tag = "[qwen3-cse_fsl]"
    print(f"  {tag} expected launches a round "
          f"{ {k: v for k, v in want.items() if v} }", flush=True)
    ((s_sync, h_sync, m_sync, _), (s_eng, h_eng, m_eng, per_round)), \
        (sync_ms, eng_ms), seen, _ = run_pair(
            tr, eng, state0, make_batcher, ENGINE_ROUNDS, cm, 1)
    for i, c in enumerate(per_round):
        check(c == want, f"{tag} round {i + 1} launches "
              f"{ {k: v for k, v in c.items() if v} } == expected")
    hd = cfg.resolved_head_dim
    check(seen["uplink"] == {(c, (LM_B, LM_S, cfg.d_model))
                             for c in range(LM_N)}
          and seen["swa_attention"] == seen["swa_attention_bwd"]
          == {(LM_B, LM_S, cfg.num_heads, hd)}
          and seen["fused_ce_fwd"] == seen["fused_ce_bwd"] == {
              (1, LM_S, d) for d in (cfg.aux_rank, cfg.d_model)},
          f"{tag} one client a call: the uplink "
          f"{sorted(seen['uplink'])}, K6 and its backward at "
          f"{sorted(seen['swa_attention'])}, K3/K4 at "
          f"{sorted(seen['fused_ce_fwd'])}")
    check([x["aggregated"] for x in h_eng] == [x["aggregated"]
                                              for x in h_sync]
          and m_eng.counts == m_sync.counts,
          f"{tag} aggregation schedule and meter {m_eng.counts} == "
          "Trainer.run's")
    for re, rs in zip(h_eng, h_sync):
        for k in metric_keys(rs):
            check(math.isclose(re[k], rs[k], rel_tol=1e-3),
                  f"{tag} round {rs['round']} {k} {re[k]:.6f} == "
                  f"Trainer.run's {rs[k]:.6f} at rtol 1e-3")
    errs = {k: rel_change_error(s_eng[k]["params"], s_sync[k]["params"],
                                state0[k]["params"])
            for k in s_sync if k != "round"}
    check(max(errs.values()) <= UNIT_RTOL,
          f"{tag} each key's update within {UNIT_RTOL} of Trainer.run's "
          f"(relative 2-norm: { {k: round(v, 5) for k, v in errs.items()} })")
    out["qwen3-cse_fsl"] = {
        "engine_ms": eng_ms[0], "loop_ms": sync_ms[0],
        "launches_per_round": {k: v for k, v in want.items() if v},
        "update_rel_err": errs}
    print(f"  {tag} engine {eng_ms[0]:.3f} ms a round | Trainer.run "
          f"{sync_ms[0]:.3f} ms", flush=True)
    del tr, eng, state0, s_sync, s_eng


def phase_engine(dev, fed, parts=("cnn", "lm", "drivers")):
    """Phase 24: the event engine on the card, the ``parts`` of it (the CNN
    paths, the Qwen3 path, the drivers).  Returns its numbers."""
    t0 = phase("24 event engine: AsyncTrainer against Trainer.run at zero "
               "latency (CNN, four methods; Qwen3 CSE-FSL), arrival order, "
               "retries and frames, the three drivers")
    release(dev)
    out = {}
    # deterministic algorithms, as in phases 19-22: the same kernels on
    # every run, so the comparisons and the times do not wander
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        if "cnn" in parts:
            t = time.perf_counter()
            check_engine_cnn(dev, fed, out)
            release(dev)
            out["cnn_s"] = time.perf_counter() - t
        if "lm" in parts:
            t = time.perf_counter()
            check_engine_lm(dev, out)
            release(dev)
            out["lm_s"] = time.perf_counter() - t
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    import importlib
    for name in ENGINE_DRIVERS if "drivers" in parts else ():
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        t = time.perf_counter()
        res = mod.main(dev, **DRIVER_KW.get(name, {}))
        sync(dev)
        secs = time.perf_counter() - t
        print(f"  {name}: ran to its end, its claims held, {secs:.3f} s",
              flush=True)
        out[name] = {"seconds": secs, "result": res if name ==
                     "fig6_async_order" else {k: v[-1] for k, v in
                                              res.items()}}
        release(dev)
    done(t0)
    return out


# ---------------------------------------------------------------------------
# The population engine and telemetry
# ---------------------------------------------------------------------------

# Phase 25: the population engine (repro_torch.population) and telemetry
# (repro_torch.telemetry) on the card, with phase 19's setup: int8 on every
# wire channel (the uplink, the blocking methods' downlink, the model
# sync), the lr decaying every round, deterministic algorithms.
# - cnn-dense: C == N = 4 over a FederatedPool, Population.run against
#   Trainer.run_compiled on the same data, 3 rounds at chunk 2 (segments
#   across a window boundary), every method;
# - cnn-fleet: a VirtualPool fleet of 10^6 sharding the CNN path's 1200
#   samples (each client a hashed window of 300), C = 4 stratified on the
#   tiered network, refresh=False, windows of 2 rounds (agg_every 2h), 6
#   rounds; saved after round 3 (mid-window) and restored into a fresh
#   engine; the same fleet at N = 10^4 for the memory report;
# - cnn-lossy, cnn-crashy: the presets on that fleet with refresh=True, 4
#   rounds, against the same engine on the CPU;
# - qwen3-fleet (part "lm", which main() leaves out: phase 26's CLI
#   population run drives the engine on Qwen3): full-width Qwen3-0.6B
#   through LMPool(VirtualPool), N = 10^6, C = 4, h = 2, B = 1, S = 4096,
#   CSE-FSL, stratified on the tiered network, 3 rounds;
# - telemetry: CSE-FSL on the CNN through run, run_compiled, AsyncTrainer
#   and Population with a recorder and without, 3 rounds each.
POP_N, POP_SMALL_N = 10**6, 10**4
POP_ROUNDS, POP_SAVE, POP_FAULT_ROUNDS, POP_LM_ROUNDS = 6, 3, 4, 3
POP_EXACT = ("round", "aggregated", "comm_bytes", "participants",
             "dropped_updates", "fault_retries", "fault_drops")
# The constants of the cohort draw and of the virtual shards, spelled out
# here so the plain draws below stand apart from the port's modules.
COHORT_SALT, SHARD_HASH, DATA_SALT = 0xC0408, 2654435761, 0xDA7A
POOLS = {}


def plain_seats(cohort: int, spans) -> np.ndarray:
    """Seats in proportion to the tiers, where that is exact (1/2/1 of 4
    on the tiered network's 25/50/25 split)."""
    sizes = np.array([hi - lo for _, lo, hi in spans])
    return cohort * sizes // sizes.sum()


def plain_cohort(seed: int, window: int, spans, seats) -> np.ndarray:
    """The stratified cohort of ``window``, drawn plainly: ``seats`` a
    tier, uniform within each tier from one generator keyed (seed,
    window, COHORT_SALT), sorted."""
    rng = np.random.default_rng((seed, window, COHORT_SALT))
    return np.sort(np.concatenate([
        lo + rng.choice(hi - lo, size=int(k), replace=False)
        for (_, lo, hi), k in zip(spans, seats)]))


def plain_round_indices(pool: VirtualPool, ids, rnd: int) -> np.ndarray:
    """A virtual fleet's ``[len(ids), h, B]`` index plan, drawn plainly: a
    client's shard starts at ``client * SHARD_HASH`` mod the pool, its
    batches uniform over ``d_local`` samples from (seed, client, round,
    DATA_SALT)."""
    S = len(pool.pool_x)
    return np.stack([
        (int(c) * SHARD_HASH + np.random.default_rng(
            (pool.seed, int(c), int(rnd), DATA_SALT)).integers(
                0, pool.d_local, size=(pool.h, pool.batch_size))) % S
        for c in ids])


def pop_parts(model: str, method: str, dev, agg_every: int = 0):
    """``(bundle, fsl, transport, cost model)`` of a phase-25 path."""
    down = "int8" if get_method(method).downloads_gradients else "none"
    tp = make_transport("int8", down, model_sync="int8")
    if model == "cnn":
        bundle = cnn_bundle(CIFAR10, device=dev)
        fsl = FSLConfig(num_clients=N, h=H, lr=LR, lr_decay_every=1,
                        method=method, agg_every=agg_every)
        return bundle, fsl, tp, cost_model(bundle, N, SAMPLES // N)
    bundle = lm_bundle(lm_cfg(), dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, lr_decay_every=1,
                    method=method)
    return bundle, fsl, tp, cost_model(bundle, LM_N, LM_SAMPLES)


def cnn_pool() -> VirtualPool:
    """The CNN fleet's pool: the CNN path's 1200 samples (signal 12), each
    client a window of 300 (the path's samples a client)."""
    if "cnn" not in POOLS:
        POOLS["cnn"] = VirtualPool.synthetic(
            CIFAR10.in_shape, CIFAR10.num_classes, pool_size=SAMPLES,
            d_local=SAMPLES // N, batch_size=B, h=H, seed=0, signal=12.0)
    return POOLS["cnn"]


def fleet(dev, population: int, refresh: bool = False, faults=None,
          telemetry=None):
    """A CSE-FSL engine on the CNN fleet (windows of 2 rounds) and its
    cost model."""
    bundle, fsl, tp, cm = pop_parts("cnn", "cse_fsl", dev, agg_every=2 * H)
    return Population(bundle, fsl, population=population, data=cnn_pool(),
                      transport=tp, sampler="stratified",
                      network=TieredNetwork(), refresh=refresh,
                      faults=faults, telemetry=telemetry), cm


def profiled_round(pop, dev, chunk: int) -> dict:
    """One more round of ``pop``, profiled: the port's kernels it launched
    (nonzero counts)."""
    with cuda_profile() as prof:
        pop.run(1, chunk=chunk)
        close_profile(dev)
    return {k: v for k, v in kernel_counts(cuda_events(prof)).items() if v}


def check_pop_dense(dev, fed, out, compiled):
    """Phase 25 (a): C == N, Population.run == Trainer.run_compiled."""
    for method in ("cse_fsl",) + BASELINES:
        tag = f"[cnn-dense-{method}]"
        bundle, fsl, tp, cm = pop_parts("cnn", method, dev)
        meters = [CommMeter(), CommMeter()]
        tr = Trainer(bundle, fsl, transport=tp)
        state, hist = tr.run_compiled(
            tr.init(0), FederatedBatcher(fed, B, H, seed=0), 3, chunk=2,
            log_every=1, meter=meters[0], cost_model=cm)
        want = state_on_cpu(state)
        del tr, state
        pop = Population(bundle, fsl, population=N, transport=tp,
                         data=FederatedPool(fed, B, H, seed=0)).init(0)
        state, phist = pop.run(3, chunk=2, log_every=1, meter=meters[1],
                               cost_model=cm)
        got = state_on_cpu(state)
        check(len(got) == len(want) and all(same(a, b)
                                            for a, b in zip(got, want))
              and phist == hist and meters[1].counts == meters[0].counts,
              f"{tag} Population.run == Trainer.run_compiled, bitwise "
              f"(state, {len(hist)} history rows, meter "
              f"{meters[1].total:,} B)")
        kc = profiled_round(pop, dev, 2)
        ref_ = (compiled or {}).get(f"cnn-{method}")
        if ref_ is not None:
            check(kc == ref_["kernels_per_round"], f"{tag} a population "
                  f"round launches phase 19's replayed round's kernels {kc}")
        out["k2_per_round"][f"cnn-dense-{method}"] = kc.get(
            "quantize_philox_kernel", 0)
        del pop, state
        release(dev)


def check_pop_fleet(dev, out):
    """Phase 25 (b): the CNN fleet of 10^6, refresh=False: cohorts and
    index plans against the plain draws, one shared cache row a finished
    window, the default row untouched, save/restore mid-window bitwise,
    engine_total independent of N."""
    tag = "[cnn-fleet]"
    pool = cnn_pool()
    eng, _ = fleet(dev, POP_N)
    eng.init(0)
    default0 = [t.cpu() for t in tree_leaves(eng._default)]
    t = time.perf_counter()
    state, hist = eng.run(POP_ROUNDS, chunk=2, log_every=1)
    sync(dev)
    run_s = time.perf_counter() - t
    want = state_on_cpu(state)
    spans = TieredNetwork().tier_ranges(POP_N)
    seats = plain_seats(N, spans)
    cohorts = {w: eng._cohorts[w].tolist() for w in sorted(eng._cohorts)}
    check(seats.sum() == N and (seats > 0).all()
          and all(np.array_equal(ids, plain_cohort(0, w, spans, seats))
                  for w, ids in eng._cohorts.items()),
          f"{tag} cohorts == the plain stratified draws ({seats.tolist()} "
          f"seats a tier): {cohorts}")
    plans = [pool.round_indices(eng.cohort_for(eng.window_of(r)), r)
             for r in range(POP_ROUNDS)]
    check(all(np.array_equal(p, plain_round_indices(
        pool, eng.cohort_for(eng.window_of(r)), r))
        for r, p in enumerate(plans)),
        f"{tag} index plans == the plain virtual-shard draws "
        f"({POP_ROUNDS} rounds of [{N}, {H}, {B}])")
    check(all(same(a.cpu(), b) for a, b in
              zip(tree_leaves(eng._default), default0)),
          f"{tag} the default row is unchanged by the rounds (a copy, not a "
          "view of the replayed state)")
    finished = [w for w in eng._cohorts if w < eng._window]
    rows = {id(r) for r in eng._cache.values()}
    clients = {int(c) for w in finished for c in eng._cohorts[w]}
    rep = eng.memory_report()
    check(len(rows) == len(finished) == POP_ROUNDS // 2
          and set(eng._cache) == clients
          and rep["engine"]["cache_rows"]
          == len(rows) * rep["engine"]["default_row"],
          f"{tag} one shared cache row a finished window: {len(rows)} rows "
          f"for {len(eng._cache)} clients, {rep['engine']['cache_rows']:,} B")
    summary = eng.population_summary(hist)
    del eng, state
    release(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet")
        eng, _ = fleet(dev, POP_N)
        eng.init(0)
        eng.run(POP_SAVE, chunk=2)
        check(eng.window_of(POP_SAVE) == eng.window_of(POP_SAVE - 1),
              f"{tag} the checkpoint after round {POP_SAVE} is mid-window")
        eng.save(path)
        del eng
        release(dev)
        eng, _ = fleet(dev, POP_N)
        state, rhist = eng.restore(path).run(POP_ROUNDS - POP_SAVE, chunk=2,
                                             log_every=1)
    got = state_on_cpu(state)
    check(all(same(a, b) for a, b in zip(got, want))
          and rhist == hist[POP_SAVE:],
          f"{tag} save after round {POP_SAVE}, restore into a fresh engine: "
          f"rounds {POP_SAVE + 1}-{POP_ROUNDS} bitwise the uninterrupted "
          "run's (state, losses)")
    del eng, state
    release(dev)
    small, _ = fleet(dev, POP_SMALL_N)
    small.init(0)
    small.run(POP_ROUNDS, chunk=2)
    rep_small = small.memory_report()
    check(rep_small["engine_total"] == rep["engine_total"]
          and rep["engine_total"] * 1000 < rep["dense_extrapolated"],
          f"{tag} engine_total {rep['engine_total']:,} B at N = 10^4 and "
          f"10^6; dense extrapolation at 10^6 "
          f"{rep['dense_extrapolated']:,} B "
          f"({rep['dense_extrapolated'] / rep['engine_total']:.0f}x)")
    del small
    release(dev)
    out["cnn_fleet"] = {"memory_report": rep,
                        "memory_report_small": rep_small,
                        "population_summary": summary, "cohorts": cohorts,
                        "run_s": run_s}


def check_pop_faults(dev, out):
    """Phase 25 (c): the lossy and crashy presets on the fleet, against the
    same engine on the CPU."""
    for preset in ("lossy", "crashy"):
        tag = f"[cnn-{preset}]"
        rows, meters, parts = [], [], []
        for where in (dev, torch.device("cpu")):
            eng, cm = fleet(where, POP_N, refresh=True,
                            faults=make_fault(preset))
            eng.init(0)
            meter = CommMeter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, hist = eng.run(POP_FAULT_ROUNDS, chunk=2, log_every=1,
                                  meter=meter, cost_model=cm)
            rows.append([{k: r[k] for k in POP_EXACT if k in r}
                         for r in hist])
            meters.append(meter.counts)
            parts.append(eng.trainer.participation_summary())
            losses = [r["client_loss"] for r in hist]
            del eng
        f = parts[0]["faults"]
        check(rows[0] == rows[1] and meters[0] == meters[1]
              and parts[0] == parts[1],
              f"{tag} participants {[r.get('participants') for r in rows[0]]},"
              f" dropped updates, {f['retries']} retries, "
              f"{f['crash_drops'] + f['wire_drops']} drops and the wire bytes "
              f"({meters[0]['fault_frames']:,} B of frames) == the CPU "
              "engine's")
        check((f["retries"] > 0 if preset == "lossy" else
               f["crash_drops"] > 0) and all(map(math.isfinite, losses)),
              f"{tag} the faults bit: {json.dumps(f)}")
        out[f"cnn_{preset}"] = {"rows": rows[0], "meter": meters[0],
                                "faults": f}
        release(dev)


def check_pop_lm(dev, out, compiled):
    """Phase 25 (d): full-width Qwen3-0.6B, a fleet of 10^6 through
    LMPool(VirtualPool)."""
    tag = "[qwen3-fleet]"
    cfg = lm_cfg()
    bundle, fsl, tp, cm = pop_parts("qwen3", "cse_fsl", dev)
    x, y = synthetic_lm(LM_N * LM_SAMPLES, LM_S + 1, cfg.vocab_size, seed=0)
    data = LMPool(cfg, VirtualPool(x, y, d_local=LM_SAMPLES,
                                   batch_size=LM_B, h=LM_H, seed=0))
    pop = Population(bundle, fsl, population=POP_N, data=data, transport=tp,
                     sampler="stratified", network=TieredNetwork())
    nm = len(pop.trainer.method.model_sync_specs(bundle, fsl))
    k2 = pop.trainer.units_per_round + 2 * nm
    expect = lm_launches(cfg, "cse_fsl", k2)
    torch.cuda.reset_peak_memory_stats(dev)
    pop.init(0)
    meter = CommMeter()
    reset_counts()
    t = time.perf_counter()
    state, hist = pop.run(POP_LM_ROUNDS, chunk=POP_LM_ROUNDS, log_every=1,
                          meter=meter, cost_model=cm)
    sync(dev)
    first_s = time.perf_counter() - t
    at_capture = {k: v for k, v in counts().items() if v}
    check(all(math.isfinite(r[k]) for r in hist for k in metric_keys(r))
          and len(hist) == POP_LM_ROUNDS,
          f"{tag} {POP_LM_ROUNDS} rounds, losses finite: "
          f"{[round(r[k], 5) for r in hist for k in metric_keys(r)]}")
    layer = [k for k in expect if expect[k] and not k.startswith(
        ("quantize", "fused_ce"))]
    check(all(at_capture.get(k) == 3 * expect[k] for k in layer),
          f"{tag} the warm-up and the two captured rounds called the layer "
          f"kernels 3 rounds' worth { {k: at_capture.get(k) for k in layer} }")
    spec = pop.trainer.pool_round_spec(data.device_pool(dev), (LM_N, LM_H,
                                                               LM_B))
    prof_ = pop.trainer.comm_profile(cm, LM_B, batch=spec)
    aggs = sum(r["aggregated"] for r in hist)
    wire = {"uplink_smashed": POP_LM_ROUNDS * prof_.wire_uplink_smashed,
            "uplink_labels": POP_LM_ROUNDS * prof_.uplink_labels,
            "downlink_grads": POP_LM_ROUNDS * prof_.wire_downlink_grads,
            "model_sync": aggs * prof_.wire_model_sync}
    check(meter.counts == wire, f"{tag} meter {meter.counts} == CommProfile "
          f"({aggs} aggregations)")
    kc = profiled_round(pop, dev, POP_LM_ROUNDS)
    ref_ = (compiled or {}).get("qwen3-cse_fsl")
    check(kc.get("quantize_philox_kernel") == k2 and (
        ref_ is None or kc == ref_["kernels_per_round"]),
        f"{tag} a replayed population round launches {kc}: K2 {k2} times"
        + ("" if ref_ is None else ", phase 19's compiled round's kernels"))
    box = {}

    def one_round():
        box["r"] = pop.run(1, chunk=POP_LM_ROUNDS)

    ms = events_ms(one_round, 2, 1)
    peak = torch.cuda.max_memory_allocated(dev)
    rep = pop.memory_report()
    summary = pop.population_summary(hist)
    print(f"  {tag} run (warm-up, two captures, {POP_LM_ROUNDS} replays) "
          f"{first_s:.3f} s; a round {statistics.median(ms):.3f} ms of "
          f"{[round(v, 3) for v in ms]}; peak {peak / 2**30:.3f} GiB; "
          f"engine {rep['engine_total']:,} B against "
          f"{rep['dense_extrapolated']:,} B dense at N = 10^6; "
          f"{json.dumps(summary)}", flush=True)
    check(rep["engine_total"] * 1000 < rep["dense_extrapolated"],
          f"{tag} engine_total {rep['engine_total']:,} B is under a "
          "thousandth of the dense extrapolation")
    out["qwen3_fleet"] = {"kernels_per_round": kc, "ms": statistics.median(ms),
                          "rounds_ms": ms, "first_run_s": first_s,
                          "peak_bytes": peak, "memory_report": rep,
                          "population_summary": summary,
                          "launches_at_capture": at_capture}
    out["k2_per_round"]["qwen3-fleet"] = kc.get("quantize_philox_kernel", 0)
    del pop, state, box
    release(dev)


def check_telemetry(dev, fed, out):
    """Phase 25 (e): run, run_compiled, AsyncTrainer.run and
    Population.run on the CNN with a recorder and without: states,
    histories and meters bitwise, the same number of synchronizing calls
    (the sync debug mode's warnings), every exported record valid; then
    ``run`` at ``log_every=0``, where the recorder's one fetch at the
    run's end is the one call it adds.  Each
    engine runs once without a recorder first, uncounted: a first run in
    the process can synchronize once more (on an H100 the loop's first
    run counted 37 against 36)."""
    bundle, fsl, tp, cm = pop_parts("cnn", "cse_fsl", dev)

    def batcher():
        return FederatedBatcher(fed, B, H, seed=0)

    runs = {
        "loop": lambda tele: Trainer(bundle, fsl, transport=tp,
                                     telemetry=tele),
        "compiled": lambda tele: Trainer(bundle, fsl, transport=tp,
                                         telemetry=tele),
        "async": lambda tele: AsyncTrainer(bundle, fsl, transport=tp,
                                           latency=LognormalLatency(),
                                           telemetry=tele),
        "population": lambda tele: Population(
            bundle, fsl, population=N, transport=tp, telemetry=tele,
            data=FederatedPool(fed, B, H, seed=0)),
    }
    res = {}
    for engine, make in runs.items():
        for on in (None, True, False):
            tele = Telemetry() if on else None
            t = make(tele)
            meter = CommMeter()
            kw = dict(log_every=1, meter=meter, cost_model=cm)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    if engine == "population":
                        state, hist = t.init(0).run(3, chunk=2, **kw)
                    elif engine == "compiled":
                        state, hist = t.run_compiled(t.init(0), batcher(), 3,
                                                     chunk=2, **kw)
                    else:
                        state, hist = t.run(t.init(0), batcher(), 3, **kw)
                    sync(dev)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("synchronizing" in str(x.message) for x in w)
            stats = t.stats.as_dict() if engine == "async" else None
            if on is not None:
                res[engine, on] = (state_on_cpu(state), hist, meter.counts,
                                   stats, syncs, tele)
            del t, state
        (s1, h1, m1, st1, y1, tele), (s0, h0, m0, st0, y0, _) = \
            res[engine, True], res[engine, False]
        check(all(same(a, b) for a, b in zip(s1, s0)) and h1 == h0
              and m1 == m0 and st1 == st0,
              f"[telemetry {engine}] on == off, bitwise (state, history, "
              "meter" + (", AsyncStats)" if st1 else ")"))
        check(y1 == y0 > 0, f"[telemetry {engine}] the recorder adds no "
              f"synchronizing call: {y1} with it, {y0} without")
        rounds = [r for r in tele.records if r["type"] == "round"]
        check(len(rounds) == 3 and all(r["engine"] == engine
                                       for r in tele.records)
              and tele.records[-1]["type"] == "summary",
              f"[telemetry {engine}] {len(tele.records)} records "
              f"({len(tele.spans)} spans)")
        release(dev)
    # the loop with no logged round: its records wait on the card for one
    # fetch at the run's end, where one a round would add 3 calls here
    quiet = {}
    for on in (None, True, False):
        tele = Telemetry() if on else None
        t = runs["loop"](tele)
        meter = CommMeter()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, hist = t.run(t.init(0), batcher(), 3, log_every=0,
                                    meter=meter, cost_model=cm)
                sync(dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if on is not None:
            quiet[on] = (state_on_cpu(state), hist, meter.counts,
                         sum("synchronizing" in str(x.message) for x in w),
                         tele)
        del t, state
    (s1, h1, m1, y1, tele), (s0, h0, m0, y0, _) = quiet[True], quiet[False]
    check(all(same(a, b) for a, b in zip(s1, s0)) and h1 == h0 == []
          and m1 == m0 == res["loop", True][2],
          "[telemetry loop, log_every=0] on == off, bitwise (state, "
          "history, meter)")
    check(tele.records == res["loop", True][5].records,
          f"[telemetry loop, log_every=0] its {len(tele.records)} records "
          "== those of the run that logs every round")
    check(y1 == y0 + 1, f"[telemetry loop, log_every=0] the recorder adds "
          f"one synchronizing call, its one fetch: {y1} with it, {y0} "
          "without")
    out["loop_log_every_0"] = {"syncs": y1, "syncs_without": y0}
    release(dev)
    with tempfile.TemporaryDirectory() as tmp:
        n = 0
        for engine in runs:
            tele = res[engine, True][5]
            path = os.path.join(tmp, f"{engine}.jsonl")
            tele.export_jsonl(path)
            with open(path) as f:
                for line in f:
                    validate_record(json.loads(line))
                    n += 1
            json.dumps(tele.chrome_trace())
            tele.prometheus_text()
    spans = res["compiled", True][5].spans
    execs = [sp.labels["capture"] for sp in spans
             if sp.name == "chunk/execute"]
    check(n == sum(len(res[e, True][5].records) for e in runs)
          and execs == [True, False],
          f"[telemetry] {n} exported records pass validate_record; the "
          f"compiled run's chunk spans mark its capture {execs}")
    out.update({e: {"records": len(res[e, True][5].records),
                    "spans": len(res[e, True][5].spans),
                    "syncs": res[e, True][4]} for e in runs})
    print(f"  [telemetry] synchronizing calls with the recorder, 3 rounds: "
          f"{ {e: res[e, True][4] for e in runs} } at log_every=1; the "
          f"loop at log_every=0 {y1} ({y0} without)", flush=True)


def phase_population(dev, fed, parts=("cnn", "lm", "drivers"),
                     compiled=None):
    """Phase 25: the population engine and telemetry on the card, the
    ``parts`` of it (the CNN paths and telemetry, the Qwen3 fleet, the
    driver); ``compiled``: phase 19's numbers, whose replayed rounds'
    kernels a population round must launch.  Returns the phase's
    ``population`` and ``telemetry`` numbers."""
    t0 = phase("25 population engine and telemetry: Population against "
               "run_compiled (CNN, C == N), fleets of 10^6 (CNN, Qwen3), "
               "checkpoint, faults, telemetry on and off, fig_population")
    release(dev)
    pop = {"k2_per_round": {}}
    tele = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        if "cnn" in parts:
            pop["seconds"] = secs = {}
            for name, fn, args in (
                    ("dense", check_pop_dense, (dev, fed, pop, compiled)),
                    ("fleet", check_pop_fleet, (dev, pop)),
                    ("faults", check_pop_faults, (dev, pop)),
                    ("telemetry", check_telemetry, (dev, fed, tele))):
                t = time.perf_counter()
                fn(*args)
                secs[name] = time.perf_counter() - t
            print(f"  seconds: {secs}", flush=True)
        if "lm" in parts:
            t = time.perf_counter()
            check_pop_lm(dev, pop, compiled)
            pop["lm_s"] = time.perf_counter() - t
            print(f"  qwen3-fleet seconds: {pop['lm_s']:.3f}", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if "drivers" in parts:
        from repro_torch.benchmarks import fig_population
        t = time.perf_counter()
        res = fig_population.main(dev)
        sync(dev)
        secs = time.perf_counter() - t
        print(f"  fig_population: ran to its end, its three claims held, "
              f"{secs:.3f} s", flush=True)
        pop["fig_population"] = {"seconds": secs,
                                 "throughput": res["throughput"],
                                 "memory": res["memory"]}
        release(dev)
    done(t0)
    return pop, tele


# ---------------------------------------------------------------------------
# The entry points: the training CLI, perf_bench, the dense configs, Trainer
# resume, falcon-mamba through both engines
# ---------------------------------------------------------------------------

# Phase 26 calls the CLI in this process (repro_torch.launch.train.main), so
# the launch counters are read.  Its LM flags are phase 20's Qwen3 path's:
# n 4, h 2, B 1, S 4096, 8 sequences a client, lr 0.1, int8 on the uplink
# and the model sync.  The CLI takes each config as it is: qwen3-0.6b,
# qwen2-1.5b and falcon-mamba-7b set remat, so a replayed Qwen3 round
# launches phase 22's counts with remat (K6's forward once more a
# backward).  The reduced dense configs run tiny on the card and the CPU.
CLI_LM = ["--clients", str(LM_N), "--h", str(LM_H), "--batch", str(LM_B),
          "--seq", str(LM_S), "--samples", str(LM_SAMPLES), "--lr",
          str(LM_LR), "--codec", "int8", "--model-codec", "int8",
          "--log-every", "1"]
CLI_REDUCED = ["--size", "reduced", "--clients", "2", "--h", "2", "--batch",
               "1", "--seq", "256", "--samples", "4", "--lr", "0.1",
               "--rounds", "2", "--chunk", "2", "--log-every", "1"]
CLI_ROUNDS, CLI_POP, CLI_POP_ROUNDS, CLI_QWEN2_ROUNDS = 3, 10**6, 2, 2
# bf16 on both devices, the kernels on the card and their plain versions on
# the CPU: a loss moves by a few bf16 ulps of the activations
CLI_REDUCED_RTOL = 2e-2
CLI_HOST = ("comm", "participation", "faults", "population", "memory",
            "wallclock", "record")
# Trainer resume on the card: the CNN path (int8 on every channel), windows
# of 2 rounds (agg_every 2h), lossy faults whose trace drops client 2 in
# round 3 (1-based) alone, 6 rounds at chunk 2 split after round 3.
RESUME_FAULTS = dict(loss_rate=0.4, max_retries=1, seed=1)
RESUME_ROUNDS, RESUME_SPLIT = 6, 3
# falcon-mamba through Population and the event engine: one round each
# (Population two until phase 29 took the room)
MB_ENGINE_ROUNDS = 1
# perf_bench's telemetry row in each protocol once (three times each until
# phase 28 took the room)
TELE_PROTOCOL_RUNS = 1


def card_bundle(cfg, device):
    """``transformer_bundle(cfg, dev)`` whose ``init(gen)`` is
    ``init_params``' draw (its shapes, dtypes and scales) made on the card
    from a generator seeded with ``gen``'s seed: a full-width model's host
    draw took about 20 of qwen2-1.5b's 33 s in phase 26 (H100 80GB HBM3,
    700.00 W)."""
    bundle = transformer_bundle(cfg, device=device)
    return dataclasses.replace(bundle, init=lambda gen: serve_mod.draw_params(
        cfg, gen.initial_seed(), bundle.device))


def cli(argv, draw_on_card: bool = False):
    """``train.main(argv + --out)`` on the card, the LM bundles this
    script's (lm_bundle: the parameters drawn once a config and seed, the
    bits of a fresh draw; with ``draw_on_card``, card_bundle's).  Returns
    ``(state, history, --out JSON, s)``."""
    path = os.path.join(tempfile.mkdtemp(), "out.json")
    saved = train_mod.transformer_bundle
    train_mod.transformer_bundle = card_bundle if draw_on_card \
        else (lambda cfg, device: lm_bundle(cfg, device))
    try:
        t = time.perf_counter()
        state, hist = train_mod.main(list(argv) + ["--out", path])
        sync(state_leaves(state)[0].device)
        secs = time.perf_counter() - t
    finally:
        train_mod.transformer_bundle = saved
    with open(path) as f:
        return state, hist, json.load(f), secs


def at_capture_ok(lab, at_cap, expect, rounds=3):
    """The warm-up and the two captures called each layer kernel's wrapper
    ``rounds`` rounds' worth (phase 19's check)."""
    layer = [k for k in expect if expect[k] and not k.startswith(
        ("quantize", "fused_ce"))]
    check(all(at_cap.get(k) == rounds * expect[k] for k in layer),
          f"{lab} the warm-up and the two captured rounds called the layer "
          f"kernels {rounds} rounds' worth "
          f"{ {k: at_cap.get(k) for k in layer} }")


def philox_rows(seeds, r0: int, r1: int, c: int) -> torch.Tensor:
    """``ref.philox_bits(seeds, r1, c)[..., r0:r1, :]`` without drawing
    the rows before ``r0`` (a tile's bits depend on its tile indices and
    the seed alone); ``r0`` a multiple of the 8-row tile."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64).cpu()
    nr, nc = (r1 - r0) // ref.BT, -(-c // ref.BC)
    s = seeds.reshape(-1, 1, 1, 1)
    k0, k1 = s & ref._M32, (s >> 32) & ref._M32
    ti = torch.arange(r0 // ref.BT, r0 // ref.BT + nr,
                      dtype=torch.int64).reshape(1, nr, 1, 1)
    tj = torch.arange(nc, dtype=torch.int64).reshape(1, 1, nc, 1)
    call = torch.arange(ref.BT * ref.BC // 4,
                        dtype=torch.int64).reshape(1, 1, 1, -1)
    words = ref.philox4x32_10((tj, ti, call, torch.zeros((),
                                                         dtype=torch.int64)),
                              (k0, k1))
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = w.reshape(-1, nr, nc, ref.BT, ref.BC).permute(0, 1, 3, 2, 4)
    w = w.reshape(-1, nr * ref.BT, nc * ref.BC)[:, :, :c]
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def time_k2_leaf(shape, launches, dev) -> dict:
    """K2 at a model-sync leaf shape ``[n, R, C]``: its first and last
    1024 rows bitwise the plain version's (from the same Philox tiles),
    its device time (graph replay), a wrapper call's, and its bound from
    the bytes it moves (fp32 in, int8 and a scale a tile out, a seed a
    client).  The plain version draws its bits on the CPU: at this size
    it is not timed."""
    n, r, c = shape
    g = torch.Generator(device=dev).manual_seed(11)
    xd = torch.randn(shape, generator=g, device=dev) * 2
    seeds = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    q, s = qk.quantize_2d(xd, seeds=seeds)
    err, w = 0.0, min(1024, r)
    for r0 in (0, r - w):
        x = xd[:, r0:r0 + w].cpu()
        pq, ps = ref.quantize_2d(x, philox_rows(seeds.cpu(), r0, r0 + w, c))
        t0 = r0 // ref.BT
        qs, ss = q[:, r0:r0 + w].cpu(), s[:, t0:t0 + w // ref.BT].cpu()
        check(same(qs, pq) and same(ss, ps),
              f"quantize_philox {list(shape)} rows {r0}..{r0 + w} == "
              "plain on the CPU fed the same Philox tiles")
        err = max(err, max_abs(qs, ss, pq, ps))
    del q, s
    elems, tiles = n * r * c, n * -(-r // ref.BT) * -(-c // ref.BC)
    io = elems * (4 + 1) + tiles * 4 + n * 8
    ops = 8 * elems + (2 * elems + (elems // 4) * 10 * 10) \
        * FP32_OPS / INT32_OPS
    run = lambda: qk.quantize_2d(xd, seeds=seeds)       # noqa: E731
    rec = record("quantize_philox", launches, err,
                 graph_ms(run, reps=5, inner=5),
                 event_ms(run, reps=5, inner=5, warm=2), None, io, ops,
                 FP32_OPS, shape=list(shape),
                 launches_path="qwen3-0.6b cse_fsl through the CLI, int8 "
                               "model sync (phase 26), a replayed "
                               "aggregating round: the clients' leaves "
                               "up (the average goes down at [1, R, C])")
    print(f"  [model-sync leaf {list(shape)}] quantize_philox: "
          f"{rec['ms'] * 1e3:.3f} us/launch on device (graph replay), "
          f"{rec['eager_ms'] * 1e3:.3f} us per wrapper call, bound "
          f"{rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}), plain not "
          f"timed, {launches} launches a round", flush=True)
    del xd
    return rec


def check_cli_qwen3(dev, out, remat_runs):
    """Phase 26 (a): the CLI's Qwen3 run (``run_compiled``, chunk 3)
    bitwise a direct ``run_compiled`` built the same way; the CLI's own
    replays profiled (ReplayWatch): a replayed round launching phase 22's
    kernels with remat, no wrapper call, the warm-up and captures calling
    the layer kernels 3 rounds' worth; the model-sync leaves' K2 shapes in
    the captured aggregating round, whose K2 calls add up to the replayed
    round's K2 launches; K2 timed at the largest leaf, with its launches
    a round from that count."""
    lab = "[cli-qwen3]"
    cfg = get_config("qwen3-0.6b").with_(use_pallas=True)
    release(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with ReplayWatch(dev, shapes=True) as watch:
        state, hist, js, secs = cli(["--arch", "qwen3-0.6b", "--size",
                                     "full"] + CLI_LM
                                    + ["--rounds", str(CLI_ROUNDS),
                                       "--chunk", str(CLI_ROUNDS)])
    at_cap = {k: v for k, v in watch.at_capture.items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    copy = state_on_cpu(state)
    del state
    release(dev)
    print(f"  {lab} the CLI: {CLI_ROUNDS} rounds (warm-up, two captures, "
          f"replays) in {secs:.3f} s, {watch.added_s:.3f} s of it the "
          f"replays' profiling; peak {peak / 2**30:.3f} GiB; wrapper "
          f"launches {at_cap}", flush=True)
    check(all(math.isfinite(r[k]) for r in hist for k in metric_keys(r)),
          f"{lab} losses finite: {[round(r['client_loss'], 6) for r in hist]}")

    bundle = lm_bundle(cfg, dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, codec="int8",
                    model_codec="int8")
    tr = Trainer(bundle, fsl)
    nm = len(tr.method.model_sync_specs(bundle, fsl))
    expect = lm_launches(cfg, "cse_fsl", tr.units_per_round + 2 * nm)
    at_capture_ok(lab, at_cap, expect)
    per = watch.per_round()
    want = (remat_runs or {}).get("qwen3-cse_fsl", {}).get(
        "remat", {}).get("kernels_per_round")
    check(watch.replay_calls == 0 and watch.flags == [True] * CLI_ROUNDS
          and (want is None or per == want)
          and per.get("quantize_philox_kernel") == expect["quantize_philox"]
          and per.get("swa_tc_kernel") == expect["swa_attention_tc"]
          and per.get("ce_combine_kernel") == expect["fused_ce_fwd"],
          f"{lab} the CLI's {len(watch.flags)} replayed rounds "
          f"(aggregating: {watch.flags}) launch {per} a round: phase 22's "
          f"Qwen3 round with remat (K2 {expect['quantize_philox']}, K3/K4 "
          f"{expect['fused_ce_fwd']}, K6 {expect['swa_attention_tc']}, its "
          f"backward {expect['swa_attention_bwd_dkdv']}), no wrapper call")
    agg = watch.k2_shapes[True]
    leaves = sorted(agg, key=lambda s: -math.prod(s))
    check(sum(agg.values()) == per.get("quantize_philox_kernel"),
          f"{lab} K2's calls in the captured aggregating round "
          f"({sum(agg.values())}, by shape) == its launches a replayed "
          "round")
    print(f"  {lab} K2's shapes in the captured aggregating round (calls): "
          f"{ {s: agg[s] for s in leaves[:6]} } ...", flush=True)

    fed = build_data(cfg, fsl, LM_S, LM_SAMPLES, False)
    cm = CostModel(n=LM_N, q=bundle.smashed_bytes_per_sample * LM_S,
                   d_local=LM_SAMPLES,
                   w_client=bytes_of(bundle.specs["client"]),
                   w_server=bytes_of(bundle.specs["server"]),
                   aux=bytes_of(bundle.specs["aux"]))
    meter, batcher = CommMeter(), LMBatcher(cfg, fed, LM_B, LM_H)
    state, dhist = tr.run_compiled(tr.init(), batcher, CLI_ROUNDS,
                                   chunk=CLI_ROUNDS, log_every=1,
                                   meter=meter, cost_model=cm)
    check(len(copy) == len(state_leaves(state))
          and all(same(a, b) for a, b in zip(state_leaves(state), copy))
          and dhist == hist and js["comm"] == meter.as_dict()
          and js["history"] == hist,
          f"{lab} the CLI's state, {len(hist)} history rows and meter "
          f"({meter.total:,} B) == a direct run_compiled's, bitwise")
    del state, copy
    out["cli-qwen3"] = {"seconds": secs, "profiling_s": watch.added_s,
                        "peak_bytes": peak, "kernels_per_round": per,
                        "k2_shapes": len(agg)}
    del tr
    release(dev)
    # the largest model-sync leaf, [n, V, d]: the clients' embeddings on the
    # uplink of an aggregating round (the average goes down at [1, V, d])
    big = (LM_N, cfg.vocab_size, cfg.d_model)
    check(big in agg and math.prod(big) == math.prod(leaves[0]),
          f"{lab} the embedding's {big} is the largest K2 shape, "
          f"{agg.get(big)} launches a replayed round")
    out["k2_leaf"] = time_k2_leaf(big, agg.get(big, 0), dev)
    release(dev)


def check_cli_population(dev, out):
    """Phase 26 (b): the CLI's population mode on full-width Qwen3, N =
    10^6, C = 4 stratified on the tiered network."""
    lab = "[cli-qwen3-population]"
    cfg = get_config("qwen3-0.6b").with_(use_pallas=True)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    state, hist, js, secs = cli(
        ["--arch", "qwen3-0.6b", "--size", "full"] + CLI_LM
        + ["--rounds", str(CLI_POP_ROUNDS), "--chunk", str(CLI_POP_ROUNDS),
           "--population", str(CLI_POP), "--cohort", str(LM_N),
           "--sampler", "stratified", "--network", "tiered"])
    at_cap = {k: v for k, v in counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    mem, pop = js["memory"], js["population"]
    check(len(hist) == CLI_POP_ROUNDS and all(
        math.isfinite(r[k]) for r in hist for k in metric_keys(r))
        and pop["windows"] == CLI_POP_ROUNDS
        and mem["population"] == CLI_POP
        and mem["engine_total"] * 1000 < mem["dense_extrapolated"],
        f"{lab} {len(hist)} rounds, losses finite, {pop['windows']} "
        f"windows of {pop['unique_clients']} clients, engine "
        f"{mem['engine_total']:,} B against {mem['dense_extrapolated']:.3g} "
        "B dense")
    nm = len(get_method("cse_fsl").model_sync_specs(lm_bundle(cfg, dev),
                                                     FSLConfig(
                                                         num_clients=LM_N)))
    at_capture_ok(lab, at_cap, lm_launches(cfg, "cse_fsl", 1 + 2 * nm))
    out["cli-qwen3-population"] = {"seconds": secs, "peak_bytes": peak,
                                   "engine_total": mem["engine_total"]}
    print(f"  {lab} {secs:.3f} s, peak {peak / 2**30:.3f} GiB", flush=True)
    release(dev)


def chunk_spans_ms(trace_path) -> list:
    """The ``chunk/execute`` host spans' durations (ms) in a Chrome
    trace the CLI wrote (``--trace``)."""
    with open(trace_path) as f:
        ev = json.load(f)["traceEvents"]
    return [e["dur"] / 1e3 for e in ev if e.get("name") == "chunk/execute"]


def check_cli_qwen2(dev, out):
    """Phase 26 (c): qwen2-1.5b at full width (28 layers) through the CLI
    at chunk 1, its parameters drawn on the card (card_bundle): K6 at a
    GQA group of 6, round 1's losses near ln V, the
    peak and the compiled ms a round (the second chunk's execute span: a
    replayed round and its metrics' fetch)."""
    lab = "[cli-qwen2-1.5b]"
    cfg = get_config("qwen2-1.5b").with_(use_pallas=True)
    trace = os.path.join(tempfile.mkdtemp(), "trace.json")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    state, hist, js, secs = cli(
        ["--arch", "qwen2-1.5b", "--size", "full"] + CLI_LM
        + ["--rounds", str(CLI_QWEN2_ROUNDS), "--chunk", "1", "--trace",
           trace], draw_on_card=True)
    at_cap = {k: v for k, v in counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    lnv = math.log(cfg.vocab_size)
    r1 = hist[0]
    check(all(math.isfinite(r[k]) for r in hist for k in metric_keys(r))
          and all(abs(r1[k] - lnv) < 1.5 for k in metric_keys(r1)),
          f"{lab} {cfg.num_layers} layers, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads}: round 1 losses "
          f"{ {k: round(r1[k], 4) for k in metric_keys(r1)} } within 1.5 of "
          f"ln V = {lnv:.4f}, all finite")
    nm = len(get_method("cse_fsl").model_sync_specs(card_bundle(cfg, dev),
                                                     FSLConfig(
                                                         num_clients=LM_N)))
    expect = lm_launches(cfg, "cse_fsl", 1 + 2 * nm)
    at_capture_ok(lab, at_cap, expect)
    check(swa.kernel_for(torch.bfloat16, cfg.resolved_head_dim)
          == "swa_attention_tc" and cfg.num_heads // cfg.num_kv_heads == 6,
          f"{lab} K6 on the tensor cores at hd {cfg.resolved_head_dim}, "
          "a GQA group of 6")
    ms = chunk_spans_ms(trace)
    out["cli-qwen2-1.5b"] = {"seconds": secs, "peak_bytes": peak,
                             "chunk_execute_ms": ms, "round1": r1}
    print(f"  {lab} {secs:.3f} s for {CLI_QWEN2_ROUNDS} rounds; peak "
          f"{peak / 2**30:.3f} GiB; chunk/execute spans {ms} ms (the first "
          "captures; the second is one replayed round)", flush=True)
    release(dev)


def check_cli_reduced(dev, out):
    """Phase 26 (d): glm4-9b and qwen2-72b reduced (bf16, 2 layers), the
    CLI on the card against the same run on the CPU: the host sections
    exactly, the losses at CLI_REDUCED_RTOL, the kernels launched."""
    for arch in ("glm4-9b", "qwen2-72b"):
        lab = f"[cli-{arch}-reduced]"
        reset_counts()
        st, hist, js, secs = cli(["--arch", arch, "--device", "cuda"]
                                 + CLI_REDUCED)
        launched = {k: v for k, v in counts().items() if v}
        del st
        _, chist, cjs, csecs = cli(["--arch", arch, "--device", "cpu"]
                                   + CLI_REDUCED)
        check(all(js[k] == cjs[k] for k in CLI_HOST)
              and [r["aggregated"] for r in hist]
              == [r["aggregated"] for r in chist],
              f"{lab} comm, record and the other host sections == the CPU "
              "run's")
        for r, c in zip(hist, chist):
            for k in metric_keys(r):
                check(math.isclose(r[k], c[k], rel_tol=CLI_REDUCED_RTOL),
                      f"{lab} round {r['round']} {k} {r[k]:.5f} == the "
                      f"CPU's {c[k]:.5f} at rtol {CLI_REDUCED_RTOL}")
        check(launched.get("swa_attention_tc", 0) > 0
              and launched.get("fused_ce_fwd", 0) > 0,
              f"{lab} the card launched K6 (tensor cores) and K3: "
              f"{launched}")
        out[f"cli-{arch}-reduced"] = {"seconds": secs, "cpu_seconds": csecs,
                                      "launches": launched}
    release(dev)


def check_perf_bench(dev, out):
    """Phase 26 (e): ``perf_bench --smoke`` on the card with its two bars
    (compiled >= 2x the loop's steps/s on the smoke CNN at h = 1; the
    recorder's steps/s at least 0.95 of the no-op's)."""
    from repro_torch.benchmarks import perf_bench
    t = time.perf_counter()
    rows, tele = perf_bench.main(smoke=True, device=dev)
    secs = time.perf_counter() - t
    check(all(r["speedup"] >= 2.0 for r in rows)
          and tele["telemetry_overhead_ratio"] >= 0.95,
          f"perf_bench --smoke: speed-ups {[r['speedup'] for r in rows]} "
          f">= 2.0, telemetry ratio {tele['telemetry_overhead_ratio']} >= "
          f"0.95 ({secs:.3f} s)")
    # the telemetry row's two protocols side by side on this machine: the
    # JAX driver's order (no-op side, then recorder, best of 3) and
    # perf_bench's turns (best of 5), TELE_PROTOCOL_RUNS times each,
    # alternating
    protocols = []
    for turns in (False, True) * TELE_PROTOCOL_RUNS:
        r = perf_bench.bench_telemetry_overhead(
            80, 20, device=dev, turns=turns, repeats=5 if turns else 3)
        protocols.append(r)
        print(f"  [perf_bench telemetry, {'turns' if turns else 'JAX order'}"
              f"] ratio {r['telemetry_overhead_ratio']}; ms a call off "
              f"{[round(x * 1e3, 3) for x in r['telemetry_off_calls_s']]}, "
              f"on {[round(x * 1e3, 3) for x in r['telemetry_on_calls_s']]}",
              flush=True)
    out["perf_bench"] = {"rows": rows, "telemetry": tele, "seconds": secs,
                         "telemetry_protocols": protocols}
    release(dev)


def check_trainer_resume(dev, out):
    """Phase 26 (f): ``run_compiled`` on the CNN path under lossy faults,
    saved after round 3 (mid-window), restored into a fresh Trainer from a
    ``meta`` template and continued: bitwise the uninterrupted run, the
    window's cohort included (the trace drops client 2 in round 3 alone,
    so a restarted window would admit it)."""
    lab = "[cnn-resume]"
    fed = make_data()

    def trainer():
        bundle, fsl, tp, cm = pop_parts("cnn", "cse_fsl", dev,
                                        agg_every=2 * H)
        return Trainer(bundle, fsl, transport=tp, faults=make_fault(
            "lossy", **RESUME_FAULTS)), cm

    tr, cm = trainer()
    m0 = CommMeter()
    state, whist = tr.run_compiled(tr.init(0), FederatedBatcher(
        fed, B, H, seed=0), RESUME_ROUNDS, chunk=2, log_every=1, meter=m0,
        cost_model=cm)
    want = state_on_cpu(state)
    del tr, state
    tr, _ = trainer()
    batcher = FederatedBatcher(fed, B, H, seed=0)
    state, h1 = tr.run_compiled(tr.init(0), batcher, RESUME_SPLIT, chunk=2,
                                log_every=1)
    path = tr.save(os.path.join(tempfile.mkdtemp(), "trainer"), state)
    del tr, state
    fresh, _ = trainer()
    state = fresh.restore(path)
    batcher = FederatedBatcher(fed, B, H, seed=0)
    for _ in range(RESUME_SPLIT):
        batcher.next_round()
    state, h2 = fresh.run_compiled(state, batcher,
                                   RESUME_ROUNDS - RESUME_SPLIT, chunk=2,
                                   log_every=1)
    got = state_on_cpu(state)
    cohorts = [(r["round"], r["participants"]) for r in whist
               if r["aggregated"]]
    check(min(p for _, p in cohorts) < N
          and [(r["round"], r.get("participants")) for r in h1 + h2
               if r["aggregated"]] == cohorts
          and all(same(a, b) for a, b in zip(got, want))
          and [r["client_loss"] for r in h1 + h2]
          == [r["client_loss"] for r in whist],
          f"{lab} saved after round {RESUME_SPLIT} (mid-window), restored "
          f"into a fresh Trainer: cohorts {cohorts}, losses and state "
          "bitwise the uninterrupted run's")
    out["cnn-resume"] = {"cohorts": cohorts}
    del fresh, state
    release(dev)


def check_mamba_population(dev, out, remat_runs=None):
    """Phase 26 (g): falcon-mamba (phase 12's cut, S = 2048) with remat
    through ``Population`` at C == N over a FederatedPool, bitwise
    ``run_compiled`` on the same data (state, rows, meter), the launches
    of its warm-up and captures, and the default row untouched by the
    replays.  ``remat_runs``: phase 22's runs, whose Mamba remat path (the
    same config, data, wire and rounds, its loop == its run_compiled) is
    held here by its state's digests, rows and meter; without it the
    rounds run through ``run_compiled`` here first."""
    lab = "[mamba-population]"
    cfg = path_cfg("mamba", remat=True)
    bundle = lm_bundle(cfg, dev)
    tp = make_transport("int8", "none", model_sync="int8")
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, lr_decay_every=1)
    fed = lm_data(cfg, fsl, MB_S)
    cm = cost_model(bundle, LM_N, LM_SAMPLES)
    meters = [CommMeter(), CommMeter()]
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(bundle, fsl, transport=tp)
    nm = len(tr.method.model_sync_specs(bundle, fsl))
    expect = lm_launches(cfg, "cse_fsl", tr.units_per_round + 2 * nm)
    run = ((remat_runs or {}).get("mamba-cse_fsl") or {}).get("remat", {})
    t = time.perf_counter()
    if "loop_run" in run:               # phase 22's run of this path
        rounds = run["rounds"]
        want, hist = run["loop_run"]["state"], run["loop_run"]["hist"]
        meters[0].counts.update(run["loop_run"]["meter"])
        source = "phase 22's run"
    else:
        rounds = REMAT_ROUNDS
        state, hist = tr.run_compiled(
            tr.init(0), LMBatcher(cfg, fed, LM_B, LM_H, seed=0), rounds,
            chunk=rounds, log_every=1, meter=meters[0], cost_model=cm)
        sync(dev)
        want = state_digests(state)
        del state
        source = "run_compiled here"
    c_s = time.perf_counter() - t
    del tr
    release(dev)
    pop = Population(bundle, fsl, population=LM_N, transport=tp,
                     data=LMPool(cfg, FederatedPool(fed, LM_B, LM_H,
                                                    seed=0))).init(0)
    default0 = [bits_digest(x) for x in tree_leaves(pop._default)]
    reset_counts()
    t = time.perf_counter()
    state, phist = pop.run(rounds, chunk=rounds, log_every=1,
                           meter=meters[1], cost_model=cm)
    sync(dev)
    p_s = time.perf_counter() - t
    at_cap = {k: v for k, v in counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    check(state_digests(state) == want and phist == hist
          and meters[1].counts == meters[0].counts,
          f"{lab} Population.run (C == N = {LM_N}, remat) == "
          f"Trainer.run_compiled ({source}), bitwise (state: "
          f"{len(want)} leaves' 64-bit digests, {len(hist)} rows, meter "
          f"{meters[1].total:,} B)")
    check([bits_digest(x) for x in tree_leaves(pop._default)] == default0,
          f"{lab} the default row is untouched by the replays (a copy, not "
          "a view of the replayed state; 64-bit digests of its leaves)")
    at_capture_ok(lab, at_cap, expect)
    out["mamba-population"] = {"run_compiled_s": c_s, "population_s": p_s,
                               "peak_bytes": peak}
    print(f"  {lab} run_compiled ({source}) {c_s:.3f} s, Population "
          f"{p_s:.3f} s for {rounds} rounds each (warm-up, captures, "
          f"replays); peak {peak / 2**30:.3f} GiB", flush=True)
    del pop, state, want
    release(dev)


def check_mamba_engine(dev, out):
    """Phase 26 (h): falcon-mamba (phase 12's cut, remat) through the event
    engine at zero latency for one round against ``Trainer.run`` from the
    same state: the schedule and meter equal, losses at rtol 1e-3, each
    state key's update within UNIT_RTOL, launches as engine_lm_launches
    states them.  Everything stays on the card, compared 2^26 elements at
    a time (a whole leaf in fp64 ran the card out of memory): each key's
    update norm |Trainer.run's - initial| is summed after Trainer.run, from
    the initial state the engine then consumes, and the differences
    |engine's - Trainer.run's| after the engine (no host copy of the
    11 GB initial state)."""
    lab = "[mamba-engine]"
    cfg = path_cfg("mamba", remat=True)
    tr, make_batcher, cm, _ = compiled_trainer("mamba", "cse_fsl", dev,
                                               remat=True)
    eng = AsyncTrainer(tr.bundle, tr.fsl, transport=tr.transport,
                       latency=ConstantLatency(0.0, 0.0, 0.0))
    nm = len(tr.method.model_sync_specs(tr.bundle, tr.fsl))
    want = engine_lm_launches(cfg, LM_N + 2 * nm)
    state0 = tr.init(0)
    runs, dens = [], {}

    def slices(*trees):             # leaf slices of 2^26 elements, zipped
        for leaves in zip(*(tree_leaves(t) for t in trees)):
            flat = [x.reshape(-1) for x in leaves]
            for i in range(0, flat[0].numel(), 1 << 26):
                yield [x[i:i + (1 << 26)] for x in flat]

    for t in (tr, eng):
        st = state0 if t is eng else tree_map(
            lambda x: x.clone() if torch.is_tensor(x) else x, state0)
        meter, after = CommMeter(), []
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        st, hist = t.run(st, make_batcher(), MB_ENGINE_ROUNDS, log_every=1,
                         meter=meter, cost_model=cm,
                         callback=lambda *_: after.append(counts()))
        sync(dev)
        secs = time.perf_counter() - t0
        runs.append((st, hist, meter, after[-1], secs))
        if t is tr:                 # |w - before|^2 a key, before state0 goes
            dens = {k: sum(rel_sums([w], [w], [b])[1] for w, b in slices(
                st[k]["params"], state0[k]["params"]))
                for k in st if k != "round"}
        del st
        release(dev)
    del state0
    (s_sync, h_sync, m_sync, _, sync_s), (s_eng, h_eng, m_eng, c_eng,
                                          eng_s) = runs
    check(c_eng == want, f"{lab} the engine's round launches "
          f"{ {k: v for k, v in c_eng.items() if v} } == expected")
    check([x["aggregated"] for x in h_eng] == [x["aggregated"]
                                              for x in h_sync]
          and m_eng.counts == m_sync.counts,
          f"{lab} aggregation schedule and meter {m_eng.counts} == "
          "Trainer.run's")
    for re, rs in zip(h_eng, h_sync):
        for k in metric_keys(rs):
            check(math.isclose(re[k], rs[k], rel_tol=1e-3),
                  f"{lab} round {rs['round']} {k} {re[k]:.6f} == "
                  f"Trainer.run's {rs[k]:.6f} at rtol 1e-3")
    del eng, tr
    release(dev)
    errs = {}
    for k, den in dens.items():     # rel_sums' numerator: needs no before
        num = sum(rel_sums([g], [w], [w])[0] for g, w in slices(
            s_eng[k]["params"], s_sync[k]["params"]))
        check(den > 0, f"{lab} Trainer.run moved {k}")
        errs[k] = (num / den) ** 0.5
    release(dev)
    check(max(errs.values()) <= UNIT_RTOL,
          f"{lab} each key's update within {UNIT_RTOL} of Trainer.run's "
          f"(relative 2-norm: { {k: round(v, 5) for k, v in errs.items()} })")
    out["mamba-engine"] = {"engine_s": eng_s, "loop_s": sync_s,
                           "update_rel_err": errs}
    print(f"  {lab} engine {eng_s:.3f} s a round | Trainer.run {sync_s:.3f} "
          "s (host clock, the first round of each)", flush=True)
    del runs, s_sync, s_eng
    release(dev)


def phase_cli(dev, remat_runs=None, parts=("qwen3", "dense", "bench",
                                           "resume", "mamba")):
    """Phase 26: the entry points on the card, the ``parts`` of it (the
    CLI's Qwen3 and population runs; qwen2-1.5b and the reduced dense
    configs; perf_bench; Trainer resume; falcon-mamba through both
    engines).  ``remat_runs``: phase 22's numbers, whose Qwen3 replayed
    round the CLI's must launch.  Returns the phase's numbers."""
    t0 = phase("26 entry points: the training CLI (Qwen3, population mode, "
               "qwen2-1.5b, glm4-9b and qwen2-72b reduced), perf_bench, "
               "Trainer resume, falcon-mamba through both engines")
    release(dev)
    out, secs = {}, {}
    steps = (("qwen3", check_cli_qwen3, (dev, out, remat_runs)),
             ("qwen3", check_cli_population, (dev, out)),
             ("dense", check_cli_qwen2, (dev, out)),
             ("dense", check_cli_reduced, (dev, out)),
             ("resume", check_trainer_resume, (dev, out)),
             ("mamba", check_mamba_population, (dev, out, remat_runs)),
             ("mamba", check_mamba_engine, (dev, out)))
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        for part, fn, args in steps:
            if part in parts:
                t = time.perf_counter()
                fn(*args)
                secs[fn.__name__] = time.perf_counter() - t
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if "bench" in parts:
        t = time.perf_counter()
        check_perf_bench(dev, out)
        secs["perf_bench"] = time.perf_counter() - t
    out["seconds"] = secs
    print(f"  seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    done(t0)
    return out


# ---------------------------------------------------------------------------
# Serving: prefill, the captured decode, the serving CLI and the example
# ---------------------------------------------------------------------------

# Phase 27 serves the merged model (paper Step 4) at full depth: serving
# keeps no gradient or optimizer state.
# - qwen3-serve-window: Qwen3-0.6B (bf16, the kernels on), a prefill of 4
#   prompts of 4,096 tokens at window 4,096 (K6 once a layer) against the
#   same prefill on the plain attention; 32 decode steps at positions
#   4,096-4,127 (the ring wraps at the first), eager and captured, against
#   the merged model on the 4,128 tokens (teacher-forced); layer 0's ring
#   against that layer's k and v of the decoded tokens;
# - qwen3-long: decode_specs(long_500k): B = 1, a ring of 4,096 slots,
#   pos 524,287, 16 steps eager and captured;
# - qwen3-cli: python -m repro_torch.launch.serve at its defaults (B 4,
#   prompt 64, gen 32, 3 batches, window 0, caches padded);
# - mamba-serve: falcon-mamba-7b at 64 layers drawn on the card, a prefill
#   of 4 x 2,048 (the plain scan: K5 no launch), 16 steps eager and
#   captured, against the merged model on the 2,064 tokens (through K5);
#   layer 0's conv window against its last 3 inputs; then the CLI;
# - reduced: both archs reduced, the card's prefill and captured decode
#   against the CPU's prefill and eager decode (8 steps); the example.
# The Qwen3 and Mamba decodes took 64 and 32 steps until phase 28 took
# their host-bound eager steps' seconds.
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_LONG_STEPS = 4, 4096, 32, 16
MB_SERVE_S, MB_SERVE_STEPS, SERVE_REDUCED_STEPS = 2048, 16, 8
SERVE_SEED = 0
# Two paths that compute the same function with other kernels and shapes
# (K6 against the plain attention; a one-token decode against the whole
# sequence) differ by bf16 rounding.  Each rounds the residual stream's
# inputs about 16 times a layer (projections, norms, RoPE, the attention or
# the scan, the MLP, the adds); independent roundings of unit roundoff
# u = 2^-9 add up as a random walk, so the relative 2-norm error after L
# layers is about u sqrt(16 L): 0.041 at Qwen3's 28 layers, 0.0625 at
# falcon-mamba's 64.  The logits and the cache leaves are held at twice
# that (SERVE_BOUND).  Where both paths take the same inputs through the
# same few ops (layer 0's k, v and conv inputs, the card against the CPU on
# the reduced configs), each element within SERVE_ELEM: a few bf16 ulps
# (rtol 2e-2 and atol 2^-4, as tests/test_torch_serve.py holds the port
# against the reference).
SERVE_ELEM = dict(rtol=2e-2, atol=2.0 ** -4)


def serve_bound(layers: int) -> float:
    return 2 * 2.0 ** -9 * math.sqrt(16 * layers)


def within(got, want, rtol, atol) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def serve_counted(plain_calls: list):
    """``ref.swa_attention_fwd`` (K6's plain version, which the wrapper
    takes on the CPU) counting its calls into ``plain_calls``; returns the
    original."""
    plain = ref.swa_attention_fwd

    def counted(*a, **kw):
        plain_calls.append(1)
        return plain(*a, **kw)
    ref.swa_attention_fwd = counted
    return plain


def decode_pair(lab, cfg, params, caches, tokens, pos0, window, dev,
                eager_steps=None):
    """``tokens.shape[1]`` decode steps from ``caches``: eager
    (``decode_step`` on a copy) and captured (``make_serving_fns``' decode
    on ``caches`` themselves).  Checks each step's logits bitwise, the
    caches bitwise at the end, every step in place and no kernel launched.
    With ``eager_steps`` the eager decode runs only the first that many
    steps, held bitwise against the captured ones and the caches after
    them (a copy taken there), and the captured decode runs on alone.
    Returns ``(last logits, caches, eager ms a token, captured ms a
    token)``."""
    steps = tokens.shape[1]
    eager_steps = eager_steps or steps
    eager = tree_map(torch.clone, caches)
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    eptrs = [t.data_ptr() for t in tree_leaves(eager)]
    _, decode = serve_mod.make_serving_fns(cfg, window=window, device=dev)
    reset_counts()
    sync(dev)
    t = time.perf_counter()
    want = []
    for i in range(eager_steps):
        lg, eager = tf_mod.decode_step(cfg, params, tokens[:, i], pos0 + i,
                                       eager, window=window)
        want.append(lg)
    sync(dev)
    eager_ms = (time.perf_counter() - t) * 1e3 / eager_steps
    got, at = [], None
    lg, caches = decode(params, tokens[:, 0], pos0, caches)    # captures
    got.append(lg)
    sync(dev)
    t = time.perf_counter()
    for i in range(1, steps):
        if i == eager_steps:
            at = tree_map(torch.clone, caches)
        lg, caches = decode(params, tokens[:, i], pos0 + i, caches)
        got.append(lg)
    sync(dev)
    graph_ms = (time.perf_counter() - t) * 1e3 / (steps - 1)
    check(counts() == only(), f"{lab} decode launched no kernel (eager and "
          "captured): the plain attention and scan steps")
    check(len(decode.graphs) == 1 and [t.data_ptr() for t in tree_leaves(
        caches)] == ptrs and [t.data_ptr() for t in tree_leaves(eager)]
          == eptrs, f"{lab} one capture; every step updated the caches in "
          "place (no step copied a cache)")
    check(all(torch.equal(a, b) for a, b in zip(want, got))
          and all(torch.equal(a, b) for a, b in zip(tree_leaves(eager),
                                                    tree_leaves(at or caches))),
          f"{lab} the captured decode == eager decode, bitwise ({eager_steps}"
          f" steps' logits and the caches after them"
          + (f"; {steps} captured steps" if at else "") + ")")
    check(all(torch.isfinite(g.float()).all() for g in got),
          f"{lab} logits finite at every step")
    del eager, at
    return got[-1], caches, eager_ms, graph_ms


def serve_times(lab, out, prefill_ms, eager_ms, graph_ms, batch, peak,
                card):
    out.update(prefill_ms=prefill_ms, decode_eager_ms=eager_ms,
               decode_ms=graph_ms, tokens_per_s=batch * 1e3 / graph_ms,
               peak_bytes=peak, card=card)
    pre = "no prefill" if prefill_ms is None \
        else f"prefill {prefill_ms:.3f} ms"
    print(f"  {lab} {pre}; decode {graph_ms:.3f} ms a "
          f"token captured ({eager_ms:.3f} eager), "
          f"{batch * 1e3 / graph_ms:.1f} tokens/s; peak "
          f"{peak / 2**30:.3f} GiB ({card})", flush=True)


def serve_tokens(vocab: int, b: int, s: int, dev, seed=SERVE_SEED):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (b, s),
                                         dtype=np.int32)).to(dev)


def layer0(params):
    return tree_map(lambda t: t[0], params["client"]["blocks_stage"]
                    ["blocks"])


def check_serve_qwen3(dev, out, card):
    """Phase 27 (a): full-width Qwen3-0.6B, the windowed prefill through
    K6, the captured decode past the ring's wrap, the merged model."""
    lab = "[qwen3-serve-window]"
    cfg = lm_cfg()
    params = lm_bundle(cfg, dev).init(torch.Generator().manual_seed(
        SERVE_SEED))
    win, L = cfg.swa_window, cfg.num_layers
    toks = serve_tokens(cfg.vocab_size, SERVE_B, SERVE_S + SERVE_STEPS, dev)
    prompt = {"tokens": toks[:, :SERVE_S]}
    torch.cuda.reset_peak_memory_stats(dev)
    plain_calls = []
    plain = serve_counted(plain_calls)
    try:
        ms = []
        for _ in range(2):              # the second call is timed
            reset_counts()
            sync(dev)
            t = time.perf_counter()
            logits, caches = tf_mod.prefill(cfg, params, prompt, window=win)
            sync(dev)
            ms.append((time.perf_counter() - t) * 1e3)
            launched = counts()
    finally:
        ref.swa_attention_fwd = plain
    check(launched == only(swa_attention_tc=L) and not plain_calls,
          f"{lab} prefill [{SERVE_B}, {SERVE_S}] at window {win}: K6 "
          f"launched {launched['swa_attention_tc']} == {L} times (once a "
          f"layer), its plain version {len(plain_calls)} times, nothing else")
    pcfg = cfg.with_(use_pallas=False)
    plogits, pcaches = tf_mod.prefill(pcfg, params, prompt, window=win)
    bound = serve_bound(L)
    errs = {"logits": rel_error(logits, plogits)}
    for st in ("client", "server"):
        for k in ("k", "v"):
            errs[f"{st}.{k}"] = rel_error(caches[st]["blocks"][k],
                                     pcaches[st]["blocks"][k])
    same0 = all(torch.equal(caches["client"]["blocks"][k][0],
                            pcaches["client"]["blocks"][k][0])
                for k in ("k", "v"))
    check(all(e <= bound for e in errs.values()) and same0,
          f"{lab} K6's prefill against the plain attention's: logits and "
          f"each cache stack within relative 2-norm {bound:.4f} "
          f"{ {k: round(v, 6) for k, v in errs.items()} }; layer 0's k and "
          "v bitwise (computed before any attention)")
    del plogits, pcaches
    check(caches["server"]["blocks"]["k"].shape
          == (L - cfg.resolved_cut, SERVE_B, win, cfg.num_kv_heads,
              cfg.resolved_head_dim), f"{lab} the ring holds the window "
          f"({win} slots a layer)")
    last, caches, eager_ms, graph_ms = decode_pair(
        lab, cfg, params, caches, toks[:, SERVE_S:], SERVE_S, win, dev)
    with torch.no_grad():
        x = tf_mod.full_forward(cfg, params, {"tokens": toks},
                                Ctx(cfg, "train", window=win))
        full = tf_mod.server_logits_fn(cfg, params["server"])(
            x[:, -1:])[:, 0]
        del x
        p0 = layer0(params)["attn"]
        xd = tf_mod.embed_inputs(cfg, params["client"],
                                 {"tokens": toks[:, SERVE_S:]})
        _, kv = blocks.attn_apply(cfg, p0, xd, Ctx(cfg, "prefill",
                                                   pos=SERVE_S), None)
    e = rel_error(last, full)
    agree = float((last.argmax(-1) == full.argmax(-1)).float().mean())
    ref_frac = float(((last.float() - full.float()).abs() <= 2e-2 + 2e-2
                      * full.float().abs()).float().mean())
    check(e <= bound, f"{lab} the last step's logits (position "
          f"{SERVE_S + SERVE_STEPS - 1}) against full_forward on "
          f"{SERVE_S + SERVE_STEPS} tokens at window {win}: relative 2-norm "
          f"{e:.6f} <= {bound:.4f} (max |diff| {diff(last, full):.4f}, "
          f"argmax agreement {agree}, {ref_frac:.6f} of the logits within "
          "the reference test's rtol = atol = 2e-2)")
    slots = [(SERVE_S + i) % win for i in range(SERVE_STEPS)]
    ring = {k: caches["client"]["blocks"][k][0][:, slots] for k in kv}
    check(all(within(ring[k], kv[k], **SERVE_ELEM) for k in kv),
          f"{lab} layer 0's ring after {SERVE_STEPS} steps: slots "
          f"{slots[0]}-{slots[-1]} hold the k and v of positions "
          f"{SERVE_S}-{SERVE_S + SERVE_STEPS - 1} (that layer run on the "
          f"decoded tokens), each element within {SERVE_ELEM}")
    peak = torch.cuda.max_memory_allocated(dev)
    out["qwen3_window"] = {"k6_launches": launched["swa_attention_tc"],
                           "k6_plain_calls": len(plain_calls),
                           "prefill_cold_ms": ms[0], "errors": errs,
                           "full_forward_rel2": e, "bound": bound,
                           "argmax_agreement": agree,
                           "within_2e-2": ref_frac}
    serve_times(lab, out["qwen3_window"], ms[1], eager_ms, graph_ms,
                SERVE_B, peak, card)
    del params, caches
    release(dev)


def check_serve_long(dev, out, card):
    """Phase 27 (b): the long_500k decode (B = 1, a ring of the window,
    pos 524,287) on full-width Qwen3-0.6B."""
    lab = "[qwen3-long]"
    cfg = lm_cfg()
    params = lm_bundle(cfg, dev).init(torch.Generator().manual_seed(
        SERVE_SEED))
    token, pos, caches, window = specs_mod.decode_specs(
        cfg, SHAPES["long_500k"], as_spec=False, seed=SERVE_SEED,
        device=dev)
    check(window == cfg.swa_window and int(pos) == 524_287
          and caches["client"]["blocks"]["k"].shape[2] == window
          and token.shape == (1,), f"{lab} B = 1, a ring of {window} "
          "slots, pos 524,287")
    toks = torch.cat([token[:, None], serve_tokens(
        cfg.vocab_size, 1, SERVE_LONG_STEPS - 1, dev)], 1)
    torch.cuda.reset_peak_memory_stats(dev)
    _, caches, eager_ms, graph_ms = decode_pair(lab, cfg, params, caches,
                                                toks, pos, window, dev)
    out["qwen3_long"] = {"steps": SERVE_LONG_STEPS, "pos0": int(pos)}
    serve_times(lab, out["qwen3_long"], None, eager_ms, graph_ms, 1,
                torch.cuda.max_memory_allocated(dev), card)
    del params, caches
    release(dev)


def serve_cli(lab, argv, dev, out, card):
    """``repro_torch.launch.serve.main(argv)`` in this process: its lines,
    its tokens/s, its peak."""
    torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        toks = serve_mod.main(argv)
    secs = time.perf_counter() - t
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"  {lab} | {line}")
    lines = [ln for ln in text.splitlines() if ln]
    m = re.fullmatch(r"total: (\d+) tokens, ([\d.]+) tok/s", lines[-1])
    check(len(lines) == 4 and all(re.fullmatch(
        rf"batch {i}: 128 tokens in [\d.]+s \([\d.]+ tok/s\)", lines[i])
        for i in range(3)) and m and int(m.group(1)) == 384
          and toks.shape == (4, 32) and toks.device.type == "cuda",
          f"{lab} the reference's lines: 3 batches of 4 x 32 tokens, the "
          "total")
    peak = torch.cuda.max_memory_allocated(dev)
    out[lab.strip("[]")] = {"tokens_per_s": float(m.group(2)),
                            "seconds": secs, "peak_bytes": peak,
                            "card": card}
    print(f"  {lab} {float(m.group(2)):.1f} tokens/s over the run; "
          f"{secs:.3f} s; peak {peak / 2**30:.3f} GiB ({card})", flush=True)
    del toks
    release(dev)


def check_serve_mamba(dev, out, card):
    """Phase 27 (d): falcon-mamba-7b at 64 layers, drawn on the card."""
    lab = "[mamba-serve]"
    cfg = get_config("falcon-mamba-7b").with_(use_pallas=True, remat=False)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = serve_mod.draw_params(cfg, SERVE_SEED, dev)
    sync(dev)
    draw_s = time.perf_counter() - t
    n = sum(x.numel() for x in tree_leaves(params))
    toks = serve_tokens(cfg.vocab_size, SERVE_B, MB_SERVE_S + MB_SERVE_STEPS,
                        dev)
    reset_counts()
    sync(dev)
    t = time.perf_counter()
    logits, caches = tf_mod.prefill(cfg, params,
                                    {"tokens": toks[:, :MB_SERVE_S]})
    sync(dev)
    prefill_ms = (time.perf_counter() - t) * 1e3
    check(counts() == only() and cfg.num_layers == 64,
          f"{lab} {cfg.num_layers} layers, {n:,} parameters: prefill "
          f"[{SERVE_B}, {MB_SERVE_S}] launched no kernel (K5 0 times: the "
          "reference's prefill takes the plain scan with its state)")
    check(bool(torch.isfinite(logits.float()).all()),
          f"{lab} the prefill's logits are finite")
    last, caches, eager_ms, graph_ms = decode_pair(
        lab, cfg, params, caches, toks[:, MB_SERVE_S:], MB_SERVE_S, 0, dev)
    reset_counts()
    with torch.no_grad():
        x = tf_mod.full_forward(cfg, params, {"tokens": toks},
                                Ctx(cfg, "train"))
        full = tf_mod.server_logits_fn(cfg, params["server"])(
            x[:, -1:])[:, 0]
        del x
        k5 = counts()["ssm_scan"]
        kc = cfg.ssm_conv - 1
        s1 = MB_SERVE_S + MB_SERVE_STEPS
        xd = tf_mod.embed_inputs(cfg, params["client"],
                                 {"tokens": toks[:, s1 - kc:]})
        _, c0, _ = blocks.mamba1_apply(cfg, layer0(params), xd,
                                       Ctx(cfg, "prefill"), None)
    bound = serve_bound(cfg.num_layers)
    e = rel_error(last, full)
    agree = float((last.argmax(-1) == full.argmax(-1)).float().mean())
    check(e <= bound and k5 == cfg.num_layers,
          f"{lab} the last step's logits against full_forward on {s1} "
          f"tokens (through K5, {k5} launches): relative 2-norm {e:.6f} <= "
          f"{bound:.4f} (max |diff| {diff(last, full):.4f}, argmax "
          f"agreement {agree})")
    conv = caches["client"]["blocks"]["conv"][0]
    check(within(conv, c0["conv"], **SERVE_ELEM),
          f"{lab} layer 0's conv window after {MB_SERVE_STEPS} steps holds "
          f"the inputs of positions {s1 - kc}-{s1 - 1} (that layer run on "
          f"the last {kc} tokens), each element within {SERVE_ELEM}")
    peak = torch.cuda.max_memory_allocated(dev)
    out["mamba"] = {"layers": cfg.num_layers, "parameters": n,
                    "draw_s": draw_s, "full_forward_rel2": e,
                    "bound": bound, "argmax_agreement": agree,
                    "k5_prefill_launches": 0}
    serve_times(lab, out["mamba"], prefill_ms, eager_ms, graph_ms, SERVE_B,
                peak, card)
    del params, caches, logits, last, full
    release(dev)


def check_serve_reduced(dev, out):
    """Phase 27 (e): both archs reduced (bf16, 2 layers): the card's
    prefill and captured decode against the CPU's prefill and eager decode;
    then the example on the card."""
    res = {}
    for arch in ("qwen3-0.6b", "falcon-mamba-7b"):
        lab = f"[{arch}-reduced]"
        cfg = get_config(arch).reduced()
        cpu = serve_mod.draw_params(cfg, SERVE_SEED, "cpu")
        params = tree_map(lambda t: t.to(dev), cpu)
        toks = serve_tokens(cfg.vocab_size, SERVE_B,
                            32 + SERVE_REDUCED_STEPS, "cpu")
        prefill, decode = serve_mod.make_serving_fns(cfg, device=dev,
                                                     cache_len=40)
        want, cw = tf_mod.prefill(cfg, cpu, {"tokens": toks[:, :32]},
                                  cache_len=40)
        got, cg = prefill(params, {"tokens": toks[:, :32].to(dev)})
        ok = [within(got.cpu(), want, **SERVE_ELEM)]
        worst = diff(got.cpu(), want)
        for i in range(SERVE_REDUCED_STEPS):
            want, cw = tf_mod.decode_step(cfg, cpu, toks[:, 32 + i], 32 + i,
                                          cw)
            got, cg = decode(params, toks[:, 32 + i].to(dev), 32 + i, cg)
            ok.append(within(got.cpu(), want, **SERVE_ELEM))
            worst = max(worst, diff(got.cpu(), want))
        ok += [within(a.cpu(), b, **SERVE_ELEM)
               for a, b in zip(tree_leaves(cg), tree_leaves(cw))]
        check(all(ok) and len(decode.graphs) == 1,
              f"{lab} prefill and {SERVE_REDUCED_STEPS} captured decode "
              f"steps on the card against the CPU's: logits and caches "
              f"within {SERVE_ELEM} (max |diff| {worst:.4f})")
        res[arch] = worst
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        toks = serve_split_model.main(["--batch", "4", "--prompt-len", "32",
                                       "--gen", "16"])
    for line in buf.getvalue().splitlines():
        print(f"  [example] | {line}")
    check(set(toks) == {"qwen3-0.6b", "falcon-mamba-7b"} and all(
        t.shape == (4, 16) and t.device.type == "cuda"
        for t in toks.values()), "[example] serve_split_model on the card: "
          "both archs, 4 x 16 tokens each")
    out["reduced_max_abs_diff"] = res
    release(dev)


def phase_serve(dev, card="", parts=("qwen3", "long", "cli", "mamba",
                                     "reduced")):
    """Phase 27: the serving path on the card, the ``parts`` of it (the
    windowed Qwen3 prefill and decode, the long_500k decode, the CLI,
    falcon-mamba at 64 layers, the reduced configs and the example).
    Returns the phase's numbers."""
    t0 = phase("27 serving: prefill (K6 in the windowed Qwen3 prefill), the "
               "captured decode with KV and SSM caches, serve.main, the "
               "example, on full-width Qwen3-0.6B and falcon-mamba-7b")
    release(dev)
    out, secs = {}, {}
    steps = (("qwen3", check_serve_qwen3, (dev, out, card)),
             ("long", check_serve_long, (dev, out, card)),
             ("cli", serve_cli, ("[qwen3-cli]", ["--arch", "qwen3-0.6b",
                                                 "--size", "full"], dev,
                                 out, card)),
             ("mamba", check_serve_mamba, (dev, out, card)),
             ("mamba", serve_cli, ("[mamba-cli]", [
                 "--arch", "falcon-mamba-7b", "--size", "full"], dev, out,
                 card)),
             ("reduced", check_serve_reduced, (dev, out)))
    for part, fn, args in steps:
        if part in parts:
            t = time.perf_counter()
            fn(*args)
            secs[f"{part}:{fn.__name__}"] = time.perf_counter() - t
    out["seconds"] = secs
    print(f"  seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    done(t0)
    return out


# ---------------------------------------------------------------------------
# Phase 28: the MoE family (olmoe-1b-7b at full width, phi3.5-moe reduced)
# ---------------------------------------------------------------------------

# olmoe-1b-7b (configs/olmoe_1b_7b.py) at full width: 16 layers cut at 2,
# d 2048, 16 heads over 16 kv heads (hd 128), 64 experts top 8 (d_ff 1024),
# V 50,304, bf16, the kernels on, remat as the config sets it; CSE-FSL at
# the LM path's n, h, B, S, lr, int8 uplink and model sync, one round.
# Its parameters (6.92 B; 9.78 B with the four clients' copies of the cut)
# are drawn on the card (card_bundle).
MOE_ROUNDS = 1
# K3/K4 at olmoe's heads (G, T, d, V): the server's and the 4 folded aux
# heads'; K6 at its heads (B, S, H, KH, hd, W), the 4 folded clients, and
# its backward at one server sequence.
MOE_CE_CASES = [((1, 4096, 2048, 50304), torch.bfloat16),
                ((4, 4096, 128, 50304), torch.bfloat16)]
MOE_SWA_CASES = [((4, 4096, 16, 16, 128, 4096), torch.bfloat16)]
MOE_SWA_BWD_CASES = [((1, 4096, 16, 16, 128, 4096), torch.bfloat16)]
# One MoE layer on one group of 1,024 tokens, the card (bf16) against the
# host CPU (fp32) from the card's router probabilities.  The routing is a
# function of the probabilities, so the expert ids, slots and kept flags
# must be equal.  On the card the output passes five bf16 roundings (h and
# hg, their gated product, the expert output, the combine weight, y), each
# within 2^-8 of its value, so its relative 2-norm error stays within
# 5 x 2^-8; a token sent to a wrong expert moves it by about 1.
MOE_GROUP, MOE_LAYER_BOUND = 1024, 5 * 2.0 ** -8
# Serving: prefill [4, 2048] at window 4096 (K6 once a layer), 32 captured
# decode steps.  phi3.5-moe reduced (2 layers, d 256, 4 experts top 2):
# one round at S 512, then prefill [4, 512] and 4 captured decode steps.
MOE_SERVE_S, MOE_SERVE_STEPS = 2048, 32
PHI_S, PHI_STEPS = 512, 4


def moe_cfg():
    return get_config("olmoe-1b-7b").with_(use_pallas=True)


def no_drops(cfg):
    """``cfg`` at the capacity factor E / k: an expert's capacity is the
    whole group, so no choice drops."""
    return cfg.with_(moe_capacity_factor=cfg.num_experts
                     / cfg.num_experts_per_tok)


def moe_kernels(dev, out):
    """Phase 28 (a): K3/K4 and K6 (forward and backward) at olmoe's
    shapes against their plain versions, phase 7's bounds."""
    err = {"fused_ce_fwd": 0.0, "fused_ce_dx": 0.0, "fused_ce_dw": 0.0,
           "fused_ce_bwd": 0.0, "swa_attention": 0.0, "swa_attention_tc": 0.0,
           **{n: 0.0 for n in swa.BWD_KERNELS}}
    check_ce(MOE_CE_CASES, err, dev)
    check_swa(MOE_SWA_CASES, err, dev, seed=600)
    check_swa_bwd(MOE_SWA_BWD_CASES, err, dev)
    out["kernel_max_abs_err"] = {k: v for k, v in err.items() if v}
    release(dev)


def moe_aux_losses(out):
    """``after_loop`` of phase 28's training path: client 0's and the
    server's summed aux losses on one sequence, from the trained state."""
    def after(tr, state, batcher):
        cfg = moe_cfg().with_(remat=True)
        ctx = Ctx(cfg, "train", window=cfg.swa_window)
        toks = serve_tokens(cfg.vocab_size, 1, LM_S, state_leaves(
            state)[0].device)
        with torch.no_grad():
            cp = tree_map(lambda t: t[0], state["clients"]["params"]
                          ["client"])
            sm, caux, _ = tf_mod.client_forward(cfg, cp, {"tokens": toks},
                                                ctx)
            _, saux, _ = tf_mod.server_forward(
                cfg, state["server"]["params"], sm, ctx)
        caux, saux = float(caux), float(saux)
        check(all(math.isfinite(a) and a > 0 for a in (caux, saux)),
              f"[olmoe-cse_fsl] the trained model's aux losses finite and "
              f"> 0: client stage {caux:.6f} (2 layers), server stage "
              f"{saux:.6f} (14 layers; 1.0 a layer is a uniform load)")
        out["aux_losses"] = {"client": caux, "server": saux}
    return after


def moe_train(dev, out):
    """Phase 28 (b): CSE-FSL on full-width olmoe through phase 19's checks
    (check_compiled_path, remat on): a loop round and a replayed round
    bitwise, launches a round as lm_launches states, losses finite, the
    meter CommProfile's, ms a round in both engines, idle and peak."""
    out["train"] = check_compiled_path(
        "olmoe-cse_fsl", "olmoe", "cse_fsl", MOE_ROUNDS, MOE_ROUNDS, dev,
        remat=True, reps=1, after_loop=moe_aux_losses(out))
    r = out["train"]
    print(f"  [olmoe-cse_fsl] loop {r['loop_ms']:.3f} ms/round (device "
          f"{r['loop_device_ms']:.3f} ms, idle {r['loop_idle']:.4f}), peak "
          f"{r['loop_peak_bytes'] / 2**30:.3f} GiB | compiled "
          f"{r['compiled_ms']:.3f} ms/round (replay {r['replay_ms']:.3f}, "
          f"idle {r['compiled_idle']:.4f}), peak "
          f"{r['compiled_peak_bytes'] / 2**30:.3f} GiB", flush=True)
    release(dev)


def moe_layer(dev, out):
    """Phase 28 (c): one full-width MoE layer.  Its dispatch on one group
    of 1,024 tokens against the host CPU's from the card's router
    probabilities (expert ids, slots and kept flags equal; a zero row to
    experts 0..7), its output against the CPU's fp32 experts
    (MOE_LAYER_BOUND); then the whole block (attention and experts) as a
    one-layer stage with remat against the same stage without it:
    output, aux loss and every gradient bitwise, under deterministic
    algorithms."""
    lab = "[olmoe-layer]"
    cfg = moe_cfg()
    d, e, k = cfg.d_model, cfg.num_experts, cfg.num_experts_per_tok
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    with torch.device(dev):
        p = blocks.moe_init(cfg, gen, torch.bfloat16)
        xn = torch.randn((MOE_GROUP, d), generator=gen).to(torch.bfloat16)
    xn[7] = 0.0
    g, s, cap = tf_layers.moe_groups(MOE_GROUP, cfg.moe_group_size, e, k,
                                     cfg.moe_capacity_factor)
    probs = tf_layers.moe_router_probs(xn.reshape(g, s, d),
                                       p["moe"]["router"])
    idx, gates, slot, keep = tf_layers.moe_slots(probs, k, cap)
    hidx, hgates, hslot, hkeep = tf_layers.moe_slots(probs.cpu(), k, cap)
    kept = int(keep.sum())
    check(torch.equal(idx.cpu(), hidx) and torch.equal(slot.cpu(), hslot)
          and torch.equal(keep.cpu(), hkeep)
          and torch.allclose(gates.cpu(), hgates, rtol=1e-6, atol=0),
          f"{lab} dispatch of {g} x {s} tokens (capacity {cap}) == the "
          f"host CPU's from the card's fp32 router probabilities: expert "
          f"ids, slots and kept flags equal, gates within 1e-6 ({kept} of "
          f"{g * s * k} choices kept)")
    check(idx[0, 7].tolist() == list(range(k)),
          f"{lab} a zero row's {e} equal probabilities route it to experts "
          f"0..{k - 1}: {idx[0, 7].tolist()}")
    y, aux = tf_layers.moe_ffn(xn, p["moe"], num_experts=e, k=k,
                               capacity_factor=cfg.moe_capacity_factor,
                               group_size=cfg.moe_group_size)
    disp, comb, haux = tf_layers.moe_tables(probs.cpu(), k, cap)
    hp = {n: p["moe"][n].float().cpu() for n in ("w1", "w2", "w3")}
    want = tf_layers.moe_experts(xn.float().cpu(), disp, comb, hp, g, s)
    err = rel_error(y, want)
    check(err <= MOE_LAYER_BOUND and math.isclose(float(aux), float(haux),
                                                  rel_tol=1e-5),
          f"{lab} output against the host CPU's fp32 experts: relative "
          f"2-norm {err:.6f} <= {MOE_LAYER_BOUND:.4f} (max |diff| "
          f"{diff(y.cpu(), want):.4g}); aux loss {float(aux):.6f} == the "
          f"CPU's {float(haux):.6f}")
    del disp, comb, hp, want, y
    out["layer"] = {"kept": kept, "choices": g * s * k, "capacity": cap,
                    "rel2": err, "bound": MOE_LAYER_BOUND}

    # the block as a one-layer stage, with and without remat
    sp = {"blocks": tree_map(lambda t: t[None], p)}
    plan = tf_mod.StagePlan("moe", 1)
    with torch.device(dev):
        x = torch.randn((1, MOE_GROUP, d), generator=gen).to(torch.bfloat16)
        gy = torch.randn((1, MOE_GROUP, d), generator=gen)
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {}
    try:
        for remat in (False, True):
            c = cfg.with_(remat=remat)
            xx = x.clone().requires_grad_(True)
            leaves = [t.clone().requires_grad_(True)
                      for t in tree_leaves(sp)]
            it = iter(leaves)
            spp = tree_map(lambda _: next(it), sp)
            reset_counts()
            xo, a, _ = tf_mod.stage_apply(c, plan, spp, xx, Ctx(
                c, "train", window=c.swa_window))
            loss = (xo.float() * gy).sum() + tf_mod.MOE_AUX_COEF * a
            grads = torch.autograd.grad(loss, [xx, *leaves])
            sync(dev)
            runs[remat] = (xo.detach(), a.detach(), grads,
                           {n: v for n, v in counts().items() if v})
            del xx, leaves, spp, xo, a, loss, grads
    finally:
        torch.use_deterministic_algorithms(False)
    (x0, a0, g0, c0), (x1, a1, g1, c1) = runs[False], runs[True]
    ri = 1 + len(tree_leaves(p["attn"])) + 1     # x, attn, moe's ln, router
    check(same(x0, x1) and same(a0, a1) and len(g0) == len(g1)
          and all(same(u, v) for u, v in zip(g0, g1)),
          f"{lab} the block ([1, {MOE_GROUP}, {d}], attention and experts) "
          f"with remat == without, bitwise: output, aux loss "
          f"{float(a0):.6f} and all {len(g0)} gradients (the router's "
          f"summed |.| {float(g0[ri].abs().sum()):.4g})")
    check(c1.get("swa_attention_tc") == 2 * c0.get("swa_attention_tc", 0)
          == 2, f"{lab} K6 once without remat, twice with it (the "
          f"backward's rerun): {c0} -> {c1}")
    out["layer"]["remat_launches"] = {"plain": c0, "remat": c1}
    del runs, p, sp, x, gy, xn, probs
    release(dev)


def moe_serve(dev, out, card):
    """Phase 28 (d): serving full-width olmoe: the windowed prefill of
    [4, 2048] at the config's factor (K6 once a layer, timed; layer 0's
    drops counted); then, with drops disabled (``no_drops``: a decode
    step groups only its 4 tokens and drops nothing, full_forward groups
    the sequence), the prefill, 32 captured decode steps bitwise the eager
    ones, and the last step against full_forward."""
    lab = "[olmoe-serve]"
    cfg = moe_cfg()
    nd = no_drops(cfg)
    win, L, d = cfg.swa_window, cfg.num_layers, cfg.d_model
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    torch.cuda.reset_peak_memory_stats(dev)
    params = serve_mod.draw_params(cfg, SERVE_SEED, dev)
    toks = serve_tokens(cfg.vocab_size, SERVE_B,
                        MOE_SERVE_S + MOE_SERVE_STEPS, dev)
    prompt = {"tokens": toks[:, :MOE_SERVE_S]}
    ms = []
    for _ in range(2):              # the second call is timed
        reset_counts()
        sync(dev)
        t = time.perf_counter()
        logits, caches = tf_mod.prefill(cfg, params, prompt, window=win)
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        launched = counts()
    check(launched == only(swa_attention_tc=L)
          and torch.isfinite(logits.float()).all(),
          f"{lab} prefill [{SERVE_B}, {MOE_SERVE_S}] at window {win}: K6 "
          f"launched {launched['swa_attention_tc']} == {L} times (once a "
          f"layer), nothing else; logits finite ({ms[1]:.3f} ms)")
    del caches, logits
    p0 = layer0(params)
    with torch.no_grad():
        x0 = tf_mod.embed_inputs(cfg, params["client"], prompt)
        x1, _ = blocks.attn_apply(cfg, p0["attn"], x0, Ctx(
            cfg, "prefill", window=win), None)
        xn = tf_layers.rmsnorm(x1, p0["moe"]["ln"]).reshape(-1, d)
        t = xn.shape[0]
        g, s, cap = tf_layers.moe_groups(t, min(cfg.moe_group_size, t), e,
                                         k, cfg.moe_capacity_factor)
        keep = tf_layers.moe_slots(tf_layers.moe_router_probs(
            xn[: g * s].reshape(g, s, d), p0["moe"]["router"]), k, cap)[3]
    dropped = g * s * k - int(keep.sum())
    print(f"  {lab} at the config's factor {cfg.moe_capacity_factor} layer "
          f"0's prefill drops {dropped} of {g * s * k} choices ({g} groups "
          f"of {s}, capacity {cap}); a decode step of {SERVE_B} tokens has "
          f"capacity {tf_layers.moe_groups(SERVE_B, SERVE_B, e, k, cfg.moe_capacity_factor)[2]} "
          "and drops none", flush=True)
    del x0, x1, xn, keep
    _, caches = tf_mod.prefill(nd, params, prompt, window=win)
    ring = min(win, MOE_SERVE_S)
    last, caches, eager_ms, graph_ms = decode_pair(
        lab, nd, params, caches, toks[:, MOE_SERVE_S:], MOE_SERVE_S, win,
        dev)
    del caches
    with torch.no_grad():
        # the ring holds min(window, prompt) = 2,048 slots, so each step
        # attends to the last 2,048 positions: full_forward at that window
        x = tf_mod.full_forward(nd, params, {"tokens": toks},
                                Ctx(nd, "train", window=ring))
        full = tf_mod.server_logits_fn(nd, params["server"])(
            x[:, -1:])[:, 0]
        del x
    bound = serve_bound(L)
    err = rel_error(last, full)
    agree = float((last.argmax(-1) == full.argmax(-1)).float().mean())
    check(err <= bound, f"{lab} drops disabled (capacity factor "
          f"{nd.moe_capacity_factor}): the last step's logits (position "
          f"{MOE_SERVE_S + MOE_SERVE_STEPS - 1}) against full_forward on "
          f"{MOE_SERVE_S + MOE_SERVE_STEPS} tokens at window {ring}: "
          f"relative 2-norm {err:.6f} <= {bound:.4f} (argmax agreement "
          f"{agree})")
    peak = torch.cuda.max_memory_allocated(dev)
    out["serve"] = {"k6_launches": launched["swa_attention_tc"],
                    "prefill_cold_ms": ms[0], "layer0_dropped": dropped,
                    "layer0_choices": g * s * k, "full_forward_rel2": err,
                    "bound": bound, "argmax_agreement": agree}
    serve_times(lab, out["serve"], ms[1], eager_ms, graph_ms, SERVE_B, peak,
                card)
    del params
    release(dev)


def moe_phi(dev, out):
    """Phase 28 (e): phi3.5-moe-42b-a6.6b reduced (its 42 B parameters do
    not fit one card): one CSE-FSL round on the card (int8 uplink and
    model sync) with the launches lm_launches states and finite losses,
    then a prefill and captured decode steps bitwise the eager ones."""
    lab = "[phi3.5-moe-reduced]"
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced().with_(use_pallas=True)
    bundle = transformer_bundle(cfg, device=dev)
    fsl = FSLConfig(num_clients=LM_N, h=LM_H, lr=LM_LR, codec="int8",
                    model_codec="int8")
    tr = Trainer(bundle, fsl)
    nm = len(tr.method.model_sync_specs(bundle, fsl))
    expect = lm_launches(cfg, "cse_fsl", tr.units_per_round + 2 * nm)
    fed = build_data(cfg, fsl, PHI_S, LM_SAMPLES, False)
    reset_counts()
    state, hist = tr.run(tr.init(0), LMBatcher(cfg, fed, LM_B, LM_H), 1,
                         log_every=1)
    sync(dev)
    got = counts()
    check(got == expect and all(math.isfinite(r[m]) for r in hist
                                for m in metric_keys(r)),
          f"{lab} one round at S {PHI_S}: launches "
          f"{ {n: v for n, v in got.items() if v} } == expected, losses "
          f"{[round(r[m], 5) for r in hist for m in metric_keys(r)]} finite")
    del state, tr
    params = serve_mod.draw_params(cfg, SERVE_SEED, dev)
    toks = serve_tokens(cfg.vocab_size, SERVE_B, PHI_S + PHI_STEPS, dev)
    _, caches = tf_mod.prefill(cfg, params, {"tokens": toks[:, :PHI_S]},
                               cache_len=PHI_S + PHI_STEPS)
    decode_pair(lab, cfg, params, caches, toks[:, PHI_S:], PHI_S, 0, dev)
    out["phi"] = {"losses": hist[0], "launches": {
        n: v for n, v in got.items() if v}}
    release(dev)


def phase_moe(dev, card="", parts=("kernels", "train", "layer", "serve",
                                   "phi")):
    """Phase 28: the MoE family on the card, the ``parts`` of it: the
    kernels at olmoe's shapes, CSE-FSL on full-width olmoe-1b-7b in both
    engines, one layer against the host CPU and with remat, serving, and
    phi3.5-moe reduced.  Returns the phase's numbers."""
    t0 = phase("28 MoE: full-width olmoe-1b-7b (64 experts top 8, "
               "capacity-limited dispatch, aux loss through remat) trained "
               "in both engines and served; phi3.5-moe reduced")
    release(dev)
    out, secs = {}, {}
    steps = (("kernels", moe_kernels, (dev, out)),
             ("train", moe_train, (dev, out)),
             ("layer", moe_layer, (dev, out)),
             ("serve", moe_serve, (dev, out, card)),
             ("phi", moe_phi, (dev, out)))
    for part, fn, args in steps:
        if part in parts:
            t = time.perf_counter()
            fn(*args)
            secs[part] = time.perf_counter() - t
    out["seconds"] = secs
    print(f"  seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    done(t0)
    return out


# ---------------------------------------------------------------------------
# Phase 29: the hybrid family (zamba2-7b)
# ---------------------------------------------------------------------------

# zamba2-7b at full width: 81 Mamba-2 layers (d 3,584, d_inner 7,168, 112
# SSD heads of 64, N 64, chunk 128), one shared dense block (32 heads of
# hd 112, d_ff 14,336) after every 6 of them, V 32,000, bf16, the kernels
# on, remat as configured (each backbone layer and each shared site
# recomputed in the backward).  Training: CSE-FSL at the Qwen3 cell's
# settings (4 clients x B 1 x h 2, S 4,096, int8 uplink and model sync),
# one round, at ZAMBA_LAYERS: cut 12 (the client stage 2 groups) and 15
# server layers (2 groups and a tail of 3).  At all 81 layers the loop
# round ran, but run_compiled's capture ran out of the card's 79.18 GiB
# (24.3 GiB held by the first captured graph's pool when the aggregating
# round's int8 model sync widened the 10 GB in_proj leaf to fp32; H100
# 80GB HBM3, 700 W); at 27 it peaks at 53.2 GiB.  Serving takes all 81.
ZAMBA_ROUNDS, ZAMBA_LAYERS = 1, 27
# K3/K4 at zamba2's heads (G, T, d, V): the server's and the 4 folded aux
# heads'; K6 at the 4 folded clients' shared sites (B, S, H, KH, hd, W)
# (one server sequence's K6 and its backward are phase 7's hd-112 cases).
ZAMBA_CE_CASES = [((1, 4096, 3584, 32000), torch.bfloat16),
                  ((4, 4096, 128, 32000), torch.bfloat16)]
ZAMBA_SWA_CASES = [((4, 4096, 32, 32, 112, 4096), torch.bfloat16)]
# One mamba2 layer and one shared site on [1, 1024] tokens, the card
# (bf16) against the host CPU (fp32) from the same bf16 inputs and
# parameters, relative 2-norm of the output.  Each bf16 rounding on the
# card moves a value by at most 2^-9 of itself, and an error passes the
# rest of the layer with a gain near 1, so each rounding adds at most
# about 2^-8 relative (twice u, as MOE_LAYER_BOUND counts them): the
# mamba2 layer rounds 10 times (its norm, the projection, the conv, the
# SiLU, the scan's y, the skip term, the gate, the gate norm, out_proj,
# the residual add), a shared site 14 (norm, q, k, v, RoPE on q and k,
# K6, wo, the add, norm, w1, w3, their gated product, w2 and the add).
ZAMBA_LAYER_S = 1024
MAMBA2_LAYER_BOUND, SITE_LAYER_BOUND = 10 * 2.0 ** -8, 14 * 2.0 ** -8
# Serving at all 81 layers (13 shared sites): a prefill of [4, 1920] at
# window 4,096 (K6 once a site), then 128 decode steps eager and captured
# to position 2,047; the ring is min(window, prompt) = 1,920 slots a site,
# so each step attends to the last 1,920 positions: the last step against
# full_forward at window 1,920 on the 2,048 tokens, and every cache leaf
# (the 81 conv windows and SSD states, the 13 sites' rings) against a
# prefill of the 2,048 tokens at window 1,920, within SERVE_BOUND of the
# layers and sites.  Both lengths are multiples of the 128-step SSD chunk.
# The eager decode (host-bound: 257 ms a token at 81 layers on an H100
# 80GB HBM3 at 700 W) runs the first ZAMBA_EAGER_STEPS of them, held
# bitwise against the captured steps and the caches after them.
ZAMBA_SERVE_S, ZAMBA_SERVE_STEPS, ZAMBA_EAGER_STEPS = 1920, 128, 32


def zamba_cfg():
    return get_config("zamba2-7b").with_(use_pallas=True)


def zamba_kernels(dev, out):
    """Phase 29 (a): K3/K4 and K6 at zamba2's shapes against their plain
    versions, phase 7's bounds."""
    err = {"fused_ce_fwd": 0.0, "fused_ce_dx": 0.0, "fused_ce_dw": 0.0,
           "fused_ce_bwd": 0.0, "swa_attention": 0.0,
           "swa_attention_tc": 0.0}
    check_ce(ZAMBA_CE_CASES, err, dev)
    check_swa(ZAMBA_SWA_CASES, err, dev, seed=700)
    out["kernel_max_abs_err"] = {k: v for k, v in err.items() if v}
    release(dev)


def zamba_train(dev, out):
    """Phase 29 (b): CSE-FSL on zamba2-7b through phase 19's checks
    (check_compiled_path, remat on): a loop round and a replayed round
    bitwise (64-bit digests of the state), launches a round as
    lm_launches states (K6 a shared site, K5 never), losses finite, the
    meter CommProfile's, ms a round in both engines, idle and peak."""
    out["train"] = check_compiled_path(
        "zamba2-cse_fsl", "zamba2", "cse_fsl", ZAMBA_ROUNDS, ZAMBA_ROUNDS,
        dev, remat=True, reps=1, layers=ZAMBA_LAYERS)
    r = out["train"]
    print(f"  [zamba2-cse_fsl] {ZAMBA_LAYERS} layers: loop "
          f"{r['loop_ms']:.3f} ms/round (device {r['loop_device_ms']:.3f} "
          f"ms, idle {r['loop_idle']:.4f}), peak "
          f"{r['loop_peak_bytes'] / 2**30:.3f} GiB | compiled "
          f"{r['compiled_ms']:.3f} ms/round (replay {r['replay_ms']:.3f}, "
          f"idle {r['compiled_idle']:.4f}), peak "
          f"{r['compiled_peak_bytes'] / 2**30:.3f} GiB", flush=True)
    release(dev)


def zamba_layer(dev, out):
    """Phase 29 (c): one full-width mamba2 layer and one shared site
    (``dense_apply``: K6 on the card, the plain attention on the CPU) on
    [1, 1024] tokens, the card in bf16 against the host CPU in fp32 from
    the same bf16 inputs and parameters (MAMBA2_LAYER_BOUND,
    SITE_LAYER_BOUND)."""
    cfg = zamba_cfg()
    ctx = Ctx(cfg, "train", window=cfg.swa_window)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    with torch.device(dev):
        parts = {"mamba2": blocks.mamba2_init(cfg, gen, torch.bfloat16),
                 "site": blocks.dense_init(cfg, gen, torch.bfloat16)}
        x = torch.randn((1, ZAMBA_LAYER_S, cfg.d_model),
                        generator=gen).to(torch.bfloat16)
    fns = {"mamba2": blocks.mamba2_apply, "site": blocks.dense_apply}
    bounds = {"mamba2": MAMBA2_LAYER_BOUND, "site": SITE_LAYER_BOUND}
    hcfg = cfg.with_(dtype="float32")
    out["layer"] = {}
    for name, p in parts.items():
        lab = f"[zamba2-layer {name}]"
        reset_counts()
        with torch.no_grad():
            y, _, _ = fns[name](cfg, p, x, ctx, None)
            sync(dev)
            launched = counts()
            hp = tree_map(lambda t: t.float().cpu(), p)
            want, _, _ = fns[name](hcfg, hp, x.float().cpu(),
                                   Ctx(hcfg, "train", window=cfg.swa_window),
                                   None)
        err = rel_error(y, want)
        k6 = 1 if name == "site" else 0
        check(torch.isfinite(y.float()).all() and err <= bounds[name]
              and launched == only(swa_attention_tc=k6),
              f"{lab} [1, {ZAMBA_LAYER_S}, {cfg.d_model}] on the card (bf16, "
              f"K6 {launched.get('swa_attention_tc', 0)} time(s)) against "
              f"the host CPU (fp32): relative 2-norm {err:.6f} <= "
              f"{bounds[name]:.4f} (max |diff| {diff(y.cpu(), want):.4g})")
        out["layer"][name] = {"rel2": err, "bound": bounds[name]}
        del y, hp, want
    del parts, x
    release(dev)


def zamba_serve(dev, out, card):
    """Phase 29 (d): serving zamba2-7b at all 81 layers: the windowed
    prefill of [4, 1920] (K6 once a shared site, 13 times, timed), 128
    captured decode steps bitwise the eager ones, the last step against
    full_forward, and every cache leaf against a prefill of the whole
    sequence (each site its own ring)."""
    lab = "[zamba2-serve]"
    cfg = zamba_cfg()
    win, L = cfg.swa_window, cfg.num_layers
    sites = sum(pl.n_shared_sites for pl in tf_mod.stage_plans(cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    params = serve_mod.draw_params(cfg, SERVE_SEED, dev)
    total = ZAMBA_SERVE_S + ZAMBA_SERVE_STEPS
    toks = serve_tokens(cfg.vocab_size, SERVE_B, total, dev)
    prompt = {"tokens": toks[:, :ZAMBA_SERVE_S]}
    ms = []
    for _ in range(2):              # the second call is timed
        reset_counts()
        sync(dev)
        t = time.perf_counter()
        logits, caches = tf_mod.prefill(cfg, params, prompt, window=win)
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        launched = counts()
        if not ms[1:]:
            del caches, logits
    check(launched == only(swa_attention_tc=sites)
          and torch.isfinite(logits.float()).all(),
          f"{lab} prefill [{SERVE_B}, {ZAMBA_SERVE_S}] at window {win}: K6 "
          f"launched {launched['swa_attention_tc']} == {sites} times (once "
          f"a shared site), nothing else; logits finite ({ms[1]:.3f} ms)")
    ring = min(win, ZAMBA_SERVE_S)
    last, caches, eager_ms, graph_ms = decode_pair(
        lab, cfg, params, caches, toks[:, ZAMBA_SERVE_S:], ZAMBA_SERVE_S,
        win, dev, eager_steps=ZAMBA_EAGER_STEPS)
    bound = serve_bound(L + sites)
    with torch.no_grad():
        x = tf_mod.full_forward(cfg, params, {"tokens": toks},
                                Ctx(cfg, "train", window=ring))
        full = tf_mod.server_logits_fn(cfg, params["server"])(
            x[:, -1:])[:, 0]
        del x
        _, whole = tf_mod.prefill(cfg, params, {"tokens": toks},
                                  window=ring)
    err = rel_error(last, full)
    agree = float((last.argmax(-1) == full.argmax(-1)).float().mean())
    check(err <= bound, f"{lab} the last step's logits (position "
          f"{total - 1}) against full_forward on {total} tokens at window "
          f"{ring}: relative 2-norm {err:.6f} <= {bound:.4f} ({L} layers + "
          f"{sites} sites; argmax agreement {agree})")
    errs = {}
    for stage in ("client", "server"):
        for group, tree in caches[stage].items():
            for leaf, t in tree.items():
                errs[f"{stage}/{group}/{leaf}"] = rel_error(
                    t, whole[stage][group][leaf])
    worst = max(errs, key=errs.get)
    check(all(v <= bound for v in errs.values())
          and caches["server"]["shared"]["k"].shape[0] == sites - 2,
          f"{lab} after the decode every cache leaf (the conv windows, the "
          f"SSD states, each site's own ring of {ring} slots) against a "
          f"prefill of the {total} tokens at window {ring}: relative "
          f"2-norm <= {bound:.4f} (worst {worst} {errs[worst]:.6f})")
    del whole, caches
    peak = torch.cuda.max_memory_allocated(dev)
    out["serve"] = {"k6_launches": launched["swa_attention_tc"],
                    "prefill_cold_ms": ms[0], "full_forward_rel2": err,
                    "cache_rel2": errs, "bound": bound,
                    "argmax_agreement": agree}
    serve_times(lab, out["serve"], ms[1], eager_ms, graph_ms, SERVE_B, peak,
                card)
    del params
    release(dev)


def phase_hybrid(dev, card="", parts=("kernels", "train", "layer",
                                      "serve")):
    """Phase 29: the hybrid family on the card, the ``parts`` of it: the
    kernels at zamba2's shapes, CSE-FSL on zamba2-7b in both engines, one
    mamba2 layer and one shared site against the host CPU, and serving at
    81 layers.  Returns the phase's numbers."""
    t0 = phase(f"29 hybrid: zamba2-7b (Mamba-2 SSD, a shared attention "
               f"block every 6 layers) trained at {ZAMBA_LAYERS} layers in "
               "both engines and served at 81")
    release(dev)
    out, secs = {"train_layers": ZAMBA_LAYERS}, {}
    steps = (("kernels", zamba_kernels, (dev, out)),
             ("train", zamba_train, (dev, out)),
             ("layer", zamba_layer, (dev, out)),
             ("serve", zamba_serve, (dev, out, card)))
    for part, fn, args in steps:
        if part in parts:
            t = time.perf_counter()
            fn(*args)
            secs[part] = time.perf_counter() - t
    out["seconds"] = secs
    print(f"  seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    done(t0)
    return out


# ---------------------------------------------------------------------------
# Phase 30: the VLM and audio families (qwen2-vl-72b, hubert-xlarge)
# ---------------------------------------------------------------------------

# qwen2-vl-72b at full width: d 8,192, 64 query heads over 8 kv heads of
# hd 128 (a GQA group of 8), d_ff 29,568, V 152,064, M-RoPE sections (16,
# 24, 24) of hd / 2 over 256 image positions (a 16 x 16 patch grid), bf16,
# the kernels on, remat as configured.  Training: CSE-FSL at the Qwen3
# cell's settings (4 clients x B 1 x h 2, S 4,096, lr 0.1, the int8
# uplink), one round, depth 80 cut to VLM_LAYERS (cut 1, 3 server layers).
# A layer is 877.7 M parameters (1.755 GB), the embedding and the head
# 1.246 B each: the 4 client copies hold 17.3 GB, the server 7.8 GB, and a
# round their gradients and updates as much again.  The model sync runs
# uncoded (MODEL_SYNC): the int8 one codes each client's leaf in fp32, and
# the [4, 152064, 8192] embedding widened is 19.9 GB more (phase 29's
# failure); FedAvg averages such a leaf in slices (core/methods/base.py).
VLM_LAYERS, VLM_ROUNDS = 4, 1
MODEL_SYNC = {"qwen2vl": "none"}
# hubert-xlarge at full width and depth: 48 encoder layers cut at 6, d
# 1,280, 16 heads of 80, non-causal plain attention (no K6), a 512-wide
# frame frontend, 504 classes, 1.26 B parameters; the int8 uplink and
# model sync; train_batch_specs-style features [4, 2, 1, 4096, 512].
HUBERT_ROUNDS = 1
# K3/K4 at both families' heads (G, T, d, V): the server head and the 4
# folded aux heads.  V 504 is 3 x 128 + 120: the last bf16 vocabulary tile
# is ragged at both of hubert's heads.
VLM_CE_CASES = [((1, 4096, 8192, 152064), torch.bfloat16),
                ((4, 4096, 256, 152064), torch.bfloat16)]
HUBERT_CE_CASES = [((1, 4096, 1280, 504), torch.bfloat16),
                   ((4, 4096, 64, 504), torch.bfloat16)]
# One attention sub-block (blocks.attn_apply) of each family on [1, 4096]
# positions, the card (bf16; qwen2-vl's K6) against the host CPU in fp32,
# from the same bf16 inputs and parameters, through attn_reference: an
# attention written out here, whose rotation is the complex form
# (torch.polar, per section for M-RoPE) over position streams written out
# here, so it shares no code with the port's RoPE, M-RoPE or attention.
# The inputs are N(0, 2^-12): the norm undoes their scale, and the
# sub-block's own output, not the residual, carries the relative error.
# Roundings on the card, each within 2^-8 relative as MOE_LAYER_BOUND
# counts them: qwen2-vl 13 (the norm, q, k, v, their bias adds, RoPE on q
# and k, K6's P and output, wo, the add), hubert 9 (no biases; the plain
# attention's one output rounding).
ATTN_LAYER_S, ATTN_X_SCALE = 4096, 2.0 ** -6
VLM_LAYER_BOUND, HUBERT_LAYER_BOUND = 13 * 2.0 ** -8, 9 * 2.0 ** -8
# Serving qwen2-vl at full width and 16 layers (cut 10): prefill [4, 4096]
# with 256 image embeddings at window 4,096 (K6 once a layer), 32 captured
# decode steps bitwise the eager ones, the last against full_forward on
# the 4,128 tokens and every cache leaf against a prefill of them.
VLM_SERVE_LAYERS, VLM_SERVE_STEPS = 16, 32


def vlm_cfg():
    return get_config("qwen2-vl-72b").with_(use_pallas=True,
                                            num_layers=VLM_LAYERS,
                                            cut_layer=1)


def hubert_cfg():
    return get_config("hubert-xlarge").with_(use_pallas=True)


class SpecBatcher:
    """Round batches as ``launch.specs.train_batch_specs`` draws them with
    numpy (seed: the round's index), on the host for ``run_compiled`` to
    stage: hubert's frame features ``[n, h, B, S, 512]`` (fp32) and its
    labels."""

    def __init__(self, cfg, fsl, seq):
        self.cfg, self.fsl, self.rnd = cfg, fsl, 0
        self.shape = dataclasses.replace(
            SHAPES["train_4k"], seq_len=seq,
            global_batch=fsl.num_clients * LM_B)

    def next_round(self):
        inputs, labels = specs_mod.train_batch_specs(
            self.cfg, self.shape, self.fsl, as_spec=False, seed=self.rnd,
            device="cpu")
        self.rnd += 1
        return tree_map(lambda t: t.numpy(), inputs), labels.numpy()


def family_kernels(dev, out):
    """Phase 30 (a): K3/K4 at qwen2-vl's and hubert's heads against their
    plain versions (phase 7's bounds; K6 at qwen2-vl's group of 8 is among
    phase 7's cases), timed at the two server heads, and FedAvg of a leaf
    past SLICE_NUMEL (averaged in slices) bitwise the whole leaf's."""
    err = {"fused_ce_fwd": 0.0, "fused_ce_dx": 0.0, "fused_ce_dw": 0.0,
           "fused_ce_bwd": 0.0}
    check_ce(VLM_CE_CASES, err, dev)
    out["qwen2_vl_max_abs_err"] = dict(err)
    err = dict.fromkeys(err, 0.0)
    check_ce(HUBERT_CE_CASES, err, dev)
    out["hubert_max_abs_err"] = dict(err)
    x = torch.randn((LM_N, 152064, 1024), device=dev).to(torch.bfloat16)
    total = x[0].float()
    for i in range(1, LM_N):        # the clients added in order
        total = total + x[i].float()
    whole = (total * (1.0 / LM_N)).expand(x.shape).to(x.dtype)
    got = fedavg({"x": x})["x"]
    check(x[0].numel() >= SLICE_NUMEL and same(got, whole),
          f"FedAvg of a [{LM_N}, 152064, 1024] bf16 leaf in slices of dim "
          "1 == the whole leaf's fp32 mean (the clients added in order), "
          "bitwise")
    del total
    del x, whole, got
    release(dev)
    # the qwen2-vl head's calls take 21-62 ms (its plain versions 0.2-0.9
    # s): three single calls each after none, and one plain call
    none = dict.fromkeys(("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw",
                          "fused_ce_p"), 0)
    out["times"] = {
        **time_ce({"qwen2_vl": VLM_CE_CASES[0][0][:4]}, none,
                  {**out["qwen2_vl_max_abs_err"]}, dev, plain_reps=1,
                  reps=3, inner=1, warm=0),
        **time_ce({"hubert": HUBERT_CE_CASES[0][0][:4]}, none,
                  {**out["hubert_max_abs_err"]}, dev, plain_reps=1)}
    release(dev)


def family_train(dev, out, model):
    """Phase 30 (b, d): CSE-FSL on qwen2-vl (cut to VLM_LAYERS; its vlm
    batches staged from the host, zero image embeddings as the
    reference's batcher gives) or hubert (all 48 layers, SpecBatcher's
    features) through phase 19's checks (check_compiled_path, remat as
    configured): a loop round and a replayed round bitwise, launches a
    round as lm_launches states (K6 none for hubert), losses finite, the
    meter CommProfile's, ms a round in both engines, idle and peak."""
    tag = {"qwen2vl": "qwen2vl-cse_fsl", "hubert": "hubert-cse_fsl"}[model]
    rounds = VLM_ROUNDS if model == "qwen2vl" else HUBERT_ROUNDS
    # no separate timed loop round: the loop's ms a round is its checked
    # run's host time (profiled for qwen2-vl); hubert's round (about 6 s,
    # some 100,000 kernel launches) runs unprofiled, and its compiled round
    # is timed through run_compiled only (its replay alone is not)
    vlm = model == "qwen2vl"
    r = check_compiled_path(tag, model, "cse_fsl", rounds, rounds, dev,
                            remat=True, reps=1, time_loop=False, profile=vlm)
    out[model] = r
    loop = f"loop {r['loop_run_ms']:.3f} ms/round (the run's host time" + (
        f", profiled; device {r['loop_device_ms']:.3f} ms)" if vlm else ")")
    alone = (f"replay {r['replay_ms']:.3f}, idle {r['compiled_idle']:.4f}"
             if vlm else "a replay alone not timed")
    print(f"  [{tag}] {r['layers']} layers: {loop}, peak "
          f"{r['loop_peak_bytes'] / 2**30:.3f} "
          f"GiB | compiled {r['compiled_ms']:.3f} ms/round ({alone}), peak "
          f"{r['compiled_peak_bytes'] / 2**30:.3f} GiB ({out['card']})",
          flush=True)
    release(dev)


def rope_streams(cfg, s: int) -> np.ndarray:
    """The position streams of positions 0..s-1 written out here: for
    M-RoPE (t, h, w) over a square patch grid of the first P positions
    (t 0, h the row, w the column) and text positions from 0 after it on
    all three; otherwise the one stream 0..s-1.  ``[streams, s]``."""
    pos = np.arange(s)
    if cfg.mrope_sections is None:
        return pos[None]
    p = cfg.num_image_tokens
    side = int(round(p ** 0.5))
    img = pos < p
    return np.stack([np.where(img, 0, pos - p),
                     np.where(img, pos // side, pos - p),
                     np.where(img, pos % side, pos - p)])


def rotate(x, streams, cfg):
    """RoPE as a complex product: each pair ``(x_j, x_{j + hd/2})`` as
    ``x_j + i x_{j + hd/2}`` times ``polar(1, p f_j)``, ``f_j = theta^(-2j
    / hd)`` in fp64, ``p`` the stream of frequency slot j's section.  x
    ``[B, S, H, hd]`` fp32."""
    hd = x.shape[-1]
    f = cfg.rope_theta ** (-torch.arange(0, hd, 2, dtype=torch.float64)
                           / hd)
    secs = cfg.mrope_sections or (hd // 2,)
    which = torch.repeat_interleave(torch.arange(len(secs)),
                                    torch.tensor(secs))
    ang = torch.from_numpy(streams).double()[which].T * f      # [S, hd/2]
    rot = torch.polar(torch.ones_like(ang), ang)[None, :, None, :]
    c = torch.complex(x[..., :hd // 2].double(), x[..., hd // 2:].double())
    c = c * rot
    return torch.cat([c.real, c.imag], dim=-1).float()


def attn_reference(cfg, p, x, streams, causal: bool, window: int):
    """One attention sub-block's output ``x + attention`` in fp32, written
    out here: the RMS norm, the projections (with the biases), the
    rotation (:func:`rotate`), GQA by repeating the kv heads, softmax over
    the causal band of ``window`` (or every key when not ``causal``), the
    output projection and the residual."""
    b, s, d = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    xf = x.float()
    xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6) \
        * p["ln"].float()
    q, k, v = (xn @ p[w].float() for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), \
            v + p["bv"].float()
    q = rotate(q.reshape(b, s, h, hd), streams, cfg)
    k = rotate(k.reshape(b, s, kh, hd), streams, cfg)
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.reshape(b, s, kh, hd).repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    i = torch.arange(s)
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    scores.masked_fill_(~keep, -math.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    return xf + o.reshape(b, s, h * hd) @ p["wo"].float()


def family_layer(dev, out):
    """Phase 30 (c): one full-width attention sub-block of qwen2-vl
    (M-RoPE over positions 0..4095, the image/text boundary at 256; K6)
    and of hubert (non-causal plain attention) on the card against
    attn_reference on the host CPU (VLM_LAYER_BOUND, HUBERT_LAYER_BOUND)."""
    out["layer"] = {}
    for name, cfg, bound in (("qwen2vl", vlm_cfg(), VLM_LAYER_BOUND),
                             ("hubert", hubert_cfg(), HUBERT_LAYER_BOUND)):
        lab = f"[{name}-layer]"
        gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
        with torch.device(dev):
            p = blocks.attn_init(cfg, gen, torch.bfloat16)
            x = (torch.randn((1, ATTN_LAYER_S, cfg.d_model), generator=gen)
                 * ATTN_X_SCALE).to(torch.bfloat16)
        reset_counts()
        with torch.no_grad():
            y, _ = blocks.attn_apply(cfg, p, x, Ctx(
                cfg, "train", window=cfg.swa_window), None)
            sync(dev)
        launched = counts()
        k6 = 0 if cfg.encoder_only else 1
        hp = tree_map(lambda t: t.cpu(), p)
        t = time.perf_counter()
        want = attn_reference(cfg, hp, x.cpu(), rope_streams(
            cfg, ATTN_LAYER_S), causal=not cfg.encoder_only,
            window=cfg.swa_window)
        host_s = time.perf_counter() - t
        err = rel_error(y.float() - x.float(), want - x.float().cpu())
        rot = " per M-RoPE section" if cfg.mrope_sections else ""
        check(torch.isfinite(y.float()).all() and err <= bound
              and launched == only(swa_attention_tc=k6),
              f"{lab} attention sub-block [1, {ATTN_LAYER_S}, "
              f"{cfg.d_model}] on the card (bf16, K6 {k6} time(s)) against "
              f"the host CPU's written-out attention (fp32, "
              f"{'non-causal, ' if cfg.encoder_only else ''}rotation by "
              f"torch.polar{rot}): relative 2-norm of the sub-block's "
              f"output {err:.6f} <= "
              f"{bound:.4f} (host {host_s:.3f} s)")
        out["layer"][name] = {"rel2": err, "bound": bound, "host_s": host_s}
        del p, x, y, hp, want
    release(dev)


def vlm_serve(dev, out, card):
    """Phase 30 (e): serving qwen2-vl at 16 layers: the image merge on the
    card, the windowed prefill of [4, 4096] with 256 image embeddings (K6
    once a layer), 32 captured decode steps bitwise the eager ones, the
    last against full_forward and every cache leaf against a prefill of
    the whole sequence."""
    lab = "[qwen2vl-serve]"
    cfg = get_config("qwen2-vl-72b").with_(use_pallas=True,
                                           num_layers=VLM_SERVE_LAYERS)
    win, L, p_img = cfg.swa_window, cfg.num_layers, cfg.num_image_tokens
    torch.cuda.reset_peak_memory_stats(dev)
    params = serve_mod.draw_params(cfg, SERVE_SEED, dev)
    total = SERVE_S + VLM_SERVE_STEPS
    toks = serve_tokens(cfg.vocab_size, SERVE_B, total, dev)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    img = torch.randn((SERVE_B, p_img, cfg.d_model), generator=gen,
                      device=dev)
    prompt = {"tokens": toks[:, :SERVE_S], "image_embeds": img}
    with torch.no_grad():
        x = tf_mod.embed_inputs(cfg, params["client"], prompt)
        emb = params["client"]["embed"][toks[:, p_img:SERVE_S].long()]
    check(same(x[:, :p_img], img.to(torch.bfloat16))
          and same(x[:, p_img:], emb),
          f"{lab} embed_inputs on the card: positions 0-{p_img - 1} the "
          f"image embeddings (bf16), {p_img}-{SERVE_S - 1} the tokens' "
          "embedding rows, bitwise")
    del x, emb
    ms = []
    for _ in range(2):              # the second call is timed
        reset_counts()
        sync(dev)
        t = time.perf_counter()
        logits, caches = tf_mod.prefill(cfg, params, prompt, window=win)
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        launched = counts()
        if not ms[1:]:
            del caches, logits
    check(launched == only(swa_attention_tc=L)
          and torch.isfinite(logits.float()).all(),
          f"{lab} prefill [{SERVE_B}, {SERVE_S}] with {p_img} image "
          f"embeddings at window {win}: K6 launched "
          f"{launched['swa_attention_tc']} == {L} times (once a layer), "
          f"nothing else; logits finite ({ms[1]:.3f} ms)")
    ring = min(win, SERVE_S)
    last, caches, eager_ms, graph_ms = decode_pair(
        lab, cfg, params, caches, toks[:, SERVE_S:], SERVE_S, win, dev)
    bound = serve_bound(L)
    whole_in = {"tokens": toks, "image_embeds": img}
    with torch.no_grad():
        x = tf_mod.full_forward(cfg, params, whole_in,
                                Ctx(cfg, "train", window=ring))
        full = tf_mod.server_logits_fn(cfg, params["server"])(
            x[:, -1:])[:, 0]
        del x
        _, whole = tf_mod.prefill(cfg, params, whole_in, window=ring)
        # layer 0 on the decoded tokens, a prefill at their positions
        xd = tf_mod.embed_inputs(cfg, params["client"], {
            "tokens": toks[:, SERVE_S:], "image_embeds": img[:, :0]})
        _, kv = blocks.attn_apply(cfg, layer0(params)["attn"], xd,
                                  Ctx(cfg, "prefill", pos=SERVE_S), None)
        del xd
    err = rel_error(last, full)
    agree = float((last.argmax(-1) == full.argmax(-1)).float().mean())
    check(err <= bound, f"{lab} the last step's logits (position "
          f"{total - 1}) against full_forward on {total} tokens with the "
          f"image at window {ring}: relative 2-norm {err:.6f} <= "
          f"{bound:.4f} ({L} layers; argmax agreement {agree})")
    slots = [(SERVE_S + i) % ring for i in range(VLM_SERVE_STEPS)]
    r0 = {k: caches["client"]["blocks"][k][0][:, slots] for k in kv}
    check(all(within(r0[k], kv[k], **SERVE_ELEM) for k in kv),
          f"{lab} layer 0's ring after {VLM_SERVE_STEPS} steps: slots "
          f"{slots[0]}-{slots[-1]} hold the k (M-RoPE-rotated) and v of "
          f"positions {SERVE_S}-{total - 1} (that layer run on the decoded "
          f"tokens at their positions), each element within {SERVE_ELEM}")
    del r0, kv
    errs = {}
    for stage in ("client", "server"):
        for leaf, t in caches[stage]["blocks"].items():
            errs[f"{stage}/{leaf}"] = rel_error(
                t, whole[stage]["blocks"][leaf])
    worst = max(errs, key=errs.get)
    check(all(v <= bound for v in errs.values()),
          f"{lab} after the decode every cache leaf (each layer's ring of "
          f"{ring} slots) against a prefill of the {total} tokens at "
          f"window {ring}: relative 2-norm <= {bound:.4f} (worst {worst} "
          f"{errs[worst]:.6f})")
    del whole, caches
    peak = torch.cuda.max_memory_allocated(dev)
    out["serve"] = {"layers": L, "k6_launches": launched["swa_attention_tc"],
                    "prefill_cold_ms": ms[0], "full_forward_rel2": err,
                    "cache_rel2": errs, "bound": bound,
                    "argmax_agreement": agree}
    serve_times(lab, out["serve"], ms[1], eager_ms, graph_ms, SERVE_B, peak,
                card)
    del params
    release(dev)


def phase_families(dev, card="", parts=("kernels", "train", "layer",
                                        "hubert", "serve")):
    """Phase 30: the VLM and audio families on the card, the ``parts`` of
    it: K3/K4 at both families' heads, CSE-FSL on qwen2-vl-72b (cut to
    VLM_LAYERS) in both engines, one attention sub-block of each family
    against the host CPU, CSE-FSL on hubert-xlarge at full depth in both
    engines, and serving qwen2-vl at 16 layers.  Returns the phase's
    numbers."""
    t0 = phase(f"30 VLM and audio: qwen2-vl-72b (M-RoPE, image embeddings) "
               f"trained at {VLM_LAYERS} layers in both engines and served "
               "at 16; hubert-xlarge (encoder-only, frame features) trained "
               "at 48 in both engines")
    release(dev)
    out, secs = {"train_layers": VLM_LAYERS, "card": card}, {}
    steps = (("kernels", family_kernels, (dev, out)),
             ("train", family_train, (dev, out, "qwen2vl")),
             ("layer", family_layer, (dev, out)),
             ("hubert", family_train, (dev, out, "hubert")),
             ("serve", vlm_serve, (dev, out, card)))
    for part, fn, args in steps:
        if part in parts:
            t = time.perf_counter()
            fn(*args)
            secs[part] = time.perf_counter() - t
    out["seconds"] = secs
    print(f"  seconds: { {k: round(v, 3) for k, v in secs.items()} }",
          flush=True)
    done(t0)
    return out


def phase_capture_raises(dev):
    """Phases 19 and 21, run last: a kernel wrapper made to synchronize
    makes the capture of the unmasked and of the masked graphs raise.
    Last, because a failed capture leaves the caching allocator keeping
    every freed block reserved for the rest of the process (torch 2.11):
    run before phase 21, it left phase 21's Qwen3 capture out of memory."""
    t0 = phase("19 and 21, last: a capture that must raise")
    check_capture_raises(dev)
    check_capture_raises(dev, masked=True)
    done(t0)


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
    del mtr, mstate
    torch.cuda.empty_cache()
    cnn_paths = phase_baselines(dev, fed)
    phase_baselines_cpu_vs(dev, fed)
    lm_paths = phase_lm_baselines(dev)
    baselines = phase_baseline_times(dev, fed, records, cnn_paths, lm_paths)
    del cnn_paths, lm_paths
    torch.cuda.empty_cache()
    main_lm = ("mamba-cse_fsl", "qwen3-cse_fsl")
    compiled = phase_compiled(dev, keep=main_lm)
    scheduled = phase_sched(dev, plain=compiled)
    remat = phase_remat(dev, plain={t: compiled[t] for t in main_lm})
    for t in main_lm:
        del compiled[t]["loop_run"]
    figures, known = phase_figures(dev)
    engine = phase_engine(dev, fed)
    population, telemetry = phase_population(dev, fed, parts=("cnn",
                                                              "drivers"),
                                             compiled=compiled)
    cli_out = phase_cli(dev, remat)
    for t in main_lm:               # digests kept for phase 26's Mamba run
        remat[t]["remat"].pop("loop_run", None)
    serve = phase_serve(dev, card)
    moe = phase_moe(dev, card)
    hybrid = phase_hybrid(dev, card)
    families = phase_families(dev, card)
    phase_capture_raises(dev)
    for r_ in records:              # K2 a replayed round, model sync in
        if r_["name"] == "quantize_philox":
            r_["compiled_launches_per_round"] = {
                tag: c["kernels_per_round"]["quantize_philox_kernel"]
                for tag, c in compiled.items()}
            r_["sched_launches_per_round"] = {
                tag: c["k2_per_round"] for tag, c in scheduled.items()}
            r_["population_launches_per_round"] = population["k2_per_round"]
            r_["model_sync_leaf"] = {k: cli_out["k2_leaf"][k] for k in (
                "shape", "launches", "launches_path", "max_abs_err", "ms",
                "eager_ms", "plain_ms", "bound_ms", "bound_by", "bytes")}
    for r_ in lm_records:           # K6 in the windowed Qwen3 prefill
        if r_["name"] == "swa_attention_tc":
            r_["serve_prefill_launches"] = serve["qwen3_window"][
                "k6_launches"]
            r_["olmoe_serve_prefill_launches"] = moe["serve"]["k6_launches"]
            r_["zamba2_serve_prefill_launches"] = hybrid["serve"][
                "k6_launches"]
            r_["qwen2_vl_serve_prefill_launches"] = families["serve"][
                "k6_launches"]
    # the MoE path (phase 28): launches a round at olmoe's shapes and the
    # largest differences from the plain versions there
    moe_launches = moe["train"]["launches_per_round"]
    for r_ in records + lm_records:
        key = "fused_ce_p" if r_["name"] == "fused_ce_bwd" else r_["name"]
        if moe_launches.get(key):
            r_["olmoe_launches_per_round"] = moe_launches[key]
            r_["olmoe_max_abs_err"] = moe["kernel_max_abs_err"].get(
                r_["name"])
    # the hybrid path (phase 29): the same at zamba2's shapes
    zamba_launches = hybrid["train"]["launches_per_round"]
    for r_ in records + lm_records:
        key = "fused_ce_p" if r_["name"] == "fused_ce_bwd" else r_["name"]
        if zamba_launches.get(key):
            r_["zamba2_launches_per_round"] = zamba_launches[key]
            r_["zamba2_max_abs_err"] = hybrid["kernel_max_abs_err"].get(
                r_["name"])
    # the VLM and audio paths (phase 30): launches a round, the largest
    # differences at their heads, and K3/K4 timed at their server heads
    for model, key in (("qwen2vl", "qwen2_vl"), ("hubert", "hubert")):
        launched = families[model]["launches_per_round"]
        for r_ in records + lm_records:
            name = r_["name"]
            if launched.get("fused_ce_p" if name == "fused_ce_bwd"
                            else name):
                r_[f"{key}_launches_per_round"] = launched[
                    "fused_ce_p" if name == "fused_ce_bwd" else name]
                r_[f"{key}_max_abs_err"] = families[
                    f"{key}_max_abs_err"].get(name)
            if name in families["times"][key]:
                r_[f"{key}_server"] = {k: families["times"][key][name][k]
                                       for k in ("shape", "ms", "eager_ms",
                                                 "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}
    print(f"\n  total wall time {time.perf_counter() - t_start:.3f} s")
    print(card)
    print(json.dumps({"kernels": records + lm_records + ssm_records,
                      "round_ms": round_ms, "lm": lm, "mamba": mb,
                      "baselines": baselines, "compiled": compiled,
                      "sched": scheduled, "remat": remat,
                      "figures": figures, "engine": engine,
                      "population": population, "telemetry": telemetry,
                      "cli": {k: v for k, v in cli_out.items()
                              if k != "k2_leaf"}, "serve": serve,
                      "moe": {k: v for k, v in moe.items()
                              if k != "kernel_max_abs_err"},
                      "hybrid": {k: v for k, v in hybrid.items()
                                 if k != "kernel_max_abs_err"},
                      "families": {k: v for k, v in families.items()
                                   if k != "times"},
                      "known_reference_failures": known, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except torch.OutOfMemoryError:
        # the allocator's state and the phase, after the traceback: the
        # end of stderr is what a failed run shows
        print(torch.cuda.memory_summary(abbreviated=True), file=sys.stderr)
        traceback.print_exc()
        print(f"out of memory in phase {PHASE[0]!r}", file=sys.stderr)
        sys.exit(1)
