#!/usr/bin/env python3
"""Show that the kernel checks of ``chip_smoke.py`` (phases 7 and 11), the
topk tie check (phase 15), the compiled runner's (phase 19), the masked
runner's (phase 21), the layer recompute's (phase 22), the event
engine's (phase 24), the population engine's and telemetry's (phase
25), the entry points' (phase 26: the CLI's Qwen3 run, Trainer
resume, falcon-mamba through the population engine) and the serving
path's (phase 27: the windowed Qwen3 prefill and decode, falcon-mamba's
decode), the MoE layer's (phase 28: one olmoe block with and without
recompute), the hybrid serving path's (phase 29: zamba2-7b's decode
caches against a prefill of the whole sequence) and the VLM and audio
families' (phase 30: the attention sub-blocks against an attention
written out in the phase, the image merge, qwen2-vl's decoded ring) can
fail.  Run from the repo root on a machine with
one NVIDIA GPU and nvcc:

    python3 chip_mutants.py [--only PHASE ...]

(``--only 19 26q``: the tree on those phases and the mutants that run in
them.)

The tree itself runs phases 1, 2, 7, 11, 15 (its topk tie check), 19 (its
CNN CSE-FSL path), 21 (its cnn-cse-deadline and cnn-cse-bwh paths), 22
(its qwen3-cse_fsl path), 24 and 25 (their CNN paths) and 26 (its
qwen3, resume and mamba parts), 27 (its qwen3 and mamba parts), 28
(its layer part), 29 (its serve part) and 30 (its layer and serve parts)
of ``chip_smoke.py`` in a fresh process, with every check reported instead
of raised; each mutant below runs phases 1, 2 and the one of 7 (fused CE,
K6 and its backward), 11 (K5), 15 (topk), 19 (the captured round), 21
(the masked round), 22 (the recomputed layer), 24 (the event engine),
25 (the population engine, telemetry), 26 (the CLI, the Trainer's
checkpoint, the Mamba population run), 27 (the ring, the conv window,
the captured decode), 28 (the recomputed MoE block), 29 (the shared
sites' rings, the SSD's carried state) or 30 (M-RoPE in decode and in its
sections, the image merge, hubert's non-causal attention) that holds its
fault.  A mutant is
one deliberate fault in a kernel source, in the compiled runner, in the
masked aggregate, in the topk codec, in the layer recompute, in the
per-client coding, in the checksum frame, in the arrival heap, in the
population engine's rows, in the cohort or shard draws, in telemetry,
in the CLI, in the Trainer's checkpoint or in the serving path,
made in a copy of the checkout
under a temporary directory; the checkout itself is never changed.  The script exits non-zero unless the tree passes
every check and each mutant fails a bound of its phase at a main-path
shape.  The last line is a JSON summary: per run, the checks that
failed.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CE = "src/repro_torch/kernels/csrc/fused_ce.cu"
SWA = "src/repro_torch/kernels/csrc/swa_attention.cu"
SSM = "src/repro_torch/kernels/csrc/ssm_scan.cu"
BASE = "src/repro_torch/core/methods/base.py"
GRAPHS = "src/repro_torch/core/graphs.py"
TRANSPORT = "src/repro_torch/transport/__init__.py"
MODEL = "src/repro_torch/models/model.py"
FRAME = "src/repro_torch/faults/frame.py"
ENGINE = "src/repro_torch/core/async_trainer.py"
POPULATION = "src/repro_torch/population/engine.py"
POOL = "src/repro_torch/population/data.py"
COHORT = "src/repro_torch/sched/cohort.py"
TRAINER = "src/repro_torch/core/trainer.py"
CLI = "src/repro_torch/launch/train.py"
BLOCKS = "src/repro_torch/models/blocks.py"
LAYERS = "src/repro_torch/models/layers.py"
SERVE = "src/repro_torch/launch/serve.py"
COMPILED = "[cnn-cse_fsl] run_compiled's state == run's, bitwise"
REMAT = "[qwen3-cse_fsl] run with remat == run without, bitwise"
# name -> (edits (file, old, new), a check that must fail[, the phase to
# run, where the file's own phase (phase_of) is not it]).  A mutant
# never desynchronises a kernel's producer and consumers (that would hang
# the card): it changes what both see, or only what a consumer adds up.
MUTANTS = {
    "P without the softmax term": (
        [(CE, "? (expf(d[4 * j + 2 * h + i] - lse_t) -",
          "? (0.f * expf(d[4 * j + 2 * h + i] - lse_t) -")],
        "fused_ce_dx [1, 4096, 1024, 151936] bfloat16 per element"),
    "dx missing one vocabulary chunk": (
        [(CE, "if (dx) {\n      a.out = dx;",
          "if (dx && c0 != vc) {\n      a.out = dx;")],
        "fused_ce_dx [1, 4096, 1024, 151936] bfloat16 per element"),
    "dw written one tile off": (
        [(CE, "bf16* orow = a.out + ((long long)g * a.d + dc) * a.V + a.c0;",
          "bf16* orow = a.out + ((long long)g * a.d + (dc + G_BM) % a.d) "
          "* a.V + a.c0;")],
        "fused_ce_dw [1, 4096, 1024, 151936] bfloat16 per element"),
    "K6 window one kv tile late": (
        [(SWA, "const int jt0 = max(0, q0 - window + 1) / A_BK,",
          "const int jt0 = max(0, q0 - window + 1) / A_BK "
          "+ (q0 - window + 1 > 0),")],
        "swa_attention_tc [1, 8192, 16, 8, 128] W=4096 bfloat16 per element"),
    "K6 one kv tile inside the window skipped": (
        [(SWA, "const bool edge = k0 + A_BK - 1 > qa || k0 <= qa + 63 "
          "- window;",
          "const bool edge = k0 + A_BK - 1 > qa || k0 <= qa + 63 - window "
          "|| jt == jt0 + 1;"),
         (SWA, "const bool ok = key <= row && key > row - window;",
          "const bool ok = key <= row && key > row - window "
          "&& jt != jt0 + 1;")],
        "swa_attention_tc [4, 4096, 16, 8, 128] W=4096 bfloat16 per element"),
    "K6 backward: dS without its -delta term": (
        [(SWA, "  return p * (dp - delta);",
          "  return p * dp + 0.f * delta;")],
        "swa_attention_bwd [1, 4096, 16, 8, 128] W=4096 bfloat16 dq per "
        "element"),
    "K6 backward: the dK/dV kernel skips one q tile inside the band": (
        [(SWA, "      kv_tile_p(sacc, dpacc, pa, dsa, lrow, lrow + B_ROWS, q0, "
          "ka, kr, cq,\n                window, sl2);",
          "      kv_tile_p(sacc, dpacc, pa, dsa, lrow, lrow + B_ROWS, q0, "
          "ka, kr, cq,\n                window, sl2);\n"
          "      if (n == nqi / 2)\n"
          "        for (int kk = 0; kk < 16; ++kk)\n"
          "          pa[kk / 4][kk % 4] = dsa[kk / 4][kk % 4] = 0u;")],
        "swa_attention_bwd [4, 4096, 16, 8, 128] W=4096 bfloat16 dv per "
        "element"),
    "K6 backward: the dQ kernel skips one kv tile inside the band": (
        [(SWA, "      q_tile_ds(sacc, dpacc, dsa, lrow, drow, lt * B_ROWS, qa, "
          "r, cq, window,\n                sl2);",
          "      q_tile_ds(sacc, dpacc, dsa, lrow, drow, lt * B_ROWS, qa, "
          "r, cq, window,\n                sl2);\n"
          "      if (lt == lt0 + 1)\n"
          "        for (int kk = 0; kk < 16; ++kk) dsa[kk / 4][kk % 4] = 0u;")],
        "swa_attention_bwd [1, 4096, 16, 8, 128] W=4096 bfloat16 dq per "
        "element"),
    "K3 one vocabulary tile of a split skipped": (
        [(CE, "        fwd_tile(d, n0, a.V, lane, lab, fm, fl, fp);",
          "        if (tile != 1) fwd_tile(d, n0, a.V, lane, lab, fm, fl, "
          "fp);")],
        "fused_ce_fwd [1, 4096, 1024, 151936] bfloat16 lse, picked within "
        "1e-4"),
    "K5 state reset every 128 steps": (
        [(SSM, "float h0 = hin[n * 32 + lane], h1 = hin[(n + 1) * 32 + lane];",
          "float h0 = 0.f * hin[n * 32 + lane],\n"
          "              h1 = 0.f * hin[(n + 1) * 32 + lane];")],
        "ssm_scan [4, 2048, 8192, 16] G=4 bfloat16 per element"),
    "K5 backward: adjoint carry dropped at one chunk boundary": (
        [(SSM, "if (w == 0) gout[n * 32 + lane] = g;",
          "if (w == 0) gout[n * 32 + lane] = i == nt / 2 ? 0.f : g;")],
        "ssm_scan_bwd [4, 2048, 8192, 16] G=4 bfloat16 du per element"),
    "K5 backward: one db/dc slab partial skipped in the ordered sum": (
        [(SSM, "for (int k = 0; k < nslab; ++k) s += p[k * bsn + f];",
          "for (int k = 0; k < nslab; ++k) s += k == 1 ? 0.f "
          ": p[k * bsn + f];")],
        "ssm_scan_bwd [4, 2048, 8192, 16] G=4 bfloat16 db per element"),
    "captured round: seeds frozen at the capture's step": (
        [(BASE, "sd = {k: v.index_select(0, step)[0] for k, v in "
          "seeds.items()}", "sd = {k: v[0] for k, v in seeds.items()}")],
        COMPILED),
    "captured round: lr frozen at the capture's step": (
        [(BASE, "lr = lrs.index_select(0, step)[0]", "lr = lrs[0]")],
        COMPILED),
    "captured round: the aggregating variant skips the aggregation": (
        [(GRAPHS, "                self._round(aggregated)",
          "                self._round(False)")],
        COMPILED),
    "masked round: the aggregating graph reads the cohort of row 0": (
        [(BASE, "state, windows.index_select(0, step)[0], sd)",
          "state, windows[0], sd)")],
        "[cnn-cse-deadline] run_compiled's state == run's, bitwise", "21"),
    "masked aggregate: refresh=False broadcasts to every client": (
        [(BASE, "                    if refresh:\n"
          "                        return b.contiguous()",
          "                    if True:\n"
          "                        return b.contiguous()")],
        "[cnn-cse-bwh] on the card the cohort's rows are equal", "21"),
    "topk with an unstable order (torch.topk in place of the stable sort)": (
        [(TRANSPORT, "        idx = torch.sort(x.abs(), dim=-1, descending=True,\n"
          "                         stable=True).indices[..., :self._k(c)]",
          "        idx = torch.topk(x.abs(), self._k(c), dim=-1).indices")],
        "topk ties (bf16 [2, 64, 1024], ratio 0.1", "15"),
    "recompute from a stale input (the layer's output, not its input)": (
        [(MODEL, "        ctx.save_for_backward(x, *leaves)",
          "        ctx.save_for_backward(output, *leaves)")],
        REMAT, "22"),
    "recompute drops the parameter leaves' gradients": (
        [(MODEL, "        return vjp_fn(gs[0] if ng == 1 else tuple(gs))\n",
          "        dx, *_ = vjp_fn(gs[0] if ng == 1 else tuple(gs))\n"
          "        return (dx, *(torch.zeros_like(t) for t in leaves))\n")],
        REMAT, "22"),
    "recompute drops the aux loss's gradient (MoE)": (
        [(MODEL, "        return vjp_fn(gs[0] if ng == 1 else tuple(gs))\n",
          "        return vjp_fn(gs[0] if ng == 1 else\n"
          "                      (gs[0], torch.zeros_like(gs[1])))\n")],
        "[olmoe-layer] the block (", "28"),
    "per-client coding with client 0's seeds for every client": (
        [(TRANSPORT, "s = seeds[i][client:client + 1] if one else seeds[i]",
          "s = seeds[i][0:1] if one else seeds[i]")],
        "one client's coding (client=c) == row c of the stacked coding",
        "24"),
    "check_frame passes every payload": (
        [(FRAME, "    return frame_checksum(tree) == (int(frame[0]), "
          "int(frame[1]))", "    return True")],
        "[cnn-cse-lognormal-lossy]", "24"),
    "the arrival heap pops ties by descending client id": (
        [(ENGINE, "            heapq.heappush(heap, (client_t[c] + xfer,\n"
          "                                  next(seq), c, k, upload, "
          "pending))",
          "            heapq.heappush(heap, (client_t[c] + xfer,\n"
          "                                  -1000 * c + next(seq), c, k, "
          "upload, pending))")],
        "[cnn-cse_fsl] zero latency consumes in Trainer.run's order", "24"),
    "the population's default row kept as a view of the state": (
        [(POPULATION, "self._default = {k: _row(state[k]) for k in "
          "self._stacked}",
          "self._default = {k: tree_map(lambda x: x[0], state[k]) for k in "
          "self._stacked}")],
        "[cnn-fleet] the default row is unchanged by the rounds", "25"),
    "the cohort draws' salt changed": (
        [(COHORT, "_COHORT_SALT = 0xC0408", "_COHORT_SALT = 0xC0409")],
        "[cnn-fleet] cohorts == the plain stratified draws", "25"),
    "the virtual shards' hash changed": (
        [(POOL, "_SHARD_HASH = 2654435761", "_SHARD_HASH = 2654435769")],
        "[cnn-fleet] index plans == the plain virtual-shard draws", "25"),
    "telemetry reads a state tensor on the host each round": (
        [(TRAINER, "            if tele.enabled:\n"
          "                tele.round_record(engine, rnd + 1, m, "
          "aggregated,",
          "            if tele.enabled:\n"
          "                tele.gauge(\"state_norm\", float(\n"
          "                    graphs.state_leaves(state)[0].float()"
          ".norm()))\n"
          "                tele.round_record(engine, rnd + 1, m, "
          "aggregated,")],
        "[telemetry compiled] the recorder adds no synchronizing call", "25"),
    "the CLI drops --model-codec": (
        [(CLI, "codec=args.codec, model_codec=args.model_codec)",
          "codec=args.codec, model_codec=\"none\")")],
        "[cli-qwen3] the CLI's state", "26q"),
    "the Trainer's checkpoint loses the window": (
        [(TRAINER, "        if w is not None and w[0] == rnd:\n"
          "            tree[\"window\"]",
          "        if False:\n"
          "            tree[\"window\"]")],
        "[cnn-resume] saved after round", "26r"),
    "the population's rows taken as views of the state": (
        [(POPULATION, "    return tree_map(lambda x: x[0].clone(), tree)",
          "    return tree_map(lambda x: x[0], tree)")],
        "[mamba-population] the default row is untouched", "26m"),
    "decode writes the ring slot one late": (
        [(BLOCKS, "slot = (pos % clen).reshape(1)",
          "slot = ((pos + 1) % clen).reshape(1)")],
        "[qwen3-serve-window] layer 0's ring", "27q"),
    "the Mamba decode does not shift the conv window": (
        [(LAYERS, "    state.copy_(full[:, 1:])",
          "    state.copy_(full[:, :-1])")],
        "[mamba-serve] layer 0's conv window", "27m"),
    "the captured decode replays with a stale pos": (
        [(SERVE, "        self._set_pos(pos)\n        self.graph.replay()",
          "        self.graph.replay()")],
        "[qwen3-serve-window] the captured decode == eager", "27q"),
    "one KV ring shared by every shared attention site": (
        [(MODEL, "sites[(i + 1) // cfg.attn_every - 1])", "sites[0])")],
        "[zamba2-serve] after the decode every cache leaf", "29"),
    "the SSD's carried state not decayed across its chunk": (
        [(LAYERS, "z = F.pad(la_cum[..., -1], (1, 0))",
          "z = F.pad(0 * la_cum[..., -1], (1, 0))")],
        "[zamba2-serve] after the decode every cache leaf", "29"),
    "the vlm's decode builds 1-D RoPE positions": (
        [(BLOCKS, "pos_ids = L.mrope_pos_ids(cfg.num_image_tokens, b, s, "
          "ctx.pos,",
          "pos_ids = L.mrope_pos_ids(0 if ctx.mode == \"decode\" else "
          "cfg.num_image_tokens, b, s, ctx.pos,")],
        "[qwen2vl-serve] layer 0's ring", "30"),
    "the image merge skipped on the card": (
        [(MODEL, "    if cfg.family == \"vlm\":\n        img = ",
          "    if cfg.family == \"vlm\" and x.device.type != \"cuda\":\n"
          "        img = ")],
        "[qwen2vl-serve] embed_inputs on the card", "30"),
    "hubert's attention left causal": (
        [(BLOCKS, "out = L.attention(q, k, v, causal=not cfg.encoder_only,",
          "out = L.attention(q, k, v, causal=True,")],
        "[hubert-layer] attention sub-block", "30"),
    "M-RoPE's sections take the streams in reverse order": (
        [(LAYERS, "parts.append(pos[i][..., None].float()",
          "parts.append(pos[2 - i][..., None].float()")],
        "[qwen2vl-layer] attention sub-block", "30"),
}
KERNEL_PHASES = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
def report(cond, what):
    print(("  ok  " if cond else "  FAIL ") + what, flush=True)
cs.check = report
cs.phase_device()
cs.phase_build()
"""
PHASES = {"7": 'cs.phase_lm_kernels(torch.device("cuda"))\n',
          "11": 'cs.phase_mamba_kernels(torch.device("cuda"))\n',
          "19": 'cs.phase_compiled(torch.device("cuda"), '
                'paths=("cnn-cse_fsl",))\n',
          "21": 'cs.phase_sched(torch.device("cuda"), '
                'paths=("cnn-cse-deadline", "cnn-cse-bwh"))\n',
          "15": 'cs.check_topk_ties(torch.device("cuda"))\n',
          "22": 'cs.phase_remat(torch.device("cuda"), '
                'paths=("qwen3-cse_fsl",))\n',
          "24": 'cs.phase_engine(torch.device("cuda"), cs.make_data(), '
                'parts=("cnn",))\n',
          "25": 'cs.phase_population(torch.device("cuda"), cs.make_data(), '
                'parts=("cnn",))\n',
          "26q": 'cs.phase_cli(torch.device("cuda"), parts=("qwen3",))\n',
          "26r": 'cs.phase_cli(torch.device("cuda"), parts=("resume",))\n',
          "26m": 'cs.phase_cli(torch.device("cuda"), parts=("mamba",))\n',
          "27q": 'cs.phase_serve(torch.device("cuda"), parts=("qwen3",))\n',
          "27m": 'cs.phase_serve(torch.device("cuda"), parts=("mamba",))\n',
          "28": 'cs.phase_moe(torch.device("cuda"), parts=("layer",))\n',
          "29": 'cs.phase_hybrid(torch.device("cuda"), parts=("serve",))\n',
          "30": 'cs.phase_families(torch.device("cuda"), '
                'parts=("layer", "serve"))\n'}


def phase_of(path: str) -> str:
    """The chip_smoke.py phase that holds the code of ``path``."""
    if path.endswith(".py"):
        return "19"
    return "11" if path == SSM else "7"


ALL_PHASES = ("7", "11", "15", "19", "21", "22", "24", "25", "26q", "26r",
              "26m", "27q", "27m", "28", "29", "30")


def run(where: str, phases=ALL_PHASES) -> list:
    """Phases 1, 2 and ``phases`` in ``where``; returns the failed
    checks."""
    code = KERNEL_PHASES + "".join(PHASES[p] for p in phases)
    r = subprocess.run([sys.executable, "-c", code], cwd=where,
                       capture_output=True, text=True, timeout=900)
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        raise RuntimeError(f"phases {phases} did not run to their end in "
                           f"{where}:\n"
                           f"{r.stderr[-3000:]}")
    return [ln[len("  FAIL "):] for ln in r.stdout.splitlines()
            if ln.startswith("  FAIL ")]


def phases_of(edits, where) -> list:
    """The phases a mutant runs: its own, else those of its files."""
    return list(where) or sorted({phase_of(p) for p, _, _ in edits})


def main(only=None) -> int:
    """The tree and every mutant; with ``only`` (phases, as in PHASES),
    the tree on those phases and the mutants that run in them."""
    for name, (edits, *_) in MUTANTS.items():   # every edit applies once
        for path, old, _ in edits:
            with open(os.path.join(ROOT, path)) as f:
                assert f.read().count(old) == 1, (name, old)
    chosen = {name: m for name, m in MUTANTS.items()
              if only is None or set(phases_of(m[0], m[2:])) <= set(only)}
    print("== the tree as it is", flush=True)
    failed = {"tree": run(ROOT, tuple(only) if only else ALL_PHASES)}
    ok = not failed["tree"]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (edits, must_fail, *where)) in enumerate(
                chosen.items()):
            print(f"\n== mutant: {name}", flush=True)
            copy = os.path.join(tmp, f"m{i}")
            # a mutant of Python code keeps the built kernels
            python_only = all(p.endswith(".py") for p, _, _ in edits)
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                ".git", "chiprun_out", *(() if python_only else ("build",))))
            for path, old, new in edits:
                p = os.path.join(copy, path)
                with open(p) as f:
                    src = f.read()
                assert src.count(old) == 1, (name, old)
                with open(p, "w") as f:
                    f.write(src.replace(old, new))
            failed[name] = run(copy, phases_of(edits, where))
            caught = any(c.startswith(must_fail) for c in failed[name])
            print(f"  {'caught' if caught else 'MISSED'}: {must_fail}")
            ok = ok and caught
    print(json.dumps({"ok": ok, "failed": failed}))
    return 0 if ok else 1


if __name__ == "__main__":
    only = sys.argv[sys.argv.index("--only") + 1:] \
        if "--only" in sys.argv else None
    sys.exit(main(only))
