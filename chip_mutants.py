#!/usr/bin/env python3
"""Show that the kernel checks of ``chip_smoke.py`` (phases 7 and 11) can
fail.  Run from the repo root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_mutants.py

The tree itself runs phases 1, 2, 7 and 11 of ``chip_smoke.py`` in a
fresh process, with every check reported instead of raised; each mutant
below runs phases 1, 2 and the one of 7 (fused CE, K6) and 11 (K5) that
holds its kernel.  A mutant is one deliberate fault in a kernel source,
made in a copy of the checkout under a temporary directory; the checkout
itself is never changed.  The script exits non-zero unless the tree passes
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
# name -> (edits (file, old, new), a check that must fail).  A mutant
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
          "11": 'cs.phase_mamba_kernels(torch.device("cuda"))\n'}


def phase_of(path: str) -> str:
    """The chip_smoke.py phase that holds the kernels of ``path``."""
    return "11" if path == SSM else "7"


def run(where: str, phases=("7", "11")) -> list:
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


def main() -> int:
    for name, (edits, _) in MUTANTS.items():    # every edit applies once
        for path, old, _ in edits:
            with open(os.path.join(ROOT, path)) as f:
                assert f.read().count(old) == 1, (name, old)
    print("== the tree as it is", flush=True)
    failed = {"tree": run(ROOT)}
    ok = not failed["tree"]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (edits, must_fail)) in enumerate(MUTANTS.items()):
            print(f"\n== mutant: {name}", flush=True)
            copy = os.path.join(tmp, f"m{i}")
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
                ".git", "build", "chiprun_out"))
            for path, old, new in edits:
                p = os.path.join(copy, path)
                with open(p) as f:
                    src = f.read()
                assert src.count(old) == 1, (name, old)
                with open(p, "w") as f:
                    f.write(src.replace(old, new))
            failed[name] = run(copy, sorted({phase_of(p)
                                             for p, _, _ in edits}))
            caught = any(c.startswith(must_fail) for c in failed[name])
            print(f"  {'caught' if caught else 'MISSED'}: {must_fail}")
            ok = ok and caught
    print(json.dumps({"ok": ok, "failed": failed}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
