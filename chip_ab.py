"""One compiled path of ``chip_smoke.py``'s phase 19 (Qwen3 CSE-FSL: 2
rounds, chunk 2, 3 timed chunks) in the tree this is run from: its
compiled and loop ms a round and peaks, as one JSON line starting "AB".

To compare two commits on one card, unpack each into a directory (say
``build/parent`` and ``build/final``, with ``git archive``) and run them
in turns, parent, change, change, parent::

    cd build/parent && python3 ../../chip_ab.py

Each tree's own ``chip_smoke.py`` (and so its own port) is imported, and
its kernels are built into that tree's ``build/``.  Needs one NVIDIA GPU.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

dev = torch.device("cuda")
card = cs.phase_device()
cs.phase_build()
r = cs.check_compiled_path("qwen3-cse_fsl", "qwen3", "cse_fsl", 2, 2, dev,
                           reps=3)
print("AB", json.dumps({"tree": os.path.basename(os.getcwd()), "card": card,
                        **{k: r[k] for k in (
                            "compiled_ms", "compiled_rounds_ms", "replay_ms",
                            "loop_ms", "loop_rounds_ms",
                            "compiled_peak_bytes", "loop_peak_bytes")}}),
      flush=True)
