"""PyTorch/CUDA port of the CSE-FSL system (`repro`, the JAX package, is the
reference it is tested against).

Layout mirrors ``repro``: ``configs``, ``common``, ``data``, ``models``,
``optim``, ``transport``, ``kernels``, ``core`` (bundle, accounting,
trainer, methods), plus ``convert`` for moving reference weights across.
The package imports ``torch`` and numpy only — never ``jax`` and never
``repro`` — and every entry point runs on ``device="cuda"`` unless the
caller asks for the CPU.
"""
