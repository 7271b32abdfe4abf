"""Runnable examples of the port (``examples/`` of the JAX package):
``python -m repro_torch.examples.<name> [--device cpu]``."""
