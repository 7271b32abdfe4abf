"""Registry of the architectures the port runs (``repro.configs.registry``).

``get_config(name)`` returns the full-size ModelConfig;
``get_config(name).reduced()`` is the CPU smoke variant.  The other
families join as their slices are ported.
"""
from __future__ import annotations

from repro_torch.configs import falcon_mamba_7b, qwen3_0_6b

ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
}


def get_config(name: str):
    return ARCHS[name]


def arch_names():
    return list(ARCHS)
