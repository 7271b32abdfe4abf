"""Registry of the architectures the port runs (``repro.configs.registry``).

``get_config(name)`` returns the full-size ModelConfig;
``get_config(name).reduced()`` is the CPU smoke variant.  It holds every
architecture of the reference, in the reference's order; asking for any
other name raises a ``KeyError`` that lists them.
"""
from __future__ import annotations

from repro_torch.configs import falcon_mamba_7b, glm4_9b, hubert_xlarge, \
    olmoe_1b_7b, phi35_moe, qwen2_1_5b, qwen2_72b, qwen2_vl_72b, \
    qwen3_0_6b, zamba2_7b

ARCHS = {
    "zamba2-7b": zamba2_7b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "qwen2-72b": qwen2_72b.CONFIG,
    "qwen2-vl-72b": qwen2_vl_72b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"{name!r} is not an architecture of the port, "
                       f"which has {arch_names()}")
    return ARCHS[name]


def arch_names():
    return list(ARCHS)
