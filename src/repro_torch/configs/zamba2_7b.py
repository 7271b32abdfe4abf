"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 backbone layers; one *shared* full attention block applied after every
`attn_every`=6 Mamba2 layers (weights shared across sites, Zamba-style).
The cut layer is a multiple of attn_every.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14_336, vocab_size=32_000,
    rope_theta=1e4,
    ssm_variant="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_headdim=64, attn_every=6,
    cut_layer=12, aux_rank=128, dtype="bfloat16", remat=True,
    swa_window=4096,   # shared attn uses SWA for the long_500k shape
    citation="arXiv:2411.15242",
)
