"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution [arXiv:2409.12191]
(``repro.configs.qwen2_vl_72b``).

The vision frontend is a stub: the inputs carry precomputed patch
embeddings (``image_embeds``) that replace the first ``num_image_tokens``
positions' token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29_568, vocab_size=152_064,
    qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24),        # t/h/w sections of head_dim/2 = 64
    num_image_tokens=256,
    cut_layer=10, aux_rank=256, dtype="bfloat16", remat=True,
    swa_window=4096,
    citation="arXiv:2409.12191",
)
