"""glm4-9b [dense]: RoPE, GQA kv=2 [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13_696, vocab_size=151_552,
    qkv_bias=True, rope_theta=1e4,
    cut_layer=5, aux_rank=128, dtype="bfloat16", remat=True,
    swa_window=4096,
    citation="hf:THUDM/glm-4-9b",
)
