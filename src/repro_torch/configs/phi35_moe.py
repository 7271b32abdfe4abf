"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32_064,
    rope_theta=1e4,
    num_experts=16, num_experts_per_tok=2,
    cut_layer=4, aux_rank=128, dtype="bfloat16", remat=True,
    swa_window=4096,
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)
