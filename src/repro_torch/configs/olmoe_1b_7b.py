"""olmoe-1b-7b [moe]: 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50_304,
    qk_norm=True, rope_theta=1e4,
    num_experts=64, num_experts_per_tok=8,
    cut_layer=2, aux_rank=128, dtype="bfloat16", remat=True,
    swa_window=4096,
    citation="arXiv:2409.02060",
)
