"""qwen3-0.6b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=3072, vocab_size=151_936,
    qk_norm=True, rope_theta=1e6,
    cut_layer=4, aux_rank=128, dtype="bfloat16",
    swa_window=4096,
    citation="hf:Qwen/Qwen3-8B",
)
