"""qwen2-1.5b [dense]: GQA kv=2, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151_936,
    qkv_bias=True, rope_theta=1e6,
    cut_layer=4, aux_rank=128, dtype="bfloat16", remat=True,
    swa_window=4096,
    citation="arXiv:2407.10671",
)
