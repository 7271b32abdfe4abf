"""qwen2-72b [dense]: GQA kv=8, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29_568, vocab_size=152_064,
    qkv_bias=True, rope_theta=1e6,
    cut_layer=10, aux_rank=256, dtype="bfloat16", remat=True,
    swa_window=4096,
    citation="arXiv:2407.10671",
)
