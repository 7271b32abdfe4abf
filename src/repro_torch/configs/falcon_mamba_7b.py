"""falcon-mamba-7b [ssm]: mamba1, attention-free [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65_024,
    ssm_variant="mamba1", ssm_state=16, ssm_conv=4, ssm_expand=2,
    cut_layer=8, aux_rank=128, dtype="bfloat16", remat=True,
    citation="arXiv:2410.05355",
)
