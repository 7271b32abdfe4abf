"""hubert-xlarge [audio]: encoder-only, w2v2-style [arXiv:2106.07447]
(``repro.configs.hubert_xlarge``).

The conv feature extractor is a stub: the inputs carry ``(B, T,
frontend_dim)`` frame features.  Objective: masked-frame cluster
prediction over 504 classes.  There is no decode step (encoder-only).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, encoder_only=True, frontend_dim=512,
    cut_layer=6, aux_rank=64, dtype="bfloat16", remat=True,
    citation="arXiv:2106.07447",
)
