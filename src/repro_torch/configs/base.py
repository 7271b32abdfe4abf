"""Config schema, mirroring ``repro.configs.base``: the transformer
``ModelConfig``, the FSL protocol config (the paper's knobs) and the
input shapes (``ShapeConfig``, ``SHAPES``) the serving specs read.

Only the fields this port reads are here.  ``ModelConfig`` carries every
family of the reference: dense, MoE, Mamba-1 (``ssm``), hybrid (Mamba-2
with a shared attention block), the VLM (M-RoPE over a stub frontend of
``num_image_tokens`` patch embeddings) and audio (an encoder-only model
over ``frontend_dim`` frame features).  ``remat`` recomputes
each layer's activations in the backward (``models.model.Remat``, a
layer-level ``torch.autograd.Function`` that composes with the client
phase's ``vmap(grad(...))``, where ``torch.utils.checkpoint`` does not); it
changes memory only.  ``unroll`` and ``dryrun_unroll`` are JAX scan hints
with no PyTorch meaning and stay out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int                  # 0 for attention-free families
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    citation: str = ""

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl M-RoPE
    causal: bool = True
    encoder_only: bool = False      # hubert: no decode step exists
    swa_window: int = 0             # 0 = full attention; >0 = sliding window

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024      # token group size for capacity dispatch

    # SSM (mamba1: falcon-mamba; mamba2: zamba2)
    ssm_variant: str = ""           # "" | "mamba1" | "mamba2"
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # mamba1; 0 -> ceil(d_model/16)
    ssm_heads: int = 0              # mamba2; 0 -> d_inner // ssm_headdim
    ssm_headdim: int = 64           # mamba2
    ssm_chunk: int = 128            # chunked-scan chunk length

    # hybrid (zamba2): one shared attention block run after every
    # `attn_every` backbone layers, its weights shared across the sites
    attn_every: int = 0

    # modality frontend stubs: precomputed frame features (audio) or patch
    # embeddings (vlm) enter ``embed_inputs``
    frontend_dim: int = 0           # hubert conv-feature dim (512)
    num_image_tokens: int = 0       # vlm: patch embeddings per sample

    # split-learning structure
    cut_layer: int = 0              # 0 -> default max(1, num_layers // 8)
    aux_kind: str = "lowrank"       # lowrank | mlp
    aux_rank: int = 128

    # numerics
    dtype: str = "float32"          # activation / param dtype
    remat: bool = False             # recompute layers in the backward
    use_pallas: bool = False        # route hot spots through the kernels

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r} (have "
                             f"{FAMILIES})")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def resolved_cut(self) -> int:
        if self.cut_layer:
            return self.cut_layer
        return max(1, self.num_layers // 8)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        if self.ssm_dt_rank:
            return self.ssm_dt_rank
        return max(1, math.ceil(self.d_model / 16))

    @property
    def resolved_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(1, self.d_inner // max(self.ssm_headdim, 1))

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts top<=2,
        no remat; a hybrid 4 layers cut at 2 with a shared site every 2; 8
        image positions, M-RoPE sections rescaled to the reduced head and a
        64-wide frame frontend (the reference's ``reduced``)."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        if self.num_kv_heads < self.num_heads:   # keep GQA nontrivial
            kv = max(1, heads // 2)
        kw = dict(
            num_layers=2, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=0, d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512), cut_layer=1,
            aux_rank=min(self.aux_rank, 32), moe_group_size=64,
            ssm_chunk=16, remat=False)
        if self.num_experts:
            kw["num_experts"] = min(self.num_experts, 4)
            kw["num_experts_per_tok"] = min(self.num_experts_per_tok, 2)
        if self.ssm_variant:
            kw["ssm_state"] = min(self.ssm_state, 16)
            kw["ssm_headdim"] = 32
            kw["ssm_heads"] = 0
        if self.attn_every:
            # a hybrid cut is a multiple of attn_every, and the server
            # stage keeps a site
            kw["attn_every"] = 2
            kw["num_layers"] = 4
            kw["cut_layer"] = 2
        if self.num_image_tokens:
            kw["num_image_tokens"] = 8
        if self.mrope_sections:
            # the sections rescaled to the reduced head_dim / 2
            half = (d // max(heads, 1)) // 2
            base = sum(self.mrope_sections)
            secs = [max(1, s * half // base) for s in self.mrope_sections]
            secs[0] += half - sum(secs)
            kw["mrope_sections"] = tuple(secs)
        if self.frontend_dim:
            kw["frontend_dim"] = 64
        return self.with_(**kw)


@dataclass(frozen=True)
class FSLConfig:
    num_clients: int = 4
    h: int = 1                  # smashed-data upload period (batches)
    agg_every: int = 0          # C, in batches; 0 -> once per round (C=h)
    method: str = "cse_fsl"     # cse_fsl | fsl_mc | fsl_oc | fsl_an
    server_update: str = "sequential"   # sequential (faithful) | batched
    codec: str = "none"         # uplink wire codec: none|int8|fp8|topk
    model_codec: str = "none"   # model-sync (FedAvg) wire codec, both ways
    grad_clip: float = 0.0      # used by FSL_OC (0 -> a limit of 1.0)
    lr: float = 0.05
    lr_decay_every: int = 10    # rounds (paper: decay every 10 rounds)
    lr_decay: float = 0.99
    optimizer: str = "sgd"      # sgd | momentum | adam

    @property
    def resolved_agg_every(self) -> int:
        return self.agg_every if self.agg_every else self.h


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_config(name: str) -> ShapeConfig:
    return SHAPES[name]
