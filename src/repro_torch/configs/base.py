"""Config schema, mirroring ``repro.configs.base``: the transformer
``ModelConfig`` and the FSL protocol config (the paper's knobs).

Only the fields this port reads are here.  ``ModelConfig`` carries the
dense and Mamba-1 (``ssm``) families' fields; MoE, hybrid and modality
fields come with the slices that port those families.  ``remat`` is left
out: activation checkpointing (``torch.utils.checkpoint``) does not
compose with the ``torch.func.grad`` of the client phase, so the port runs
without it.  ``unroll`` and ``dryrun_unroll`` (JAX scan knobs),
``grad_clip`` (read only by FSL_OC) and ``model_codec`` (the model-sync
wire) come with the parts of the port that use them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

FAMILIES = ("dense", "ssm")


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
    encoder_only: bool = False
    swa_window: int = 0             # 0 = full attention; >0 = sliding window

    # SSM (mamba1: falcon-mamba)
    ssm_variant: str = ""           # "" | "mamba1"
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 -> ceil(d_model/16)
    ssm_chunk: int = 128            # chunked-scan chunk length

    # split-learning structure
    cut_layer: int = 0              # 0 -> default max(1, num_layers // 8)
    aux_kind: str = "lowrank"       # lowrank | mlp
    aux_rank: int = 128

    # numerics
    dtype: str = "float32"          # activation / param dtype
    use_pallas: bool = False        # route hot spots through the kernels

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet (have {FAMILIES})")

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

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256 (the reference's
        ``reduced`` on the dense and ssm families)."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        if self.num_kv_heads < self.num_heads:   # keep GQA nontrivial
            kv = max(1, heads // 2)
        kw = dict(
            num_layers=2, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=0, d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512), cut_layer=1,
            aux_rank=min(self.aux_rank, 32), ssm_chunk=16)
        if self.ssm_variant:
            kw["ssm_state"] = min(self.ssm_state, 16)
        return self.with_(**kw)


@dataclass(frozen=True)
class FSLConfig:
    num_clients: int = 4
    h: int = 1                  # smashed-data upload period (batches)
    agg_every: int = 0          # C, in batches; 0 -> once per round (C=h)
    method: str = "cse_fsl"
    server_update: str = "sequential"   # sequential (faithful) | batched
    codec: str = "none"         # uplink wire codec: none|int8|fp8
    lr: float = 0.05
    lr_decay_every: int = 10    # rounds (paper: decay every 10 rounds)
    lr_decay: float = 0.99
    optimizer: str = "sgd"      # sgd | momentum | adam

    @property
    def resolved_agg_every(self) -> int:
        return self.agg_every if self.agg_every else self.h
