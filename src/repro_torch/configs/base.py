"""FSL protocol config (the paper's knobs), mirroring ``repro.configs.base``.

Only the fields this port reads are here: ``unroll`` (a JAX scan knob),
``grad_clip`` (read only by FSL_OC) and ``model_codec`` (the model-sync
wire) come with the parts of the port that use them.
"""
from __future__ import annotations

from dataclasses import dataclass


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
