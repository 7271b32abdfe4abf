"""Every width a repo config gives the kernels is one they take: for each
config of the JAX package's registry and its ``reduced()``, the port's
sliding-window attention has a kernel for the head width wherever the
reference routes attention through its kernel, the selective scan takes the
state count, and the fused cross-entropy plans take the server head's
``d_model`` and the aux head's ``aux_rank`` in both dtypes.  These are the
CUDA wrappers' own checks, which the CPU path never reaches."""
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro_torch.kernels import fused_ce, ssm_scan, swa_attention

CONFIGS = [(name, red) for name in sorted(JARCHS) for red in (False, True)]


def _cfg(name, red):
    cfg = JARCHS[name]
    return cfg.reduced() if red else cfg


@pytest.mark.parametrize("name,red", CONFIGS)
def test_kernel_widths_cover_every_config(name, red):
    cfg = _cfg(name, red)
    # the reference's K6 route: models/blocks.py (a window, not an encoder)
    if cfg.swa_window and not cfg.encoder_only:
        hd = cfg.resolved_head_dim
        for dtype in (torch.bfloat16, torch.float32):
            assert swa_attention.kernel_for(dtype, hd) in \
                swa_attention.LAUNCHES
        assert hd in swa_attention.HEAD_DIMS, (name, hd)
    if cfg.ssm_state:
        assert ssm_scan.check_states(cfg.ssm_state) >= 1
    for g, t, d in ((1, 4096, cfg.d_model), (4, 4096, cfg.aux_rank)):
        for bf16 in (True, False):
            plan = fused_ce.launch_plan(g, t, d, cfg.vocab_size, bf16=bf16)
            assert plan["dp"] >= d and plan["dp"] - d < 8
        assert fused_ce.bwd_plan(g, t, d, cfg.vocab_size)["dp"] % 8 == 0
