"""Serving the MoE family on the CPU: reduced olmoe-1b-7b and phi3.5-moe
(2 layers, d 256, 4 experts top 2) against the JAX package's ``prefill``
and ``decode_step``, and the port's own decode against its
``full_forward``; ``serve.main``'s tokens against greedy ``full_forward``
for reduced qwen3-0.6b and olmoe; the serving specs at full width.

The reference's initial params cross over through ``repro_torch.convert``
and both sides see the same numpy tokens: prefill B 2 x 16 and 8 decode
steps, window 0 with the caches padded past the prompt, and window 8
(the ring wraps).  A decode step groups only its B tokens (capacity 4,
nothing dropped); prefill groups the B*S prompt tokens as the reference
does, so both packages drop the same choices.  fp32 at rtol 1e-4 / atol
1e-5, as ``tests/test_torch_serve.py``.

Against ``full_forward`` the decode matches only where ``full_forward``
drops nothing: it groups the whole sequence at the config's capacity
factor.  Those checks set ``moe_capacity_factor = E / k`` (2.0 here), so
the capacity is the group and no choice drops; at the config's own 1.25
an expert of ``full_forward``'s one 48-token group holds 30 choices.
"""
import contextlib
import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro_torch.common import tree_leaves
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.convert import (caches_to_numpy, params_from_numpy)
from repro_torch.launch import serve, specs
from repro_torch.models import layers
from repro_torch.models import model
from repro_torch.models.blocks import Ctx

ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
B, PROMPT, GEN = 2, 16, 8
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tokens(vocab, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(
        np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _same_caches(got, want):
    mine = jax.tree_util.tree_leaves_with_path(caches_to_numpy(got))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in mine] == [p for p, _ in flat]
    for (path, a), (_, w) in zip(mine, flat):
        assert a.shape == w.shape and a.dtype == w.dtype, path
        np.testing.assert_allclose(_f32(a), _f32(w),
                                   err_msg=jax.tree_util.keystr(path), **TOL)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name, window):
    cfg = get_config(name).reduced().with_(dtype="float32")
    jcfg = jget_config(name).reduced().with_(dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = _tokens(cfg.vocab_size, PROMPT + GEN)
    cache_len = 0 if window else PROMPT + GEN
    jl, jc = jax.jit(partial(jmodel.prefill, jcfg, window=window,
                             cache_len=cache_len))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    logits, caches = model.prefill(
        cfg, p, {"tokens": torch.from_numpy(toks[:, :PROMPT].copy())},
        window=window, cache_len=cache_len)
    np.testing.assert_allclose(_f32(logits), _f32(jl), **TOL)
    _same_caches(caches, jc)
    jdecode = jax.jit(partial(jmodel.decode_step, jcfg, window=window))
    for i in range(GEN):
        pos = PROMPT + i
        jl, jc = jdecode(jp, jnp.asarray(toks[:, pos]),
                         jnp.asarray(pos, jnp.int32), jc)
        logits, caches = model.decode_step(
            cfg, p, torch.from_numpy(toks[:, pos].copy()), pos, caches,
            window=window)
        np.testing.assert_allclose(_f32(logits), _f32(jl),
                                   err_msg=f"step {i}", **TOL)
    _same_caches(caches, jc)
    assert caches["server"]["blocks"]["k"].shape[2] == (window or
                                                        PROMPT + GEN)


def _no_drops(cfg):
    return cfg.with_(moe_capacity_factor=cfg.num_experts
                     / cfg.num_experts_per_tok)


def _greedy_full_forward(cfg, params, prompt, gen):
    """``gen`` greedy tokens of ``full_forward`` on the growing sequence."""
    seq, out = prompt, []
    with torch.no_grad():
        for _ in range(gen):
            x = model.full_forward(cfg, params, {"tokens": seq},
                                   Ctx(cfg, "train"))
            tok = model.server_logits_fn(cfg, params["server"])(
                x[:, -1:])[:, 0].argmax(-1).to(torch.int32)
            out.append(tok)
            seq = torch.cat([seq, tok[:, None]], 1)
    return torch.stack(out, 1)


def test_decode_matches_full_forward_without_drops():
    """Reduced olmoe, fp32, the capacity factor E / k: the last of 8
    decode steps' logits against ``full_forward`` on the 24 tokens; at the
    config's own factor ``full_forward``'s grouping drops choices."""
    base = get_config("olmoe-1b-7b").reduced().with_(dtype="float32")
    cfg = _no_drops(base)
    params = serve.draw_params(cfg, 2, "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, PROMPT + GEN))
    _, caches = model.prefill(cfg, params, {"tokens": toks[:, :PROMPT]},
                              cache_len=PROMPT + GEN)
    for i in range(GEN):
        logits_d, caches = model.decode_step(cfg, params,
                                             toks[:, PROMPT + i],
                                             PROMPT + i, caches)
    with torch.no_grad():
        x = model.full_forward(cfg, params, {"tokens": toks[:, :PROMPT + GEN]},
                               Ctx(cfg, "train"))
        logits_f = model.server_logits_fn(cfg, params["server"])(
            x[:, -1:])[:, 0]
    # the logits at position PROMPT + GEN - 1 on both sides
    np.testing.assert_allclose(_f32(logits_d), _f32(logits_f), **TOL)
    # the config's own factor leaves full_forward's one group of 48
    # tokens a capacity of 30 an expert, under the 96 choices' worst case
    t = B * (PROMPT + GEN)
    assert layers.moe_groups(t, min(base.moe_group_size, t),
                             base.num_experts, base.num_experts_per_tok,
                             base.moe_capacity_factor) == (1, 48, 30)
    assert layers.moe_groups(t, min(cfg.moe_group_size, t),
                             cfg.num_experts, cfg.num_experts_per_tok,
                             cfg.moe_capacity_factor) == (1, 48, 48)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_serve_main_tokens_are_greedy_full_forward(arch, monkeypatch):
    """``serve.main`` on the CPU at prompt 8 and gen 4 (fp32; olmoe with
    drops disabled): its tokens are the greedy tokens of ``full_forward``
    on the growing sequence from the parameters ``draw_params`` draws and
    the prompt ``main`` draws."""
    cfg = get_config(arch).reduced().with_(dtype="float32")
    if cfg.family == "moe":
        cfg = _no_drops(cfg)

    class Reduced:
        def reduced(self):
            return cfg

    monkeypatch.setattr(serve, "get_config", lambda name: Reduced())
    with contextlib.redirect_stdout(io.StringIO()):
        got = serve.main(["--arch", arch, "--device", "cpu", "--batch",
                          str(B), "--prompt-len", "8", "--gen", "4",
                          "--num-batches", "1"])
    params = serve.draw_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 8),
                                           dtype=np.int32))
    want = _greedy_full_forward(cfg, params, prompt, 4)
    assert got.shape == (B, 4) and torch.equal(got, want)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_reference(name, shape):
    """``prefill_specs``, ``decode_specs`` (meta tensors) and
    ``combo_supported`` at full width: shapes, dtypes and the window
    equal to the reference's (``long_500k``: the 4,096-slot ring)."""
    cfg, jcfg = get_config(name), jget_config(name)
    sc, jsc = SHAPES[shape], JSHAPES[shape]
    assert specs.combo_supported(cfg, sc) == jspecs.combo_supported(jcfg,
                                                                    jsc)
    sig = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in tree_leaves(specs.prefill_specs(cfg, sc))]
    jsig = [(tuple(a.shape), str(jnp.dtype(a.dtype)))
            for a in jax.tree_util.tree_leaves(jspecs.prefill_specs(jcfg,
                                                                   jsc))]
    assert sig == jsig
    token, pos, caches, window = specs.decode_specs(cfg, sc)
    jtoken, jpos, jcaches, jwindow = jspecs.decode_specs(jcfg, jsc)
    assert window == jwindow == (4096 if shape == "long_500k" else 0)
    sig = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in tree_leaves((token, pos, caches))]
    jsig = [(tuple(a.shape), str(jnp.dtype(a.dtype)))
            for a in jax.tree_util.tree_leaves((jtoken, jpos, jcaches))]
    assert sig == jsig
