"""Serving the hybrid family on the CPU: zamba2-7b reduced to 7 layers (a
client group, 2 server groups and a tail of 1) against the JAX package's
``prefill`` and ``decode_step``, the per-site shared attention caches
included; the port's decode against its own ``full_forward``;
``serve.main``'s tokens against greedy ``full_forward``; the serving
specs at full width.

The reference's initial params cross over through ``repro_torch.convert``
and both sides see the same numpy tokens: prefill B 2 x 16 and 8 decode
steps, window 0 with the caches padded past the prompt, and window 8
(each site's ring wraps).  fp32 at rtol 1e-4 and an atol of 1e-5 of the
largest magnitude compared (seven fp32 layers, sums in other orders, as
``tests/test_torch_hybrid.py``).
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
from repro_torch.convert import caches_to_numpy, params_from_numpy
from repro_torch.launch import serve, specs
from repro_torch.models import model
from repro_torch.models.blocks import Ctx

NAME = "zamba2-7b"
B, PROMPT, GEN = 2, 16, 8
RTOL, ATOL = 1e-4, 1e-5


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


def _near(got, want, what=""):
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max(initial=1.0),
                               err_msg=what)


def _same_caches(got, want):
    mine = jax.tree_util.tree_leaves_with_path(caches_to_numpy(got))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in mine] == [p for p, _ in flat]
    for (path, a), (_, w) in zip(mine, flat):
        assert a.shape == w.shape and a.dtype == w.dtype, path
        _near(a, w, jax.tree_util.keystr(path))


def _cfgs():
    kw = dict(dtype="float32", num_layers=7)
    return (get_config(NAME).reduced().with_(**kw),
            jget_config(NAME).reduced().with_(**kw))


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_match_reference(window):
    """Logits and every cache leaf after the prefill and after 8 steps:
    the backbone's conv windows and SSD states ``[L, B, H, N, P]`` and
    the shared sites' rings ``[sites, B, slots, KH, hd]`` (client 1,
    server 2)."""
    cfg, jcfg = _cfgs()
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
    _near(logits, jl, "prefill logits")
    _same_caches(caches, jc)
    slots = window or PROMPT + GEN
    assert caches["client"]["shared"]["k"].shape == (1, B, slots, 4, 64)
    assert caches["server"]["shared"]["v"].shape == (2, B, slots, 4, 64)
    assert caches["server"]["blocks"]["ssm"].shape == (5, B, 16, 16, 32)
    jdecode = jax.jit(partial(jmodel.decode_step, jcfg, window=window))
    for i in range(GEN):
        pos = PROMPT + i
        jl, jc = jdecode(jp, jnp.asarray(toks[:, pos]),
                         jnp.asarray(pos, jnp.int32), jc)
        logits, caches = model.decode_step(
            cfg, p, torch.from_numpy(toks[:, pos].copy()), pos, caches,
            window=window)
        _near(logits, jl, f"step {i}")
    _same_caches(caches, jc)
    # each site keeps its own ring: the server's two sites differ
    ring = caches["server"]["shared"]["k"]
    assert not torch.equal(ring[0], ring[1])


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


def test_decode_matches_full_forward():
    """The last of 8 decode steps after a 16-token prefill against
    ``full_forward`` on the 24 tokens (one chunk: 24 is not a multiple of
    16); then a prompt of 32 (two chunks of 16) and 8 steps past it."""
    cfg, _ = _cfgs()
    params = serve.draw_params(cfg, 2, "cpu")
    for prompt in (PROMPT, 32):
        toks = torch.from_numpy(_tokens(cfg.vocab_size, prompt + GEN, 3))
        _, caches = model.prefill(cfg, params, {"tokens": toks[:, :prompt]},
                                  cache_len=prompt + GEN)
        for i in range(GEN):
            logits_d, caches = model.decode_step(cfg, params,
                                                 toks[:, prompt + i],
                                                 prompt + i, caches)
        with torch.no_grad():
            x = model.full_forward(cfg, params, {"tokens": toks},
                                   Ctx(cfg, "train"))
            logits_f = model.server_logits_fn(cfg, params["server"])(
                x[:, -1:])[:, 0]
        _near(logits_d, logits_f, f"prompt {prompt}")


def test_serve_main_tokens_are_greedy_full_forward(monkeypatch):
    """``serve.main --arch zamba2-7b`` on the CPU at prompt 8 and gen 4
    (fp32, 7 layers): its tokens are the greedy tokens of ``full_forward``
    on the growing sequence from the parameters ``draw_params`` draws and
    the prompt ``main`` draws."""
    cfg, _ = _cfgs()

    class Reduced:
        def reduced(self):
            return cfg

    monkeypatch.setattr(serve, "get_config", lambda name: Reduced())
    with contextlib.redirect_stdout(io.StringIO()):
        got = serve.main(["--arch", NAME, "--device", "cpu", "--batch",
                          str(B), "--prompt-len", "8", "--gen", "4",
                          "--num-batches", "1"])
    params = serve.draw_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 8),
                                           dtype=np.int32))
    want = _greedy_full_forward(cfg, params, prompt, 4)
    assert got.shape == (B, 4) and torch.equal(got, want)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_specs_match_reference(shape):
    """``prefill_specs``, ``decode_specs`` (meta tensors) and
    ``combo_supported`` at full width: shapes, dtypes and the window
    equal to the reference's; the hybrid with its window serves
    ``long_500k`` on a 4,096-slot ring a site."""
    cfg, jcfg = get_config(NAME), jget_config(NAME)
    sc, jsc = SHAPES[shape], JSHAPES[shape]
    assert specs.combo_supported(cfg, sc) == jspecs.combo_supported(
        jcfg, jsc) == (True, "")
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
    assert tuple(caches["server"]["shared"]["k"].shape[:3]) == (
        11, sc.global_batch, 4096 if shape == "long_500k" else sc.seq_len)


def test_server_stage_without_a_site_matches_reference():
    """3 layers: the client group and a server stage of 1 layer, shorter
    than a group (no site, an empty shared cache): prefill at window 8
    and 4 decode steps against the reference, every cache leaf."""
    kw = dict(dtype="float32", num_layers=3)
    cfg = get_config(NAME).reduced().with_(**kw)
    jcfg = jget_config(NAME).reduced().with_(**kw)
    assert [(s.groups, s.tail) for s in model.stage_plans(cfg)] == [
        (1, 0), (0, 1)]
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = _tokens(cfg.vocab_size, PROMPT + 4, seed=4)
    jl, jc = jmodel.prefill(jcfg, jp, {"tokens": jnp.asarray(
        toks[:, :PROMPT])}, window=8)
    logits, caches = model.prefill(cfg, p, {"tokens": torch.from_numpy(
        toks[:, :PROMPT].copy())}, window=8)
    _near(logits, jl, "prefill logits")
    _same_caches(caches, jc)
    assert caches["server"]["shared"]["k"].shape == (0, B, 8, 4, 64)
    for i in range(4):
        pos = PROMPT + i
        jl, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(toks[:, pos]),
                                    jnp.asarray(pos, jnp.int32), jc,
                                    window=8)
        logits, caches = model.decode_step(
            cfg, p, torch.from_numpy(toks[:, pos].copy()), pos, caches,
            window=8)
        _near(logits, jl, f"step {i}")
    _same_caches(caches, jc)
