"""The port's dense split transformer against the JAX package's, on reduced
Qwen3-0.6B (2 layers, d=256, 4 heads over 2 kv heads, hd=64, V=512).

The reference's initial params cross over through ``repro_torch.convert``
and both sides see the same numpy tokens.  Tolerances:
- fp32 stages and losses at rtol 1e-5 / atol 1e-5: the two frameworks sum
  products in different orders, nothing more;
- fp32 gradients at rtol 1e-4 / atol 1e-5 (the backward adds more
  reordered sums), with the kernels' ops (``use_pallas=True``: the JAX
  side in Pallas interpret mode, the port's Functions with their plain
  versions) and without;
- bf16 at atol 0.1 on the stage outputs (a few bf16 ulps of values of
  order 10: the frameworks round bf16 at different points) and rtol 1e-2
  on the losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.data import synthetic_lm as jsynthetic_lm
from repro.launch.train import LMBatcher as JLMBatcher
from repro.launch.train import build_data as jbuild_data
from repro.models import model as jmodel
from repro.models.blocks import Ctx as JCtx
from repro_torch.common import count_params, tree_leaves
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core.bundle import transformer_bundle
from repro_torch.data import synthetic_lm
from repro_torch.launch.train import LMBatcher, build_data
from repro_torch.models import model
from repro_torch.models.blocks import Ctx

B, S = 2, 128


def _cfgs(dtype="float32", use_pallas=False, window=64):
    kw = dict(dtype=dtype, use_pallas=use_pallas, swa_window=window)
    return (get_config("qwen3-0.6b").reduced().with_(**kw),
            jget_config("qwen3-0.6b").reduced().with_(**kw))


def _setup(dtype="float32", use_pallas=False, window=64):
    cfg, jcfg = _cfgs(dtype, use_pallas, window)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, p, jp, toks, labels


def _f32(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def test_full_width_param_counts():
    """Full-width Qwen3-0.6B: the counts of the reference's
    ``abstract_params`` (client 218,506,240; aux 19,579,904; server
    533,126,144), from shapes only."""
    specs = transformer_bundle(get_config("qwen3-0.6b"), device="cpu").specs
    got = tuple(count_params(specs[k]) for k in ("client", "aux", "server"))
    assert got == (218_506_240, 19_579_904, 533_126_144)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in tree_leaves(specs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stages_and_losses_match_reference(dtype):
    cfg, jcfg, p, jp, toks, labels = _setup(dtype)
    ctx, jctx = Ctx(cfg, "train", window=64), JCtx(jcfg, "train", window=64)
    inputs, jinputs = {"tokens": torch.from_numpy(toks)}, \
        {"tokens": jnp.asarray(toks)}
    sm, _, _ = model.client_forward(cfg, p["client"], inputs, ctx)
    jsm, _, _ = jmodel.client_forward(jcfg, jp["client"], jinputs, jctx)
    x, _, _ = model.server_forward(cfg, p["server"], sm, ctx)
    jx, _, _ = jmodel.server_forward(jcfg, jp["server"], jsm, jctx)
    cl, _ = model.client_loss(cfg, p["client"], p["aux"], inputs,
                              torch.from_numpy(labels), ctx)
    jcl, _ = jmodel.client_loss(jcfg, jp["client"], jp["aux"], jinputs,
                                jnp.asarray(labels), jctx)
    sl = model.server_loss(cfg, p["server"], sm, torch.from_numpy(labels),
                           ctx)
    jsl = jmodel.server_loss(jcfg, jp["server"], jsm, jnp.asarray(labels),
                             jctx)
    from repro.core.bundle import transformer_bundle as jtransformer_bundle
    e2e = transformer_bundle(cfg, device="cpu").e2e_loss(
        p["client"], p["server"], inputs, torch.from_numpy(labels))
    je2e = jtransformer_bundle(jcfg).e2e_loss(jp["client"], jp["server"],
                                              jinputs, jnp.asarray(labels))
    al = model.aux_logits_fn(cfg, p["aux"])(sm)
    jal = jmodel.aux_logits_fn(jcfg, jp["aux"])(jsm)
    assert sm.dtype == getattr(torch, dtype) and x.shape == (B, S, 256)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=0, atol=0.1)
    np.testing.assert_allclose(_f32(sm), _f32(jsm), **tol)
    np.testing.assert_allclose(_f32(x), _f32(jx), **tol)
    np.testing.assert_allclose(_f32(al), _f32(jal), **tol)
    ltol = dict(rtol=1e-5) if dtype == "float32" else dict(rtol=1e-2)
    for got, want in ((cl, jcl), (sl, jsl), (e2e, je2e)):
        np.testing.assert_allclose(float(got), float(want), **ltol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_grads_match_reference(use_pallas):
    cfg, jcfg, p, jp, toks, labels = _setup("float32", use_pallas)
    b = transformer_bundle(cfg, device="cpu")
    from repro.core.bundle import transformer_bundle as jtransformer_bundle
    jb = jtransformer_bundle(jcfg)
    inputs, y = {"tokens": torch.from_numpy(toks)}, torch.from_numpy(labels)
    jinputs, jy = {"tokens": jnp.asarray(toks)}, jnp.asarray(labels)

    g, (loss, sm) = torch.func.grad_and_value(
        lambda pr: b.client_loss(pr["client"], pr["aux"], inputs, y),
        has_aux=True)({"client": p["client"], "aux": p["aux"]})
    (jloss, jsm), jg = jax.value_and_grad(
        lambda pr: jb.client_loss(pr["client"], pr["aux"], jinputs, jy),
        has_aux=True)({"client": jp["client"], "aux": jp["aux"]})
    sg, sloss = torch.func.grad_and_value(b.server_loss)(p["server"], sm, y)
    jsloss, jsg = jax.value_and_grad(jb.server_loss)(jp["server"], jsm, jy)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(sloss), float(jsloss), rtol=1e-5)
    got = params_to_numpy({**g, "server": sg})
    want = jax.tree_util.tree_map(np.asarray, {**jg, "server": jsg})
    pairs = zip(jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves_with_path(want))
    for (path, a), (wpath, w) in pairs:
        assert path == wpath
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_converter_round_trip_is_bitwise():
    """Reference state (bf16 params, stacked clients) -> port -> reference,
    bit for bit; the port's tree mirrors the reference's."""
    from repro.core.bundle import transformer_bundle as jtransformer_bundle
    from repro.core.trainer import Trainer as JTrainer
    _, jcfg = _cfgs("bfloat16")
    jtr = JTrainer(jtransformer_bundle(jcfg),
                   JFSLConfig(num_clients=2, h=1, optimizer="momentum"),
                   donate=False)
    want = jax.tree_util.tree_map(np.asarray, jtr.init(0))
    state = state_from_numpy(want, device="cpu")
    assert state["clients"]["params"]["client"]["embed"].dtype \
        == torch.bfloat16
    assert state["clients"]["params"]["client"]["blocks_stage"]["blocks"][
        "attn"]["wq"].shape == (2, 1, 256, 256)
    got = state_to_numpy(state)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, w) in zip(flat_g, flat_w):
        a, w = np.asarray(a), np.asarray(w)
        assert a.dtype == w.dtype and a.shape == w.shape, path
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))


def test_lm_data_and_batcher_match_reference_bitwise():
    for order in (1, 3):
        for a, b in zip(synthetic_lm(6, 33, 97, seed=3, order=order),
                        jsynthetic_lm(6, 33, 97, seed=3, order=order)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    cfg, jcfg = _cfgs()
    kw = dict(num_clients=3, h=2)
    for non_iid in (False, True):
        fed = build_data(cfg, FSLConfig(**kw), 16, 5, non_iid, seed=1)
        jfed = jbuild_data(jcfg, JFSLConfig(**kw), 16, 5, non_iid, seed=1)
        for a, b in zip(fed.inputs + fed.labels, jfed.inputs + jfed.labels):
            np.testing.assert_array_equal(a, b)
        bat, jbat = LMBatcher(cfg, fed, 2, 2), JLMBatcher(jcfg, jfed, 2, 2)
        for _ in range(4):
            (x, y), (jx, jy) = bat.next_round(), jbat.next_round()
            assert x["tokens"].dtype == np.int32 and y.shape == (3, 2, 2, 16)
            np.testing.assert_array_equal(x["tokens"], np.asarray(jx["tokens"]))
            np.testing.assert_array_equal(y, np.asarray(jy))
