"""The port's Mamba-1 split model against the JAX package's, on reduced
falcon-mamba-7b (2 layers, cut 1, d=256, d_inner=512, N=16, dt_rank=16,
conv 4, chunk 16, V=512).

The reference's initial params cross over through ``repro_torch.convert``
and both sides see the same numpy tokens.  Tolerances:
- fp32 stages and losses at rtol 1e-5 / atol 1e-5: the two frameworks sum
  products in other orders, nothing more;
- fp32 gradients at rtol 1e-4 / atol 1e-5 (the backward adds reordered
  sums), with the kernels' ops (``use_pallas=True``: the JAX side's K5 in
  Pallas interpret mode, the port's Functions with their plain versions)
  and without;
- bf16 at atol 0.1 on the stage outputs (a few bf16 ulps of values of
  order 10) and rtol 1e-2 on the losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.models import blocks as jblocks
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.models.blocks import Ctx as JCtx
from repro_torch.common import count_params, tree_leaves
from repro_torch.configs.registry import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core.bundle import transformer_bundle
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.models import model
from repro_torch.models.blocks import Ctx

B, S = 2, 64
NAME = "falcon-mamba-7b"


def _cfgs(dtype="float32", use_pallas=False):
    kw = dict(dtype=dtype, use_pallas=use_pallas)
    return (get_config(NAME).reduced().with_(**kw),
            jget_config(NAME).reduced().with_(**kw))


def _setup(dtype="float32", use_pallas=False):
    cfg, jcfg = _cfgs(dtype, use_pallas)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, p, jp, toks, labels


def _f32(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def test_config_and_full_width_param_counts():
    """Full-width falcon-mamba-7b: the reference's fields, and the counts of
    its ``abstract_params`` (client 1,108,836,352; aux 8,851,456; server at
    full depth 6,163,828,736), from shapes only."""
    cfg, jcfg = get_config(NAME), jget_config(NAME)
    for f in ("num_layers", "d_model", "num_heads", "vocab_size",
              "ssm_variant", "ssm_state", "ssm_conv", "ssm_expand",
              "ssm_dt_rank", "ssm_chunk", "cut_layer", "aux_rank", "dtype"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.d_inner, cfg.resolved_dt_rank) == (8192, 256)
    red, jred = cfg.reduced(), jcfg.reduced()
    assert (red.num_heads, red.ssm_chunk, red.ssm_state, red.d_inner) \
        == (jred.num_heads, jred.ssm_chunk, jred.ssm_state, jred.d_inner) \
        == (0, 16, 16, 512)
    specs = transformer_bundle(cfg, device="cpu").specs
    got = tuple(count_params(specs[k]) for k in ("client", "aux", "server"))
    assert got == (1_108_836_352, 8_851_456, 6_163_828_736)
    blk = specs["client"]["blocks_stage"]["blocks"]
    assert blk["a_log"].dtype == blk["d_skip"].dtype == torch.float32
    assert blk["in_proj"].dtype == torch.bfloat16
    assert all(t.device.type == "meta" for t in tree_leaves(specs))
    assert count_params(transformer_bundle(
        cfg.with_(num_layers=16), device="cpu").specs["server"]) \
        == 1_108_840_448


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    got = L.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b)))
    want = JL.causal_conv1d(*(jnp.asarray(a) for a in (x, w, b)))
    assert got.shape == (2, 19, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # causal: output t sees inputs <= t only
    x2 = x.copy()
    x2[:, 10:] += 1.0
    got2 = L.causal_conv1d(*(torch.from_numpy(a) for a in (x2, w, b)))
    np.testing.assert_array_equal(got2[:, :10].numpy(), got[:, :10].numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_block_matches_reference(use_pallas):
    cfg, jcfg, p, jp, _, _ = _setup("float32", use_pallas)
    bp = jax.tree_util.tree_map(
        lambda a: a[0], jp["client"]["blocks_stage"]["blocks"])
    tbp = params_from_numpy({"b": bp}, "cpu")["b"]
    x = np.random.default_rng(2).standard_normal((B, S, 256)).astype(
        np.float32)
    got, _, _ = blocks.mamba1_apply(cfg, tbp, torch.from_numpy(x),
                                    Ctx(cfg, "train"), None)
    want, _, _ = jblocks.mamba1_apply(jcfg, bp, jnp.asarray(x),
                                      JCtx(jcfg, "train"), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(NotImplementedError):
        blocks.mamba1_apply(cfg, tbp, torch.from_numpy(x),
                            Ctx(cfg, "prefill"), None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_stages_and_losses_match_reference(dtype, use_pallas):
    cfg, jcfg, p, jp, toks, labels = _setup(dtype, use_pallas)
    ctx, jctx = Ctx(cfg, "train"), JCtx(jcfg, "train")
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
    assert sm.dtype == getattr(torch, dtype) and x.shape == (B, S, 256)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=0, atol=0.1)
    np.testing.assert_allclose(_f32(sm), _f32(jsm), **tol)
    np.testing.assert_allclose(_f32(x), _f32(jx), **tol)
    ltol = dict(rtol=1e-5) if dtype == "float32" else dict(rtol=1e-2)
    for got, want in ((cl, jcl), (sl, jsl)):
        np.testing.assert_allclose(float(got), float(want), **ltol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_grads_match_reference(use_pallas):
    cfg, jcfg, p, jp, toks, labels = _setup("float32", use_pallas)
    b = transformer_bundle(cfg, device="cpu")
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
    """Reference state (bf16 model with fp32 ``a_log``/``d_skip``, stacked
    clients, momentum) -> port -> reference, bit for bit, leaf for leaf."""
    from repro.core.trainer import Trainer as JTrainer
    _, jcfg = _cfgs("bfloat16")
    jtr = JTrainer(jtransformer_bundle(jcfg),
                   JFSLConfig(num_clients=2, h=1, optimizer="momentum"),
                   donate=False)
    want = jax.tree_util.tree_map(np.asarray, jtr.init(0))
    state = state_from_numpy(want, device="cpu")
    blk = state["clients"]["params"]["client"]["blocks_stage"]["blocks"]
    assert blk["in_proj"].dtype == torch.bfloat16 \
        and blk["in_proj"].shape == (2, 1, 256, 1024)
    assert blk["a_log"].dtype == torch.float32 \
        and blk["a_log"].shape == (2, 1, 512, 16)
    assert state["server"]["opt"]["m"]["blocks_stage"]["blocks"][
        "d_skip"].dtype == torch.float32
    got = state_to_numpy(state)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, w) in zip(flat_g, flat_w):
        a, w = np.asarray(a), np.asarray(w)
        assert a.dtype == w.dtype and a.shape == w.shape, path
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))


def test_port_init_matches_reference_tree():
    """The port's own init draws the reference's tree: same leaves, shapes
    and dtypes, with its constant leaves equal (ln, conv_b, dt_b, d_skip;
    a_log = log(1..N) within one fp32 ulp: the two frameworks' log)."""
    cfg, jcfg = _cfgs("bfloat16")
    p = model.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jax.tree_util.tree_map(np.asarray,
                                jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    got = params_to_numpy(p)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(jp)
    assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
    for (path, a), (_, w) in zip(flat_g, flat_w):
        assert a.dtype == w.dtype and a.shape == w.shape, path
        leaf = jax.tree_util.keystr(path).split("'")[-2]
        if leaf in ("ln", "conv_b", "dt_b", "d_skip"):
            np.testing.assert_array_equal(a, w)
        elif leaf == "a_log":
            np.testing.assert_allclose(a, w, rtol=2 ** -23, atol=0)
