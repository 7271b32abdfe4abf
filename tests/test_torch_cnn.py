"""The port's split CNN and optimizers against the JAX package's.

The reference's initial params cross over through ``repro_torch.convert``;
losses and gradients of the three stages must then agree at fp32
rtol 1e-5 / atol 1e-6 (the two frameworks sum convolutions in different
orders, nothing more).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.models import cnn as jcnn
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.common import count_params, tree_leaves, tree_map
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.bundle import cnn_bundle
from repro_torch.models import cnn
from repro_torch.optim import make_optimizer, paper_lr_schedule

RTOL, ATOL = 1e-5, 1e-6

TABLE_COUNTS = {  # paper Tables III/IV: client, aux-MLP, server params
    "cifar10_cnn": (107_328, 23_050, 960_970),
    "femnist_cnn": (18_816, 571_454, 1_187_774),
}
CONFIGS = {"cifar10": (cnn.CIFAR10, jcnn.CIFAR10),
           "femnist": (cnn.FEMNIST, jcnn.FEMNIST),
           "cifar10_conv1x1": (
               dataclasses.replace(cnn.CIFAR10, aux_kind="conv1x1"),
               dataclasses.replace(jcnn.CIFAR10, aux_kind="conv1x1"))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(port_np, ref_np):
    flat_p = jax.tree_util.tree_leaves_with_path(port_np)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref_np))
    assert len(flat_p) == len(flat_r)
    for path, a in flat_p:
        np.testing.assert_allclose(a, flat_r[path], rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("cfg", [cnn.CIFAR10, cnn.FEMNIST],
                         ids=["cifar10", "femnist"])
def test_param_counts_match_paper_tables(cfg):
    b = cnn_bundle(cfg, device="cpu")
    got = tuple(count_params(b.specs[k]) for k in ("client", "aux", "server"))
    assert got == TABLE_COUNTS[cfg.name]
    p = b.init(torch.Generator().manual_seed(0))
    assert tuple(count_params(p[k]) for k in ("client", "aux", "server")) \
        == TABLE_COUNTS[cfg.name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_losses_and_grads_match_reference(name):
    cfg, jcfg = CONFIGS[name]
    jb, b = jcnn_bundle(jcfg), cnn_bundle(cfg, device="cpu")
    jp = _np(jb.init(jax.random.PRNGKey(0)))
    p = params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4,) + cfg.in_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, size=4).astype(np.int32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    # smashed activations, NHWC like the reference
    sm = b.client_smashed(p["client"], tx)
    jsm = np.array(jax.jit(jb.client_smashed)(jp["client"], x))
    assert sm.shape == jsm.shape == (4,) + cfg.smashed_hw \
        + (cfg.conv_channels[1],)
    np.testing.assert_allclose(sm.numpy(), jsm, rtol=RTOL, atol=ATOL)

    # client (aux-head) loss and its gradients
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda pr: jb.client_loss(pr["client"], pr["aux"], x, y),
        has_aux=True))(jp)
    g, (loss, _) = torch.func.grad_and_value(
        lambda pr: b.client_loss(pr["client"], pr["aux"], tx, ty),
        has_aux=True)({"client": p["client"], "aux": p["aux"]})
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    _assert_tree_close(params_to_numpy(g),
                       {k: _np(jg[k]) for k in ("client", "aux")})

    # server loss on the reference smashed tensor, and its gradients
    jl, jg = jax.jit(jax.value_and_grad(jb.server_loss))(jp["server"], jsm,
                                                        y)
    g, loss = torch.func.grad_and_value(b.server_loss)(
        p["server"], torch.from_numpy(jsm), ty)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    _assert_tree_close(params_to_numpy({"server": g}),
                       {"server": _np(jg)})

    # end to end
    np.testing.assert_allclose(
        float(b.e2e_loss(p["client"], p["server"], tx, ty)),
        float(jax.jit(jb.e2e_loss)(jp["client"], jp["server"], x, y)),
        rtol=RTOL)


def test_port_init_scale_and_determinism():
    b = cnn_bundle(cnn.CIFAR10, device="cpu")
    p1 = b.init(torch.Generator().manual_seed(3))
    p2 = b.init(torch.Generator().manual_seed(3))
    assert all(torch.equal(u, v)
               for u, v in zip(tree_leaves(p1), tree_leaves(p2)))
    w = p1["server"]["fc0.weight"]                 # fan_in = 2304
    assert abs(float(w.std()) * 2304 ** 0.5 - 1.0) < 0.01
    assert float(p1["server"]["fc0.bias"].abs().max()) == 0.0


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        assert cnn_bundle(cnn.CIFAR10).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cnn_bundle(cnn.CIFAR10)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    jinit, jupd = jmake_optimizer(name)
    init, upd = make_optimizer(name)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jst, st = jinit(jp), init(tp)
    for step in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        lr = paper_lr_schedule(step * 10, 0.1)
        jp, jst = jupd(jax.tree_util.tree_map(jnp.asarray, g), jst, jp, lr)
        tp, st = upd(tree_map(torch.from_numpy, g), st, tp, lr)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
def test_sgd_slices_large_leaves_bitwise(monkeypatch, gdtype):
    """Leaves of SLICE_NUMEL elements or more take the SGD step in slices
    along dim 0: the same bits as the whole-leaf step and as the JAX
    package's, per client under ``vmap`` (rows that do not divide dim 0,
    a one-row leaf, a 0-d leaf) with the lr a 0-d fp32 tensor."""
    import repro_torch.optim as optim
    rng = np.random.default_rng(3)
    shapes = {"stack": (7, 5, 3, 2), "rows": (9, 4), "one": (1, 40),
              "small": (3,), "scalar": ()}
    params = {k: torch.from_numpy(rng.normal(size=(2,) + s).astype(
        np.float32)).to(torch.bfloat16) for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.normal(size=(2,) + s).astype(
        np.float32)).to(gdtype) for k, s in shapes.items()}
    lr = torch.tensor(0.15, dtype=torch.float32)
    _, upd = make_optimizer("sgd")
    calls = []
    whole = torch.func.vmap(lambda p, g: upd(g, (), p, lr)[0])(params, grads)
    monkeypatch.setattr(optim, "SLICE_NUMEL", 32)
    sliced_fn = optim.sliced

    def counted(fn, p, *rest):       # the rows of each slice of a leaf
        if not p.dim() or p.numel() < 32:
            return sliced_fn(fn, p, *rest)
        rows = []
        calls.append(rows)

        def rec(*xs):
            rows.append(xs[0].shape[0])
            return fn(*xs)
        return sliced_fn(rec, p, *rest)

    monkeypatch.setattr(optim, "sliced", counted)
    sliced = torch.func.vmap(lambda p, g: upd(g, (), p, lr)[0])(params,
                                                                  grads)
    # 16 elements a slice: stack 30 a row -> 7 slices of 1 row; rows 4 a
    # row -> slices of 4, 4 and 1 rows; one -> 1 slice of 1 row
    assert calls == [[1] * 7, [4, 4, 1], [1]]
    _, jupd = jmake_optimizer("sgd")
    for k in shapes:
        assert torch.equal(sliced[k], whole[k]), k
        jp = jnp.asarray(params[k].float().numpy()).astype(jnp.bfloat16)
        jg = jnp.asarray(grads[k].float().numpy()).astype(
            jnp.bfloat16 if gdtype == torch.bfloat16 else jnp.float32)
        want = jupd(jg, (), jp, jnp.float32(0.15))[0]
        np.testing.assert_array_equal(
            sliced[k].float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_sgd_out_takes_the_sliced_leaves_in_place(monkeypatch):
    """``update(..., out=params)``: the leaves the step slices are written
    into ``out`` (the same tensor returned), the others come back new, and
    every leaf has the bits of the update without ``out``, per client
    under ``vmap``."""
    import repro_torch.optim as optim
    rng = np.random.default_rng(5)
    shapes = {"stack": (7, 5, 3, 2), "rows": (9, 4), "small": (3,)}
    params = {k: torch.from_numpy(rng.normal(size=(2,) + s).astype(
        np.float32)).to(torch.bfloat16) for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.normal(size=(2,) + s).astype(
        np.float32)) for k, s in shapes.items()}
    lr = torch.tensor(0.15, dtype=torch.float32)
    _, upd = make_optimizer("sgd")
    monkeypatch.setattr(optim, "SLICE_NUMEL", 32)
    want = torch.func.vmap(lambda p, g: upd(g, (), p, lr)[0])(params, grads)
    own = {k: v.clone() for k, v in params.items()}
    ptrs = {k: v.data_ptr() for k, v in own.items()}
    got = torch.func.vmap(lambda p, g: upd(g, (), p, lr, out=p)[0])(own,
                                                                     grads)
    for k in shapes:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(own[k], want[k] if k != "small" else params[k]), k
    assert got["stack"].data_ptr() == ptrs["stack"]
    assert got["small"].data_ptr() != ptrs["small"]


def test_sgd_slices_unbatched_params_batched_grads(monkeypatch):
    """Under ``vmap`` with the params shared and the grads per client,
    the sliced step's result is per client, as the whole-leaf step's is."""
    import repro_torch.optim as optim
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.normal(size=(9, 4)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 9, 4)).astype(np.float32))
    _, upd = make_optimizer("sgd")

    def step(gg):
        return upd({"w": gg}, (), {"w": p}, 0.1)[0]["w"]
    whole = torch.func.vmap(step)(g)
    monkeypatch.setattr(optim, "SLICE_NUMEL", 32)
    got = torch.func.vmap(step)(g)
    assert got.shape == (3, 9, 4) and torch.equal(got, whole)
