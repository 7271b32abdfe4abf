"""The port's fused cross-entropy op (K3 forward, K4a/K4b backward) against
the JAX package's ``repro.kernels.ops.fused_ce`` (Pallas, interpret mode).

Here on the CPU the port's autograd Functions run with the kernels' plain
versions inside, so these tests hold the op's plumbing (grouping, the
``vmap`` rule, the backward Function, ``meta`` shapes) and its arithmetic
against the reference; the CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.  Tolerances are those of
``tests/test_kernels.py``: fp32 1e-5 and bf16 2e-3 on the loss, 1e-4 /
1e-5 on fp32 grads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs.registry import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro_torch.kernels import fused_ce as K
from repro_torch.kernels import ops, ref

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(t, d, v, dtype, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (t, d)).astype(np.float32)
    w = rng.standard_normal(lead + (d, v)).astype(np.float32)
    lab = rng.integers(0, v, lead + (t,)).astype(np.int32)
    tdt, jdt = _DT[dtype]
    return ((torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
             torch.from_numpy(lab)),
            (jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
             jnp.asarray(lab)))


@pytest.mark.parametrize("t,d,v", [(8, 16, 64), (128, 64, 256),
                                   (256, 32, 512), (64, 128, 384),
                                   (16, 8, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(t, d, v, dtype):
    (x, w, lab), (jx, jw, jlab) = _inputs(t, d, v, dtype)
    got = float(ops.fused_ce(x, w, lab))
    want = float(jops.fused_ce(jx, jw, jlab))
    tol = 2e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("t,d,v", [(32, 16, 96), (128, 64, 256),
                                   (16, 8, 130)])
def test_grads_match_reference(t, d, v):
    (x, w, lab), (jx, jw, jlab) = _inputs(t, d, v, "float32", seed=1)
    gx, gw = torch.func.grad(lambda a, b: ops.fused_ce(a, b, lab),
                             argnums=(0, 1))(x, w)
    jgx, jgw = jax.grad(lambda a, b: jops.fused_ce(a, b, jlab),
                        argnums=(0, 1))(jx, jw)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-5)
    # the same grads through plain autograd (.backward) as through torch.func
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (2.0 * ops.fused_ce(xr, wr, lab)).backward()
    np.testing.assert_allclose(xr.grad.numpy(), 2 * gx.numpy(), rtol=1e-6)
    np.testing.assert_allclose(wr.grad.numpy(), 2 * gw.numpy(), rtol=1e-6)


def test_vmap_folds_clients_into_one_call(monkeypatch):
    """``vmap(grad_and_value)`` over 3 clients equals 3 separate calls, and
    reaches the grouped forward and backward once each, with G = 3."""
    (x, w, lab), _ = _inputs(37, 16, 130, "float32", seed=2, lead=(3,))
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, tuple(args[0].shape)))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(K, "fused_ce_fwd", spy("fwd", K.fused_ce_fwd))
    monkeypatch.setattr(K, "fused_ce_bwd", spy("bwd", K.fused_ce_bwd))
    (gx, gw), loss = vmap(grad_and_value(ops.fused_ce, argnums=(0, 1)))(
        x, w, lab)
    assert calls == [("fwd", (3, 37, 16)), ("bwd", (3, 37, 16))]
    for i in range(3):
        np.testing.assert_allclose(float(loss[i]),
                                   float(ref.fused_ce(x[i], w[i], lab[i])),
                                   rtol=1e-6)
        rx, rw = ref.fused_ce_grads(x[i], w[i], lab[i])
        np.testing.assert_allclose(gx[i].numpy(), rx.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(gw[i].numpy(), rw.numpy(), rtol=1e-5,
                                   atol=1e-7)
    # a weight shared by all clients (unbatched) broadcasts into the groups
    calls.clear()
    gx2, _ = vmap(grad_and_value(ops.fused_ce), in_dims=(0, None, 0))(
        x, w[0], lab)
    assert [c[0] for c in calls] == ["fwd", "bwd"]
    rx0, _ = ref.fused_ce_grads(x[1], w[0], lab[1])
    np.testing.assert_allclose(gx2[1].numpy(), rx0.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_meta_inputs_give_shapes_and_count_nothing():
    K.reset_launches()
    x = torch.empty((4096, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((128, 151936), dtype=torch.bfloat16, device="meta")
    lab = torch.empty((4096,), dtype=torch.int32, device="meta")
    (gx, gw), loss = grad_and_value(ops.fused_ce, argnums=(0, 1))(x, w, lab)
    assert loss.shape == () and loss.device.type == "meta"
    assert gx.shape == x.shape and gx.dtype == x.dtype
    assert gw.shape == w.shape and gw.dtype == w.dtype
    assert K.LAUNCHES == {"fused_ce_fwd": 0, "fused_ce_dx": 0,
                          "fused_ce_dw": 0}


def test_grouped_plain_versions_and_splits():
    """The kernels' grouped plain signatures against the 2D reference, and
    K3's vocabulary split at the main path's shapes."""
    (x, w, lab), _ = _inputs(100, 72, 1000, "float32", seed=3, lead=(2,))
    lse, picked = ref.fused_ce_fwd(x, w, lab)
    g = torch.tensor([1.0, 0.5])
    dx, dw = ref.fused_ce_bwd(x, w, lab, lse, g)
    for i in range(2):
        np.testing.assert_allclose(float((lse[i] - picked[i]).mean()),
                                   float(ref.fused_ce(x[i], w[i], lab[i])),
                                   rtol=1e-6)
        rx, rw = ref.fused_ce_grads(x[i], w[i], lab[i], float(g[i]))
        np.testing.assert_allclose(dx[i].numpy(), rx.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(dw[i].numpy(), rw.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert K.vocab_splits(1, 4096, 151936) == (9, 264)
    assert K.vocab_splits(4, 4096, 151936) == (3, 792)
    assert K.vocab_splits(1, 8, 130) == (3, 1)


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_launch_plan_takes_every_config_width(name):
    """K3/K4a/K4b's grids fit CUDA's limits at every config's server head
    (d = d_model) and aux head (d = aux_rank), S = 4096, with 1 group or
    4 folded clients; K4a/K4b split d into ceil(d / 1024) slices."""
    cfg = JARCHS[name]
    for g, d in ((1, cfg.d_model), (4, cfg.aux_rank)):
        plan = K.launch_plan(g, 4096, d, cfg.vocab_size)
        nds = -(-d // K.D_SLICE)
        assert plan["d_slices"] == nds
        assert plan["grids"]["fused_ce_dx"] == (256, g, nds)
        assert plan["grids"]["fused_ce_dw"] == (-(-cfg.vocab_size // 16), g,
                                                nds)
        ns, tps = plan["nsplit"], plan["tiles_per_split"]
        assert plan["grids"]["fused_ce_fwd"] == (64, ns, g)
        assert (ns - 1) * tps < -(-cfg.vocab_size // 64) <= ns * tps


@pytest.mark.parametrize("d", [128, 1024, 1536, 4096, 8192])
def test_any_width_d(d):
    """The grouped plain versions at every width the kernels now take
    (past the old d <= 1024), and the slices K4a/K4b split d into."""
    (x, w, lab), _ = _inputs(24, d, 80, "float32", seed=4, lead=(1,))
    x = x * d ** -0.5
    lse, picked = ref.fused_ce_fwd(x, w, lab)
    dx, dw = ref.fused_ce_bwd(x, w, lab, lse, torch.ones(1))
    rx, rw = ref.fused_ce_grads(x[0], w[0], lab[0])
    np.testing.assert_allclose(float((lse - picked).mean()),
                               float(ref.fused_ce(x[0], w[0], lab[0])),
                               rtol=1e-6)
    np.testing.assert_allclose(dx[0].numpy(), rx.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(dw[0].numpy(), rw.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert K.launch_plan(1, 24, d, 80)["d_slices"] == {
        128: 1, 1024: 1, 1536: 2, 4096: 4, 8192: 8}[d]
    with pytest.raises(ValueError):
        K.launch_plan(70000, 24, d, 80)
