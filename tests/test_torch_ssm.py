"""The port's Mamba-1 selective scan (K5 forward, plain backward) against
the JAX package's: ``repro.kernels.ref.ssm_scan``, the Pallas kernel
``repro.kernels.ssm_scan.ssm_scan`` in interpret mode and the differentiable
``repro.kernels.ops.ssm_scan``, at the cases of ``tests/test_kernels.py``.

On the CPU the port's autograd Functions run the plain versions inside, so
these tests hold the op's plumbing (grouped ``a``/``d``, the ``vmap`` rule,
the backward Function, ``meta`` shapes) and its arithmetic; the CUDA kernel
is held against the same plain version on the card by ``chip_smoke.py``.
Tolerances: fp32 2e-4 and bf16 3e-2 on the output (``tests/test_kernels.py``),
rtol 1e-4 / atol 1e-5 on fp32 grads (the backward's reordered sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssm_scan as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as K
from repro_torch.models import layers as L

CASES = [(1, 16, 8, 4), (2, 64, 32, 16), (2, 128, 64, 16), (1, 32, 128, 8)]


def _inputs(b, s, d, n, seed=3, lead=()):
    """u, dt, a, b, c, d as numpy fp32, drawn as tests/test_kernels.py
    draws them (dt = 0.1 softplus(N(0,1)), a = -exp(0.3 N(0,1)))."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(lead + (b, s, d)).astype(np.float32)
    dt = (0.1 * np.logaddexp(rng.standard_normal(lead + (b, s, d)), 0)
          ).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(lead + (d, n)))).astype(np.float32)
    bm = rng.standard_normal(lead + (b, s, n)).astype(np.float32)
    cm = rng.standard_normal(lead + (b, s, n)).astype(np.float32)
    dv = rng.standard_normal(lead + (d,)).astype(np.float32)
    return u, dt, a, bm, cm, dv


def _cast(arrs, dtype):
    """u, dt, b, c in ``dtype``; a, d stay fp32 (the model's own types)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = [torch.from_numpy(x) for x in arrs]
    j = [jnp.asarray(x) for x in arrs]
    for i in (0, 1, 3, 4):
        t[i], j[i] = t[i].to(tdt), j[i].astype(jdt)
    return t, j


@pytest.mark.parametrize("b,s,d,n", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(b, s, d, n, dtype):
    t, j = _cast(_inputs(b, s, d, n), dtype)
    want_ref = np.asarray(jref.ssm_scan(*j), np.float32)
    want_kernel = np.asarray(jssm.ssm_scan(*j, bd=min(128, d),
                                           chunk=min(128, s),
                                           interpret=True), np.float32)
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    got = {"ref.ssm_scan": ref.ssm_scan(*t),
           "layers.selective_scan": L.selective_scan(*t, chunk=16),
           "ops.ssm_scan": ops.ssm_scan(*t, 16),
           "ssm_scan_fwd": K.ssm_scan_fwd(t[0], t[1], t[2][None], t[3], t[4],
                                          t[5][None])}
    for name, y in got.items():
        assert y.dtype == t[0].dtype and y.shape == (b, s, d), name
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(y.float().numpy(), want, rtol=tol,
                                       atol=tol, err_msg=name)


@pytest.mark.parametrize("b,s,d,n", CASES)
def test_grads_match_reference(b, s, d, n):
    t, j = _cast(_inputs(b, s, d, n, seed=4), "float32")
    gw = np.random.default_rng(5).standard_normal((b, s, d)).astype(
        np.float32)
    tw, jw = torch.from_numpy(gw), jnp.asarray(gw)
    got = grad(lambda *a: (ops.ssm_scan(*a, 16) * tw).sum(),
               argnums=tuple(range(6)))(*t)
    want = jax.grad(lambda *a: (jops.ssm_scan(*a, 16) * jw).sum(),
                    argnums=tuple(range(6)))(*j)
    for name, g, w in zip(("u", "dt", "a", "b", "c", "d"), got, want):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # the same grads through plain autograd (.backward) and in one chunk
    leaves = [x.clone().requires_grad_() for x in t]
    (ops.ssm_scan(*leaves, 16) * tw).sum().backward()
    one = ref.ssm_scan_bwd(t[0], t[1], t[2], t[3], t[4], t[5], tw, chunk=s)
    for x, g, g1 in zip(leaves, got, one):
        np.testing.assert_allclose(x.grad.numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(g1.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_vmap_over_clients_with_their_own_a_and_d(monkeypatch):
    """``vmap(grad)`` over 2 clients, each with its own a and d, reaches
    the kernel wrapper once with the clients folded into B (a [2, D, N],
    d [2, D]) and equals a per-client loop."""
    arrs = [torch.from_numpy(x) for x in _inputs(2, 64, 32, 16, seed=6,
                                                 lead=(2,))]
    assert not torch.equal(arrs[2][0], arrs[2][1])
    calls = []
    fwd = K.ssm_scan_fwd

    def spy(*args):
        calls.append((tuple(args[0].shape), tuple(args[2].shape),
                      tuple(args[5].shape)))
        return fwd(*args)

    monkeypatch.setattr(K, "ssm_scan_fwd", spy)
    tw = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 64, 32)).astype(np.float32))

    def loss(*a):
        return (ops.ssm_scan(*a, 16) * tw).sum()

    got = vmap(grad(loss, argnums=tuple(range(6))))(*arrs)
    assert calls == [((4, 64, 32), (2, 32, 16), (2, 32))]
    for i in range(2):
        want = grad(loss, argnums=tuple(range(6)))(*(x[i] for x in arrs))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_grouped_plain_versions_and_meta():
    """K5's grouped plain signatures equal one call per group, and
    ``meta`` inputs give shapes and count nothing."""
    u, dt, a, bm, cm, dv = (torch.from_numpy(x) for x in
                            _inputs(4, 32, 16, 8, seed=8))
    a2 = torch.stack([a, a * 0.5])
    d2 = torch.stack([dv, -dv])
    gy = torch.randn((4, 32, 16), generator=torch.Generator().manual_seed(0))
    y = ref.ssm_scan(u, dt, a2, bm, cm, d2)
    grads = ref.ssm_scan_bwd(u, dt, a2, bm, cm, d2, gy, chunk=8)
    for grp in range(2):
        rows = slice(2 * grp, 2 * grp + 2)
        np.testing.assert_allclose(
            y[rows].numpy(),
            ref.ssm_scan(u[rows], dt[rows], a2[grp], bm[rows], cm[rows],
                         d2[grp]).numpy(), rtol=1e-6, atol=1e-6)
        one = ref.ssm_scan_bwd(u[rows], dt[rows], a2[grp], bm[rows],
                               cm[rows], d2[grp], gy[rows], chunk=8)
        for k, (g, w) in enumerate(zip(grads, one)):
            g = g[grp] if k in (2, 5) else g[rows]
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)
    K.reset_launches()
    m = [x.to("meta") for x in (u, dt, a, bm, cm, dv)]
    out = ops.ssm_scan(*m, 16)
    assert out.shape == u.shape and out.device.type == "meta"
    g = grad(lambda *x: ops.ssm_scan(*x, 16).sum(), argnums=(0, 2))(*m)
    assert [t.shape for t in g] == [u.shape, a.shape]
    assert K.LAUNCHES == {"ssm_scan": 0}
    with pytest.raises(ValueError):
        K.ssm_scan_fwd(u, dt, a2, bm[:3], cm, d2)
