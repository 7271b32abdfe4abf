"""The port's Mamba-1 selective scan (K5 forward and backward) against
the JAX package's: ``repro.kernels.ref.ssm_scan``, the Pallas kernel
``repro.kernels.ssm_scan.ssm_scan`` in interpret mode and the differentiable
``repro.kernels.ops.ssm_scan``, at the cases of ``tests/test_kernels.py``.

On the CPU the port's autograd Functions run the plain versions inside, so
these tests hold the op's plumbing (grouped ``a``/``d``, the ``vmap`` rule,
the backward Function, the saved boundary states, ``meta`` shapes) and its
arithmetic; the CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py``.
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
from repro.models import layers as jlayers
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
                                          t[5][None])[0]}
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
    assert K.LAUNCHES == {"ssm_scan": 0, "ssm_scan_bwd": 0,
                          "ssm_scan_bwd_sum": 0}
    with pytest.raises(ValueError):
        K.ssm_scan_fwd(u, dt, a2, bm[:3], cm, d2)


@pytest.mark.parametrize("b,s,d,n,chunk", [(2, 64, 32, 16, 16),
                                           (1, 100, 24, 5, 32),
                                           (2, 48, 8, 1, 16),
                                           (1, 300, 16, 16, 128)])
def test_boundary_states_are_the_prefix_states(b, s, d, n, chunk):
    """The plain forward's boundary states (the residual the backward
    kernel starts its tiles from) equal the JAX package's
    ``selective_scan(..., return_state=True)`` run on each chunk-length
    prefix (the last one S, where S is not a multiple of the chunk), at
    fp32 rtol/atol 2e-4; ``ssm_scan_fwd`` on the CPU gives the plain bits
    at ``CHUNK``, and y is unchanged by asking for the states."""
    t, j = _cast(_inputs(b, s, d, n, seed=12), "float32")
    y, hs = ref.ssm_scan(*t, chunk=chunk)
    nc = -(-s // chunk)
    assert hs.shape == (b, nc, d, n) and hs.dtype == torch.float32
    assert torch.equal(y, ref.ssm_scan(*t))
    for i in range(nc):
        end = min((i + 1) * chunk, s)
        _, want = jlayers.selective_scan(
            j[0][:, :end], j[1][:, :end], j[2], j[3][:, :end],
            j[4][:, :end], j[5], chunk=min(chunk, end), return_state=True)
        np.testing.assert_allclose(hs[:, i].numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4, err_msg=str(i))
    ky, khs = K.ssm_scan_fwd(t[0], t[1], t[2][None], t[3], t[4],
                             t[5][None])
    assert torch.equal(ky, y)
    assert torch.equal(khs, ref.ssm_scan(*t, chunk=K.CHUNK)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_wrapper_routes_by_device(dtype):
    """``ssm_scan_bwd`` on CPU tensors gives ``ref.ssm_scan_bwd``'s bits
    (the states are the CUDA kernels' business) and counts no launch; on
    ``meta`` tensors at the Mamba main path's folded shape it gives each
    gradient's shape and dtype and counts nothing."""
    arrs = _inputs(4, 40, 16, 5, seed=13)
    t, _ = _cast(arrs, dtype)
    a2 = torch.stack([t[2], t[2] * 0.5])
    d2 = torch.stack([t[5], -t[5]])
    gy = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (4, 40, 16)).astype(np.float32)).to(t[0].dtype)
    _, hs = K.ssm_scan_fwd(t[0], t[1], a2, t[3], t[4], d2)
    K.reset_launches()
    got = K.ssm_scan_bwd(t[0], t[1], a2, t[3], t[4], d2, gy, hs, 8)
    want = ref.ssm_scan_bwd(t[0], t[1], a2, t[3], t[4], d2, gy, 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert [g.dtype for g in got] == [t[0].dtype, t[1].dtype, a2.dtype,
                                      t[3].dtype, t[4].dtype, d2.dtype]
    m = [torch.empty(sh, dtype=dt_, device="meta") for sh, dt_ in (
        ((4, 2048, 8192), torch.bfloat16), ((4, 2048, 8192), torch.bfloat16),
        ((4, 8192, 16), torch.float32), ((4, 2048, 16), torch.bfloat16),
        ((4, 2048, 16), torch.bfloat16), ((4, 8192), torch.float32),
        ((4, 2048, 8192), torch.bfloat16))]
    mhs = torch.empty(K.states_shape(4, 2048, 8192, 16), device="meta")
    assert mhs.shape == (4, 16, 8192, 16)
    out = K.ssm_scan_bwd(*m, mhs)
    assert [(o.shape, o.dtype) for o in out] == [(x.shape, x.dtype)
                                                 for x in m[:6]]
    assert all(o.device.type == "meta" for o in out)
    assert sum(K.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        K.ssm_scan_bwd(t[0], t[1], a2, t[3], t[4], d2, gy[:, :8], hs)


@pytest.mark.parametrize("n", [1, 5, 16])
def test_vmapped_grads_match_jax_vjp(n):
    """``vmap(grad)`` over 3 clients, each with its own a and d, through
    ``ops.ssm_scan`` (one folded forward, one folded backward with the
    saved states) equals ``jax.vjp`` of the JAX package's op per client,
    at N in {1, 5, 16} and S not a multiple of the chunk (rtol 1e-4, atol
    1e-5, the backward's reordered sums)."""
    arrs = _inputs(2, 40, 24, n, seed=15, lead=(3,))
    gw = np.random.default_rng(16).standard_normal((3, 2, 40, 24)).astype(
        np.float32)
    t = [torch.from_numpy(x) for x in arrs]
    tw = torch.from_numpy(gw)
    got = vmap(grad(lambda *a: (ops.ssm_scan(*a[:6], 16) * a[6]).sum(),
                    argnums=tuple(range(6))))(*t, tw)
    for i in range(3):
        _, vjp = jax.vjp(lambda *a: jops.ssm_scan(*a, 16),
                         *(jnp.asarray(x[i]) for x in arrs))
        want = vjp(jnp.asarray(gw[i]))
        for name, g, w in zip(("u", "dt", "a", "b", "c", "d"), got, want):
            assert g[i].shape == tuple(w.shape), name
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_states_any_n():
    """The kernels take any N >= 1 (groups of ``NG`` states, fp32 sums
    past the first), and the saved states are one [D, N] per ``CHUNK``
    steps, the last one after step S."""
    assert [K.check_states(n) for n in (1, 5, 16, 32, 33, 64, 1000)] == \
        [1, 1, 1, 1, 2, 2, 32]
    with pytest.raises(ValueError):
        K.check_states(0)
    assert K.states_shape(4, 2048, 8192, 16) == (4, 16, 8192, 16)
    assert K.states_shape(1, 2049, 8, 5) == (1, 17, 8, 5)


def test_sum_partials_plain_and_meta():
    """The backward's second step on CPU tensors is its plain version:
    db and dc [B, S, N] are the slab partials [slabs, B, N, S] summed over
    the slabs (in the given dtype), da and dd the row partials summed over
    each group's rows; on
    ``meta`` tensors it gives the shapes and counts nothing."""
    gen = torch.Generator().manual_seed(17)
    part = torch.randn((2, 3, 4, 5, 10), generator=gen)   # D = 70, N 5, S 10
    rows_a = torch.randn((4, 70, 5), generator=gen)
    rows_d = torch.randn((4, 70), generator=gen)
    K.reset_launches()
    db, dc, da, dd = K.sum_partials(part, rows_a, rows_d, 2, torch.bfloat16)
    assert db.dtype == dc.dtype == torch.bfloat16 and db.shape == (4, 10, 5)
    assert db.is_contiguous() and dc.is_contiguous()
    want = part.double().sum(1).transpose(-1, -2)
    np.testing.assert_allclose(db.double().numpy(), want[0].numpy(),
                               rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(dc.double().numpy(), want[1].numpy(),
                               rtol=2 ** -8, atol=1e-6)
    for grp in range(2):
        np.testing.assert_allclose(
            da[grp].numpy(), (rows_a[2 * grp] + rows_a[2 * grp + 1]).numpy(),
            rtol=1e-6)
        np.testing.assert_allclose(
            dd[grp].numpy(), (rows_d[2 * grp] + rows_d[2 * grp + 1]).numpy(),
            rtol=1e-6)
    m = K.sum_partials(part.to("meta"), rows_a.to("meta"),
                       rows_d.to("meta"), 4, torch.float32)
    assert [t.shape for t in m] == [(4, 10, 5), (4, 10, 5), (4, 70, 5),
                                    (4, 70)]
    assert sum(K.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        K.sum_partials(part[:, :2], rows_a, rows_d, 2, torch.float32)
