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
from repro.kernels import ref as jref
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
                          "fused_ce_dw": 0, "fused_ce_p": 0}


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
    # bf16: 128-column tiles, one block an SM in flight; Qwen3's server and
    # aux heads fill 8 and 32 whole waves of 132 blocks
    assert K.vocab_splits(1, 4096, 151936) == (33, 36)
    assert K.vocab_splits(4, 4096, 151936) == (33, 36)
    assert K.vocab_splits(1, 2048, 65024) == (8, 64)
    assert K.vocab_splits(1, 8, 130) == (2, 1)
    # fp32 (the CUDA-core K3): 64-column tiles, about four blocks an SM
    assert K.vocab_splits(1, 4096, 151936, bf16=False) == (9, 264)
    assert K.vocab_splits(4, 4096, 151936, bf16=False) == (3, 792)
    assert K.vocab_splits(1, 8, 130, bf16=False) == (3, 1)


# (G, T) of the heads: the server's and the aux's at S = 4096 (Qwen3's main
# path) and at S = 2048 (the Mamba main path's).
HEADS = [(1, 4096), (4, 4096), (1, 2048), (4, 2048)]


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_launch_plan_takes_every_config_width(name):
    """K3's grid and the bf16 backward's plan at every config's server head
    (d = d_model) and aux head (d = aux_rank), 1 group or 4 folded clients
    at S = 4096 and 2048: the chunks cover V exactly and in order, the P
    scratch stays within P_CAP, every grid fits CUDA's limits and x's, w's
    and P's rows are 16-byte multiples for TMA."""
    cfg = JARCHS[name]
    v = cfg.vocab_size
    for g, t in HEADS:
        d = cfg.d_model if g == 1 else cfg.aux_rank
        for bf16, tile in ((True, K.TILE), (False, K.FP32_TILE)):
            plan = K.launch_plan(g, t, d, v, bf16=bf16)
            ns, tps = plan["nsplit"], plan["tiles_per_split"]
            assert plan["grids"]["fused_ce_fwd"] == (-(-t // tile), ns, g)
            # the splits cover the vocabulary tiles exactly, in order
            assert (ns - 1) * tps < -(-v // tile) <= ns * tps
            assert plan["ldw"] == v
            assert ns <= 65535 and g <= 65535
        bwd = K.bwd_plan(g, t, d, v)       # raises past CUDA's grid limits
        vc = bwd["vc"]
        # the chunks as the kernels walk them: c0 = 0, vc, 2 vc, ... < V
        chunks = [(c0, min(vc, v - c0)) for c0 in range(0, v, vc)]
        assert vc % K.TILE == 0 and 0 < v - chunks[-1][0] <= vc
        assert sum(cw for _, cw in chunks) == v
        assert 2 * g * t * vc <= K.P_CAP            # the P scratch
        assert bwd["acc"] == (len(chunks) > 1)
        assert bwd["ldw"] == v              # every vocabulary: no padding
        # 16-byte rows of x, w and P for TMA
        assert all(2 * n % 16 == 0 for n in (d, bwd["ldw"], vc))
        for n in (t, d, vc):
            assert -(-n // K.TILE) <= 65535 and g <= 65535


def test_bwd_plan_at_the_main_paths_heads():
    """The chunk widths of the Qwen3 and falcon-mamba heads: the P scratch
    at most 256 MiB, one chunk of all of V at falcon-mamba's server head."""
    want = {(1, 4096, 1024, 151936): (32768, 5),
            (4, 4096, 128, 151936): (8192, 19),
            (1, 2048, 4096, 65024): (65024, 1),
            (4, 2048, 128, 65024): (16384, 4)}
    for (g, t, d, v), (vc, n) in want.items():
        plan = K.bwd_plan(g, t, d, v)
        assert (plan["vc"], -(-v // plan["vc"])) == (vc, n)


def test_launch_plan_raises_where_tma_cannot_read():
    """The bf16 K3 reads x with TMA: its rows must be 16-byte multiples,
    so a d that is not a multiple of 8 runs padded (the fp32 K3 takes any
    d); a V that is not a multiple of 8 pads w's rows; a grid past CUDA's
    limits raises."""
    assert K.launch_plan(1, 24, 12, 80)["dp"] == 16    # x, w zero-padded
    assert K.launch_plan(1, 24, 12, 80, bf16=False)["ldw"] == 80
    assert K.launch_plan(3, 37, 16, 130)["ldw"] == 136
    with pytest.raises(ValueError):
        K.launch_plan(70000, 24, 16, 80)
    w = torch.arange(2 * 3 * 5, dtype=torch.bfloat16).reshape(2, 3, 5)
    padded, wg = K._pad_rows(w, 15, 5, 8)
    assert padded.shape == (2, 3, 8) and wg == 24
    assert torch.equal(padded[..., :5], w) and not padded[..., 5:].any()
    shared, wg0 = K._pad_rows(w[:1].expand(4, 3, 5), 0, 5, 8)
    assert shared.shape == (1, 3, 8) and wg0 == 0
    assert K._pad_rows(w, 15, 5, 5) == (w, 15)


def test_bwd_plan_raises_where_tma_cannot_read():
    """x's rows must be 16-byte multiples (a d that is not a multiple of
    8 runs padded) and bases 16-byte aligned; a V that is not a multiple of
    8 pads w's rows instead; a grid past CUDA's limits raises."""
    assert K.bwd_plan(1, 24, 12, 80)["dp"] == 16       # x, w zero-padded
    with pytest.raises(ValueError):
        K.bwd_plan(70000, 24, 16, 80)
    assert K.bwd_plan(3, 37, 16, 130)["ldw"] == 136
    buf = torch.zeros(64, dtype=torch.bfloat16)
    K._aligned(buf, "x")
    with pytest.raises(ValueError):
        K._aligned(buf[1:], "x")


@pytest.mark.parametrize("g,t,d,v", [(2, 37, 16, 130), (1, 100, 72, 1000),
                                     (3, 24, 8, 300)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_wrappers_give_the_plain_grads(g, t, d, v, dtype):
    """On CPU tensors (ragged T and V, V not a multiple of the tile)
    ``fused_ce_bwd`` gives the bits of ``fused_ce_dx`` and ``fused_ce_dw``
    alone, which are the plain versions', in x's and w's dtypes, and counts
    no launch; in fp32 they equal the JAX reference's ``fused_ce_grads``
    (rtol 1e-5)."""
    (x, w, lab), (jx, jw, jlab) = _inputs(t, d, v, dtype, seed=5, lead=(g,))
    x = x * d ** -0.5
    gs = torch.linspace(0.5, 1.5, g)
    lse, _ = K.fused_ce_fwd(x, w, lab)
    K.reset_launches()
    dx, dw = K.fused_ce_bwd(x, w, lab, lse, gs)
    assert sum(K.LAUNCHES.values()) == 0
    assert (dx.dtype, dx.shape) == (x.dtype, x.shape)
    assert (dw.dtype, dw.shape) == (w.dtype, w.shape)
    assert torch.equal(dx, K.fused_ce_dx(x, w, lab, lse, gs))
    assert torch.equal(dw, K.fused_ce_dw(x, w, lab, lse, gs))
    assert torch.equal(dx, ref.fused_ce_dx(x, w, lab, lse, gs))
    assert torch.equal(dw, ref.fused_ce_dw(x, w, lab, lse, gs))
    if dtype == "float32":
        for i in range(g):
            jdx, jdw = jref.fused_ce_grads(jx[i] * d ** -0.5, jw[i], jlab[i],
                                           float(gs[i]))
            np.testing.assert_allclose(dx[i].numpy(), np.asarray(jdx),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(dw[i].numpy(), np.asarray(jdw),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("d", [128, 1024, 1536, 4096, 8192])
def test_any_width_d(d):
    """The grouped plain versions at every width the kernels take, and
    the bf16 backward's plan there (one chunk)."""
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
    assert K.bwd_plan(1, 24, d, 80) == {"vc": 128, "ldw": 80, "acc": False,
                                        "dp": d}
    with pytest.raises(ValueError):
        K.launch_plan(70000, 24, d, 80)


def test_padding_plan_at_d_100():
    """At d = 100 the bf16 plans run the kernels at d = 104 (fp32 at 100),
    and the zero padding of x's rows and w's d rows is exact: the padded
    problem gives the same (lse, picked) and, sliced back, the same dx and
    dw (fp32 plain versions, rtol 1e-6)."""
    g, t, d, v = 2, 37, 100, 300
    fwd = K.launch_plan(g, t, d, v)
    bwd = K.bwd_plan(g, t, d, v)
    assert fwd["dp"] == bwd["dp"] == 104
    assert K.launch_plan(g, t, d, v, bf16=False)["dp"] == 100
    assert fwd["grids"]["fused_ce_fwd"] == (1, fwd["nsplit"], g)
    assert (bwd["vc"], bwd["ldw"], bwd["acc"]) == (384, 304, False)
    (x, w, lab), _ = _inputs(t, d, v, "float32", seed=11, lead=(g,))
    x = x * d ** -0.5
    gs = torch.tensor([0.5, 1.5])
    xp, xg = K._pad_d(x, x[0].numel(), 2, 104)
    wp, wg = K._pad_d(w, w[0].numel(), 1, 104)
    assert xp.shape == (g, t, 104) and xg == t * 104
    assert wp.shape == (g, 104, v) and wg == 104 * v
    assert not xp[..., d:].any() and not wp[:, d:].any()
    assert torch.equal(xp[..., :d], x) and torch.equal(wp[:, :d], w)
    shared, sg = K._pad_d(w[:1].expand(3, d, v), 0, 1, 104)
    assert shared.shape == (1, 104, v) and sg == 0
    assert K._pad_d(x, 7, 2, d) == (x, 7)
    lse, picked = ref.fused_ce_fwd(x, w, lab)
    plse, ppicked = ref.fused_ce_fwd(xp, wp, lab)
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), rtol=1e-6)
    np.testing.assert_allclose(ppicked.numpy(), picked.numpy(), rtol=1e-6,
                               atol=1e-6)
    dx, dw = ref.fused_ce_bwd(x, w, lab, lse, gs)
    pdx, pdw = ref.fused_ce_bwd(xp, wp, lab, lse, gs)
    assert not pdw[:, d:].any()
    np.testing.assert_allclose(pdx[..., :d].numpy(), dx.numpy(), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(pdw[:, :d].numpy(), dw.numpy(), rtol=1e-6,
                               atol=1e-8)
