"""The hybrid family (zamba2-7b: Mamba-2 blocks with one shared attention
block after every ``attn_every`` of them) against the JAX package: the
SSD scan and its decode step, the mamba2 block, the hybrid stage with a
server tail, layer recompute at the shared sites, and the fp32 SSD leaves
and ``shared_attn`` across ``convert``.

Tolerances.  ``ssd_scan`` is the chunk-parallel form of the reference's
chunk-by-chunk scan: every chunk's terms at once, then a walk over the
carried states.  Its sums run in other orders, so it is held at fp32
tolerances, not bitwise: outputs and states at rtol 1e-5 / atol 1e-5 of
their largest magnitude, gradients against ``jax.vjp`` at rtol 1e-4 /
atol 1e-4 of theirs (a sum of 48 products of values of order 10-100).
Blocks, stages, losses and their gradients at rtol 1e-4 and an atol of
1e-5 of the largest magnitude compared (five fp32 layers of order-10
activations carry a few 1e-5 of absolute difference), the dense blocks'
tolerance in ``tests/test_torch_dense_configs.py`` scaled to the values.  Recompute
is bitwise the plain run.  Narrow models (``reduced()``: d 256, d_inner
512, 16 SSD heads of 32, N 16, chunk 16; 7 layers: a client group, 2
server groups and a tail of 1), fp32, one intra-op thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import bytes_of as jbytes_of
from repro.configs.registry import get_config as jget_config
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.blocks import Ctx as JCtx
from repro_torch.common import bytes_of, count_params, tree_leaves, tree_map
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.bundle import transformer_bundle
from repro_torch.models import blocks, layers
from repro_torch.models import model as tf_model
from repro_torch.models.blocks import Ctx

NAME = "zamba2-7b"
RTOL, ATOL = 1e-4, 1e-5
SSD_TOL, SSD_GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shapes(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, prefix + (key,)).items()}
    return {"/".join(prefix): (tuple(tree.shape),
                               str(tree.dtype).replace("torch.", ""))}


def test_config_and_plans_match_reference():
    """Every field equals the reference's, at full size and reduced; the
    parameter tree, shapes, dtypes (``a_log``, ``dt_b``, ``d_skip`` fp32
    in the bf16 model) and bytes equal ``abstract_params``'; the stage
    plans equal the reference's: the full client stage 2 groups, the
    server 69 layers in 11 groups and a tail of 3."""
    for size in ("full", "reduced", "seven"):
        j, p = jget_config(NAME), get_config(NAME)
        if size != "full":
            j, p = j.reduced(), p.reduced()
        if size == "seven":
            j, p = j.with_(num_layers=7), p.with_(num_layers=7)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(j, f.name), (size, f.name)
        assert p.family == "hybrid"
        assert p.resolved_ssm_heads == j.resolved_ssm_heads
        got = tf_model.stage_plans(p)
        want = jmodel.stage_plans(j)
        assert [(s.kind, s.n_layers, s.groups, s.tail, s.n_shared_sites)
                for s in got] == [(s.kind, s.n_layers, s.groups, s.tail,
                                   s.n_shared_sites) for s in want]
    cfg = get_config(NAME)
    assert [(s.n_layers, s.groups, s.tail) for s in
            tf_model.stage_plans(cfg)] == [(12, 2, 0), (69, 11, 3)]
    assert [(s.n_layers, s.groups, s.tail) for s in tf_model.stage_plans(
        cfg.reduced().with_(num_layers=7))] == [(2, 1, 0), (5, 2, 1)]
    got = _shapes(tf_model.abstract_params(cfg))
    want = {"/".join(str(k.key) for k in path):
            (tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jmodel.abstract_params(jget_config(NAME)))}
    assert got == want
    for leaf in ("a_log", "dt_b", "d_skip"):
        assert got[f"server/blocks_stage/blocks/{leaf}"] == ((69, 112),
                                                            "float32")
    assert got["client/blocks_stage/blocks/in_proj"] == ((12, 3584, 14576),
                                                         "bfloat16")
    assert got["server/blocks_stage/shared_attn/attn/wq"] == (
        (3584, 3584), "bfloat16")
    specs = transformer_bundle(cfg, device="cpu").specs
    assert tuple(count_params(specs[k]) for k in ("client", "aux",
                                                  "server")) \
        == (1_255_952_832, 4_558_336, 5_700_706_064)
    assert bytes_of(tf_model.abstract_params(cfg)) == jbytes_of(
        jmodel.abstract_params(jget_config(NAME)))
    with pytest.raises(ValueError, match="multiple of 6"):
        tf_model.stage_plans(cfg.with_(cut_layer=8))


def _near(got, want, what=""):
    """rtol RTOL, atol ATOL of the largest magnitude in ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max(initial=1.0),
                               err_msg=what)


def _ssd_inputs(b, s, h, p, n, seed, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * dt_scale).astype(
        np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, a_log, bm, cm, h0


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(initial=1.0),
                               err_msg=what)


# (S, chunk, dt scale, h0): 3 chunks of 16; 40 is not a multiple of 16, so
# the whole sequence is one chunk (the reference's fallback); a carried
# state in; dt large enough that dt·A summed over a chunk passes 100
SSD_CASES = [(48, 16, 1.0, False), (40, 16, 1.0, False),
             (48, 16, 1.0, True), (48, 16, 12.0, True)]


@pytest.mark.parametrize("s,chunk,dt_scale,with_h0", SSD_CASES)
def test_ssd_scan_matches_reference(s, chunk, dt_scale, with_h0):
    """y and (``return_state``) the state after the last step."""
    x, dt, a_log, bm, cm, h0 = _ssd_inputs(2, s, 3, 4, 5, s, dt_scale)
    if dt_scale > 1:
        la = (dt * np.exp(a_log))[:, :chunk].sum(1)
        assert la.max() > 100               # dt·A summed over a chunk
    kw = dict(chunk=chunk, return_state=True)
    jy, jh = jlayers.ssd_scan(*map(jnp.asarray, (x, dt, a_log, bm, cm)),
                              h0=jnp.asarray(h0) if with_h0 else None, **kw)
    y, h = layers.ssd_scan(*map(torch.from_numpy, (x, dt, a_log, bm, cm)),
                           h0=torch.from_numpy(h0) if with_h0 else None,
                           **kw)
    assert y.shape == (2, s, 3, 4) and h.shape == (2, 3, 5, 4)
    assert y.dtype == h.dtype == torch.float32
    _close(y.numpy(), jy, SSD_TOL, "y")
    _close(h.numpy(), jh, SSD_TOL, "state")
    y2 = layers.ssd_scan(*map(torch.from_numpy, (x, dt, a_log, bm, cm)),
                         chunk=chunk)
    if not with_h0:
        assert torch.equal(y2, y)


@pytest.mark.parametrize("s,chunk,dt_scale,with_h0", SSD_CASES)
def test_ssd_scan_grads_match_jax_vjp(s, chunk, dt_scale, with_h0):
    """Gradients for x, dt, a_log, B and C (and h0) against ``jax.vjp``
    from a random cotangent; finite where dt·A passes 100 a chunk (the
    masked exponent: exp of the positive decay above the diagonal never
    runs)."""
    x, dt, a_log, bm, cm, h0 = _ssd_inputs(1, s, 2, 4, 3, 7 + s, dt_scale)
    gy = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)
    ins = [x, dt, a_log, bm, cm] + ([h0] if with_h0 else [])

    def jf(*a):
        return jlayers.ssd_scan(*a[:5], chunk=chunk,
                                h0=a[5] if with_h0 else None)

    _, vjp = jax.vjp(jf, *map(jnp.asarray, ins))
    jg = vjp(jnp.asarray(gy))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y = layers.ssd_scan(*ts[:5], chunk=chunk,
                        h0=ts[5] if with_h0 else None)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(gy))
    for name, g, w in zip(("x", "dt", "a_log", "b", "c", "h0"), grads, jg):
        _close(g.numpy(), w, SSD_GRAD_TOL, name)


def test_ssd_scan_under_vmap_over_three_clients():
    """``torch.func.vmap(grad)`` over 3 clients (a_log per client): each
    client's y and gradients those of its own call, and the gradients
    against ``jax.vmap`` of the reference's ``jax.grad``."""
    ins = [np.stack(a) for a in zip(*(_ssd_inputs(1, 48, 2, 4, 3, 20 + c)[:5]
                                      for c in range(3)))]

    def loss(x, dt, a_log, bm, cm):
        return (layers.ssd_scan(x, dt, a_log, bm, cm, chunk=16) ** 2).sum()

    def jloss(x, dt, a_log, bm, cm):
        return (jlayers.ssd_scan(x, dt, a_log, bm, cm, chunk=16) ** 2).sum()

    ts = [torch.from_numpy(a) for a in ins]
    vg = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))(*ts)
    jg = jax.vmap(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))
    for g, w in zip(vg, jg):
        _close(g.numpy(), w, SSD_GRAD_TOL)
    for c in range(3):
        one = torch.func.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(t[c] for t in ts))
        for g, o in zip(vg, one):
            torch.testing.assert_close(g[c], o, rtol=1e-6, atol=1e-6)


def test_ssd_decode_matches_reference_and_the_scan():
    """Steps from a carried state against the reference's steps (y and
    the state updated in place), and 48 steps from zero against the
    scan's y and final state."""
    x, dt, a_log, bm, cm, h0 = _ssd_inputs(2, 48, 3, 4, 5, 9)
    h = torch.from_numpy(h0.copy())
    jh = jnp.asarray(h0)
    for t in range(4):
        step = [a[:, t] for a in (x, dt)] + [a_log] + [a[:, t] for a in
                                                       (bm, cm)]
        jy, jh = jlayers.ssd_decode(*map(jnp.asarray, step), jh)
        y, h2 = layers.ssd_decode(*map(torch.from_numpy, step), h)
        assert h2 is h
        _close(y.numpy(), jy, SSD_TOL, f"y {t}")
        _close(h.numpy(), jh, SSD_TOL, f"state {t}")
    ys, h = [], torch.zeros((2, 3, 5, 4))
    for t in range(48):
        y, _ = layers.ssd_decode(*(torch.from_numpy(a[:, t]) for a in
                                   (x, dt)), torch.from_numpy(a_log),
                                 *(torch.from_numpy(a[:, t]) for a in
                                   (bm, cm)), h)
        ys.append(y)
    want, hw = layers.ssd_scan(*map(torch.from_numpy, (x, dt, a_log, bm,
                                                       cm)),
                               chunk=16, return_state=True)
    _close(torch.stack(ys, 1).numpy(), want.numpy(), SSD_TOL)
    _close(h.numpy(), hw.numpy(), SSD_TOL)


def _cfgs(**kw):
    kw = {"dtype": "float32", "swa_window": 32, "num_layers": 7, **kw}
    return (jget_config(NAME).reduced().with_(use_pallas=False, **kw),
            get_config(NAME).reduced().with_(use_pallas=True, **kw))


def _params(jcfg, seed=0):
    jp = jtransformer_bundle(jcfg).init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba2_block_matches_reference(mode):
    """Layer 0 of the client stage on B 2 x S 64 (4 chunks of 16): the
    output, and in prefill the cache (the raw conv window over the din +
    2N channels, the SSD state ``[B, H, N, P]``)."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    h = np.random.default_rng(2).standard_normal((2, 64, cfg.d_model)) \
        .astype(np.float32)
    jl0 = jax.tree_util.tree_map(lambda a: a[0],
                                 jp["client"]["blocks_stage"]["blocks"])
    l0 = tf_model._unstack(p["client"]["blocks_stage"]["blocks"])[0]
    jx, jc, _ = jblocks.mamba2_apply(jcfg, jl0, jnp.asarray(h),
                                     JCtx(jcfg, mode), None)
    x, c, aux = blocks.mamba2_apply(cfg, l0, torch.from_numpy(h),
                                    Ctx(cfg, mode), None)
    assert aux == 0.0
    _near(x.numpy(), jx)
    if mode == "prefill":
        assert set(c) == set(jc) == {"conv", "ssm"}
        assert c["conv"].shape == (2, 3, 512 + 2 * 16)
        assert c["ssm"].shape == (2, 16, 16, 32)
        for k in c:
            _near(c[k].numpy(), jc[k], k)


def test_mamba2_block_rounds_y_before_the_skip_term():
    """bf16: the block within two bf16 ulps (of its largest magnitude) of
    the reference's, which rounds the scan's y to bf16 before it adds the
    fp32 skip term and rounds again."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp, p = _params(jcfg)
    h = np.random.default_rng(4).standard_normal((1, 32, cfg.d_model))
    jl0 = jax.tree_util.tree_map(lambda a: a[0],
                                 jp["client"]["blocks_stage"]["blocks"])
    l0 = tf_model._unstack(p["client"]["blocks_stage"]["blocks"])[0]
    jx, _, _ = jblocks.mamba2_apply(jcfg, jl0, jnp.asarray(h, jnp.bfloat16),
                                    JCtx(jcfg, "train"), None)
    x, _, _ = blocks.mamba2_apply(cfg, l0,
                                  torch.from_numpy(h).to(torch.bfloat16),
                                  Ctx(cfg, "train"), None)
    assert x.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(jx, jnp.float32))
    np.testing.assert_allclose(x.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())


def test_hybrid_stages_losses_and_grads_match_reference():
    """The client stage (a group: 2 layers and the shared site) and the
    server stage (2 groups and a tail of 1) on B 2 x S 64, the losses,
    and their gradients (``shared_attn``'s summed over its sites) against
    the reference's ``jax.grad``."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    jb, b = jtransformer_bundle(jcfg), transformer_bundle(cfg, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 65), dtype=np.int32)
    x, y = tok[:, :-1], tok[:, 1:]
    jin, inp = {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
    jy, ty = jnp.asarray(y), torch.from_numpy(y)
    ctx, jctx = Ctx(cfg, "train", window=32), JCtx(jcfg, "train", window=32)
    jsm, _, _ = jmodel.client_forward(jcfg, jp["client"], jin, jctx)
    sm, _, _ = tf_model.client_forward(cfg, p["client"], inp, ctx)
    _near(sm.numpy(), jsm, "smashed")
    jx, _, _ = jmodel.server_forward(jcfg, jp["server"], jsm, jctx)
    sx, _, _ = tf_model.server_forward(cfg, p["server"], sm, ctx)
    _near(sx.numpy(), jx, "server stage")

    g, (loss, sm2) = torch.func.grad_and_value(
        lambda pr: b.client_loss(pr["client"], pr["aux"], inp, ty),
        has_aux=True)({"client": p["client"], "aux": p["aux"]})
    (jloss, jsm2), jg = jax.value_and_grad(
        lambda pr: jb.client_loss(pr["client"], pr["aux"], jin, jy),
        has_aux=True)({"client": jp["client"], "aux": jp["aux"]})
    sg, sloss = torch.func.grad_and_value(b.server_loss)(p["server"], sm2,
                                                         ty)
    jsloss, jsg = jax.value_and_grad(jb.server_loss)(jp["server"], jsm2, jy)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(sloss), float(jsloss), rtol=RTOL)
    got = params_to_numpy({**g, "server": sg})
    want = jax.tree_util.tree_map(np.asarray, {**jg, "server": jsg})
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(got),
                     jax.tree_util.tree_leaves_with_path(want)))
    assert sum("shared_attn" in jax.tree_util.keystr(p_) for (p_, _), _
               in pairs) == 2 * 9       # a dense block's 9 leaves a stage
    for (path, a), (wpath, w) in pairs:
        assert path == wpath
        _near(a, w, jax.tree_util.keystr(path))
    wq = sg["blocks_stage"]["shared_attn"]["attn"]["wq"]
    assert float(wq.abs().sum()) > 0


def test_remat_is_bitwise_the_plain_stage():
    """Two clients' losses and gradients through ``torch.func.vmap(grad)``,
    as the clients' phase takes them, and the server stage's (its 2 sites
    and its tail): ``remat=True`` (each backbone layer and each shared
    site recomputed) bitwise ``remat=False``."""
    jcfg, cfg = _cfgs()
    _, p = _params(jcfg)
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1, 65),
                                        dtype=np.int32))
    cp = tree_map(lambda t: torch.stack([t, t * 1.01]), p["client"])
    ap = tree_map(lambda t: torch.stack([t, t]), p["aux"])

    def run(c):
        def loss(cpi, api, toks):
            inp, lab = {"tokens": toks[:, :-1]}, toks[:, 1:]
            return tf_model.client_loss(c, cpi, api, inp, lab,
                                        Ctx(c, "train", window=32))
        f = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1),
                                            has_aux=True))
        g, sm = f(cp, ap, tok)
        sg = torch.func.grad(lambda sp: tf_model.server_loss(
            c, sp, sm[0], tok[0, :, 1:], Ctx(c, "train", window=32)))(
                p["server"])
        return g, sm, sg

    (g1, s1, sg1), (g2, s2, sg2) = run(cfg), run(cfg.with_(remat=True))
    assert torch.equal(s1, s2)
    l1, l2 = tree_leaves((g1, sg1)), tree_leaves((g2, sg2))
    assert len(l1) == len(l2) and all(torch.equal(x, y)
                                      for x, y in zip(l1, l2))
    assert float(sg1["blocks_stage"]["shared_attn"]["mlp"]["w2"].abs()
                 .sum()) > 0


def test_convert_round_trips_the_fp32_ssd_leaves_and_shared_attn():
    """A bf16 reduced model from the reference's init: ``a_log``, ``dt_b``
    and ``d_skip`` cross as fp32, the rest (``shared_attn`` too, with no
    layer axis) as bf16, and back, bit for bit."""
    jcfg = jget_config(NAME).reduced()
    jp = jtransformer_bundle(jcfg).init(jax.random.PRNGKey(1))
    jtree = jax.tree_util.tree_map(np.asarray, jp)
    p = params_from_numpy(jtree, device="cpu")
    for stage in ("client", "server"):
        st = p[stage]["blocks_stage"]
        for leaf in ("a_log", "dt_b", "d_skip"):
            assert st["blocks"][leaf].dtype == torch.float32
        assert st["blocks"]["in_proj"].dtype == torch.bfloat16
        assert st["shared_attn"]["attn"]["wq"].shape == (256, 256)
        assert st["shared_attn"]["mlp"]["w1"].dtype == torch.bfloat16
    back = params_to_numpy(p)
    flat, jflat = (jax.tree_util.tree_leaves_with_path(t)
                   for t in (back, jtree))
    for (path, a), (jpath, w) in zip(flat, jflat):
        assert path == jpath and a.dtype == w.dtype
        assert np.array_equal(a.view(np.uint8), w.view(np.uint8)), path
    assert bytes_of(p) == jbytes_of(jp)


def test_port_init_matches_reference_tree():
    """The port's own init draws the reference's tree (the stages'
    ``shared_attn`` included): same leaves, shapes and dtypes, the
    constant leaves equal (ln, gate_ln, conv_b, a_log, dt_b, d_skip)."""
    cfg = get_config(NAME).reduced()
    p = tf_model.init_params(cfg, torch.Generator().manual_seed(0))
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jget_config(NAME).reduced(), jax.random.PRNGKey(0)))
    flat_g = jax.tree_util.tree_leaves_with_path(params_to_numpy(p))
    flat_w = jax.tree_util.tree_leaves_with_path(jp)
    assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
    for (path, a), (_, w) in zip(flat_g, flat_w):
        assert a.dtype == w.dtype and a.shape == w.shape, path
        leaf = jax.tree_util.keystr(path).split("'")[-2]
        if leaf in ("ln", "gate_ln", "conv_b", "a_log", "dt_b", "d_skip"):
            np.testing.assert_array_equal(a, w)
