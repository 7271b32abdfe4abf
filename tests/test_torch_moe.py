"""The MoE family (olmoe-1b-7b, phi3.5-moe-42b-a6.6b) against the JAX
package: the capacity-limited top-k dispatch, the SwiGLU experts and
their load-balance aux loss, the block, the stages and the losses with
the aux term, layer recompute carrying the aux loss, and the fp32 router
across ``convert``.

Tolerances.  The dispatch and combine tables are compared bitwise from
the same router probabilities (the reference's, recomputed by the same
JAX ops its ``moe_dispatch`` runs, fed to the port's ``moe_tables``):
the tables are a function of the probabilities alone, and the two
frameworks' fp32 router products and softmaxes differ in their last bits
(sums in other orders).  From the same inputs the port's whole dispatch
gives the reference's dispatch table bitwise (no routing flips at these
inputs), its combine table at rtol 1e-6 / atol 1e-9 (gates down to 1e-8
move by 1e-5 of themselves) and its aux loss at rtol 1e-6;
the expert products, the gradients and the losses at rtol 1e-4 / atol
1e-5 (fp32), as ``tests/test_torch_dense_configs.py`` holds the dense
blocks.  Recompute with the aux loss is bitwise the plain run in the
port.  Narrow models (reduced: d 256, 4 experts top 2, group 64), fp32,
one intra-op thread.
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
from repro.models.blocks import Ctx as JCtx
from repro.models.model import abstract_params as jabstract_params
from repro_torch.common import bytes_of, tree_leaves, tree_map
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.bundle import transformer_bundle
from repro_torch.models import blocks, layers
from repro_torch.models import model as tf_model
from repro_torch.models.blocks import Ctx

ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
RTOL, ATOL = 1e-4, 1e-5
E, K, D, F = 4, 2, 32, 16


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


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference_field_for_field(name):
    """Every field of the port's config equals the reference's, at full
    size and reduced; the parameter tree, shapes, dtypes (the router
    fp32 in the bf16 model) and bytes equal ``abstract_params``'."""
    for size in ("full", "reduced"):
        j, p = jget_config(name), get_config(name)
        if size == "reduced":
            j, p = j.reduced(), p.reduced()
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(j, f.name), (size, f.name)
        assert p.family == "moe" and p.remat == (size == "full")
    cfg = get_config(name)
    got = _shapes(tf_model.abstract_params(cfg))
    want = {"/".join(str(k.key) for k in path):
            (tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jabstract_params(jget_config(name)))}
    assert got == want
    assert got["server/blocks_stage/blocks/moe/router"][1] == "float32"
    assert bytes_of(tf_model.abstract_params(cfg)) == jbytes_of(
        jabstract_params(jget_config(name)))


def _inputs(t, seed, case):
    """x [t, D] and a router [D, E] (fp32).  ``overflow``: a router biased
    to expert 0, so its groups overflow; ``zeros``: every third token all
    zeros (uniform probabilities: a tie of all E experts)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if case == "overflow":
        x[:, 0] = np.abs(x[:, 0]) + 2.0
        w[0] = [8.0, 0.5, 0.0, -0.5]
    if case == "zeros":
        x[::3] = 0.0
    return x, w


def _jprobs(x, w, g, s):
    """The reference's router probabilities, by the ops its
    ``moe_dispatch`` runs."""
    xg = jnp.asarray(x)[: g * s].reshape(g, s, -1)
    logits = jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                        jnp.asarray(w).astype(jnp.float32))
    return jax.nn.softmax(logits, axis=-1)


# (case, tokens, capacity factor); at a factor of E / K = 2 the capacity
# is the group (nothing can drop)
CASES = [("plain", 128, 2.0), ("overflow", 128, 1.25),
         ("ragged", 141, 1.25), ("zeros", 96, 1.25), ("tight", 128, 0.5)]


@pytest.mark.parametrize("case,t,cf", CASES)
def test_dispatch_tables_bitwise(case, t, cf):
    """The port's tables from the reference's probabilities: dispatch and
    combine bitwise the reference's; groups, slots and capacity equal;
    from the same inputs, the dispatch table bitwise too."""
    x, w = _inputs(t, 1, case)
    kw = dict(num_experts=E, k=K, capacity_factor=cf, group_size=64)
    jd, jc, jaux, (g, s, cap) = jlayers.moe_dispatch(
        jnp.asarray(x), jnp.asarray(w), **kw)
    assert layers.moe_groups(t, 64, E, K, cf) == (g, s, cap)
    probs = torch.from_numpy(np.array(_jprobs(x, w, g, s)))
    disp, comb, aux = layers.moe_tables(probs, K, cap)
    assert disp.dtype == comb.dtype == torch.float32
    assert np.array_equal(disp.numpy(), np.asarray(jd))
    assert np.array_equal(comb.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    d2, c2, aux2, gsc = layers.moe_dispatch(torch.from_numpy(x),
                                            torch.from_numpy(w), **kw)
    assert gsc == (g, s, cap)
    assert np.array_equal(d2.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(float(aux2), float(jaux), rtol=1e-6)
    kept = int(disp.sum())
    if case in ("overflow", "tight"):      # some choices dropped
        assert kept < g * s * K
    if cf >= E / K:
        assert cap >= s and kept == g * s * K
    if case == "ragged":
        assert g * s < t
    if case == "zeros":                    # uniform: experts 0..k-1
        idx, gates, _, _ = layers.moe_slots(probs, K, cap)
        zero = torch.from_numpy(np.all(x[: g * s] == 0, -1)).reshape(g, s)
        assert torch.equal(idx[zero], torch.arange(K).expand(
            int(zero.sum()), K))
        assert torch.equal(gates[zero], torch.full((int(zero.sum()), K),
                                                    float(gates[zero][0, 0])))


def test_route_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert first, as ``lax.top_k``."""
    p = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1]])
    vals, idx = layers.moe_route(p, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert np.array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2]]


def test_dispatch_under_vmap_over_three_clients():
    """``torch.func.vmap`` over 3 clients: each client's tables bitwise its
    own call's (the capacity counted per client, not over the folded
    clients), and the dispatch tables the reference's ``jax.vmap``'s."""
    xs, ws = zip(*(_inputs(128, 10 + c, "overflow" if c == 1 else "plain")
                   for c in range(3)))
    x, w = np.stack(xs), np.stack(ws)
    kw = dict(num_experts=E, k=K, capacity_factor=1.25, group_size=64)

    def f(xx, ww):
        d, c, a, _ = layers.moe_dispatch(xx, ww, **kw)
        return d, c, a

    vd, vc, va = torch.func.vmap(f)(torch.from_numpy(x), torch.from_numpy(w))
    jd, _, _, _ = jax.vmap(lambda a, b: jlayers.moe_dispatch(a, b, **kw))(
        jnp.asarray(x), jnp.asarray(w))
    assert np.array_equal(vd.numpy(), np.asarray(jd))
    for c in range(3):
        d, cc, a = f(torch.from_numpy(x[c]), torch.from_numpy(w[c]))
        assert torch.equal(vd[c], d) and torch.equal(vc[c], cc)
        assert torch.equal(va[c], a)


def _ffn_params(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((D, E)) * D ** -0.5).astype(
                np.float32),
            "w1": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(dtype),
            "w3": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(dtype),
            "w2": (rng.standard_normal((E, F, D)) * F ** -0.5).astype(dtype)}


@pytest.mark.parametrize("case,t,cf", [("plain", 128, 1.25),
                                       ("overflow", 141, 1.25)])
def test_moe_ffn_and_grads_match_jax_vjp(case, t, cf):
    """``moe_ffn``'s output and aux loss, and the gradients of both (a
    random cotangent on the output, one on the aux loss) for x, the
    router, w1, w2 and w3, against ``jax.vjp`` of the reference's."""
    x, w = _inputs(t, 2, case)
    p = _ffn_params(3)
    p["router"] = w
    kw = dict(num_experts=E, k=K, capacity_factor=cf, group_size=64)
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((t, D)).astype(np.float32)
    ga = np.float32(0.7)
    names = ("router", "w1", "w2", "w3")

    def jf(xx, *leaves):
        return jlayers.moe_ffn(xx, dict(zip(names, leaves)), **kw)

    (jy, jaux), vjp = jax.vjp(jf, jnp.asarray(x),
                              *(jnp.asarray(p[n]) for n in names))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(ga)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {n: torch.from_numpy(p[n]).requires_grad_(True) for n in names}
    y, aux = layers.moe_ffn(tx, tp, **kw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    grads = torch.autograd.grad(
        (y, aux), (tx, *(tp[n] for n in names)),
        (torch.from_numpy(gy), torch.tensor(ga)))
    for name, g, jg in zip(("x",) + names, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    g, s, _ = layers.moe_groups(t, 64, E, K, cf)
    if g * s < t:                   # the ragged tail is not routed
        assert float(grads[0][g * s:].abs().sum()) == 0.0


def _cfgs(name, **kw):
    kw = dict(dtype="float32", swa_window=64, **kw)
    return (jget_config(name).reduced().with_(use_pallas=False, **kw),
            get_config(name).reduced().with_(use_pallas=True, **kw))


def _params(jcfg):
    jp = jtransformer_bundle(jcfg).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_block_stage_and_losses_match_reference(name):
    """``moe_apply`` (x and aux) on layer 0 of the client stage, the
    client stage (smashed data and the summed aux), and the client and
    server losses with their ``MOE_AUX_COEF`` aux terms, against the
    reference, B 2 x S 128 (4 groups of 64)."""
    jcfg, cfg = _cfgs(name)
    jp, p = _params(jcfg)
    jb, b = jtransformer_bundle(jcfg), transformer_bundle(cfg, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 129), dtype=np.int32)
    x, y = tok[:, :-1], tok[:, 1:]
    jin, inp = {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
    jy, ty = jnp.asarray(y), torch.from_numpy(y)

    h = rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    jl0 = jax.tree_util.tree_map(lambda a: a[0],
                                 jp["client"]["blocks_stage"]["blocks"])
    l0 = tf_model._unstack(p["client"]["blocks_stage"]["blocks"])[0]
    jx, _, ja = jblocks.moe_apply(jcfg, jl0, jnp.asarray(h),
                                  JCtx(jcfg, "train"), None)
    tx, _, ta = blocks.moe_apply(cfg, l0, torch.from_numpy(h),
                                 Ctx(cfg, "train"), None)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)

    from repro.models import model as jmodel
    jsm, jaux, _ = jmodel.client_forward(jcfg, jp["client"], jin,
                                         JCtx(jcfg, "train"))
    sm, aux, _ = tf_model.client_forward(cfg, p["client"], inp,
                                         Ctx(cfg, "train"))
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0
    jloss, _ = jb.client_loss(jp["client"], jp["aux"], jin, jy)
    loss, _ = b.client_loss(p["client"], p["aux"], inp, ty)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    jsl = jb.server_loss(jp["server"], jsm, jy)
    sl = b.server_loss(p["server"], sm, ty)
    np.testing.assert_allclose(float(sl), float(jsl), rtol=RTOL)
    _, saux, _ = tf_model.server_forward(cfg, p["server"], sm,
                                         Ctx(cfg, "train"))
    assert float(saux) > 0          # the aux term is in the server loss
    assert abs(float(sl) - np.log(cfg.vocab_size)) < 1.0


def test_remat_with_aux_is_bitwise_the_plain_layer():
    """Two clients' losses (aux terms in) and gradients through
    ``torch.func.vmap(grad(...))``, as the clients' phase takes them:
    ``remat=True`` bitwise ``remat=False`` (loss, aux, every gradient),
    reduced olmoe cut at 2 of 4 layers."""
    _, cfg = _cfgs("olmoe-1b-7b", num_layers=4, cut_layer=2)
    _, p = _params(_cfgs("olmoe-1b-7b", num_layers=4, cut_layer=2)[0])
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1, 129),
                                        dtype=np.int32))
    cp = tree_map(lambda t: torch.stack([t, t * 1.01]), p["client"])
    ap = tree_map(lambda t: torch.stack([t, t]), p["aux"])

    def run(c):
        def loss(cpi, api, toks):
            inp, lab = {"tokens": toks[:, :-1]}, toks[:, 1:]
            smashed, aux, _ = tf_model.client_forward(c, cpi, inp,
                                                      Ctx(c, "train"))
            lo, _ = tf_model.client_loss(c, cpi, api, inp, lab,
                                         Ctx(c, "train"))
            return lo, (aux, smashed)
        f = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1),
                                            has_aux=True))
        return f(cp, ap, tok)

    (g1, (a1, s1)), (g2, (a2, s2)) = run(cfg), run(cfg.with_(remat=True))
    assert torch.equal(a1, a2) and torch.equal(s1, s2)
    assert bool((a1 > 0).all())
    l1, l2 = tree_leaves(g1), tree_leaves(g2)
    assert len(l1) == len(l2) and all(torch.equal(x, y)
                                      for x, y in zip(l1, l2))
    router = g1[0]["blocks_stage"]["blocks"]["moe"]["router"]
    assert router.dtype == torch.float32 and float(router.abs().sum()) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_convert_round_trips_the_fp32_router(name):
    """A bf16 reduced model from the reference's init: the router crosses
    as fp32, the rest as bf16, and back, bit for bit."""
    jcfg = jget_config(name).reduced()
    jp = jtransformer_bundle(jcfg).init(jax.random.PRNGKey(1))
    jnp_tree = jax.tree_util.tree_map(np.asarray, jp)
    p = params_from_numpy(jnp_tree, device="cpu")
    for stage in ("client", "server"):
        mb = p[stage]["blocks_stage"]["blocks"]["moe"]
        assert mb["router"].dtype == torch.float32
        assert mb["w1"].dtype == torch.bfloat16
    back = params_to_numpy(p)
    flat, jflat = (jax.tree_util.tree_leaves_with_path(t)
                   for t in (back, jnp_tree))
    for (path, a), (jpath, w) in zip(flat, jflat):
        assert path == jpath and a.dtype == w.dtype
        assert np.array_equal(a.view(np.uint8), w.view(np.uint8)), path
    assert bytes_of(p) == jbytes_of(jp)
