"""The port's sliding-window attention backward (K6's gradient) and the
forward's lse residual, against the JAX package: ``ops.swa_attention``'s
grads against ``jax.vjp`` of ``repro.kernels.ops.swa_attention`` (its
Pallas forward in interpret mode, its backward ``jax.vjp`` of the
reference), at hd 16, 64 and 112, with GQA, windows shorter than S and
ragged S.

On the CPU the autograd Functions run the plain forward (which also gives
the base-2 lse) and the plain backward; the CUDA kernels (delta, dK/dV,
dQ) are held against them on the card by ``chip_smoke.py`` phase 7.
Tolerances: fp32 grads 1e-4 relative, 1e-5 absolute, as
``tests/test_torch_swa.py`` (the two backwards sum in other orders); lse
1e-5 (both are fp32 logsumexps of the same scores).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swa_attention as K

ROOT = Path(__file__).resolve().parents[1]
# (B, S, H, KH, hd, window): hd 16 with a window; hd 64, GQA rep 2; hd 112
# (zamba2-7b's heads), GQA; ragged S (the JAX kernel's tile is then S)
# with W < S and with W > S
CASES = [(1, 128, 2, 2, 16, 32), (1, 256, 4, 2, 64, 200),
         (1, 128, 4, 2, 112, 128), (2, 100, 4, 2, 112, 37),
         (1, 96, 2, 1, 64, 200)]


def _arrays(b, s, h, kh, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, kh, kh))
    g = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("b,s,h,kh,hd,window", CASES)
def test_grads_match_jax_vjp(b, s, h, kh, hd, window):
    q, k, v, g = _arrays(b, s, h, kh, hd, seed=20)
    tg = torch.from_numpy(g)
    got = grad(lambda *a: (ops.swa_attention(*a, window) * tg).sum(),
               argnums=(0, 1, 2))(*(torch.from_numpy(a) for a in (q, k, v)))
    _, vjp = jax.vjp(lambda *a: jops.swa_attention(*a, window),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for name, x, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _jax_lse2(q, k, window):
    """Base-2 logsumexp of the reference's masked scaled scores."""
    b, s, h, hd = q.shape
    kr = jnp.repeat(jnp.asarray(k), h // k.shape[2], axis=2)
    sc = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kr) / np.sqrt(hd)
    qp, kp = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    sc = jnp.where(jnp.asarray(mask), sc, -jnp.inf)
    return jax.nn.logsumexp(sc, axis=-1) * np.log2(np.e)


@pytest.mark.parametrize("b,s,h,kh,hd,window", CASES)
def test_cpu_lse_is_logsumexp_of_the_reference_scores(b, s, h, kh, hd,
                                                      window):
    """The forward's residual on the CPU: ``[B, H, S]`` fp32, base 2, and
    its o the plain forward's bit for bit."""
    q, k, v, _ = _arrays(b, s, h, kh, hd, seed=21)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = K.swa_attention_fwd(tq, tk, tv, window)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse2(q, k,
                                                                 window)),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(o, ref.swa_attention(tq, tk, tv, window))
    o2, lse2 = ops.SWAttention.apply(tq, tk, tv, window)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_vmap_folds_clients_into_one_backward_call(monkeypatch):
    """``vmap(grad)`` over 3 clients reaches the backward wrapper once,
    with the clients folded into B (q, o and g ``[6, S, H, hd]``, lse
    ``[6, H, S]``), and equals the plain backward of each client."""
    rng = np.random.default_rng(22)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (3, 2, 128, n, 16)).astype(np.float32)) for n in (4, 2, 2))
    tw = torch.from_numpy(rng.standard_normal((2, 128, 4, 16)).astype(
        np.float32))
    calls = []
    bwd = K.swa_attention_bwd

    def spy(q_, k_, v_, o_, lse_, g_, window):
        calls.append((tuple(q_.shape), tuple(k_.shape), tuple(o_.shape),
                      tuple(lse_.shape), tuple(g_.shape)))
        return bwd(q_, k_, v_, o_, lse_, g_, window)

    monkeypatch.setattr(K, "swa_attention_bwd", spy)

    def loss(q_, k_, v_):
        return (ops.swa_attention(q_, k_, v_, 48) * tw).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    assert calls == [((6, 128, 4, 16), (6, 128, 2, 16), (6, 128, 4, 16),
                      (6, 4, 128), (6, 128, 4, 16))]
    g = tw.expand(3, *tw.shape)
    for i in range(3):
        want = ref.swa_attention_bwd(q[i], k[i], v[i], g[i], 48)
        for x, w in zip(got, want):
            np.testing.assert_allclose(x[i].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_cpu_backward_is_the_plain_backward_and_counts_nothing():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(1, 128, 4, 2, 64,
                                                       seed=23))
    o, lse = K.swa_attention_fwd(q, k, v, 100)
    K.reset_launches()
    got = K.swa_attention_bwd(q, k, v, o, lse, g, 100)
    want = ref.swa_attention_bwd(q, k, v, g, 100)
    assert all(torch.equal(x, w) for x, w in zip(got, want))
    assert not any(K.LAUNCHES.values())


def test_plain_delta_is_rowsum_of_g_times_o():
    rng = np.random.default_rng(24)
    o, g = (rng.standard_normal((2, 50, 3, 112)).astype(np.float32)
            for _ in range(2))
    got = ref.swa_attention_bwd_delta(torch.from_numpy(o),
                                      torch.from_numpy(g))
    assert got.shape == (2, 3, 50) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(),
                               (g * o).sum(-1).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hd", [(1, 128), (4, 128), (1, 112), (2, 64)])
def test_meta_inputs_give_shapes_and_count_nothing(b, hd):
    """At the Qwen3 main path's shapes (one sequence, 4 folded clients),
    zamba2-7b's hd 112 and hd 64, meta inputs give every output's shape
    and dtype through the wrappers and the op, and launch nothing."""
    h, kh, s = 16, 8, 4096
    K.reset_launches()
    q = torch.empty((b, s, h, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, kh, hd), dtype=torch.bfloat16, device="meta")
    o, lse = K.swa_attention_fwd(q, k, k, 4096)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    dq, dk, dv = K.swa_attention_bwd(q, k, k, o, lse, q, 4096)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}
    assert {t.device.type for t in (o, lse, dq, dk, dv)} == {"meta"}
    o2, lse2 = ops.SWAttention.apply(q, k, k, 4096)
    assert o2.shape == q.shape and lse2.shape == (b, h, s)
    assert not any(K.LAUNCHES.values())


def test_backward_checks_its_residual_shapes():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(1, 64, 4, 2, 16,
                                                       seed=25))
    o, lse = K.swa_attention_fwd(q, k, v, 32)
    with pytest.raises(ValueError, match="lse"):
        K.swa_attention_bwd(q, k, v, o, lse[:, :2], g, 32)
    with pytest.raises(ValueError, match="KH"):
        K.swa_attention_bwd(q, k[:, :32], v, o, lse, g, 32)


@pytest.mark.parametrize("dtype,hd,kernels", [
    (torch.bfloat16, 128, True),      # the dense models' main path
    (torch.bfloat16, 112, True),      # zamba2-7b
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 32, False),
    (torch.bfloat16, 16, False),
    (torch.float32, 128, False),      # phase 9's fp32 run
    (torch.float32, 112, False),
    (torch.float32, 64, False),
    (torch.float32, 16, False)])
def test_bwd_kernel_for_routes_as_the_forward(dtype, hd, kernels):
    """Where the forward takes the tensor-core kernel the backward takes
    the three kernels, elsewhere the plain backward under its own launch
    key; every name is a launch counter."""
    names = K.bwd_kernel_for(dtype, hd)
    assert names == (K.BWD_KERNELS if kernels else (K.BWD_PLAIN,))
    assert (K.kernel_for(dtype, hd) == "swa_attention_tc") == kernels
    assert all(n in K.LAUNCHES for n in names)


def _chip_smoke_maps():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    maps = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and getattr(node.targets[0], "id", None) in ("REPLACES",
                                                             "SOURCE"):
            maps[node.targets[0].id] = ast.literal_eval(node.value)
    return maps


def test_launch_keys_agree_with_chip_smoke_records():
    """Every kernel key of ``swa_attention.LAUNCHES`` (all but the plain
    backward's) has a ``REPLACES`` and a ``SOURCE`` entry in
    ``chip_smoke.py`` and no other attention key has one; the sources are
    ``swa_attention.cu`` and the replaced lines are the JAX package's
    ``pl.pallas_call`` of K6 and its ``_swa_bwd``."""
    maps = _chip_smoke_maps()
    kernels = set(K.LAUNCHES) - {K.BWD_PLAIN}
    for name in ("REPLACES", "SOURCE"):
        assert {k for k in maps[name] if k.startswith("swa_")} == kernels
    assert {maps["SOURCE"][k] for k in kernels} == {"swa_attention.cu"}
    assert (ROOT / "src/repro_torch/kernels/csrc/swa_attention.cu").exists()
    for k in kernels:
        path, line = maps["REPLACES"][k].split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        want = "def _swa_bwd(" if k in K.BWD_KERNELS else "pl.pallas_call("
        assert want in text, (k, text)
