"""The port's sliding-window attention op (K6; on the CPU its plain forward
and backward) against the JAX package's ``repro.kernels.ops.swa_attention``
(Pallas, interpret mode) at the four cases of ``tests/test_kernels.py``.

On the CPU the autograd Function runs the plain forward; the CUDA kernel is
held against it on the card by ``chip_smoke.py``.  Tolerances: fp32 2e-5
on the output (``tests/test_kernels.py``), 1e-4 / 1e-5 on fp32 grads (the
backward's reordered sums), bf16 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels import ops as jops
from repro.models.layers import attention as jattention
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swa_attention as K
from repro_torch.models.layers import attention

CASES = [(1, 128, 2, 2, 16, 32), (1, 256, 4, 2, 32, 64),
         (2, 128, 4, 1, 16, 128), (1, 256, 2, 2, 64, 200)]


def _qkv(b, s, h, kh, hd, seed=6, lead=()):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(lead + (b, s, n, hd)).astype(np.float32)
            for n in (h, kh, kh)]


def _loss_weights(shape, seed=9):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,s,h,kh,hd,window", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(b, s, h, kh, hd, window, dtype):
    qkv = _qkv(b, s, h, kh, hd)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ops.swa_attention(*(torch.from_numpy(a).to(tdt) for a in qkv),
                            window)
    want = jops.swa_attention(*(jnp.asarray(a).astype(jdt) for a in qkv),
                              window)
    assert got.dtype == tdt
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,s,h,kh,hd,window", CASES)
def test_grads_match_reference(b, s, h, kh, hd, window):
    qkv = _qkv(b, s, h, kh, hd, seed=7)
    wt = _loss_weights((b, s, h, hd))
    tw, jw = torch.from_numpy(wt), jnp.asarray(wt)
    got = grad(lambda *a: (ops.swa_attention(*a, window) * tw).sum(),
               argnums=(0, 1, 2))(*(torch.from_numpy(a) for a in qkv))
    want = jax.grad(lambda *a: (jops.swa_attention(*a, window) * jw).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in qkv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_vmap_folds_clients_into_the_batch(monkeypatch):
    """``vmap(grad)`` over 3 clients reaches the kernel wrapper once, with
    the clients folded into B, and equals 3 separate calls."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(2, 128, 4, 2, 16, seed=8, lead=(3,)))
    calls = []
    fwd = K.swa_attention_fwd

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return fwd(*args)

    monkeypatch.setattr(K, "swa_attention_fwd", spy)
    tw = torch.from_numpy(_loss_weights((2, 128, 4, 16)))

    def loss(q_, k_, v_):
        return (ops.swa_attention(q_, k_, v_, 48) * tw).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    assert calls == [(6, 128, 4, 16)]
    for i in range(3):
        want = grad(lambda *a: (ref.swa_attention(*a, 48) * tw).sum(),
                    argnums=(0, 1, 2))(q[i], k[i], v[i])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)
    K.reset_launches()
    out = ops.swa_attention(*(t[0].to("meta") for t in (q, k, v)), 48)
    assert out.shape == q.shape[1:] and out.device.type == "meta"
    assert not any(K.LAUNCHES.values())


def test_window_covering_sequence_is_causal_attention():
    q, k, v = _qkv(1, 128, 4, 2, 32, seed=10)
    got = ops.swa_attention(*(torch.from_numpy(a) for a in (q, k, v)), 256)
    want = attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    jwant = jattention(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "swa_attention_tc"),   # every model's main path
    (torch.bfloat16, 64, "swa_attention_tc"),
    (torch.bfloat16, 112, "swa_attention_tc"),   # zamba2-7b's heads
    (torch.bfloat16, 32, "swa_attention"),
    (torch.bfloat16, 16, "swa_attention"),
    (torch.float32, 112, "swa_attention"),
    (torch.float32, 128, "swa_attention"),       # the fp32 fidelity path
    (torch.float32, 64, "swa_attention"),
    (torch.float32, 32, "swa_attention"),
    (torch.float32, 16, "swa_attention")])
def test_kernel_for_picks_by_dtype_and_head_width(dtype, hd, want):
    """bf16 at hd 64, 112 or 128 takes the tensor-core kernel, fp32 and
    the narrow heads the CUDA-core one, which has an instance of every
    head width; each name is a launch counter."""
    assert K.kernel_for(dtype, hd) == want
    assert want in K.LAUNCHES
    assert hd in K.HEAD_DIMS


def test_meta_inputs_give_shapes_and_count_nothing():
    """At the Qwen3 main path's shapes (bf16, 16 q / 8 kv heads of 128,
    S = 4096, 4 folded clients) meta inputs give the output's shape and
    dtype and launch nothing, through the wrapper and the op."""
    K.reset_launches()
    q = torch.empty((4, 4096, 16, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 4096, 8, 128), dtype=torch.bfloat16, device="meta")
    for out in (K.swa_attention_fwd(q, k, k, 4096)[0],
                ops.swa_attention(q, k, k, 4096)):
        assert out.shape == q.shape and out.dtype == q.dtype
        assert out.device.type == "meta"
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_width_112_matches_reference(dtype):
    """zamba2-7b's head width (3584 / 32 = 112), windowed, with GQA: the
    port's op equals the JAX package's Pallas kernel (interpret mode) at
    the tolerances of ``tests/test_kernels.py``, and ``meta`` inputs give
    the shape and launch nothing."""
    qkv = _qkv(1, 256, 4, 2, 112, seed=11)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ops.swa_attention(*(torch.from_numpy(a).to(tdt) for a in qkv), 96)
    want = jops.swa_attention(*(jnp.asarray(a).astype(jdt) for a in qkv), 96)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    assert got.dtype == tdt and got.shape == (1, 256, 4, 112)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    K.reset_launches()
    q = torch.empty((1, 4096, 32, 112), dtype=torch.bfloat16, device="meta")
    assert K.swa_attention_fwd(q, q, q, 4096)[0].shape == q.shape
    assert not any(K.LAUNCHES.values())
