"""Serving the VLM (qwen2-vl-72b, reduced: 2 layers, d 256, 4 heads over 2
kv heads, hd 64, sections (8, 12, 12), 8 image positions, V 512), the
port against the JAX package.

The reference's params cross over through ``repro_torch.convert``, both
sides see the same numpy tokens and image embeddings, and the caches
cross back leaf by leaf.  Prefill of a prompt of 16 with its 8 image
positions, then decode token by token (``pos`` a 0-d tensor, as the
captured decode passes it; the vlm's zero-width ``image_embeds``): the
logits of every step and the caches after the prefill and after the last
step against the reference's, in fp32 at rtol 1e-4 / atol 1e-5 (the
serving tests' bound) with the caches padded past the prompt and with a
window of 8 that the ring wraps past.  Also: decode against the port's
``full_forward`` on the whole sequence (teacher-forced), a prompt shorter
than the image (decode positions inside the patch grid), and
``serve.main`` on the CPU drawing the image embeddings after the tokens,
its tokens the greedy ones of ``prefill`` and ``decode_step``.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import model as jmodel
from repro_torch.configs.registry import get_config
from repro_torch.convert import caches_to_numpy, params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.blocks import Ctx

NAME = "qwen2-vl-72b"
B, PROMPT, GEN = 2, 16, 6
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(**kw):
    cfg = get_config(NAME).reduced().with_(dtype="float32", **kw)
    jcfg = jget_config(NAME).reduced().with_(dtype="float32", **kw)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, jcfg, p, jp


def _inputs(cfg, total, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, total), dtype=np.int32)
    img = rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model)).astype(
        np.float32)
    return toks, img


def _caches_close(got, want):
    g = jax.tree_util.tree_leaves_with_path(caches_to_numpy(got))
    w = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=jax.tree_util.keystr(path),
                                   **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_match_reference(window):
    cfg, jcfg, p, jp = _setup()
    toks, img = _inputs(cfg, PROMPT + GEN)
    cache_len = 0 if window else PROMPT + GEN
    jlog, jc = jmodel.prefill(
        jcfg, jp, {"tokens": jnp.asarray(toks[:, :PROMPT]),
                   "image_embeds": jnp.asarray(img)},
        window=window, cache_len=cache_len)
    log, c = model.prefill(
        cfg, p, {"tokens": torch.from_numpy(toks[:, :PROMPT]),
                 "image_embeds": torch.from_numpy(img)},
        window=window, cache_len=cache_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _caches_close(c, jc)
    jdec = jax.jit(lambda pp, t, pos, cc: jmodel.decode_step(
        jcfg, pp, t, pos, cc, window=window))
    for i in range(GEN):
        pos = PROMPT + i
        jlog, jc = jdec(jp, jnp.asarray(toks[:, pos]), jnp.asarray(pos), jc)
        log, c = model.decode_step(cfg, p, torch.from_numpy(toks[:, pos]),
                                   torch.tensor(pos), c, window=window)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   err_msg=f"step {i}", **TOL)
    _caches_close(c, jc)


@pytest.mark.parametrize("prompt", [PROMPT, 4])
def test_decode_matches_full_forward(prompt):
    """Teacher-forced: the last decode step's logits against the merged
    model's on the whole sequence with the same image embeddings.  A
    prompt of 4 decodes positions 4..7 inside the 8 image positions
    (their patch-grid streams), then the text positions."""
    cfg, _, p, _ = _setup()
    gen = 6 if prompt == 4 else GEN
    toks, img = _inputs(cfg, prompt + gen, seed=1)
    t = torch.from_numpy(toks)
    im = torch.from_numpy(img)
    if prompt < cfg.num_image_tokens:
        # a prompt shorter than the image carries that many image rows;
        # the decoded tokens stand at the grid's later positions
        pre = {"tokens": t[:, :prompt], "image_embeds": im[:, :prompt]}
        full_img = im[:, :prompt]
    else:
        pre = {"tokens": t[:, :prompt], "image_embeds": im}
        full_img = im
    _, c = model.prefill(cfg, p, pre, cache_len=prompt + gen)
    for i in range(gen):
        log, c = model.decode_step(cfg, p, t[:, prompt + i],
                                   torch.tensor(prompt + i), c)
    x = model.full_forward(cfg, p, {"tokens": t, "image_embeds": full_img},
                           Ctx(cfg, "train"))
    want = model.server_logits_fn(cfg, p["server"])(x[:, -1:])[:, 0]
    np.testing.assert_allclose(log.numpy(), want.numpy(), **TOL)


def test_serve_main_draws_the_image_after_the_tokens():
    """``serve.main`` on reduced qwen2-vl (bf16, as ``--size reduced``
    gives it): its tokens the greedy tokens of ``prefill`` and
    ``decode_step`` on the reference's draws in its order (the tokens,
    then the image embeddings)."""
    argv = ["--arch", NAME, "--batch", "2", "--prompt-len", "12", "--gen",
            "4", "--num-batches", "1", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        toks = serve.main(argv)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    cfg = get_config(NAME).reduced()
    params = serve.draw_params(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12),
                                           dtype=np.int32))
    img = torch.from_numpy(rng.normal(size=(2, cfg.num_image_tokens,
                                            cfg.d_model)).astype(np.float32))
    logits, c = model.prefill(cfg, params, {"tokens": prompt,
                                            "image_embeds": img},
                              cache_len=16)
    want = [logits.argmax(-1).to(torch.int32)]
    for i in range(3):
        logits, c = model.decode_step(cfg, params, want[-1], 12 + i, c)
        want.append(logits.argmax(-1).to(torch.int32))
    assert torch.equal(toks, torch.stack(want, 1))
