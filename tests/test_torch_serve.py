"""The port's serving path against the JAX package's, on reduced
Qwen3-0.6B (2 layers, d 256, 4 heads over 2 kv heads, hd 64, V 512) and
reduced falcon-mamba-7b (2 layers, d 256, N 16).

The reference's initial params cross over through ``repro_torch.convert``,
both sides see the same numpy tokens, and the caches cross back leaf by
leaf (``caches_to_numpy``).  Each case prefills, then decodes token by
token, holding the logits of every step and the caches after the prefill
and after the last step to the reference's:
- window 0 with the attention caches padded past the prompt;
- a window shorter than the prompt, decoding past the ring's wrap;
- ``use_pallas=True`` at S = 128, window 64: the reference's prefill
  takes K6 (Pallas, interpret mode), the port's its op (the plain version
  on the CPU); falcon-mamba's prefill takes the plain scan with its state
  in both packages (the port's K5 op is not called).
Tolerances: fp32 at rtol 1e-4 / atol 1e-5 (the dense tests': the
frameworks sum products in different orders; the worst seen is 5e-6 on
logits of magnitude 4); bf16 at rtol 2e-2 / atol 2^-4, four bf16 ulps of
the largest values (logits and cache entries reach magnitude 4, where an
ulp is 2^-6): the frameworks round bf16 at different points, and a value
that two roundings put on either side of a tie moves by an ulp at each
later rounding.  The worst seen is 0.039 (2.5 ulps).  Within the port
(decode against ``full_forward``) bf16 holds the reference's own
``tests/test_archs_smoke.py`` bound, rtol = atol = 2e-2.

Also: decode against the port's ``full_forward`` (teacher-forced), the
serving specs against the reference's, ``serve.main`` and the example on
the CPU, and the blocks still to port raising.
"""
import contextlib
import io
import re
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_config as jget_config
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro_torch.common import tree_leaves
from repro_torch.configs.base import SHAPES, shape_config
from repro_torch.configs.registry import get_config
from repro_torch.convert import (caches_from_numpy, caches_to_numpy,
                                 params_from_numpy)
from repro_torch.examples import serve_split_model
from repro_torch.kernels import ops
from repro_torch.launch import serve, specs
from repro_torch.models import blocks, model
from repro_torch.models.blocks import Ctx

ARCHS = ("qwen3-0.6b", "falcon-mamba-7b")
B, PROMPT, GEN = 2, 16, 8
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2.0 ** -4)}
SAME_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(arch, dtype, **kw):
    cfg = get_config(arch).reduced().with_(dtype=dtype, **kw)
    jcfg = jget_config(arch).reduced().with_(dtype=dtype, **kw)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, jcfg, p, jp


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _same_caches(got, want, tol):
    """The port's caches against the reference's, leaf by leaf, in the
    reference's tree and dtypes."""
    got_np = caches_to_numpy(got)
    flat = jax.tree_util.tree_leaves_with_path(want)
    mine = jax.tree_util.tree_leaves_with_path(got_np)
    assert [p for p, _ in mine] == [p for p, _ in flat]
    for (path, a), (_, w) in zip(mine, flat):
        assert a.shape == w.shape and a.dtype == w.dtype, path
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(w, np.float32),
            err_msg=jax.tree_util.keystr(path), **tol)


def _serve_pair(cfg, jcfg, p, jp, toks, window, cache_len, gen):
    """Prefill ``toks[:, :-gen]`` and decode the rest on both sides,
    checking every step's logits; returns the final caches."""
    s = toks.shape[1] - gen
    tol = TOL[cfg.dtype]
    jl, jc = jax.jit(partial(jmodel.prefill, jcfg, window=window,
                             cache_len=cache_len))(
        jp, {"tokens": jnp.asarray(toks[:, :s])})
    logits, caches = model.prefill(cfg, p, {"tokens": torch.from_numpy(
        np.ascontiguousarray(toks[:, :s]))}, window=window,
        cache_len=cache_len)
    np.testing.assert_allclose(_f32(logits), _f32(jl), **tol)
    _same_caches(caches, jc, tol)
    jdecode = jax.jit(partial(jmodel.decode_step, jcfg, window=window))
    for i in range(gen):
        pos = s + i
        jl, jc = jdecode(jp, jnp.asarray(toks[:, pos]),
                         jnp.asarray(pos, jnp.int32), jc)
        before = [t.data_ptr() for t in tree_leaves(caches)]
        logits, caches = model.decode_step(
            cfg, p, torch.from_numpy(np.ascontiguousarray(toks[:, pos])),
            pos, caches, window=window)
        # decode updates the caches in place
        assert [t.data_ptr() for t in tree_leaves(caches)] == before
        np.testing.assert_allclose(_f32(logits), _f32(jl),
                                   err_msg=f"step {i}", **tol)
    _same_caches(caches, jc, tol)
    return caches


def _tokens(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["padded", "ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, case, dtype):
    """``padded``: window 0, caches padded to prompt + gen (no wrap);
    ``ring``: window 8 on a 16-token prompt, 8 steps past the wrap (the
    Mamba blocks take no window: the same run through the ring's code)."""
    cfg, jcfg, p, jp = _setup(arch, dtype)
    toks = _tokens(cfg, PROMPT + GEN)
    window, cache_len = (0, PROMPT + GEN) if case == "padded" else (8, 0)
    caches = _serve_pair(cfg, jcfg, p, jp, toks, window, cache_len, GEN)
    if arch == "qwen3-0.6b":
        k = caches["server"]["blocks"]["k"]
        assert k.shape[2] == (PROMPT + GEN if case == "padded" else 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_prefill_takes_k6(dtype, monkeypatch):
    """S = 128, window 64, ``use_pallas=True``: the reference's prefill
    runs K6 in interpret mode, the port's calls its op once a layer; the
    ring (the trailing 64 positions) wraps at the first decode step."""
    cfg, jcfg, p, jp = _setup("qwen3-0.6b", dtype, use_pallas=True)
    calls = []
    real = ops.swa_attention

    def counted(q, k, v, window):
        calls.append((tuple(q.shape), window))
        return real(q, k, v, window)

    monkeypatch.setattr(ops, "swa_attention", counted)
    toks = _tokens(cfg, 128 + 4, seed=1)
    caches = _serve_pair(cfg, jcfg, p, jp, toks, 64, 0, 4)
    assert calls == [((B, 128, 4, 64), 64)] * cfg.num_layers
    assert caches["client"]["blocks"]["k"].shape[2] == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_takes_the_plain_scan(dtype, monkeypatch):
    """S = 128, ``use_pallas=True``: the reference's Mamba prefill takes
    the plain scan with its state, not K5; so does the port's (its K5 op
    is never called), and both agree through the decode."""
    cfg, jcfg, p, jp = _setup("falcon-mamba-7b", dtype, use_pallas=True)
    calls = []
    real = ops.ssm_scan

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "ssm_scan", counted)
    _serve_pair(cfg, jcfg, p, jp, _tokens(cfg, 128 + 4, seed=1), 0, 0, 4)
    assert not calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch, dtype):
    """As ``tests/test_archs_smoke.py::test_decode_matches_prefill``: the
    decode step's logits at position s against the port's merged model on
    s + 1 tokens, teacher-forced (a cache padded past s, so the ring does
    not evict position 0)."""
    cfg = get_config(arch).reduced().with_(dtype=dtype)
    params = serve.draw_params(cfg, 2, "cpu")
    s = 16
    toks = torch.from_numpy(_tokens(cfg, s + 1))
    _, caches = model.prefill(cfg, params, {"tokens": toks[:, :s]},
                              cache_len=s + 8)
    logits_d, _ = model.decode_step(cfg, params, toks[:, s], s, caches)
    with torch.no_grad():
        x = model.full_forward(cfg, params, {"tokens": toks},
                               Ctx(cfg, "train"))
        logits_f = model.server_logits_fn(cfg, params["server"])(
            x[:, -1:, :])[:, 0]
    np.testing.assert_allclose(_f32(logits_d), _f32(logits_f),
                               **SAME_TOL[dtype])


def _spec_sig(tree):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_leaves(tree)]


def _jspec_sig(tree):
    return [(tuple(a.shape), str(jnp.dtype(a.dtype)))
            for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, shape):
    """``prefill_specs``, ``decode_specs`` (meta tensors) and
    ``combo_supported`` at full width: shapes, dtypes and the window
    equal to the reference's, the caches in its tree."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    sc, jsc = shape_config(shape), JSHAPES[shape]
    assert (sc.seq_len, sc.global_batch, sc.kind) == \
        (jsc.seq_len, jsc.global_batch, jsc.kind)
    assert specs.combo_supported(cfg, sc) == jspecs.combo_supported(jcfg,
                                                                    jsc)
    got = specs.prefill_specs(cfg, sc)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert _spec_sig(got) == _jspec_sig(jspecs.prefill_specs(jcfg, jsc))
    token, pos, caches, window = specs.decode_specs(cfg, sc)
    jtoken, jpos, jcaches, jwindow = jspecs.decode_specs(jcfg, jsc)
    assert window == jwindow
    assert _spec_sig((token, pos)) == _jspec_sig((jtoken, jpos))
    assert jax.tree_util.tree_structure(caches_to_numpy(
        model.init_decode_caches(cfg.reduced(), 1, 2, device="cpu"))) \
        == jax.tree_util.tree_structure(jmodel.init_decode_caches(
            jcfg.reduced(), 1, 2))
    assert _spec_sig(caches) == _jspec_sig(jcaches)


@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_decode_specs_as_arrays(arch):
    """``long_500k`` materialized on the reduced configs: B = 1, the
    ring the window (Qwen3), pos 524,287, the tokens the reference's
    numpy draw; then one decode step on them, finite."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    sc = SHAPES["long_500k"]
    token, pos, caches, window = specs.decode_specs(cfg, sc, as_spec=False,
                                                    device="cpu")
    jtoken, jpos, jcaches, jwindow = jspecs.decode_specs(
        jcfg, JSHAPES["long_500k"], as_spec=False)
    assert window == jwindow == (4096 if arch == "qwen3-0.6b" else 0)
    assert np.array_equal(token.numpy(), np.asarray(jtoken))
    assert int(pos) == int(jpos) == 524_287 and pos.dtype == torch.int32
    assert _spec_sig(caches) == _jspec_sig(jcaches)
    assert not any(t.any() for t in tree_leaves(caches))
    params = serve.draw_params(cfg, 0, "cpu")
    logits, _ = model.decode_step(cfg, params, token, pos, caches,
                                  window=window)
    assert logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()


def _line_shapes(text):
    """The printed lines with their numbers taken out."""
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in text.splitlines()]


def test_serve_main_prints_the_reference_lines(monkeypatch):
    """``serve.main`` on the CPU prints the reference ``main``'s lines
    (a line a batch, then the total), numbers aside."""
    argv = ["--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--num-batches", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = serve.main(argv + ["--device", "cpu"])
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jserve.main()
    assert _line_shapes(out.getvalue()) == _line_shapes(jout.getvalue())
    assert out.getvalue().splitlines()[0].startswith("batch 0: 8 tokens in ")


def test_serve_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        serve.main(["--num-batches", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_serving_fns(get_config("qwen3-0.6b").reduced())


def test_example_serves_both_archs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = serve_split_model.main(["--device", "cpu", "--batch", "2",
                                       "--prompt-len", "8", "--gen", "4"])
    assert set(toks) == set(ARCHS)
    for arch, t in toks.items():
        cfg = get_config(arch).reduced()
        assert t.shape == (2, 4)
        assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
    lines = out.getvalue().splitlines()
    assert [ln.split("]")[0] + "]" for ln in lines if ln.startswith("[")] \
        == [f"[{a}]" for a in ARCHS]


def test_cache_converters_round_trip_bitwise():
    """A bf16 and fp32 cache tree: numpy (``ml_dtypes`` bf16) and back,
    bit for bit."""
    cfg = get_config("falcon-mamba-7b").reduced()
    params = serve.draw_params(cfg, 0, "cpu")
    _, caches = model.prefill(cfg, params, {"tokens": torch.from_numpy(
        _tokens(cfg, 8))})
    back = caches_from_numpy(caches_to_numpy(caches), device="cpu")
    assert [t.dtype for t in tree_leaves(back)] == \
        [torch.bfloat16, torch.float32] * 2
    for a, b in zip(tree_leaves(caches), tree_leaves(back)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["moe", "mamba2"])
def test_unported_blocks_raise(kind):
    """The two block kinds whose cache specs raised until they were
    ported, ``moe`` (its decode cache is the attention's) and ``mamba2``
    (the conv window over the din + 2N channels and the fp32 SSD state
    ``[B, H, N, P]``): olmoe-1b-7b's and zamba2-7b's specs at B 4 and
    4,096 slots equal the reference's, shapes, dtypes and tree."""
    from repro.models import blocks as jblocks
    arch = {"moe": "olmoe-1b-7b", "mamba2": "zamba2-7b"}[kind]
    got = blocks.block_cache_spec(get_config(arch), kind, 4, 4096,
                                  torch.bfloat16)
    want = jblocks.block_cache_spec(jget_config(arch), kind, 4, 4096,
                                    jnp.bfloat16)
    assert sorted(got) == sorted(want)
    assert _spec_sig(got) == _jspec_sig(want) == {
        "moe": [((4, 4096, 16, 128), "bfloat16")] * 2,
        "mamba2": [((4, 3, 7296), "bfloat16"),
                   ((4, 112, 64, 64), "float32")]}[kind]
