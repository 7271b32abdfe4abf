"""Layer recompute (``cfg.remat``): ``models.model.Remat`` against the plain
layers in the port, and the port with remat against the JAX package with
``remat=True`` (``jax.checkpoint`` of its scan body).

Setup on both sides: ``get_config(arch).reduced()`` then ``remat=True,
num_layers=4, cut_layer=2`` (two layers a stage), fp32, ``use_pallas=True``
(the port's kernel Functions with their plain versions inside, the JAX
side's Pallas kernels in interpret mode), ``swa_window=64``, S=128, B=1,
n=2 clients, h=2, two rounds, one intra-op thread.

- Recompute changes memory only: the port's state, history and meter with
  remat equal those without it bit for bit, through ``Trainer.run`` for
  the four methods (the clients' ``vmap(grad(...))`` and the blocking
  methods' ``vjp`` pull under ``vmap`` both go through the Function) and
  through ``run_compiled``.
- The clients still fold into one kernel call: with remat each kernel
  forward (K6, K5) runs once more per backward (the rerun), every client
  call with the clients folded into its batch, and the backward calls are
  the same as without remat.
- Against the reference with ``remat=True``, from its converted initial
  state: per-round losses at rtol 1e-4 and final params at rtol 1e-4 /
  atol 1e-5, as ``test_torch_cse_fsl_lm.py`` holds the plain layers (fp32
  sums in other orders); meter and flags identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.launch.train import LMBatcher as JLMBatcher
from repro.launch.train import build_data as jbuild_data
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.trainer import Trainer
from repro_torch.kernels import ssm_scan as ssm_mod
from repro_torch.kernels import swa_attention as swa_mod
from repro_torch.launch.train import LMBatcher, build_data

ARCHS = ("qwen3-0.6b", "falcon-mamba-7b")
METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
N, H, B, S, ROUNDS, SAMPLES = 2, 2, 1, 128, 2, 4
KW = dict(dtype="float32", use_pallas=True, swa_window=64, num_layers=4,
          cut_layer=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(arch, remat):
    return get_config(arch).reduced().with_(remat=remat, **KW)


def _fsl(method):
    return FSLConfig(num_clients=N, h=H, lr=0.1, method=method,
                     grad_clip=1.0 if method == "fsl_oc" else 0.0)


def _run(arch, method, remat, compiled=False, state=None):
    cfg = _cfg(arch, remat)
    fed = build_data(cfg, _fsl(method), S, SAMPLES, non_iid=False, seed=0)
    tr = Trainer(transformer_bundle(cfg, device="cpu"), _fsl(method))
    batcher = LMBatcher(cfg, fed, B, H, seed=0)
    state = tr.init(0) if state is None else state
    if compiled:
        return tr.run_compiled(state, batcher, ROUNDS, chunk=ROUNDS,
                               log_every=1)
    return tr.run(state, batcher, ROUNDS, log_every=1)


def _assert_bitwise(a, b):
    (sa, ha), (sb, hb) = a, b
    assert sa["round"] == sb["round"] and ha == hb and len(ha) == ROUNDS
    la, lb = state_leaves(sa), state_leaves(sb)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_configs_set_remat_as_the_reference():
    for arch in ARCHS:
        assert get_config(arch).remat is jget_config(arch).remat is True
        assert get_config(arch).reduced().remat is False
        assert jget_config(arch).reduced().remat is False


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_run_is_bitwise_the_plain_run(arch, method):
    _assert_bitwise(_run(arch, method, False), _run(arch, method, True))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_run_compiled_is_bitwise_the_plain_run(arch):
    _assert_bitwise(_run(arch, "cse_fsl", False),
                    _run(arch, "cse_fsl", True, compiled=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_reruns_the_forward_with_the_clients_folded(arch,
                                                          monkeypatch):
    """One CSE-FSL round: each forward kernel call of a recomputed layer is
    made once more in its backward, with the clients folded (batch n * B)
    in the client phase; the backward calls do not change."""
    fwd_mod, fwd, bwd = (swa_mod, "swa_attention_fwd", "swa_attention_bwd") \
        if arch == "qwen3-0.6b" else (ssm_mod, "ssm_scan_fwd", "ssm_scan_bwd")
    seen = {}
    for remat in (False, True):
        calls = {"fwd": [], "bwd": []}
        for key, name in (("fwd", fwd), ("bwd", bwd)):
            real = getattr(fwd_mod, name)

            def spy(*a, _real=real, _key=key, **k):
                calls[_key].append(a[0].shape[0])
                return _real(*a, **k)
            monkeypatch.setattr(fwd_mod, name, spy)
        cfg = _cfg(arch, remat)
        fsl = _fsl("cse_fsl")
        fed = build_data(cfg, fsl, S, SAMPLES, non_iid=False, seed=0)
        tr = Trainer(transformer_bundle(cfg, device="cpu"), fsl)
        tr.run(tr.init(0), LMBatcher(cfg, fed, B, H, seed=0), 1)
        monkeypatch.undo()
        seen[remat] = calls
    cut, srv = 2, 2
    # without remat: h vmapped client steps and the smashed pass (cut layers
    # each, n * B rows), then n server updates (srv layers, B rows)
    want_fwd = [N * B] * cut * (H + 1) + [B] * srv * N
    want_bwd = [N * B] * cut * H + [B] * srv * N
    assert sorted(seen[False]["fwd"]) == sorted(want_fwd)
    assert sorted(seen[False]["bwd"]) == sorted(want_bwd)
    assert sorted(seen[True]["bwd"]) == sorted(want_bwd)
    assert sorted(seen[True]["fwd"]) == sorted(want_fwd + want_bwd)


def _jstate_and_run(arch, method):
    jcfg = jget_config(arch).reduced().with_(remat=True, **KW)
    jfsl = JFSLConfig(num_clients=N, h=H, lr=0.1, method=method,
                      grad_clip=1.0 if method == "fsl_oc" else 0.0)
    jtr = JTrainer(jtransformer_bundle(jcfg), jfsl, donate=False)
    jstate = jtr.init(0)
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu", method=method)
    jfed = jbuild_data(jcfg, jfsl, S, SAMPLES, False)
    jstate, jhist = jtr.run(jstate, JLMBatcher(jcfg, jfed, B, H), ROUNDS,
                            log_every=1)
    return state0, jstate, jhist


@pytest.mark.parametrize("arch,method", [
    ("qwen3-0.6b", "cse_fsl"), ("falcon-mamba-7b", "cse_fsl"),
    ("qwen3-0.6b", "fsl_mc")])
def test_remat_matches_reference_remat(arch, method):
    state0, jstate, jhist = _jstate_and_run(arch, method)
    state, hist = _run(arch, method, True, state=state0)
    assert len(hist) == len(jhist) == ROUNDS
    for row, jrow in zip(hist, jhist):
        assert row["round"] == jrow["round"]
        assert row["aggregated"] == jrow["aggregated"]
        for k in jrow:
            if k.endswith("loss"):
                np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4,
                                           err_msg=f"round {row['round']} "
                                                   f"{k}")
    got = state_to_numpy(state, method=method)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    for key in ("clients", "server", "servers"):
        if key not in want:
            continue
        pairs = zip(jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                    jax.tree_util.tree_leaves_with_path(want[key]["params"]))
        for (path, a), (wpath, w) in pairs:
            assert path == wpath
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
