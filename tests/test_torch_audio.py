"""The audio family (hubert-xlarge) on the CPU, the port against the JAX
package: the frame frontend, encoder-only (non-causal) attention, the
504-class heads, and the entry points that refuse it.

- ``reduced()`` field by field; ``param_specs`` against the reference's
  leaves and bytes (``frontend_w``/``frontend_b``, no ``embed``).
- One encoder block (fp32) against the reference's, and its attention
  non-causal: a change at the last frame moves the first frame's output.
- One CSE-FSL round of reduced hubert (fp32) through ``make_round_step``
  from the reference's converted initial state on ``train_batch_specs``
  features (seed 0): metrics and params at rtol 1e-4 (an atol of 1e-5 of
  each leaf's largest magnitude); and in bf16, the reference given the
  features in bf16 (the port casts them to the parameters' dtype).
- The int8 uplink and int8 model sync: ``CommProfile`` equal to the
  reference's to the byte (the frontend leaves among the synced ones);
  ``run_compiled`` on staged features bitwise ``Trainer.run``, its meter
  CommProfile's.
- The training CLI: the reference dies with ``KeyError: 'features'``, the
  port refuses with a message naming it; ``serve.main`` refuses the
  encoder-only model in both packages.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import bytes_of as jbytes_of
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.methods.cse_fsl import init_state as jinit_state
from repro.core.methods.cse_fsl import make_round_step as jmake_round_step
from repro.core.trainer import Trainer as JTrainer
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import blocks as jblocks
from repro.models.model import abstract_params as jabstract_params
from repro_torch.common import bytes_of
from repro_torch.configs.base import SHAPES, FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, state_from_numpy, \
    state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.methods.cse_fsl import make_round_step
from repro_torch.core.trainer import Trainer
from repro_torch.launch import serve, specs, train
from repro_torch.models import blocks
from repro_torch.models.model import param_specs

NAME = "hubert-xlarge"
RTOL = 1e-4
N, H, B, S = 2, 2, 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shape(global_batch=N * B, seq=S, port=True):
    return dataclasses.replace((SHAPES if port else JSHAPES)["train_4k"],
                               seq_len=seq, global_batch=global_batch)


def test_reduced_config_field_by_field():
    want = dataclasses.asdict(jget_config(NAME).reduced())
    want.pop("dryrun_unroll")
    got = dataclasses.asdict(get_config(NAME).reduced())
    assert got == want
    assert (got["frontend_dim"], got["vocab_size"], got["causal"],
            got["encoder_only"]) == (64, 504, False, True)
    full = dataclasses.asdict(get_config(NAME))
    assert full.items() <= dataclasses.asdict(jget_config(NAME)).items()


@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_reference(reduced):
    jcfg, cfg = jget_config(NAME), get_config(NAME)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = jabstract_params(jcfg)
    got = param_specs(cfg)
    wl = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
          for p, x in jax.tree_util.tree_leaves_with_path(want)}
    gl = {jax.tree_util.keystr(p): (tuple(x.shape),
                                    str(x.dtype).split(".")[-1])
          for p, x in jax.tree_util.tree_leaves_with_path(
              got, is_leaf=lambda t: isinstance(t, torch.Tensor))}
    assert gl == wl
    for k in ("client", "aux", "server"):
        assert bytes_of(got[k]) == jbytes_of(want[k])
    assert "frontend_w" in got["client"] and "embed" not in got["client"]
    assert tuple(got["client"]["frontend_w"].shape) == (
        cfg.frontend_dim, cfg.d_model)


def test_encoder_block_matches_reference_and_is_non_causal():
    jcfg = jget_config(NAME).reduced().with_(dtype="float32")
    cfg = get_config(NAME).reduced().with_(dtype="float32", use_pallas=True)
    jp = jblocks.dense_init(jcfg, jax.random.PRNGKey(5), jnp.float32)
    p = params_from_numpy({"b": jax.tree_util.tree_map(np.asarray, jp)},
                          device="cpu")["b"]
    x = np.random.default_rng(2).normal(size=(2, 128, 256)).astype(
        np.float32)
    want, _, _ = jblocks.dense_apply(jcfg, jp, jnp.asarray(x),
                                     jblocks.Ctx(jcfg, "train"), None)
    got, _, _ = blocks.dense_apply(cfg, p, torch.from_numpy(x),
                                   blocks.Ctx(cfg, "train"), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved, _, _ = blocks.dense_apply(cfg, p, torch.from_numpy(x2),
                                     blocks.Ctx(cfg, "train"), None)
    assert not torch.allclose(moved[:, 0], got[:, 0])


def test_cse_fsl_round_matches_reference():
    jcfg = jget_config(NAME).reduced().with_(dtype="float32")
    cfg = get_config(NAME).reduced().with_(dtype="float32", use_pallas=True)
    jfsl, fsl = JFSLConfig(num_clients=N, h=H), FSLConfig(num_clients=N, h=H)
    jb = jtransformer_bundle(jcfg)
    jstate = jinit_state(jb, jfsl, jax.random.PRNGKey(0))
    jbatch = jspecs.train_batch_specs(jcfg, _shape(port=False), jfsl,
                                      as_spec=False)
    jnew, jm = jax.jit(jmake_round_step(jb, jfsl))(jstate, jbatch, 0.05)
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu")
    batch = specs.train_batch_specs(cfg, _shape(), fsl, as_spec=False,
                                    device="cpu")
    assert set(batch[0]) == {"features"}
    new, m = make_round_step(transformer_bundle(cfg, device="cpu"), fsl)(
        state0, batch, 0.05)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    got = state_to_numpy(new)
    want = jax.tree_util.tree_map(np.asarray, jnew)
    for key in ("clients", "server"):
        for (path, a), (wpath, w) in zip(
                jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                jax.tree_util.tree_leaves_with_path(want[key]["params"])):
            assert path == wpath
            np.testing.assert_allclose(
                a, w, rtol=RTOL, atol=1e-5 * max(np.abs(w).max(), 1.0),
                err_msg=jax.tree_util.keystr(path))
    fw0 = state0["clients"]["params"]["client"]["frontend_w"]
    assert not torch.equal(new["clients"]["params"]["client"]["frontend_w"],
                           fw0)


def test_bf16_round_matches_reference_on_bf16_features():
    """Reduced hubert in bf16: the port casts the drawn fp32 features to
    the parameters' dtype where the reference's fp32 features promote the
    bf16 model to fp32; given the features in bf16, the reference's round
    is the port's at bf16 tolerances: the losses at rtol 1e-3, the params
    at rtol 2e-2 with an atol of 2^-5 of each leaf's largest magnitude (4
    bf16 ulps; the worst seen, frontend_b, 0.0153 of it)."""
    jcfg, cfg = jget_config(NAME).reduced(), get_config(NAME).reduced()
    assert cfg.dtype == "bfloat16"
    jfsl, fsl = JFSLConfig(num_clients=N, h=H), FSLConfig(num_clients=N, h=H)
    jb = jtransformer_bundle(jcfg)
    jstate = jinit_state(jb, jfsl, jax.random.PRNGKey(0))
    jin, jlab = jspecs.train_batch_specs(jcfg, _shape(port=False), jfsl,
                                         as_spec=False)
    jin = {"features": jin["features"].astype(jnp.bfloat16)}
    jnew, jm = jax.jit(jmake_round_step(jb, jfsl))(jstate, (jin, jlab),
                                                   0.05)
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu")
    batch = specs.train_batch_specs(cfg, _shape(), fsl, as_spec=False,
                                    device="cpu")
    assert batch[0]["features"].dtype == torch.float32
    new, m = make_round_step(transformer_bundle(cfg, device="cpu"), fsl)(
        state0, batch, 0.05)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-3,
                                   err_msg=k)
    got = state_to_numpy(new)
    want = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jnew)
    for key in ("clients", "server"):
        for (path, a), w in zip(
                jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                jax.tree_util.tree_leaves(want[key]["params"])):
            np.testing.assert_allclose(
                np.asarray(a, np.float32), w, rtol=2e-2,
                atol=2.0 ** -5 * np.abs(w).max(),
                err_msg=jax.tree_util.keystr(path))


class FeatureBatcher:
    """``train_batch_specs`` draws a round (seed = the round), as numpy."""

    def __init__(self, cfg, fsl):
        self.cfg, self.fsl, self.rnd = cfg, fsl, 0

    def next_round(self):
        inputs, labels = specs.train_batch_specs(
            self.cfg, _shape(), self.fsl, as_spec=False, seed=self.rnd,
            device="cpu")
        self.rnd += 1
        return {k: v.numpy() for k, v in inputs.items()}, labels.numpy()


def test_int8_wire_bytes_and_run_compiled():
    """bf16 reduced hubert with the int8 uplink and model sync: the
    CommProfile (its wire bytes included) equal to the reference's; two
    rounds of ``run_compiled`` on staged features bitwise ``run``, the
    meter CommProfile's."""
    fkw = dict(num_clients=N, h=H, lr=0.1, codec="int8", model_codec="int8")
    jcfg, cfg = jget_config(NAME).reduced(), get_config(NAME).reduced()
    jb, b = jtransformer_bundle(jcfg), transformer_bundle(cfg, device="cpu")
    pa = jabstract_params(jcfg)
    jcm = JCostModel(n=N, q=jb.smashed_bytes_per_sample * S, d_local=4,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    cm = CostModel(n=N, q=b.smashed_bytes_per_sample * S, d_local=4,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    tr = Trainer(b, FSLConfig(**fkw))
    jbatch = jspecs.train_batch_specs(jcfg, _shape(port=False),
                                      JFSLConfig(**fkw), as_spec=False)
    batch = FeatureBatcher(cfg, FSLConfig(**fkw)).next_round()
    want = dataclasses.asdict(jtr.comm_profile(jcm, B, batch=jbatch))
    got = dataclasses.asdict(tr.comm_profile(cm, B, batch=batch))
    assert got == want
    assert 0 < got["model_sync_wire"] < got["model_sync"]
    assert 0 < got["uplink_smashed_wire"] < got["uplink_smashed"]
    m1, m2 = CommMeter(), CommMeter()
    s1, h1 = tr.run(tr.init(0), FeatureBatcher(cfg, tr.fsl), 2,
                    log_every=1, meter=m1, cost_model=cm)
    s2, h2 = tr.run_compiled(tr.init(0), FeatureBatcher(cfg, tr.fsl), 2,
                             chunk=2, log_every=1, meter=m2, cost_model=cm)
    assert all(torch.equal(x, y) for x, y in zip(state_leaves(s1),
                                                  state_leaves(s2)))
    assert h1 == h2 and m1.as_dict() == m2.as_dict()
    assert m1.counts["model_sync"] == 2 * got["model_sync_wire"]
    assert np.isfinite([r[k] for r in h1 for k in r
                        if k.endswith("loss")]).all()


ARGV = ["--arch", NAME, "--size", "reduced", "--rounds", "1", "--clients",
        "2", "--h", "1", "--batch", "1", "--seq", "16", "--samples", "2",
        "--chunk", "0"]


def test_training_cli_fails_in_both_packages():
    argv0 = sys.argv
    try:
        sys.argv = ["train"] + ARGV
        with pytest.raises(KeyError, match="features"):
            jtrain.main()
    finally:
        sys.argv = argv0
    with pytest.raises(SystemExit, match="KeyError: 'features'"):
        train.main(ARGV + ["--device", "cpu"])


def test_serve_refuses_the_encoder_only_model():
    argv0 = sys.argv
    try:
        sys.argv = ["serve", "--arch", NAME]
        with pytest.raises(SystemExit, match="encoder-only"):
            jserve.main()
    finally:
        sys.argv = argv0
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", NAME, "--device", "cpu"])
