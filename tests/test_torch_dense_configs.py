"""The dense configs the port's blocks compute (glm4-9b, qwen2-1.5b,
qwen2-72b: GQA with QKV bias): each config field for field the JAX
package's, and each reduced config in fp32 against the reference.

The port runs its main path (``use_pallas=True``: the kernel ops, with
their plain versions on the CPU), the reference its plain path (its
Pallas kernels are TPU kernels), both from the reference's parameters
(``repro_torch.convert``), at ``swa_window`` 64 under S = 128 so the
window cuts.  The smashed data, the aux and server losses, and one
``Trainer.run`` round of CSE-FSL (n = 2, h = 2: losses, meter, params)
agree at rtol 1e-4 / atol 1e-5, as in ``tests/test_torch_cse_fsl_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs import registry as jregistry
from repro.configs.registry import get_config as jget_config
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.launch.train import LMBatcher as JLMBatcher
from repro.launch.train import build_data as jbuild_data
from repro.models.model import abstract_params as jabstract_params
from repro_torch.common import bytes_of, tree_leaves
from repro_torch.configs import registry
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import (params_from_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.launch.train import LMBatcher, build_data
from repro_torch.models.model import abstract_params

ARCHS = ("glm4-9b", "qwen2-1.5b", "qwen2-72b")
N, H, B, S, SAMPLES = 2, 2, 2, 128, 4
KW = dict(dtype="float32", swa_window=64)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shapes(tree, prefix=()):
    """``{"a/b/c": shape}`` of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, prefix + (key,)).items()}
    return {"/".join(prefix): tuple(tree.shape)}


def _cfgs(name):
    return (jget_config(name).reduced().with_(use_pallas=False, **KW),
            get_config(name).reduced().with_(use_pallas=True, **KW))


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference_field_for_field(name):
    """Every field the port's ModelConfig has equals the reference's, at
    full size and reduced; the parameter shapes and bytes (meta tensors)
    equal the reference's ``abstract_params``."""
    for size in ("full", "reduced"):
        j, p = jget_config(name), get_config(name)
        if size == "reduced":
            j, p = j.reduced(), p.reduced()
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(j, f.name), (size, f.name)
        assert p.qkv_bias and p.family == "dense"
    cfg = get_config(name)
    got = _shapes(abstract_params(cfg))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jabstract_params(jget_config(name)))}
    assert got == want
    assert all(t.device.type == "meta"
               for t in tree_leaves(abstract_params(cfg)))
    assert bytes_of(abstract_params(cfg)) == jbytes_of(
        jabstract_params(jget_config(name)))


def test_registry_names_what_is_missing():
    """Nothing is missing: every arch of the reference is in the port, in
    the reference's order, and an unknown name still raises a KeyError
    that lists them."""
    assert set(ARCHS) <= set(registry.arch_names())
    missing = [n for n in jregistry.arch_names()
               if n not in registry.arch_names()]
    assert missing == []
    assert registry.arch_names() == jregistry.arch_names()
    with pytest.raises(KeyError,
                       match="not an architecture of the port.*hubert"):
        get_config("gpt-2")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_losses_match_reference(name):
    jcfg, cfg = _cfgs(name)
    jb = jtransformer_bundle(jcfg)
    b = transformer_bundle(cfg, device="cpu")
    jp = jb.init(jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                          device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    x, y = tok[:, :-1], tok[:, 1:]
    jin, inp = {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
    jy, ty = jnp.asarray(y), torch.from_numpy(y)

    jsm = jb.client_smashed(jp["client"], jin)
    sm = b.client_smashed(p["client"], inp)
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm), rtol=RTOL,
                               atol=ATOL)
    jloss, _ = jb.client_loss(jp["client"], jp["aux"], jin, jy)
    loss, _ = b.client_loss(p["client"], p["aux"], inp, ty)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    jsl = jb.server_loss(jp["server"], jsm, jy)
    sl = b.server_loss(p["server"], sm, ty)
    np.testing.assert_allclose(float(sl), float(jsl), rtol=RTOL)
    # a fresh model: every loss near ln V
    assert abs(float(sl) - np.log(cfg.vocab_size)) < 1.0


@pytest.mark.parametrize("name", ARCHS)
def test_trainer_round_matches_reference(name):
    jcfg, cfg = _cfgs(name)
    fkw = dict(num_clients=N, h=H, lr=0.1)
    jb = jtransformer_bundle(jcfg)
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    jstate = jtr.init(0)
    pa = jabstract_params(jcfg)
    jcm = JCostModel(n=N, q=jb.smashed_bytes_per_sample, d_local=SAMPLES,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu")
    jfed = jbuild_data(jcfg, JFSLConfig(**fkw), S, SAMPLES, False)
    jmeter = JCommMeter()
    jstate, jhist = jtr.run(jstate, JLMBatcher(jcfg, jfed, B, H), 1,
                            log_every=1, meter=jmeter, cost_model=jcm)

    b = transformer_bundle(cfg, device="cpu")
    tr = Trainer(b, FSLConfig(**fkw))
    cm = CostModel(n=N, q=b.smashed_bytes_per_sample, d_local=SAMPLES,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    fed = build_data(cfg, FSLConfig(**fkw), S, SAMPLES, False)
    meter = CommMeter()
    state, hist = tr.run(state0, LMBatcher(cfg, fed, B, H), 1, log_every=1,
                         meter=meter, cost_model=cm)
    assert meter.as_dict() == jmeter.as_dict()
    (row,), (jrow,) = hist, jhist
    assert row["aggregated"] == jrow["aggregated"]
    for k in ("client_loss", "server_loss"):
        np.testing.assert_allclose(row[k], jrow[k], rtol=RTOL, err_msg=k)
    got = state_to_numpy(state)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    for key in ("clients", "server"):
        for (path, a), (wpath, w) in zip(
                jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                jax.tree_util.tree_leaves_with_path(want[key]["params"])):
            assert path == wpath
            np.testing.assert_allclose(a, w, rtol=RTOL, atol=ATOL,
                                       err_msg=jax.tree_util.keystr(path))
