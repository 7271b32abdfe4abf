"""The network model and the sync wall-clock: the port's
``repro_torch.network`` and ``Trainer.wallclock_estimate`` against the JAX
package.

- Every network model's ``draw`` from the same ``np.random.default_rng``
  seed, bitwise (rates, RTTs, and the transfer seconds of a payload);
  ``expected_links``; ``client_tier`` and ``tier_ranges``; the registry
  and ``network_from_flags``.
- ``estimate_sync_wallclock`` on every model, blocking or not, with and
  without aggregation events: every field equal.
- ``Trainer.wallclock_estimate`` on the narrow CNN for all four methods,
  from the exact payload bytes of an int8 wire (with a batch) and from the
  identity wire's analytic profile (without one), with no faults, the
  ``lossy`` preset and the JAX suite's ``MIX``: every field equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import faults as jfaults
from repro import network as jnetwork
from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.models.cnn import CNNConfig as JCNNConfig
from repro_torch import data
from repro_torch import faults
from repro_torch import network
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.models.cnn import CNNConfig

ALL_METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
N, H, B = 3, 3, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
MIX_KW = dict(loss_rate=0.25, crash_rate=0.25, outage_rate=0.2, seed=11,
              name="mix")
# each model built the same way from either package's ``network``
MODELS = {
    "ideal": lambda m: m.IdealNetwork(),
    "uniform": lambda m: m.UniformNetwork(),
    "uniform_slow": lambda m: m.UniformNetwork(up_mbps=1.5, down_mbps=3.0,
                                               rtt=0.2),
    "lognormal": lambda m: m.LognormalNetwork(),
    "lognormal_wide": lambda m: m.LognormalNetwork(up_mbps=4.0, sigma=1.0,
                                                   spread=0.8),
    "tiered": lambda m: m.TieredNetwork(),
    "tiered_five": lambda m: m.TieredNetwork(tiers=(
        ("3g", 0.1), ("4g", 0.2), ("5g", 0.3), ("wifi", 0.3),
        ("fiber", 0.1))),
    "trace": lambda m: m.TraceNetwork(),
    "diurnal": lambda m: m.TraceNetwork.diurnal(scale_mbps=6.0),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 4, 3), (7, 10, 1)])
@pytest.mark.parametrize("name", list(MODELS))
def test_draw_matches_reference(name, shape, seed):
    t = MODELS[name](network).draw(np.random.default_rng(seed), *shape)
    jt = MODELS[name](jnetwork).draw(np.random.default_rng(seed), *shape)
    assert t.shape == jt.shape == shape
    for f in ("up_bps", "down_bps", "rtt"):
        a, b = getattr(t, f), getattr(jt, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    for r in range(shape[0]):
        for nbytes in (0, 96, 4_210_688):
            np.testing.assert_array_equal(t.up_seconds(nbytes, r),
                                          jt.up_seconds(nbytes, r))
            np.testing.assert_array_equal(t.down_seconds(nbytes, r),
                                          jt.down_seconds(nbytes, r))


@pytest.mark.parametrize("name", list(MODELS))
def test_links_and_tiers_match_reference(name):
    m, jm = MODELS[name](network), MODELS[name](jnetwork)
    assert m.is_ideal == jm.is_ideal
    for n in (1, 2, 3, 4, 7, 10, 37):
        links, jlinks = m.expected_links(n), jm.expected_links(n)
        assert [dataclasses.astuple(x) for x in links] == \
            [dataclasses.astuple(x) for x in jlinks]
        for link, jlink in zip(links, jlinks):
            for nb in (0, 55_728):
                assert link.up_seconds(nb) == jlink.up_seconds(nb)
                assert link.down_seconds(nb) == jlink.down_seconds(nb)
        if hasattr(jm, "client_tier"):
            assert [m.client_tier(c, n) for c in range(n)] == \
                [jm.client_tier(c, n) for c in range(n)]
            assert m.tier_ranges(n) == jm.tier_ranges(n)


def test_registry_and_flags_match_reference():
    assert network.MBPS == jnetwork.MBPS
    assert {k: dataclasses.astuple(v) for k, v in network.TIERS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jnetwork.TIERS.items()}
    assert sorted(network.NETWORK_MODELS) == sorted(jnetwork.NETWORK_MODELS)
    for name in network.NETWORK_MODELS:
        assert vars(network.make_network(name)) == \
            vars(jnetwork.make_network(name))
        for kw in ({}, {"bandwidth_mbps": 2.5, "rtt": 0.1}):
            a = network.network_from_flags(name, **kw)
            b = jnetwork.network_from_flags(name, **kw)
            assert type(a).__name__ == type(b).__name__
            assert vars(a) == vars(b)
    with pytest.raises(KeyError, match="unknown network model"):
        network.make_network("bogus")
    with pytest.raises(ValueError, match="must sum to 1"):
        network.TieredNetwork(tiers=(("3g", 0.5),))
    with pytest.raises(KeyError, match="unknown tier"):
        network.TieredNetwork(tiers=(("dialup", 1.0),))
    with pytest.raises(ValueError, match="equal length"):
        network.TraceNetwork(up_mbps=(1.0,), down_mbps=(1.0, 2.0))


@pytest.mark.parametrize("name", list(MODELS))
def test_estimate_sync_wallclock_matches_reference(name):
    m, jm = MODELS[name](network), MODELS[name](jnetwork)
    for blocking in (False, True):
        for aggs in (0, 3):
            kw = dict(n=4, num_rounds=10, uploads_per_round=5,
                      up_bytes=55_824, down_bytes=55_728, blocking=blocking,
                      compute=0.7, server_time=0.02, agg_events=aggs,
                      model_up_bytes=1_234_567, model_down_bytes=765_432)
            a = network.estimate_sync_wallclock(m, **kw)
            b = jnetwork.estimate_sync_wallclock(jm, **kw)
            assert a.as_dict() == b.as_dict()


def _cost_models(jb, b):
    import jax
    import jax.numpy as jnp
    pa = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jcm = JCostModel(n=N, q=jb.smashed_bytes_per_sample, d_local=40,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    cm = CostModel(n=N, q=b.smashed_bytes_per_sample, d_local=40,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    return cm, jcm


@pytest.mark.parametrize("fault", ["none", "lossy", "mix"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_trainer_wallclock_estimate_matches_reference(method, fault):
    jb = jcnn_bundle(JCNNConfig(**NARROW))
    b = cnn_bundle(CNNConfig(**NARROW), device="cpu")
    cm, jcm = _cost_models(jb, b)
    if fault == "mix":
        fm, jfm = faults.FaultModel(**MIX_KW), jfaults.FaultModel(**MIX_KW)
    else:
        fm, jfm = faults.make_fault(fault), jfaults.make_fault(fault)
    x, y = data.synthetic_classification(120, NARROW["in_shape"], 10, seed=0)
    jx, jy = jdata.synthetic_classification(120, NARROW["in_shape"], 10,
                                            seed=0)
    batch = data.FederatedBatcher(data.partition_iid(x, y, N), B,
                                  H).next_round()
    jbatch = jdata.FederatedBatcher(jdata.partition_iid(jx, jy, N), B,
                                    H).next_round()
    for codec, with_batch in (("int8", True), ("none", False)):
        fkw = dict(num_clients=N, h=H, agg_every=2, method=method,
                   codec=codec, model_codec=codec)
        tr = Trainer(b, FSLConfig(**fkw), faults=fm)
        jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False, faults=jfm)
        for net_name in ("tiered", "lognormal"):
            kw = dict(compute=0.8, server_time=0.03)
            a = tr.wallclock_estimate(
                cm, B, 7, MODELS[net_name](network),
                batch=batch if with_batch else None, **kw)
            w = jtr.wallclock_estimate(
                jcm, B, 7, MODELS[net_name](jnetwork),
                batch=jbatch if with_batch else None, **kw)
            assert a.as_dict() == w.as_dict()
            # the faults= override, here no faults over the trainer's own
            assert tr.wallclock_estimate(
                cm, B, 7, MODELS[net_name](network),
                batch=batch if with_batch else None,
                faults=faults.NO_FAULTS if fault != "none" else None,
                **kw).as_dict() == jtr.wallclock_estimate(
                jcm, B, 7, MODELS[net_name](jnetwork),
                batch=jbatch if with_batch else None,
                faults=jfaults.NO_FAULTS if fault != "none" else None,
                **kw).as_dict()
    with pytest.raises(ValueError, match="needs a `batch`"):
        Trainer(b, FSLConfig(num_clients=N, h=H, codec="int8",
                             method=method)).wallclock_estimate(
            cm, B, 3, network.TieredNetwork())
