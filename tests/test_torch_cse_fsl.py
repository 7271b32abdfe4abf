"""CSE-FSL through ``Trainer.run``: the port against the JAX package.

Both trainers start from the reference's initial state (carried across by
``repro_torch.convert``) and draw the same batches (each package's own
``FederatedBatcher``, held bitwise equal below).  The setup is a narrow
CNN with n=3, h=3 and C=2, the reference's non-divisible cadence; the
``aggregated`` flags are compared round by round, and the cadence alone at
C > h, where rounds without aggregation occur.

Tolerances: with the identity codec the two runs differ only in fp32 sum
order, so per-round losses agree at rtol 1e-4 and final params at atol
1e-5.  With the int8 codec the port is fed the reference's own
``jax.random`` bits (``Transport.bits_fn``, derived exactly as the JAX
package derives them); a sum-order difference can still move one element
across a stochastic-rounding boundary, so losses agree at rtol 1e-3.  The
metered bytes and the aggregation flags are identical in every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import data as jdata
from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.models.cnn import CNNConfig as JCNNConfig
from repro_torch import data
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import AggregationCadence, Trainer
from repro_torch.models.cnn import CNNConfig
from repro_torch.transport import Transport, get_codec

N, H, C, B = 3, 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))


def _data(seed=0):
    x, y = data.synthetic_classification(120, NARROW["in_shape"], 10,
                                         seed=seed, signal=12.0)
    return data.partition_iid(x, y, N, seed=seed)


def _jdata(seed=0):
    x, y = jdata.synthetic_classification(120, NARROW["in_shape"], 10,
                                          seed=seed, signal=12.0)
    return jdata.partition_iid(x, y, N, seed=seed)


def test_batcher_and_partitions_match_reference_bitwise():
    fed, jfed = _data(), _jdata()
    for a, b in zip(fed.inputs + fed.labels, jfed.inputs + jfed.labels):
        np.testing.assert_array_equal(a, b)
    bat, jbat = data.FederatedBatcher(fed, B, H), \
        jdata.FederatedBatcher(jfed, B, H)
    for _ in range(25):                       # wraps every client's data
        for a, b in zip(bat.next_round(), jbat.next_round()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(bat.next_round_indices(),
                                      jbat.next_round_indices())
    x, y = data.synthetic_classification(200, (4,), 5, seed=2)
    jx, jy = jdata.synthetic_classification(200, (4,), 5, seed=2)
    d, jd = data.partition_dirichlet(x, y, 4, alpha=0.3, seed=1), \
        jdata.partition_dirichlet(jx, jy, 4, alpha=0.3, seed=1)
    for a, b in zip(d.labels, jd.labels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,c,start", [(3, 2, 0), (3, 4, 0), (3, 4, 6),
                                       (5, 5, 0), (2, 3, 1)])
def test_cadence_matches_reference(h, c, start):
    from repro.core.trainer import AggregationCadence as JCadence
    cad, jcad = AggregationCadence(c, start), JCadence(c, start)
    flags = [cad.advance(h) for _ in range(12)]
    assert flags == [jcad.advance(h) for _ in range(12)]
    if c > h:
        assert not all(flags)           # threshold crossings, not every round


def _jbits_fn(jtp):
    """The reference's uplink bits: unit_key -> fold_in(client) ->
    fold_in(leaf) -> jax.random.bits, as its round step derives them."""
    def bits_fn(unit, client, leaf, salt, shape):
        key = jax.random.fold_in(jtp.unit_key(unit, salt=salt), client)
        key = jax.random.fold_in(key, leaf)
        return np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return bits_fn


def _run_pair(codec, server_update, rounds):
    kw = dict(num_clients=N, h=H, agg_every=C, lr=0.1, codec=codec,
              server_update=server_update)
    jb = jcnn_bundle(JCNNConfig(**NARROW))
    jtr = JTrainer(jb, JFSLConfig(**kw), donate=False)
    jstate = jtr.init(0)
    pa = jax.eval_shape(jb.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jcm = JCostModel(n=N, q=jb.smashed_bytes_per_sample, d_local=40,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    jmeter = JCommMeter()
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu")
    jstate, jhist = jtr.run(jstate, jdata.FederatedBatcher(_jdata(), B, H),
                            rounds, log_every=1, meter=jmeter,
                            cost_model=jcm)

    b = cnn_bundle(CNNConfig(**NARROW), device="cpu")
    tp = None
    if codec != "none":
        tp = Transport(uplink=get_codec(codec),
                       bits_fn=_jbits_fn(jtr.transport))
    tr = Trainer(b, FSLConfig(**kw), transport=tp)
    cm = CostModel(n=N, q=b.smashed_bytes_per_sample, d_local=40,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    meter = CommMeter()
    state, hist = tr.run(state0, data.FederatedBatcher(_data(), B, H),
                         rounds, log_every=1, meter=meter, cost_model=cm)
    return (hist, meter, state), (jhist, jmeter, jstate)


@pytest.mark.parametrize("codec,server_update,rounds", [
    ("none", "sequential", 4), ("int8", "sequential", 4),
    ("none", "batched", 2), ("int8", "batched", 2)])
def test_trainer_run_matches_reference(codec, server_update, rounds):
    (hist, meter, state), (jhist, jmeter, jstate) = _run_pair(
        codec, server_update, rounds)
    rtol = 1e-4 if codec == "none" else 1e-3
    assert len(hist) == len(jhist) == rounds
    for row, jrow in zip(hist, jhist):
        assert row["round"] == jrow["round"]
        assert row["aggregated"] == jrow["aggregated"]
        assert row["comm_bytes"] == jrow["comm_bytes"]
        for k in ("client_loss", "server_loss"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=rtol,
                                       err_msg=f"round {row['round']} {k}")
    assert meter.as_dict() == jmeter.as_dict()
    assert meter.to_record("comm.") == jmeter.to_record("comm.")
    if codec != "none":
        return
    got = state_to_numpy(state)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(got["round"]) == int(want["round"])
    for key in ("clients", "server"):
        pairs = zip(jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                    jax.tree_util.tree_leaves_with_path(want[key]["params"]))
        for (path, a), (_, w) in pairs:
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))


def test_seeded_codec_path_is_deterministic_per_transport_seed():
    """The main-path randomness (per-client Philox seeds, no bits_fn) on
    the CPU: finite, deterministic per transport seed, and different
    across seeds and clients."""
    kw = dict(num_clients=N, h=H, agg_every=C, lr=0.1, codec="int8")
    b = cnn_bundle(CNNConfig(**NARROW), device="cpu")
    losses = []
    for seed in (0, 0, 1):
        tr = Trainer(b, FSLConfig(**kw),
                     transport=Transport(uplink=get_codec("int8"), seed=seed))
        _, hist = tr.run(tr.init(0), data.FederatedBatcher(_data(), B, H), 2,
                         log_every=1)
        losses.append([r["server_loss"] for r in hist])
        assert all(np.isfinite(losses[-1]))
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert Transport(seed=0).unit_seed(3, 1, 0, 0) \
        != Transport(seed=0).unit_seed(3, 2, 0, 0)
