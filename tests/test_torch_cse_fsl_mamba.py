"""The Mamba slice as a whole: CSE-FSL on reduced falcon-mamba-7b through
``Trainer.run``, the port against the JAX package.

Setup: fp32, ``use_pallas=True`` (the JAX side's Pallas kernels, K5 and
the fused CE, in interpret mode; the port's kernel ops with their plain
versions), 2 layers cut at 1, d=256, d_inner=512, N=16, chunk 16, S=64,
B=1, n=2 clients, h=2, C=h, the int8 uplink.
Both trainers start from the reference's initial state (carried across by
``repro_torch.convert``) and draw the same batches (each package's own
``LMBatcher``).  The port is fed the reference's own ``jax.random`` bits
for the stochastic rounding (``Transport.bits_fn``), so both code the same
uploads.  Per-round losses and the final params agree at rtol 1e-4 (fp32
sums in other orders); the metered bytes and the ``aggregated`` flags are
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.common import bytes_of as jbytes_of
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import get_config as jget_config
from repro.core.accounting import CommMeter as JCommMeter
from repro.core.accounting import CostModel as JCostModel
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.launch.train import LMBatcher as JLMBatcher
from repro.launch.train import build_data as jbuild_data
from repro.models.model import abstract_params
from repro_torch.common import bytes_of
from repro_torch.configs.base import FSLConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.launch.train import LMBatcher, build_data
from repro_torch.transport import Transport, get_codec

N, H, B, S, ROUNDS, SAMPLES = 2, 2, 1, 64, 2, 4
KW = dict(dtype="float32", use_pallas=True)
NAME = "falcon-mamba-7b"


def _jbits_fn(jtp):
    """The reference's uplink bits, derived as its round step derives
    them: unit_key -> fold_in(client) -> fold_in(leaf) -> bits."""
    def bits_fn(unit, client, leaf, salt, shape):
        key = jax.random.fold_in(jtp.unit_key(unit, salt=salt), client)
        key = jax.random.fold_in(key, leaf)
        return np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return bits_fn


def test_trainer_run_matches_reference():
    fkw = dict(num_clients=N, h=H, lr=0.1, codec="int8")
    jcfg = jget_config(NAME).reduced().with_(**KW)
    jb = jtransformer_bundle(jcfg)
    jtr = JTrainer(jb, JFSLConfig(**fkw), donate=False)
    jstate = jtr.init(0)
    pa = abstract_params(jcfg)
    jcm = JCostModel(n=N, q=jb.smashed_bytes_per_sample, d_local=SAMPLES,
                     w_client=jbytes_of(pa["client"]),
                     w_server=jbytes_of(pa["server"]),
                     aux=jbytes_of(pa["aux"]))
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu")
    jfed = jbuild_data(jcfg, JFSLConfig(**fkw), S, SAMPLES, False)
    jmeter = JCommMeter()
    jstate, jhist = jtr.run(jstate, JLMBatcher(jcfg, jfed, B, H), ROUNDS,
                            log_every=1, meter=jmeter, cost_model=jcm)

    cfg = get_config(NAME).reduced().with_(**KW)
    b = transformer_bundle(cfg, device="cpu")
    tr = Trainer(b, FSLConfig(**fkw),
                 transport=Transport(uplink=get_codec("int8"),
                                     bits_fn=_jbits_fn(jtr.transport)))
    cm = CostModel(n=N, q=b.smashed_bytes_per_sample, d_local=SAMPLES,
                   w_client=bytes_of(b.specs["client"]),
                   w_server=bytes_of(b.specs["server"]),
                   aux=bytes_of(b.specs["aux"]))
    assert dict(vars(cm)) == dict(vars(jcm))
    fed = build_data(cfg, FSLConfig(**fkw), S, SAMPLES, False)
    meter = CommMeter()
    state, hist = tr.run(state0, LMBatcher(cfg, fed, B, H), ROUNDS,
                         log_every=1, meter=meter, cost_model=cm)

    assert len(hist) == len(jhist) == ROUNDS
    for row, jrow in zip(hist, jhist):
        assert row["round"] == jrow["round"]
        assert row["aggregated"] == jrow["aggregated"]
        assert row["comm_bytes"] == jrow["comm_bytes"]
        for k in ("client_loss", "server_loss"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4,
                                       err_msg=f"round {row['round']} {k}")
    assert meter.as_dict() == jmeter.as_dict()
    # int8 wire: [64, 256] smashed per client = 16 tiles of 8x128
    assert meter.counts["uplink_smashed"] == ROUNDS * N * (S * 256 + 16 * 4)
    got = state_to_numpy(state)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    for key in ("clients", "server"):
        pairs = zip(jax.tree_util.tree_leaves_with_path(got[key]["params"]),
                    jax.tree_util.tree_leaves_with_path(want[key]["params"]))
        for (path, a), (wpath, w) in pairs:
            assert path == wpath
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
