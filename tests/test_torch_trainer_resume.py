"""Kill and restore the port's ``Trainer.run`` and ``run_compiled`` mid-run
through ``repro_torch.checkpoint`` (``Trainer.save`` / ``Trainer.restore``).

- A run split mid-window under faults keeps the window: the JAX package
  restarts a window's participation at every call (its ``part = ones``),
  so a client whose upload failed before the split enters the window's
  FedAvg.  The narrow CNN, ``agg_every`` = 2h (windows of 2 rounds), lossy
  faults (loss 0.4, 1 retry, seed 1), 6 rounds split 3 + 3: the reference
  admits 2 clients at round 4 uninterrupted and 3 split; the port admits 2
  both ways, in both engines, and its split run is bitwise the
  uninterrupted one (the parent's port restarted the window too).
- Save after round k, restore into a fresh Trainer from a ``meta``
  template (no parameters drawn), continue with a batcher advanced k
  rounds: the states bitwise the uninterrupted run's and the losses,
  participants and meter equal, in both engines, at a chunk-aligned and an
  unaligned k, with and without a deadline on the tiered network plus
  lossy faults.  The rows' cumulative ``dropped_updates``,
  ``fault_retries`` and ``fault_drops`` count from each call's start, as
  in the JAX package, and are left out.
- Under a scheduler with no faults the window is kept too.  ROADMAP's
  input (the narrow CNN at n = 6, h = 2, ``agg_every`` 4,
  ``StratifiedPolicy(seed=0)`` on ``TieredNetwork()``): 3 + 3 rounds on
  one Trainer, and a save after round 3 restored into a fresh one, are
  bitwise 6 uninterrupted rounds in both engines (the round-4 aggregation
  admits 2 clients; a restarted window admitted 4).  ``Trainer.save``
  writes the window under a scheduler with or without faults, mid-window
  or at a window's end, and warns nothing.
- A checkpoint the JAX package wrote mid-run restores in the port (read
  through ``repro_torch.checkpoint``, converted with
  ``repro_torch.convert``), and the port's continuation agrees with the
  reference's own at rtol 1e-4 / atol 1e-5 (the identity wire: fp32 sum
  order only, as ``tests/test_torch_baselines.py`` states).
"""
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import data as jdata
from repro import faults as jfaults
from repro.configs.base import FSLConfig as JFSLConfig
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.trainer import Trainer as JTrainer
from repro.models.cnn import CNNConfig as JCNNConfig
from repro_torch import checkpoint as ckpt
from repro_torch import data, faults, network, sched
from repro_torch.common import tree_leaves
from repro_torch.configs.base import FSLConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.trainer import Trainer
from repro_torch.models.cnn import CNNConfig

N, H, B = 3, 2, 4
NARROW = dict(name="narrow_cnn", in_shape=(12, 12, 3), num_classes=10,
              conv_channels=(8, 8), server_widths=(32,))
LOSSY = dict(loss_rate=0.4, max_retries=1, seed=1)
CUMULATIVE = ("dropped_updates", "fault_retries", "fault_drops",
              "comm_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bundle():
    return cnn_bundle(CNNConfig(**NARROW), device="cpu")


def _fed(pkg):
    x, y = pkg.synthetic_classification(120, NARROW["in_shape"], 10, seed=0,
                                        signal=12.0)
    return pkg.partition_iid(x, y, N, seed=0)


def _cm(bundle):
    from repro_torch.common import bytes_of
    return CostModel(n=N, q=bundle.smashed_bytes_per_sample, d_local=40,
                     w_client=bytes_of(bundle.specs["client"]),
                     w_server=bytes_of(bundle.specs["server"]),
                     aux=bytes_of(bundle.specs["aux"]))


def _trainer(bundle, masked):
    fsl = FSLConfig(num_clients=N, h=H, agg_every=2 * H, lr=0.05)
    kw = {}
    if masked:
        kw = dict(faults=faults.fault_from_flags("lossy", **LOSSY))
        if masked == "deadline":
            kw.update(scheduler=sched.DeadlinePolicy(deadline_s=2.0,
                                                     compute_s=0.5),
                      network=network.TieredNetwork())
    return Trainer(bundle, fsl, **kw)


def _go(tr, state, batcher, rounds, compiled, meter, cm):
    if compiled:
        return tr.run_compiled(state, batcher, rounds, chunk=2, log_every=1,
                               meter=meter, cost_model=cm)
    return tr.run(state, batcher, rounds, log_every=1, meter=meter,
                  cost_model=cm)


def _same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _rows(hist):
    return [{k: v for k, v in r.items() if k not in CUMULATIVE}
            for r in hist]


def _cohorts(hist):
    return [(r["round"], r.get("participants")) for r in hist
            if r["aggregated"]]


def test_reference_restarts_the_window_when_split():
    """The fault, shown on the JAX package: 6 rounds split 3 + 3 (round 3
    is the first of the window ending at round 4)."""
    b = jcnn_bundle(JCNNConfig(**NARROW))
    fsl = JFSLConfig(num_clients=N, h=H, agg_every=2 * H, lr=0.05)
    fed = _fed(jdata)
    out = []
    for splits in ((6,), (3, 3)):
        tr = JTrainer(b, fsl, donate=False,
                      faults=jfaults.fault_from_flags("lossy", **LOSSY))
        st, batcher, hist = tr.init(0), jdata.FederatedBatcher(fed, B, H), []
        for n in splits:
            st, h = tr.run(st, batcher, n, log_every=1)
            hist += h
        out.append((st, hist))
    assert _cohorts(out[0][1]) == [(2, 3), (4, 2), (6, 2)]
    assert _cohorts(out[1][1]) == [(2, 3), (4, 3), (6, 2)]
    gap = max(float(np.max(np.abs(np.asarray(u) - np.asarray(v))))
              for u, v in zip(jax.tree_util.tree_leaves(out[0][0]),
                              jax.tree_util.tree_leaves(out[1][0])))
    assert gap > 1e-3


@pytest.mark.parametrize("compiled", [False, True], ids=["run", "compiled"])
def test_split_mid_window_keeps_the_window(compiled):
    """The same split in the port, one Trainer across both calls: the
    window's cohort and the final state are the uninterrupted run's."""
    b, fed = _bundle(), _fed(data)
    out = []
    for splits in ((6,), (3, 3)):
        tr = _trainer(b, "lossy")
        st, batcher, hist = tr.init(0), data.FederatedBatcher(fed, B, H), []
        for n in splits:
            st, h = _go(tr, st, batcher, n, compiled, None, None)
            hist += h
        out.append((st, hist))
    assert _cohorts(out[0][1]) == _cohorts(out[1][1]) \
        == [(2, 3), (4, 2), (6, 2)]
    _same_state(out[0][0], out[1][0])
    assert _rows(out[0][1]) == _rows(out[1][1])


@pytest.mark.parametrize("masked", [None, "deadline"],
                         ids=["plain", "deadline-lossy"])
@pytest.mark.parametrize("k", [3, 4], ids=["unaligned", "aligned"])
@pytest.mark.parametrize("compiled", [False, True], ids=["run", "compiled"])
def test_checkpoint_resume_bitwise(compiled, k, masked, tmp_path):
    """Save after round k of 6, restore into a fresh Trainer (meta
    template), continue: bitwise the uninterrupted run (chunk 2: k = 4 ends
    a chunk, k = 3 does not; k = 3 is mid-window)."""
    b, fed, rounds = _bundle(), _fed(data), 6
    cm = _cm(b)
    tr = _trainer(b, masked)
    meter = CommMeter()
    want, whist = _go(tr, tr.init(0), data.FederatedBatcher(fed, B, H),
                      rounds, compiled, meter, cm)

    tr = _trainer(b, masked)
    batcher, m1 = data.FederatedBatcher(fed, B, H), CommMeter()
    st, h1 = _go(tr, tr.init(0), batcher, k, compiled, m1, cm)
    path = tr.save(os.path.join(tmp_path, "trainer"), st)
    man = ckpt.manifest(path)
    assert man["step"] == k
    assert (man["extra"]["window"] != []) == (masked is not None)
    del tr, st

    fresh = _trainer(b, masked)                 # a restarted process
    st = fresh.restore(path)
    assert all(t.device.type == "cpu" for t in tree_leaves(st)
               if isinstance(t, torch.Tensor))
    batcher2 = data.FederatedBatcher(fed, B, H)
    for _ in range(k):
        batcher2.next_round()
    m2 = CommMeter()
    got, h2 = _go(fresh, st, batcher2, rounds - k, compiled, m2, cm)
    _same_state(want, got)
    assert _rows(whist) == _rows(h1 + h2)
    assert {kk: m1.counts.get(kk, 0) + m2.counts.get(kk, 0)
            for kk in meter.counts} == meter.counts
    if masked:
        assert min(p for _, p in _cohorts(whist)) < N


@pytest.mark.parametrize("lossy", [False, True], ids=["sched", "sched-lossy"])
@pytest.mark.parametrize("k", [2, 3], ids=["boundary", "mid-window"])
def test_save_keeps_the_window_under_a_scheduler(k, lossy, tmp_path):
    """A deadline on the tiered network, with and without lossy faults:
    a save after round k (k = 3 is mid-window, windows of 2 rounds) writes
    the window with the state and warns nothing, and the run restored
    into a fresh Trainer continues bitwise the uninterrupted one."""
    b, fed, rounds = _bundle(), _fed(data), 6

    def make():
        tr = _trainer(b, "deadline")
        if not lossy:
            tr = Trainer(b, tr.fsl, scheduler=tr.scheduler,
                         network=tr.network)
        return tr

    tr = make()
    want, whist = tr.run(tr.init(0), data.FederatedBatcher(fed, B, H),
                         rounds, log_every=1)
    tr = make()
    st, h1 = tr.run(tr.init(0), data.FederatedBatcher(fed, B, H), k,
                    log_every=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        path = tr.save(os.path.join(tmp_path, "t"), st)
    assert not w, [str(x.message) for x in w]
    assert ckpt.manifest(path)["extra"]["window"] == (
        ["part", "part_s"] if lossy else ["part"])
    fresh = make()
    batcher = data.FederatedBatcher(fed, B, H)
    for _ in range(k):
        batcher.next_round()
    got, h2 = fresh.run(fresh.restore(path), batcher, rounds - k,
                        log_every=1)
    _same_state(want, got)
    assert _rows(whist) == _rows(h1 + h2)


def _stratified(bundle):
    """ROADMAP Queue 3's input: n = 6, h = 2, windows of 2 rounds,
    StratifiedPolicy(seed=0) on TieredNetwork(), no faults."""
    fsl = FSLConfig(num_clients=6, h=H, agg_every=2 * H, lr=0.05)
    return Trainer(bundle, fsl, scheduler=sched.StratifiedPolicy(seed=0),
                   network=network.TieredNetwork())


@pytest.mark.parametrize("compiled", [False, True], ids=["run", "compiled"])
def test_scheduler_only_window_survives_split_and_restore(compiled,
                                                          tmp_path):
    """3 + 3 rounds on one Trainer, and 3 rounds saved and restored into a
    fresh Trainer then 3 more, bitwise 6 uninterrupted rounds: the
    round-4 aggregation admits the window's AND (2 clients), not the
    restarted window's 4."""
    b = _bundle()
    x, y = data.synthetic_classification(120, NARROW["in_shape"], 10,
                                         seed=0, signal=12.0)
    fed = data.partition_iid(x, y, 6, seed=0)
    tr = _stratified(b)
    want, whist = _go(tr, tr.init(0), data.FederatedBatcher(fed, B, H), 6,
                      compiled, None, None)
    assert [p for r, p in _cohorts(whist) if r == 4] == [2]
    tr = _stratified(b)
    batcher = data.FederatedBatcher(fed, B, H)
    st, h1 = _go(tr, tr.init(0), batcher, 3, compiled, None, None)
    path = tr.save(os.path.join(tmp_path, "s"), st)
    st, h2 = _go(tr, st, batcher, 3, compiled, None, None)
    _same_state(want, st)
    assert _rows(whist) == _rows(h1 + h2)
    fresh = _stratified(b)
    batcher = data.FederatedBatcher(fed, B, H)
    for _ in range(3):
        batcher.next_round()
    got, h3 = _go(fresh, fresh.restore(path), batcher, 3, compiled, None,
                  None)
    _same_state(want, got)
    assert _rows(whist) == _rows(h1 + h3)


def test_restore_refuses_another_trainer(tmp_path):
    b = _bundle()
    tr = _trainer(b, None)
    path = tr.save(os.path.join(tmp_path, "t"), tr.init(0))
    other = Trainer(b, FSLConfig(num_clients=N, h=H, method="fsl_oc"))
    with pytest.raises(ValueError, match="checkpoint is for cse_fsl"):
        other.restore(path)


def test_reference_checkpoint_continues_as_reference(tmp_path):
    """The JAX trainer writes its state after round 2 of 4; the port
    restores the file through its checkpoint module (the reference's tree
    as a numpy template), converts it, and runs rounds 3-4 beside the
    reference's own continuation."""
    jb = jcnn_bundle(JCNNConfig(**NARROW))
    jfsl = JFSLConfig(num_clients=N, h=H, agg_every=2 * H, lr=0.05)
    jtr = JTrainer(jb, jfsl, donate=False)
    jbatcher = jdata.FederatedBatcher(_fed(jdata), B, H)
    jst, _ = jtr.run(jtr.init(0), jbatcher, 2)
    path = os.path.join(tmp_path, "ref")
    jckpt.save(path, jst, step=2)
    jwant, jhist = jtr.run(jst, jbatcher, 2, log_every=1)

    like = jax.tree_util.tree_map(np.asarray, jtr.init(0))
    tree = ckpt.restore(path, like)
    state = state_from_numpy(tree, device="cpu")
    assert state["round"] == int(jst["round"])
    tr = _trainer(_bundle(), None)
    batcher = data.FederatedBatcher(_fed(data), B, H)
    for _ in range(2):
        batcher.next_round()
    got, hist = tr.run(state, batcher, 2, log_every=1)
    assert [r["aggregated"] for r in hist] == \
        [r["aggregated"] for r in jhist] == [False, True]
    for r, jr in zip(hist, jhist):
        for key in ("client_loss", "server_loss"):
            np.testing.assert_allclose(r[key], jr[key], rtol=1e-4)
    got_np = state_to_numpy(got)
    want_np = jax.tree_util.tree_map(np.asarray, jwant)
    for a, w in zip(jax.tree_util.tree_leaves(got_np),
                    jax.tree_util.tree_leaves(want_np)):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5)
