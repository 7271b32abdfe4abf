"""The port's compiled chunk runner on the CPU: ``Trainer.run_compiled`` is
BITWISE equal to the per-round loop ``Trainer.run`` -- final state and
history rows -- across the four methods, the non-divisible h=3 / C=2
cadence, the ``none`` and ``int8`` wires with ``int8`` model sync, chunks
that do not divide the rounds, the pooled and the staged data paths,
resume from a round that is not chunk-aligned, and the callback's
chunk-final state.  Then the pieces a captured round relies on: the staged
seeds are ``Transport.unit_seed`` bit for bit, and the round step reads
its seeds, its lr and (for the codecs) no round counter from the host.

The model is a small CIFAR-shaped CNN (32x32x3 inputs, narrow widths),
n = 2.  On the CPU the chunk program runs eagerly; on the card the same
program is captured as CUDA graphs (``chip_smoke.py`` phase 19).
"""
import numpy as np
import pytest
import torch

from repro_torch.common import bytes_of, tree_leaves
from repro_torch.configs.base import FSLConfig
from repro_torch.core.accounting import CommMeter, CostModel
from repro_torch.core.bundle import cnn_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.trainer import Trainer
from repro_torch.data import (FederatedBatcher, partition_iid,
                              synthetic_classification)
from repro_torch.models.cnn import CNNConfig
from repro_torch.transport import CHANNEL_SALTS, Transport, make_transport

ALL_METHODS = ("cse_fsl", "fsl_mc", "fsl_oc", "fsl_an")
SMALL = CNNConfig(name="small_cifar", in_shape=(32, 32, 3), num_classes=10,
                  conv_channels=(8, 8), server_widths=(32,))
N, B = 2, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny ops run on one intra-op thread: under pytest-xdist several
    workers share the cores, and torch's thread pools would fight over
    them.  Both sides of every comparison run under the same setting."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    bundle = cnn_bundle(SMALL, device="cpu")
    x, y = synthetic_classification(240, SMALL.in_shape, 10, seed=0,
                                    signal=12.0)
    cm = CostModel(n=N, q=bundle.smashed_bytes_per_sample, d_local=120,
                   w_client=bytes_of(bundle.specs["client"]),
                   w_server=bytes_of(bundle.specs["server"]),
                   aux=bytes_of(bundle.specs["aux"]))
    return bundle, partition_iid(x, y, N, seed=0), cm


def _fsl(method, h=2, c=0, codec="none", model_codec="none"):
    return FSLConfig(num_clients=N, h=h, agg_every=c, lr=0.05, method=method,
                     codec=codec, model_codec=model_codec,
                     grad_clip=1.0 if method == "fsl_oc" else 0.0)


def _transport(method, codec, model_codec):
    """``codec`` up and, for the blocking methods, down too."""
    from repro_torch.core.methods import get_method
    down = codec if get_method(method).downloads_gradients else "none"
    return make_transport(codec, down, model_sync=model_codec)


def _assert_states_bitwise(a, b):
    assert a["round"] == b["round"]
    la, lb = state_leaves(a), state_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _run_both(setup, fsl, rounds, chunk, transport=None, log_every=1,
              device_data=True):
    """(state, history, meter) from ``run`` and from ``run_compiled`` on
    the same initial state and batch stream."""
    bundle, fed, cm = setup
    out = []
    for compiled in (False, True):
        tr = Trainer(bundle, fsl, transport=transport)
        meter, batcher = CommMeter(), FederatedBatcher(fed, B, fsl.h, seed=0)
        kw = dict(log_every=log_every, meter=meter, cost_model=cm)
        if compiled:
            state, hist = tr.run_compiled(tr.init(0), batcher, rounds,
                                          chunk=chunk,
                                          device_data=device_data, **kw)
        else:
            state, hist = tr.run(tr.init(0), batcher, rounds, **kw)
        out.append((state, hist, meter))
    return out


def _check(out):
    (s0, h0, m0), (s1, h1, m1) = out
    _assert_states_bitwise(s0, s1)
    assert h0 == h1 and len(h0) > 0
    assert m0.counts == m1.counts


@pytest.mark.parametrize("method", ALL_METHODS)
def test_run_compiled_bitwise_matches_run(setup, method):
    """5 rounds at chunk 2 (a trailing partial chunk), h = 2, C = h: state,
    metered history rows and meter identical to the loop's."""
    _check(_run_both(setup, _fsl(method), rounds=5, chunk=2))


@pytest.mark.parametrize("h,c", [(3, 2), (2, 4)])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_run_compiled_cadence(setup, method, h, c):
    """Aggregation on threshold crossings of the unit counter: h = 3 with
    C = 2 (not a multiple of h), and C = 4 > h = 2, where every other
    round does not aggregate."""
    out = _run_both(setup, _fsl(method, h=h, c=c), rounds=4, chunk=3)
    _check(out)
    flags = [r["aggregated"] for r in out[0][1]]
    assert flags == ([True] * 4 if c < h else [False, True] * 2)


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("method", ALL_METHODS)
def test_run_compiled_coded_wires(setup, method, codec):
    """``codec`` up (and down for the blocking methods) with int8 model
    sync: the seeds staged per chunk code the same bits as the loop's per
    round, and the meter bills the coded model-sync bytes."""
    out = _run_both(setup, _fsl(method, model_codec="int8"), rounds=3,
                    chunk=2, transport=_transport(method, codec, "int8"))
    _check(out)
    meter = out[1][2]
    assert 0 < meter.counts["model_sync"] < 3 * 2 * N * bytes_of(
        setup[0].specs["client"]) * 2


@pytest.mark.parametrize("chunk,rounds", [(1, 3), (3, 7), (8, 5)])
def test_run_compiled_chunk_not_dividing(setup, chunk, rounds):
    """Chunks of 1, a chunk that leaves a remainder, a chunk longer than
    the run."""
    _check(_run_both(setup, _fsl("cse_fsl", h=3, c=2), rounds=rounds,
                     chunk=chunk))


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_oc"])
def test_run_compiled_pooled_equals_staged(setup, method):
    """The device-pool path (index plan, gathered batches) against the
    staged one and the loop: bitwise, with an int8 wire."""
    fsl = _fsl(method, model_codec="int8")
    tp = _transport(method, "int8", "int8")
    pooled = _run_both(setup, fsl, rounds=3, chunk=2, transport=tp)
    staged = _run_both(setup, fsl, rounds=3, chunk=2, transport=tp,
                       device_data=False)
    _check(pooled)
    _check([pooled[1], staged[1]])


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_mc"])
def test_run_compiled_resume_not_chunk_aligned(setup, method):
    """3 loop rounds, then ``run_compiled`` resumes from the state at round
    3 for 4 more at chunk 2: the cadence, the lr schedule and the seeds
    continue from ``state["round"]``, equal to 7 loop rounds."""
    bundle, fed, cm = setup
    fsl = FSLConfig(num_clients=N, h=3, agg_every=2, lr=0.05,
                    lr_decay_every=2, lr_decay=0.5, method=method,
                    codec="int8", model_codec="int8")
    tr = Trainer(bundle, fsl)
    batcher = FederatedBatcher(fed, B, 3, seed=0)
    want, whist = tr.run(tr.init(0), batcher, 7, log_every=1)
    batcher = FederatedBatcher(fed, B, 3, seed=0)
    mid, _ = tr.run(tr.init(0), batcher, 3, log_every=1)
    assert mid["round"] == 3 * tr.units_per_round
    got, ghist = Trainer(bundle, fsl).run_compiled(mid, batcher, 4, chunk=2,
                                                   log_every=1)
    _assert_states_bitwise(got, want)
    assert ghist == whist[3:]


def test_run_compiled_callback_sees_chunk_final_state(setup):
    """The callback fires on the ``log_every`` cadence with that round's
    metrics and the chunk-final state; with ``chunk == log_every`` that is
    its own round's state."""
    bundle, fed, _ = setup
    fsl = _fsl("cse_fsl")
    seen = {}
    for compiled, chunk in ((False, 0), (True, 2), (True, 3)):
        tr = Trainer(bundle, fsl)
        rows = []

        def cb(rnd, m, state):
            rows.append((rnd, dict(m), state["round"],
                         [t.clone() for t in state_leaves(state)]))

        batcher = FederatedBatcher(fed, B, 2, seed=0)
        if compiled:
            tr.run_compiled(tr.init(0), batcher, 6, chunk=chunk, log_every=2,
                            callback=cb)
        else:
            tr.run(tr.init(0), batcher, 6, log_every=2, callback=cb)
        seen[chunk] = rows
    loop, aligned, final = seen[0], seen[2], seen[3]
    assert [r[:3] for r in loop] == [r[:3] for r in aligned]
    for a, b in zip(loop, aligned):
        assert all(torch.equal(x, y) for x, y in zip(a[3], b[3]))
    # chunk 3, log_every 2: rounds 2 and 4 see the states of rounds 3, 6
    assert [(r[0], r[2]) for r in final] == [(2, 3), (4, 6), (6, 6)]
    assert [r[1] for r in final] == [r[1] for r in loop]
    for (_, _, _, got), want in zip(final, (None, loop[2][3], loop[2][3])):
        if want is not None:
            assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("method", ["cse_fsl", "fsl_oc"])
def test_step_and_aggregate_stage_a_rounds_seeds(setup, method):
    """The per-round API (``Trainer.step`` then ``Trainer.aggregate``, a
    Python float lr) stages the same lr and seeds as ``run``: one round,
    int8 up (and down) and int8 model sync, bitwise."""
    bundle, fed, _ = setup
    fsl = _fsl(method, model_codec="int8")
    tp = _transport(method, "int8", "int8")
    tr = Trainer(bundle, fsl, transport=tp)
    state = tr.init(0)
    batch = FederatedBatcher(fed, B, 2, seed=0).next_round()
    st, m = tr.step(state, batch, rnd=0)
    got = tr.aggregate(st)
    want, hist = Trainer(bundle, fsl, transport=tp).run(
        tr.init(0), FederatedBatcher(fed, B, 2, seed=0), 1, log_every=1)
    _assert_states_bitwise(got, want)
    assert {k: float(v) for k, v in m.items()} == {
        k: v for k, v in hist[0].items() if k not in ("round", "aggregated")}


@pytest.mark.parametrize("channel", list(CHANNEL_SALTS))
def test_staged_seeds_equal_unit_seed(channel):
    """``Transport.stage_seeds`` (what every round and chunk stages on the
    device) equals ``Transport.unit_seed`` bit for bit: per unit of the
    round, leaf and client on the wire channels; at the counter after
    the round, per leaf and client (model up) or for the one coded copy
    (model down, as client 0)."""
    tp = Transport(seed=12345)
    unit0, units, n, leaves = 2**33 + 7, 3, 4, 5
    table = tp.stage_seeds(unit0, units, n, {channel: leaves})[channel]
    salt = CHANNEL_SALTS[channel]
    assert table.dtype == np.int64
    if channel in ("uplink", "downlink"):
        assert table.shape == (units, leaves, n)
        want = [[[tp.unit_seed(unit0 + u, c, salt, leaf) for c in range(n)]
                 for leaf in range(leaves)] for u in range(units)]
    else:
        clients = n if channel == "model_up" else 1
        assert table.shape == (leaves, clients)
        want = [[tp.unit_seed(unit0 + units, c, salt, leaf)
                 for c in range(clients)] for leaf in range(leaves)]
    assert table.tolist() == want


def test_trainer_stages_each_rounds_seeds(setup):
    """The chunk's seed tables hold, row by row, the seeds of each round's
    own units: the loop's per-round tables stacked."""
    bundle, _, _ = setup
    fsl = _fsl("fsl_oc", h=3, c=2, model_codec="int8")
    tr = Trainer(bundle, fsl, transport=_transport("fsl_oc", "int8", "int8"))
    batch = (np.zeros((N, 3, B) + SMALL.in_shape, np.float32),
             np.zeros((N, 3, B), np.int32))
    rows = [tr._round_seeds(5 + 3 * i, batch) for i in range(3)]
    assert set(rows[0]) == set(CHANNEL_SALTS)
    for i, row in enumerate(rows):
        unit0 = 5 + 3 * i
        assert row["uplink"][1, 0, 1] == tr.transport.unit_seed(
            unit0 + 1, 1, 0, 0)
        assert row["downlink"][2, 0, 0] == tr.transport.unit_seed(
            unit0 + 2, 0, 1, 0)
        assert row["model_up"][3, 1] == tr.transport.unit_seed(
            unit0 + 3, 1, 2, 3)


def test_round_step_reads_staged_seeds_not_the_counter(setup):
    """Repair: the round step takes its wire seeds from the staged tables,
    never derives them on the host from ``state["round"]``: with the host
    derivation made to fail, a round with staged seeds still runs, and a
    state whose counter is wrong codes exactly as the right one does."""
    bundle, fed, _ = setup
    fsl = _fsl("fsl_mc", model_codec="int8")
    tr = Trainer(bundle, fsl, transport=_transport("fsl_mc", "int8", "int8"))
    state = tr.init(0)
    batch = tr.to_device(FederatedBatcher(fed, B, 2, seed=0).next_round())
    seeds = {k: torch.from_numpy(v) for k, v in
             tr._round_seeds(state["round"], batch).items()}
    lr = tr._lr(0.05)
    want, wm = tr.step_fn(state, batch, lr, seeds)
    want = tr.agg_fn(want, seeds)

    def refuse(*_a, **_k):
        raise AssertionError("seeds derived on the host inside a round")

    orig = Transport.seed_table
    Transport.seed_table = refuse
    try:
        got, gm = tr.step_fn({**state, "round": 10**6}, batch, lr, seeds)
        got = tr.agg_fn(got, seeds)
    finally:
        Transport.seed_table = orig
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(got),
                                                 state_leaves(want)))
    assert all(torch.equal(gm[k], wm[k]) for k in wm)


@pytest.mark.parametrize("method,server_update",
                         [(m, "sequential") for m in ALL_METHODS]
                         + [("cse_fsl", "batched")])
def test_round_step_reads_lr_tensor_each_call(setup, method, server_update):
    """Repair: the lr is a 0-d fp32 device tensor the round step reads at
    run time -- one tensor, refilled between two calls, gives each call
    its own lr (a captured round replays with the staged lr, not the
    capture's); CSE-FSL's batched server step scales it by n on the
    device."""
    bundle, fed, _ = setup
    fsl = FSLConfig(num_clients=N, h=2, lr=0.05, method=method,
                    server_update=server_update)
    tr = Trainer(bundle, fsl)
    state = tr.init(0)
    batch = tr.to_device(FederatedBatcher(fed, B, 2, seed=0).next_round())
    lr = tr._lr(0.05)
    assert lr.dim() == 0 and lr.dtype == torch.float32
    moved, _ = tr.step_fn(state, batch, lr, {})
    lr.fill_(0.0)
    still, _ = tr.step_fn(state, batch, lr, {})
    for key in ("clients", tr.method.server_key):
        before = tree_leaves(state[key]["params"])
        assert any(not torch.equal(a, b) for a, b in
                   zip(tree_leaves(moved[key]["params"]), before))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(still[key]["params"]), before))


def test_chunk_body_ignores_the_counter_it_was_built_with(setup):
    """Repair: the chunk program's round reads its step, lr and seeds from
    the staged buffers; the host counter in the state it is handed is
    bookkeeping (a captured round holds the capture's), so a wrong counter
    changes nothing on the wire."""
    bundle, fed, _ = setup
    fsl = _fsl("cse_fsl", codec="int8", model_codec="int8")
    tr = Trainer(bundle, fsl)
    batcher = FederatedBatcher(fed, B, 2, seed=0)
    rounds = [batcher.next_round() for _ in range(2)]
    data = tuple(torch.from_numpy(np.stack(x)) for x in zip(*rounds))
    lrs = torch.tensor([0.05, 0.04], dtype=torch.float32)
    per = [tr._round_seeds(u, rounds[0]) for u in (4, 5)]
    seeds = {k: torch.from_numpy(np.stack([p[k] for p in per]))
             for k in per[0]}
    body = tr.chunk_fn.body
    state = {**tr.init(0), "round": 4}
    step = torch.ones(1, dtype=torch.int64)
    want, wm = body(state, data, lrs, seeds, step, True)
    got, gm = body({**state, "round": 999}, data, lrs, seeds, step, True)
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(got),
                                                 state_leaves(want)))
    assert all(torch.equal(gm[k], wm[k]) for k in wm)
