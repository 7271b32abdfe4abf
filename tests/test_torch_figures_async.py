"""The port's event-engine drivers (``repro_torch.benchmarks``:
``fig6_async_order``, ``fig_sched``, ``fig_wallclock``) against the JAX
package's (``benchmarks/``), each ``main`` run whole on both sides on the
CPU.

Each side trains from the reference's initial state: the port's
``AsyncTrainer`` is swapped, inside the driver module, for a subclass
whose ``init`` returns the reference's ``init_state`` carried across by
``repro_torch.convert``, and whose int8 wires take the reference's own
``jax.random`` bits (``Transport.bits_fn``: salts 0 and 2 fold the client
into the unit key, as the reference's engine and wire aggregate do).
``fig6_async_order`` runs with both modules' ``ROUNDS`` set to 4;
``fig_sched`` and ``fig_wallclock`` run their ``--smoke`` sets.

Held exactly: the simulated times of every curve point, the arrival
orders, ``AsyncStats``, the participation summaries and the meters.
Accuracies within one test sample of the reference's (as
``tests/test_torch_figures.py`` holds the other figure scripts), Fig 6's
server distances at rtol 1e-3.  Each driver's claims hold in both packages, or
fail in both on the same row.
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FSLConfig as JFSLConfig
from repro.core.bundle import cnn_bundle as jcnn_bundle
from repro.core.methods import get_method as jget_method
from repro.models.cnn import CIFAR10 as JCIFAR10
from repro_torch.benchmarks import (common, fig6_async_order, fig_sched,
                                    fig_wallclock)
from repro_torch.convert import state_from_numpy
from repro_torch.core import async_trainer as at
from repro_torch.core.methods import get_method

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jbench(monkeypatch, tmp_path):
    """The JAX package's scripts (``benchmarks/`` at the repo root); both
    packages' outputs go to ``tmp_path``."""
    monkeypatch.syspath_prepend(str(ROOT))
    import importlib
    jcommon = importlib.import_module("benchmarks.common")
    monkeypatch.setattr(jcommon, "OUT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path / "port"))
    return lambda name: importlib.import_module(f"benchmarks.{name}")


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _port_paths(v, prefix + (k,))]
    return [prefix]


def _leaf_map(method, port_params, ref_params):
    """Port leaf index -> the reference's leaf index of the same param."""
    keys = dict((pk, rk) for rk, pk in get_method(method).client_keys or ())

    def ref_path(path):
        if keys:
            path = (keys[path[0]],) + path[1:]
        name = path[-1]
        if name.endswith(".weight") or name.endswith(".bias"):
            layer, kind = name.rsplit(".", 1)
            path = path[:-1] + (layer, "w" if kind == "weight" else "b")
        return path

    ref = [tuple(k.key for k in p) for p, _ in
           jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    return [ref.index(ref_path(p)) for p in _port_paths(port_params)]


def _jbits_fn(jtp, leaf_of):
    """The reference's bits on every channel: the engine's per-client
    uplink/downlink keys (salts 0/1), the wire aggregate's model-sync keys
    (salt 2 folds the client in, salt 3 codes the one average), each leaf
    folded in by its index in the reference's tree."""
    def bits_fn(unit, client, leaf, salt, shape):
        if salt < 2:
            key = jtp.unit_key(unit, client=client, salt=salt)
        else:
            key = jtp.unit_key(unit, salt=salt)
            if salt == 2:
                key = jax.random.fold_in(key, client)
            leaf = leaf_of[leaf]
        key = jax.random.fold_in(key, leaf)
        return np.asarray(jax.random.bits(key, shape, jax.numpy.uint32))
    return bits_fn


def _with_reference(monkeypatch, mod, jbundles):
    """Swap ``mod.AsyncTrainer`` for one that starts from the reference's
    initial state and codes with the reference's bits."""
    from repro.transport import resolve_transport as jresolve_transport

    class RefInit(at.AsyncTrainer):
        def _jfsl(self):
            names = {f.name for f in dataclasses.fields(JFSLConfig)}
            return JFSLConfig(**{f.name: getattr(self.fsl, f.name)
                                 for f in dataclasses.fields(self.fsl)
                                 if f.name in names})

        def _jstate(self, seed):
            return jax.tree_util.tree_map(np.asarray, jget_method(
                self.method.name).init_state(jbundles[self.bundle.name],
                                             self._jfsl(),
                                             jax.random.PRNGKey(seed)))

        def __post_init__(self):
            super().__post_init__()
            jtp = jresolve_transport(None, self._jfsl())
            leaf_of = _leaf_map(self.method.name,
                                self.init(0)["clients"]["params"],
                                self._jstate(0)["clients"]["params"])
            self.transport = dataclasses.replace(
                self.transport, bits_fn=_jbits_fn(jtp, leaf_of))
            self._agg_fn = self.method.make_wire_aggregate(
                self.bundle, self.fsl, transport=self.transport)
            if hasattr(self, "_magg_fn"):
                self._magg_fn = self.method.make_wire_aggregate(
                    self.bundle, self.fsl, transport=self.transport,
                    participation=True,
                    refresh=self.scheduler.refresh_dropped)

        def init(self, seed=0):
            return state_from_numpy(self._jstate(seed), device="cpu",
                                    method=self.method.name)

    monkeypatch.setattr(mod, "AsyncTrainer", RefInit)


def _recording(monkeypatch, mod, name="run_one", arg=False):
    """Record every call of ``mod.<name>``: its result, or with ``arg`` its
    first argument."""
    calls = []
    fn = getattr(mod, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        calls.append(a[0] if arg else out)
        return out

    monkeypatch.setattr(mod, name, wrapped)
    return calls


def _claims(run):
    """``(None, result)`` or ``(the AssertionError's argument, None)``."""
    try:
        return None, run()
    except AssertionError as e:
        return (e.args[0] if e.args else "assert"), None


def _close_curves(got, want, n_test):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["round"] == w["round"] and g["t"] == w["t"], (g, w)
        assert abs(g["acc"] - w["acc"]) <= 1.0 / n_test + 1e-7, (g, w)


def test_fig6_matches_reference(jbench, monkeypatch):
    """4 rounds a latency seed: the three traces' arrival orders, each
    final accuracy and server distance, and the claims' outcome."""
    jfig = jbench("fig6_async_order")
    for mod in (jfig, fig6_async_order):
        monkeypatch.setattr(mod, "ROUNDS", 4)
    assert dataclasses.asdict(fig6_async_order.CNN) == \
        dataclasses.asdict(jfig.CNN)
    _with_reference(monkeypatch, fig6_async_order,
                    {"fig6_cnn": jcnn_bundle(jfig.CNN)})
    tables = (_recording(monkeypatch, fig6_async_order, "table", arg=True),
              _recording(monkeypatch, jfig, "table", arg=True))
    got = _claims(lambda: fig6_async_order.main("cpu"))
    want = _claims(lambda: jfig.main())
    (grows,), (wrows,) = tables
    assert [r["arrival_order"] for r in grows] == \
        [r["arrival_order"] for r in wrows]
    assert len({r["arrival_order"] for r in grows}) > 1
    for g, w in zip(grows, wrows):
        assert abs(g["acc"] - w["acc"]) <= 1.0 / 4000 + 1e-4, (g, w)
        np.testing.assert_allclose(g["server_rel_dist"],
                                   w["server_rel_dist"], rtol=1e-3,
                                   atol=2e-5)
    # the spread claim: held in both, or failed in both on close accuracies
    assert (got[0] is None) == (want[0] is None), (got, want)
    if got[0] is None:
        accs = got[1]["accs"], want[1]["accs"]
    else:
        accs = got[0], want[0]
    assert set(accs[0]) == set(accs[1])
    for k in accs[1]:
        assert abs(accs[0][k] - accs[1][k]) <= 1.0 / 4000 + 1e-7, accs


def test_fig_sched_smoke_matches_reference(jbench, monkeypatch):
    """The ``--smoke`` set (4 rounds, tiered, wait_all and deadline): each
    run's curve, AsyncStats and participation summary."""
    jfig = jbench("fig_sched")
    _with_reference(monkeypatch, fig_sched, {"cifar10_cnn": jcnn_bundle(
        JCIFAR10)})
    runs = (_recording(monkeypatch, fig_sched),
            _recording(monkeypatch, jfig))
    kw = dict(rounds=4, nets=("tiered",), policies=("wait_all", "deadline"))
    got = _claims(lambda: fig_sched.main("cpu", **kw))
    want = _claims(lambda: jfig.main(**kw))
    assert len(runs[0]) == len(runs[1]) == 2
    for (curve, stats, part), (jcurve, jstats, jpart) in zip(*runs):
        _close_curves(curve, jcurve, 400)
        assert stats == jstats
        assert part == jpart
    assert runs[0][1][1]["skipped"] > 0
    assert (got[0] is None) == (want[0] is None), (got, want)
    if got[0] is not None:
        assert got[0] == want[0]


def test_fig_wallclock_smoke_matches_reference(jbench, monkeypatch):
    """The ``--smoke`` set (4 rounds, 4g, the identity and int8 codecs,
    int8 on the model sync too): each run's curve and meter."""
    jfig = jbench("fig_wallclock")
    _with_reference(monkeypatch, fig_wallclock, {"cifar10_cnn": jcnn_bundle(
        JCIFAR10)})
    runs = (_recording(monkeypatch, fig_wallclock),
            _recording(monkeypatch, jfig))
    kw = dict(rounds=4, tiers=("4g",), codecs=("none", "int8"))
    got = _claims(lambda: fig_wallclock.main("cpu", **kw))
    want = _claims(lambda: jfig.main(**kw))
    assert len(runs[0]) == len(runs[1]) == 2
    for (curve, meter), (jcurve, jmeter) in zip(*runs):
        _close_curves(curve, jcurve, 400)
        assert meter.as_dict() == jmeter.as_dict()
    assert runs[0][1][1].counts["model_sync"] < \
        runs[0][0][1].counts["model_sync"] / 3.5
    assert (got[0] is None) == (want[0] is None), (got, want)
    if got[0] is not None:
        assert got[0] == want[0]
