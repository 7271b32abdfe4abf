"""The VLM family (qwen2-vl-72b) on the CPU, the port against the JAX
package: M-RoPE, the stub image-embedding frontend and the training
engines, and ``train_batch_specs`` for every family.

- ``mrope_pos_ids`` bitwise the reference's at 8 and 256 image positions
  and offsets 0, 5 and 300; sectioned ``apply_rope`` within fp32 rtol
  1e-6 (atol 1e-6 on values of order 1: sin and cos of angles up to a
  few hundred radians round differently in the two libraries);
  ``attn_apply`` rebuilding the three streams from ``ctx.pos`` alone.
- ``reduced()`` field by field (the sections rescaled to the reduced
  head: (8, 12, 12)), ``param_specs`` against the reference's shapes and
  bytes, the registry holding every reference arch.
- ``train_batch_specs`` for every arch: the drawn leaves bitwise the
  reference's (same numpy draws, same order), the specs' shapes and dtypes.
- One CSE-FSL round of reduced qwen2-vl (fp32) through
  ``make_round_step`` from the reference's converted initial state on
  ``train_batch_specs`` draws: metrics and params at rtol 1e-4.
- ``LMBatcher``'s zero ``image_embeds`` and no device pool; the staged
  ``run_compiled`` bitwise ``Trainer.run``; the event engine's round
  within 1e-5 of the loop's; the CLI's ``--out`` JSON on reduced qwen2-vl
  at ``--chunk 2`` against the JAX CLI's (host columns exact, losses at
  rtol 2e-2 in bf16, as ``tests/test_torch_cli.py``); both packages
  refusing population mode for the vlm.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import FSLConfig as JFSLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_config as jget_config
from repro.core.bundle import transformer_bundle as jtransformer_bundle
from repro.core.methods.cse_fsl import init_state as jinit_state
from repro.core.methods.cse_fsl import make_round_step as jmake_round_step
from repro.core.trainer import Trainer as JTrainer
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import blocks as jblocks
from repro.models import layers as JL
from repro.models.model import abstract_params as jabstract_params
from repro.models.model import init_params as jinit_params
from repro_torch.common import bytes_of, tree_map
from repro_torch.configs.base import SHAPES, FSLConfig
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.convert import params_from_numpy, state_from_numpy, \
    state_to_numpy
from repro_torch.core.accounting import CommMeter
from repro_torch.core.async_trainer import AsyncTrainer
from repro_torch.core.bundle import transformer_bundle
from repro_torch.core.graphs import state_leaves
from repro_torch.core.methods.cse_fsl import make_round_step
from repro_torch.core.trainer import Trainer
from repro_torch.launch import specs, train
from repro_torch.launch.train import LMBatcher, LMPool, build_data
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.models.model import param_specs
from repro_torch.population import VirtualPool

NAME = "qwen2-vl-72b"
RTOL = 1e-4
N, H, B, S = 2, 2, 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("p", [8, 256])
@pytest.mark.parametrize("offset", [0, 5, 300])
def test_mrope_pos_ids_equal_reference(p, offset):
    s = 300
    want = np.asarray(JL.mrope_pos_ids(p, 2, s, offset))
    got = L.mrope_pos_ids(p, 2, s, offset)
    assert got.shape == want.shape == (3, 2, s)
    np.testing.assert_array_equal(got.numpy(), want)
    # a 0-d tensor offset (the captured decode's) gives the same streams
    got_t = L.mrope_pos_ids(p, 2, s, torch.tensor(offset))
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_sectioned_rope_matches_reference(sections, hd):
    rng = np.random.default_rng(0)
    s = 384
    x = rng.normal(size=(2, s, 3, hd)).astype(np.float32)
    pos = np.array(JL.mrope_pos_ids(256, 2, s, 40))
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                    sections))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       sections)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                     (4, 4, 4))


def test_attention_block_rebuilds_mrope_positions():
    """One dense block of reduced qwen2-vl (fp32) in training mode at q
    offset 0 and in prefill mode against the reference's block: the
    three streams are rebuilt from the shape and ``ctx.pos``."""
    jcfg = jget_config(NAME).reduced().with_(dtype="float32")
    cfg = get_config(NAME).reduced().with_(dtype="float32")
    jp = jblocks.dense_init(jcfg, jax.random.PRNGKey(3), jnp.float32)
    p = params_from_numpy({"b": jax.tree_util.tree_map(np.asarray, jp)},
                          device="cpu")["b"]
    x = np.random.default_rng(1).normal(size=(2, 24, 256)).astype(np.float32)
    for mode in ("train", "prefill"):
        want, _, _ = jblocks.dense_apply(jcfg, jp, jnp.asarray(x),
                                         jblocks.Ctx(jcfg, mode), None)
        got, _, _ = blocks.dense_apply(cfg, p, torch.from_numpy(x),
                                       blocks.Ctx(cfg, mode), None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-5)


def test_reduced_config_field_by_field():
    want = dataclasses.asdict(jget_config(NAME).reduced())
    got = dataclasses.asdict(get_config(NAME).reduced())
    for k in ("unroll", "dryrun_unroll"):
        want.pop(k, None)
    assert got == want
    assert got["mrope_sections"] == (8, 12, 12)
    assert got["num_image_tokens"] == 8
    assert dataclasses.asdict(get_config(NAME)).items() <= {
        **dataclasses.asdict(jget_config(NAME))}.items()


@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_reference(reduced):
    jcfg, cfg = jget_config(NAME), get_config(NAME)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = jabstract_params(jcfg)
    got = param_specs(cfg)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: np.empty(0), got))
    assert sorted(jax.tree_util.keystr(p) for p, _ in wl) == \
        sorted(jax.tree_util.keystr(p) for p, _ in gl)
    for k in ("client", "aux", "server"):
        assert bytes_of(got[k]) == sum(
            x.size * x.dtype.itemsize
            for x in jax.tree_util.tree_leaves(want[k]))
    assert "embed" in got["client"] and "frontend_w" not in got["client"]


def test_registry_holds_every_reference_arch():
    assert arch_names() == list(JARCHS)


def _specs_pair(name, as_spec):
    jcfg, cfg = jget_config(name), get_config(name)
    if as_spec:
        shape = JSHAPES["train_4k"]
    else:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
        shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=24,
                                    global_batch=4)
    fkw = dict(num_clients=2, h=3)
    want = jspecs.train_batch_specs(jcfg, shape, JFSLConfig(**fkw),
                                    as_spec=as_spec, seed=7)
    got = specs.train_batch_specs(cfg, dataclasses.replace(
        SHAPES["train_4k"], seq_len=shape.seq_len,
        global_batch=shape.global_batch), FSLConfig(**fkw), as_spec=as_spec,
        seed=7, device="cpu")
    return got, want


@pytest.mark.parametrize("name", list(JARCHS))
def test_train_batch_specs_draws_equal_reference(name):
    (inputs, labels), (jinputs, jlabels) = _specs_pair(name, False)
    assert set(inputs) == set(jinputs)
    for k in jinputs:
        assert inputs[k].numpy().dtype == np.asarray(jinputs[k]).dtype
        np.testing.assert_array_equal(inputs[k].numpy(),
                                      np.asarray(jinputs[k]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "hubert-xlarge",
                                  "qwen3-0.6b"])
def test_train_batch_specs_shapes_equal_reference(name):
    (inputs, labels), (jinputs, jlabels) = _specs_pair(name, True)
    assert set(inputs) == set(jinputs)
    for k, t in list(inputs.items()) + [("labels", labels)]:
        w = jlabels if k == "labels" else jinputs[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(w.shape)
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
    with pytest.raises(ValueError, match="multiple"):
        specs.train_batch_specs(get_config(name), SHAPES["train_4k"],
                                FSLConfig(num_clients=3))


def _allclose_tree(got, want, rtol):
    for (path, a), (wpath, w) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(want)):
        assert path == wpath
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(w, np.float32), rtol=rtol,
            atol=1e-5 * max(np.abs(np.asarray(w, np.float32)).max(), 1.0),
            err_msg=jax.tree_util.keystr(path))


def round_against_reference(name):
    """One CSE-FSL round of reduced ``name`` (fp32) through each package's
    ``make_round_step`` from the reference's initial state, on
    ``train_batch_specs`` draws (seed 0): metrics and params at rtol
    1e-4."""
    jcfg = jget_config(name).reduced().with_(dtype="float32")
    cfg = get_config(name).reduced().with_(dtype="float32", use_pallas=True)
    jfsl, fsl = JFSLConfig(num_clients=N, h=H), FSLConfig(num_clients=N, h=H)
    jb = jtransformer_bundle(jcfg)
    jstate = jinit_state(jb, jfsl, jax.random.PRNGKey(0))
    shape = dataclasses.replace(JSHAPES["train_4k"], seq_len=S,
                                global_batch=N * B)
    jbatch = jspecs.train_batch_specs(jcfg, shape, jfsl, as_spec=False)
    jnew, jm = jax.jit(jmake_round_step(jb, jfsl))(jstate, jbatch, 0.05)
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu")
    batch = specs.train_batch_specs(
        cfg, dataclasses.replace(SHAPES["train_4k"], seq_len=S,
                                 global_batch=N * B), fsl, as_spec=False,
        device="cpu")
    step = make_round_step(transformer_bundle(cfg, device="cpu"), fsl)
    new, m = step(state0, batch, 0.05)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    got = state_to_numpy(new)
    want = jax.tree_util.tree_map(np.asarray, jnew)
    for key in ("clients", "server"):
        _allclose_tree(got[key]["params"], want[key]["params"], RTOL)
    before = state_to_numpy(state0)["clients"]["params"]
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(before),
        jax.tree_util.tree_leaves(got["clients"]["params"]))]
    assert any(moved)
    return new


def test_cse_fsl_round_matches_reference():
    new = round_against_reference(NAME)
    emb = new["clients"]["params"]["client"]["embed"]
    assert emb.shape == (N, 512, 256)


def _trainer(**fkw):
    cfg = get_config(NAME).reduced().with_(dtype="float32", use_pallas=True)
    fsl = FSLConfig(num_clients=N, h=H, lr=0.1, **fkw)
    fed = build_data(cfg, fsl, S, 4, non_iid=False, seed=0)
    tr = Trainer(transformer_bundle(cfg, device="cpu"), fsl)
    return tr, lambda: LMBatcher(cfg, fed, B, H, seed=0)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                  state_leaves(b)))


def test_batcher_stages_zero_image_embeds():
    """The reference's batcher: zero fp32 ``image_embeds`` ``[n, h, B, P,
    d]`` beside the tokens, and no device-pool protocol (the reference
    probes it with hasattr)."""
    tr, batcher = _trainer()
    cfg = get_config(NAME).reduced()
    jfed = jtrain.build_data(jget_config(NAME).reduced(),
                             JFSLConfig(num_clients=N, h=H), S, 4, False)
    jb = jtrain.LMBatcher(jget_config(NAME).reduced(), jfed, B, H)
    b = LMBatcher(cfg, build_data(cfg, FSLConfig(num_clients=N, h=H), S, 4,
                                  False), B, H)
    (ji, jy), (gi, gy) = jb.next_round(), b.next_round()
    assert set(gi) == set(ji) == {"tokens", "image_embeds"}
    for k in ji:
        assert gi[k].dtype == np.asarray(ji[k]).dtype
        np.testing.assert_array_equal(gi[k], np.asarray(ji[k]))
    np.testing.assert_array_equal(gy, np.asarray(jy))
    for attr in ("device_pool", "next_round_indices"):
        assert hasattr(jb, attr) == hasattr(b, attr) is False


def test_staged_run_compiled_and_event_engine_match_the_loop():
    """``run_compiled`` stages the vlm's batches (no device pool) and is
    bitwise ``Trainer.run`` (int8 uplink and model sync); the event engine
    at zero latency runs the host-staged inputs, its round within 1e-5 of
    the loop's (it runs each client alone, the loop vmaps them)."""
    tr, batcher = _trainer(codec="int8", model_codec="int8")
    m1, m2 = CommMeter(), CommMeter()
    s1, h1 = tr.run(tr.init(0), batcher(), 2, log_every=1, meter=m1)
    s2, h2 = tr.run_compiled(tr.init(0), batcher(), 2, chunk=2,
                             log_every=1, meter=m2)
    assert _same(s1, s2) and h1 == h2 and m1.as_dict() == m2.as_dict()
    tr, batcher = _trainer()
    want, _ = tr.run(tr.init(0), batcher(), 1, log_every=1)
    eng = AsyncTrainer(tr.bundle, tr.fsl)
    got, ehist = eng.run(eng.init(0), batcher(), 1, log_every=1)
    for a, b in zip(state_leaves(got), state_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert np.isfinite([r[k] for r in ehist for k in r
                        if k.endswith("loss")]).all()


CLI = ["--arch", NAME, "--size", "reduced", "--rounds", "2", "--clients",
       "2", "--h", "2", "--batch", "1", "--seq", "16", "--samples", "4",
       "--log-every", "1", "--chunk", "2"]
EXACT = {"round", "aggregated", "comm_bytes"}


def test_cli_out_json_matches_reference(tmp_path, monkeypatch):
    """The two CLIs on reduced qwen2-vl (bf16) at ``--chunk 2``: the port
    from the reference's initial state."""
    path = str(tmp_path / "ref.json")
    argv0 = sys.argv
    try:
        sys.argv = ["train"] + CLI + ["--out", path]
        jtrain.main()
    finally:
        sys.argv = argv0
    with open(path) as f:
        want = json.load(f)
    jcfg = jget_config(NAME).reduced()
    jtr = JTrainer(jtransformer_bundle(jcfg),
                   JFSLConfig(num_clients=2, h=2, lr=0.1), donate=False)
    init = jax.tree_util.tree_map(np.asarray, jtr.init(0))
    monkeypatch.setattr(Trainer, "init", lambda self, seed=0:
                        state_from_numpy(init, device=self.device))
    out = str(tmp_path / "port.json")
    _, hist = train.main(CLI + ["--out", out, "--device", "cpu"])
    with open(out) as f:
        got = json.load(f)
    assert set(got) == set(want)
    assert set(got["args"]) - {"device"} == set(want["args"])
    for key in ("comm", "participation", "faults", "population", "memory",
                "wallclock", "record"):
        assert got[key] == want[key], key
    assert len(got["history"]) == len(want["history"]) == 2
    for row, jrow in zip(got["history"], want["history"]):
        assert set(row) == set(jrow)
        for k in set(row) & EXACT:
            assert row[k] == jrow[k], (row["round"], k)
        for k in set(row) - EXACT:
            np.testing.assert_allclose(row[k], jrow[k], rtol=2e-2,
                                       err_msg=f"round {row['round']} {k}")


def test_population_mode_refuses_the_vlm():
    msg = "population mode needs poolable"
    argv = CLI + ["--population", "10"]
    argv0 = sys.argv
    try:
        sys.argv = ["train"] + argv
        with pytest.raises(ValueError, match=msg):
            jtrain.main()
    finally:
        sys.argv = argv0
    with pytest.raises(ValueError, match=msg):
        train.main(argv + ["--device", "cpu"])
    cfg = get_config(NAME).reduced()
    x = np.zeros((8, 17), np.int32)
    with pytest.raises(ValueError, match=f"{NAME} is a vlm"):
        LMPool(cfg, VirtualPool(x[:, :-1], x[:, 1:], d_local=4,
                                batch_size=1, h=2))


def test_prefill_full_forward_take_image_embeds():
    """``full_forward`` of reduced qwen2-vl (fp32) from the reference's
    params on the same tokens and image embeddings: the merge of the
    first P positions and M-RoPE through both stages."""
    from repro.models.model import full_forward as jfull_forward
    from repro_torch.models.model import full_forward
    jcfg = jget_config(NAME).reduced().with_(dtype="float32")
    cfg = get_config(NAME).reduced().with_(dtype="float32")
    jp = jinit_params(jcfg, jax.random.PRNGKey(4))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                          device="cpu")
    inputs = specs.prefill_specs(cfg, dataclasses.replace(
        SHAPES["prefill_32k"], seq_len=24, global_batch=2), as_spec=False,
        device="cpu")
    want = jfull_forward(jcfg, jp, {k: jnp.asarray(v.numpy())
                                    for k, v in inputs.items()},
                         jblocks.Ctx(jcfg, "train"))
    got = full_forward(cfg, p, inputs, blocks.Ctx(cfg, "train"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    # the image positions matter: zeroing them moves the first P rows
    zero = dict(inputs, image_embeds=torch.zeros_like(inputs["image_embeds"]))
    moved = full_forward(cfg, p, zero, blocks.Ctx(cfg, "train"))
    assert not torch.allclose(moved[:, :8], got[:, :8])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fedavg_in_slices_is_bitwise_the_whole_leaf(dtype, monkeypatch):
    """A leaf of SLICE_NUMEL elements or more a client (the full-width
    vlm's embedding) is averaged in slices of dim 1: the bits of the whole
    leaf's fp32 mean, broadcast; a smaller leaf in one piece."""
    from repro_torch.core.methods import base
    g = torch.Generator().manual_seed(0)
    tree = {"big": torch.randn((4, 1000, 24), generator=g).to(dtype),
            "small": torch.randn((4, 30), generator=g).to(dtype)}
    want = {k: (x.float().sum(0, keepdim=True) * 0.25).expand(x.shape)
            .to(dtype) for k, x in tree.items()}
    monkeypatch.setattr(base, "SLICE_NUMEL", 1000)
    got = base.fedavg(tree)
    for k in tree:
        assert torch.equal(got[k], want[k]), k
        assert got[k].is_contiguous()


def test_donated_state_updates_the_clients_in_place_with_the_same_bits(
        monkeypatch):
    """Under ``donated_state()`` (the captured round's) the CSE-FSL
    clients' SGD steps write into the state handed in the leaves they
    slice (``SLICE_NUMEL`` elements a client or more; 4,096 here): the
    same bits as the functional round, those handed-in client params
    holding them and the smaller ones left as they were."""
    import repro_torch.optim as optim
    from repro_torch.core.methods.base import donated_state
    monkeypatch.setattr(optim, "SLICE_NUMEL", 4096)
    tr, batcher = _trainer()
    batch = tr.to_device(batcher().next_round())
    state = tr.init(0)

    def copy(st):
        return {k: (v if k == "round" else tree_map(torch.clone, v))
                for k, v in st.items()}

    want, wm = tr.step(copy(state), batch)
    given = copy(state)
    with donated_state():
        got, gm = tr.step(given, batch)
    assert _same(got, want) and wm.keys() == gm.keys()
    assert all(torch.equal(wm[k], gm[k]) for k in wm)
    big = 0
    for a, b, c in zip(*(state_leaves({"c": s["clients"]["params"]})
                         for s in (given, want, state))):
        sliced = a[0].numel() >= 4096
        big += sliced
        assert torch.equal(a, b if sliced else c)
    assert big > 0
    # without it the state handed in is left as it was
    again = copy(state)
    tr.step(again, batch)
    assert _same(again, state)
