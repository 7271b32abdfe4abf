"""The port's checkpoint module (``repro_torch.checkpoint``): save/restore
of trees of bf16, fp32 and int tensors (and the host round counter)
bitwise, the manifest, restore onto another device and from ``meta``
templates, and the JAX package's on-disk format both ways: a file the
reference writes restores in the port, and one the port writes restores in
the reference, bit for bit.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as ckpt
from repro_torch.common import tree_leaves


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"conv.weight": torch.randn(4, 3, 3, 3, generator=g),
                       "emb": torch.randn(5, 7, generator=g).bfloat16()},
            "opt": ({"m": torch.randn(6, generator=g)}, ()),
            "steps": torch.arange(5, dtype=torch.int32),
            "codes": torch.randint(-128, 128, (3, 4), generator=g,
                                   dtype=torch.int8),
            "round": 17}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_roundtrip_bitwise_and_manifest(tmp_path):
    tree = _tree()
    path = os.path.join(tmp_path, "sub", "ckpt")
    ckpt.save(path, tree, step=17, extra={"note": "x", "ids": [1, 2]})
    got = ckpt.restore(path, tree)
    _equal(got, tree)
    man = ckpt.manifest(path)
    assert man["step"] == 17 and man["extra"] == {"note": "x", "ids": [1, 2]}
    assert man["keys"] == sorted(
        ["params/conv.weight", "params/emb", "opt/0/m", "steps", "codes",
         "round"])
    npz = np.load(path + ".npz")
    assert npz["params/emb"].dtype == np.float32       # bf16 widened
    assert npz["round"].shape == ()
    # ".npz" suffixes are optional and equivalent
    _equal(ckpt.restore(path + ".npz", tree), tree)
    assert ckpt.manifest(path + ".npz") == man


def test_restore_from_meta_template_onto_a_device(tmp_path):
    tree = _tree()
    path = os.path.join(tmp_path, "c")
    ckpt.save(path, tree)
    like = {k: (v if not isinstance(v, torch.Tensor) else
                torch.empty(v.shape, dtype=v.dtype, device="meta"))
            for k, v in tree.items() if k not in ("params", "opt")}
    got = ckpt.restore(path, like, device="cpu")
    assert got["steps"].device.type == "cpu"
    _equal(got, {k: tree[k] for k in like})
    with pytest.raises(AssertionError):
        ckpt.restore(path, {"steps": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(KeyError):
        ckpt.restore(path, {"missing": torch.zeros(1)})


def test_format_matches_reference(tmp_path):
    """Reference -> port and port -> reference, bf16 and int leaves
    included; both manifests hold the same fields."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    e = rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16)
    jtree = {"a": {"w": jnp.asarray(w), "e": jnp.asarray(e)},
             "r": jnp.asarray(np.int32(9)), "seq": (jnp.arange(3),)}
    jpath = os.path.join(tmp_path, "ref")
    jckpt.save(jpath, jtree, step=3, extra={"k": 1})
    like = {"a": {"w": torch.zeros(3, 4), "e": torch.zeros(
        2, 5, dtype=torch.bfloat16)}, "r": 0,
        "seq": (torch.zeros(3, dtype=torch.int64),)}
    got = ckpt.restore(jpath, like)
    assert torch.equal(got["a"]["w"], torch.from_numpy(w))
    assert got["a"]["e"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["a"]["e"].view(torch.int16).numpy(), e.view(np.int16))
    assert got["r"] == 9 and torch.equal(got["seq"][0], torch.arange(3))
    assert ckpt.manifest(jpath) == jckpt.manifest(jpath)

    ppath = os.path.join(tmp_path, "port")
    ckpt.save(ppath, got, step=3, extra={"k": 1})
    back = jckpt.restore(ppath, jtree)
    np.testing.assert_array_equal(np.asarray(back["a"]["w"]), w)
    np.testing.assert_array_equal(
        np.asarray(back["a"]["e"]).view(np.int16), e.view(np.int16))
    assert int(back["r"]) == 9
    with open(ppath + ".json") as f, open(jpath + ".json") as g:
        assert json.load(f) == json.load(g)
