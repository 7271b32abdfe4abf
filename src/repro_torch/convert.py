"""Weights across: the JAX package's state as numpy arrays <-> the port's.

CNN params: the reference keeps conv weights HWIO and dense weights
``[din, dout]`` under ``{layer: {"w", "b"}}``; the port keeps
``nn.Module`` layouts — conv ``weight`` OIHW, ``nn.Linear`` ``weight``
``[dout, din]`` — under ``{"layer.weight", "layer.bias"}``.  The smashed
tensor is NHWC in both, so dense weights need only the transpose.

Transformer params keep the reference's tree, its ``[din, dout]`` weights
and its stacked ``[L, ...]`` layer axis, so they cross leaf for leaf; only
the dtype moves (numpy has no bf16: ``ml_dtypes`` bf16 arrays cross as
their uint16 bit patterns).  A leading stacked-client dim, where present,
is carried through.

Reference state (``repro`` ``Trainer.init``) -> port state::

  {"clients": {"params": {"params": C, "aux": A}, "opt": O(C, A)},
   "server": {"params": S, "opt": O(S)}, "round": r}
  ->
  {"clients": {"params": {"client": C', "aux": A'}, "opt": O(C', A')},
   "server": {"params": S', "opt": O(S')}, "round": int(r)}

with optimizer states ``()`` (sgd), ``{"m"}`` (momentum) or
``{"m", "v", "t"}`` (adam) converted leafwise like the params they shadow.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common import tree_map

_CLIENT_KEYS = (("params", "client"), ("aux", "aux"))   # reference, port


def _weight_axes(ndim: int, conv: bool, to_port: bool):
    """Permutation of a weight's axes: the trailing HWIO <-> OIHW (conv) or
    [din, dout] <-> [dout, din] (dense), leading stacked dims kept."""
    k = ndim - (4 if conv else 2)
    tail = ((3, 2, 0, 1) if to_port else (2, 3, 1, 0)) if conv else (1, 0)
    return tuple(range(k)) + tuple(k + a for a in tail)


def _layers_from_numpy(layers: Dict[str, Dict[str, Any]], device):
    """``{layer: {"w", "b"}}`` -> ``{"layer.weight", "layer.bias"}``."""
    out = {}
    for name, p in layers.items():
        w, b = np.asarray(p["w"]), np.asarray(p["b"])
        axes = _weight_axes(w.ndim, w.ndim - b.ndim == 3, to_port=True)
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(axes))).to(device)
        out[f"{name}.bias"] = torch.from_numpy(b.copy()).to(device)
    return out


def _layers_to_numpy(params: Dict[str, torch.Tensor]):
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, t in params.items():
        name, kind = key.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if kind == "weight":
            conv = a.ndim - params[f"{name}.bias"].dim() == 3
            a = np.ascontiguousarray(
                a.transpose(_weight_axes(a.ndim, conv, to_port=False)))
        out.setdefault(name, {})["w" if kind == "weight" else "b"] = a
    return out


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (``ml_dtypes`` bf16 included) as a tensor, bit for
    bit."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`tensor_from_numpy` (bf16 -> ``ml_dtypes``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _is_cnn(params, port: bool) -> bool:
    """A CNN parameter dict: ``{layer: {"w", "b"}}`` (reference) or
    ``{"layer.weight": ...}`` (port); anything else is a transformer tree."""
    if not isinstance(params, dict) or not params:
        return False
    if port:
        return all("." in k and isinstance(v, torch.Tensor)
                   for k, v in params.items())
    return all(isinstance(v, dict) and set(v) == {"w", "b"}
               for v in params.values())


def _from_numpy(params, device):
    if _is_cnn(params, port=False):
        return _layers_from_numpy(params, device)
    return tree_map(lambda a: tensor_from_numpy(a, device), params)


def _to_numpy(params):
    if _is_cnn(params, port=True):
        return _layers_to_numpy(params)
    return tree_map(tensor_to_numpy, params)


def _opt_from_numpy(opt, convert_params, device):
    if isinstance(opt, (tuple, list)) and len(opt) == 0:
        return ()
    out = {k: convert_params(opt[k]) for k in ("m", "v") if k in opt}
    if "t" in opt:
        out["t"] = torch.from_numpy(np.asarray(opt["t"])).to(device)
    return out


def _opt_to_numpy(opt, convert_params):
    if isinstance(opt, (tuple, list)) and len(opt) == 0:
        return ()
    out = {k: convert_params(opt[k]) for k in ("m", "v") if k in opt}
    if "t" in opt:
        out["t"] = opt["t"].detach().cpu().numpy()
    return out


def state_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """The reference ``Trainer.init`` state (as numpy arrays) -> the port's
    state on ``device``."""
    def client(p):
        return {pk: _from_numpy(p[rk], device) for rk, pk in _CLIENT_KEYS}

    def server(p):
        return _from_numpy(p, device)

    cl, sv = tree["clients"], tree["server"]
    return {
        "clients": {"params": client(cl["params"]),
                    "opt": _opt_from_numpy(cl["opt"], client, device)},
        "server": {"params": server(sv["params"]),
                   "opt": _opt_from_numpy(sv["opt"], server, device)},
        "round": int(np.asarray(tree["round"])),
    }


def state_to_numpy(state) -> Dict[str, Any]:
    """Inverse of :func:`state_from_numpy`, in the reference's layout."""
    def client(p):
        return {rk: _to_numpy(p[pk]) for rk, pk in _CLIENT_KEYS}

    cl, sv = state["clients"], state["server"]
    return {
        "clients": {"params": client(cl["params"]),
                    "opt": _opt_to_numpy(cl["opt"], client)},
        "server": {"params": _to_numpy(sv["params"]),
                   "opt": _opt_to_numpy(sv["opt"], _to_numpy)},
        "round": np.int32(state["round"]),
    }


def params_from_numpy(params, device="cuda") -> Dict[str, Any]:
    """Reference ``bundle.init`` params ``{"client", "aux", "server"}`` (or
    a gradient of them) -> the port's parameter dicts."""
    return {k: _from_numpy(v, device) for k, v in params.items()}


def params_to_numpy(params) -> Dict[str, Any]:
    """Inverse of :func:`params_from_numpy`."""
    return {k: _to_numpy(v) for k, v in params.items()}
