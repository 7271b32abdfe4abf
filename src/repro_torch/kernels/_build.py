"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/`` at the repo root
(listed in ``.gitignore``), at first use and again whenever the source or
any ``csrc/*.cuh`` header (``hopper.cuh``, the Hopper building blocks) is
newer than the library, and loaded with ``ctypes``.  All sources build in
parallel, one ``nvcc`` each.  No ``--use_fast_math``: the quantizer's
divide must stay IEEE-rounded.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported launchers: pointers and the stream are
# c_void_p (ctypes would otherwise cut them to 32-bit ints), group strides
# c_longlong.
_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "quantize": {
        "quantize_bits": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "quantize_philox": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "fused_ce": {
        "fused_ce_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L,
                         _L, _I, _I, _I, _P],
        "fused_ce_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _L, _L, _I, _I, _P],
    },
    "swa_attention": {
        "swa_attention_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        "swa_attention_tc": [_P] * 5 + [_I] * 6 + [_F, _P],
        "swa_bwd_delta": [_P] * 3 + [_I] * 4 + [_P],
        "swa_bwd_dkdv": [_P] * 8 + [_I] * 6 + [_F, _P],
        "swa_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _P],
    },
    "ssm_scan": {
        "ssm_scan_fwd": [_P] * 9 + [_I] * 6 + [_P],
        "ssm_scan_bwd": [_P] * 15 + [_I] * 6 + [_P],
        "ssm_scan_bwd_sum": [_P] * 8 + [_I] * 6 + [_P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # ptxas report of each fresh build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile the stale sources among ``names``, all at once; raises with
    nvcc's stderr on a failed build.  Returns the paths of the libraries it
    built."""
    stale = [n for n in names if _stale(n)]
    if not stale:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in stale:
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        BUILD_LOG[name] = out + err
        os.replace(tmp, _lib_path(name))    # atomic: never a half-written .so
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: str(_lib_path(n)) for n in stale}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
