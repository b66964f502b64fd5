"""Build the package's native libraries at first use and load them.

Each library has one source with a plain C interface: the hand-written CUDA
kernels (``csrc/<name>.cu``, compiled by ``nvcc`` for Hopper, ``sm_90a``) and
the host C++ builders (``native/<name>.cpp``, compiled by ``g++``).  The
library goes to ``_build/lib<name>-<source hash>.so`` (written to a
per-process temporary file, then renamed, so that processes building at once
leave one whole library) and is loaded with ``ctypes``.  Sources come from
the package alone, so a fresh checkout builds everything it needs; a build
failure raises with the compiler's log (there is no fallback).  ``build``
starts one compiler per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["KERNELS", "HOST", "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
_BUILD = _PKG / "_build"

# library name -> C signature (argtypes, restype) of each entry point
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
KERNELS: Dict[str, Dict[str, tuple]] = {
    "segment_csr": {
        "segment_csr_f32": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
                            _I),
    },
    "segment_csr_bwd": {
        "segment_csr_bwd_f32": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
                                _I),
    },
}
HOST: Dict[str, Dict[str, tuple]] = {
    "kernelmap": {
        "dva_build_kernel_map": ((_P, _L, _P, _L, _P, _L, ctypes.c_int32, _L,
                                  _L, _P, _I, _P), _I),
        "dva_unique_inverse": ((_P, _L, _P, _P, _P, _P), _I),
        "dva_query_coords": ((_P, _L, _P, _L, _P, _P), _I),
        "dva_knn_grid": ((_P, _L, _P, _L, _L, ctypes.c_double, _P, _P, _I),
                         _I),
    },
    "images": {
        "dva_jitter_gray": ((_P, _I, _L, _L, _P, _I, _P, _P, _I), _I),
        "dva_jitter_normalize": ((_P, _I, _L, _L, _P, _I, _P, _P, _I, _P, _P,
                                  _P, _I), _I),
    },
}
# extra g++ flags of a host library: the image pass must round as numpy does
_HOST_FLAGS: Dict[str, list] = {"images": ["-ffp-contract=off"]}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _gxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("g++ not found: the host builders (native/) need a "
                       "C++17 compiler on PATH")


def _source(name: str) -> Path:
    if name in KERNELS:
        return _PKG / "csrc" / f"{name}.cu"
    if name in HOST:
        return _PKG / "native" / f"{name}.cpp"
    raise KeyError(f"no native library {name!r}")


def _command(name: str, out: Path) -> list:
    src = str(_source(name))
    if name in KERNELS:
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-o", str(out), src]
    return [_gxx(), "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            *_HOST_FLAGS.get(name, ()), "-o", str(out), src]


def _target(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = tuple(KERNELS) + tuple(HOST)) -> None:
    """Compile every named library that is missing, in parallel."""
    _BUILD.mkdir(exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{_source(name).name} failed to build:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in {**KERNELS, **HOST}[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib
