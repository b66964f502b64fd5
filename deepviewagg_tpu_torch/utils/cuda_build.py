"""Build the package's hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``_build/lib<name>-<source hash>.so``, which is
loaded with ``ctypes``.  Sources come from the package alone, so a fresh
checkout builds everything it needs; a build failure raises (there is no
fallback on a machine with a card).  ``build`` starts one ``nvcc`` per source,
all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["KERNELS", "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

# kernel name -> C signature (argtypes, restype) of its entry point
_P, _I = ctypes.c_void_p, ctypes.c_int
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


def _target(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = tuple(KERNELS)) -> None:
    """Compile every named kernel whose library is missing, in parallel."""
    _BUILD.mkdir(exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in KERNELS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib
