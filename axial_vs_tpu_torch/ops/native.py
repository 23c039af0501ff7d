"""Build and load the hand-written CUDA kernels of the port.

All sources under ``axial_vs_tpu_torch/csrc/`` are compiled by ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``axial_vs_tpu_torch/_build/<hash>/``, keyed by
a hash of the sources and flags, so a fresh checkout builds everything it
needs and a second process reuses the library. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: name -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "axvs_dwconv7x7_ln": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          ctypes.c_float, _P],
    "axvs_msda_fwd": [_P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _I, _I,
                      _I, _I, _I, _P],
}

_lib = None
#: {"seconds": build wall time (0.0 when reused), "log": nvcc output, "path"}
build_info: dict = {}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libaxvs_kernels.so"
    t0 = time.perf_counter()
    if so.exists():
        log = (out_dir / "build.log").read_text() if (out_dir / "build.log").exists() else ""
        seconds = 0.0
    else:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libaxvs_kernels.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        (out_dir / "build.log").write_text(log)
        os.replace(tmp, so)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=seconds, log=log, path=str(so))
    _lib = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
