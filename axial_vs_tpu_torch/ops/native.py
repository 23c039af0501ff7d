"""Build and load the hand-written CUDA kernels of the port.

All sources under ``axial_vs_tpu_torch/csrc/`` are compiled by ``nvcc``, one
process per source in parallel, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The
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

#: bound on |kernel - plain| / max|plain| of the f32 instantiations of K1,
#: K2 and K3. Both sides compute in f32 and only sum in other orders (the
#: kernels' FMA chains against cuDNN, cuBLAS or the CPU), which moves a
#: result by a few f32 ulps of its sums, about 1e-6 of max|out|; TF32
#: products (a 10-bit mantissa) would move it by about 5e-4 and fail.
F32_REL_BOUND = 1e-4

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: name -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "axvs_dwconv7x7_ln": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          ctypes.c_float, _P],
    "axvs_dwconv7x7_ln_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              ctypes.c_float, _P],
    "axvs_msda_fwd": [_P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P],
    "axvs_msda_fwd_f32": [_P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _P],
    "axvs_traj_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, ctypes.c_float, _P],
    "axvs_traj_smem_bytes": [_I, _I, _I, _I],
    "axvs_traj_fwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, ctypes.c_float, _P],
    "axvs_traj_smem_bytes_f32": [_I, _I, _I, _I],
    "axvs_convnext_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P],
    "axvs_convnext_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "axvs_corner_reduce_multi": [ctypes.POINTER(_P), _I, _P, _P, _I, _I, _P],
    "axvs_corner_reduce_v5": [ctypes.POINTER(_P), _I, _I, _P, _P, _I, _I, _I,
                              _P],
    "axvs_pack_corner_table": [_P, _P, _I, _I, ctypes.c_longlong, _I, _I, _I,
                               _P],
    "axvs_scale_copy": [_P, _P, ctypes.c_longlong, _P],
    "axvs_sum_n": [ctypes.POINTER(_P), _I, _P, ctypes.c_longlong, _P],
    "axvs_column_gather": [_P, _P, _P, _I, _I, _I, _I, _P],
    "axvs_slab_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "axvs_dwconv_variant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            ctypes.c_float, _I, _P],
    "axvs_overlap_vpu": [_P, _P, _I, _I, _I, _P],
    "axvs_overlap_mxu": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "axvs_overlap_both": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P],
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
        tag = os.getpid()
        # one nvcc per source, all at once; then one link
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        tmp = out_dir / f"libaxvs_kernels.{tag}.tmp.so"
        link = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                *[str(obj) for _, obj, _ in jobs]]
        outs = [proc.communicate()[0] for _, _, proc in jobs]  # wait for all
        log = "".join(outs)
        for (cmd, _, proc), out in zip(jobs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{log}")
        for _, obj, _ in jobs:
            obj.unlink()
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


def on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version's case),
    False when all lie on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def refuse_grad(*tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and a tensor argument
    requires grad. K1 and K4-K8 and the probes have no backward: a launch
    would hand back an output without ``grad_fn`` and silently cut the
    graph. Their wrappers call this before they launch on the card; run
    inference under ``torch.inference_mode()`` or ``torch.no_grad()``. K2
    and K3 (``ops/msda.py``, ``ops/traj.py``) do not: under grad they run
    as autograd Functions whose backward is ``plain_vjp`` of their plain
    versions."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            "a CUDA kernel of the port has no backward: call it under "
            "torch.inference_mode() or torch.no_grad(), or on tensors that "
            "do not require grad")


def plain_vjp(fn, inputs, grad_out, name: str = "plain VJP"):
    """The VJP of ``fn`` at ``inputs`` against ``grad_out``, recomputed
    under grad mode from detached copies of the inputs: one gradient per
    input, in that input's dtype, None for an input that needs none. The
    backward of K2's and K3's autograd Functions, as the JAX package's
    custom VJPs take ``jax.vjp`` of their plain math. It runs inside a
    profiler range called ``name``."""
    import torch

    leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
    wanted = [t for t in leaves if t.requires_grad]
    with torch.profiler.record_function(name), torch.enable_grad():
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad_out,
                                         allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


def launch(name: str, *args, device) -> None:
    """Call the C launcher ``name`` on ``device``'s current stream (passed
    last) and raise on its CUDA error code."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(library(), name)(*args, stream)
    check(status, name)


def pointers(tensors):
    """A C array of the tensors' data pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
