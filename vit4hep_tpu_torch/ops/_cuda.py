"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``vit4hep_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. The library's file name carries a digest of the source, so an
edited source is rebuilt and a stale library is never loaded. Nothing is
built or loaded at import time: the package imports on hosts without CUDA.

Pointers and the stream go to C as ``ctypes.c_void_p``; sizes as
``ctypes.c_int``. Every exported function launches on the stream it is
given and returns ``cudaGetLastError()`` after the launch; :func:`check`
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("energy_decoder", "vit_forward", "qkv_attention", "binned_rqs")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SMEM_BYTES = 232448  # opt-in shared memory per block on sm_90

_LIBS: dict[str, ctypes.CDLL] = {}
P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no current library, one ``nvcc``
    process per source, all started together. Returns {name: seconds} for
    the sources compiled (empty when all were current). The compiler's
    ``-Xptxas -v`` report goes to ``_build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if needed), with
    ``argtypes``/``restype`` set from ``signatures`` {function: argtypes}."""
    if name not in _LIBS:
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel library '{name}' needs a CUDA device")
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel '{what}' failed to launch: cudaError {code}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors, dtype=torch.float32):
    """Raise unless every tensor is a contiguous ``dtype`` CUDA tensor on
    one device."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} is on {t.device}, expected a CUDA tensor")
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} is on {t.device}, argument 0 on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: argument {i} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")


class LaunchCounter:
    """Number of kernel launches a wrapper has made: each wrapper adds one
    where it launches its kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def add(self):
        self.launches += 1

    def reset(self):
        self.launches = 0
