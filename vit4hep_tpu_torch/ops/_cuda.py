"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``vit4hep_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. The library's file name carries a digest of the source and of
every ``csrc/`` header it includes (``#include "..."``, followed through
headers), so an edited source or header is rebuilt and a stale library is
never loaded. Nothing is
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
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("energy_decoder", "vit_forward", "vit_backward", "qkv_attention", "qkv_attention_bwd",
           "binned_rqs", "vmem_attention", "flash_qkv_attention", "flash_attention")
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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes, directly or
    through another header, in the order first reached."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


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


_SASS_NOISE = re.compile(r"/\*[0-9a-fx]+\*/|;?\s*/\* 0x[0-9a-f]+ \*/")
# an anonymous namespace's mangled name carries a hash of the source's path
_ANON_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def sass_functions(lib: Path, addresses: bool = False) -> dict:
    """{mangled name: its SASS instructions} of a built library, from
    ``cuobjdump -sass``, addresses and encodings stripped; an anonymous
    namespace's path hash is dropped from the name, so that two checkouts
    name a kernel alike. With ``addresses``, each instruction comes as
    (its address, the instruction), so that branches can be followed."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(_ANON_HASH.sub("_GLOBAL__N__", m.group(1)), [])
        elif cur is not None and "/*" in line:
            ins = _SASS_NOISE.sub("", line).strip()
            if ins:
                at = re.match(r"\s*/\*([0-9a-f]+)\*/", line)
                cur.append((int(at.group(1), 16), ins) if addresses else ins)
    return funcs


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
