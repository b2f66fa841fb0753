"""Native record cache (port of ``vit4hep_tpu/data/native_cache.py``):
events converted once into a flat binary file of fixed-size float32
records, mmap'd and gathered by index from C++ threads with the GIL
released (``vit4hep_tpu_torch/native/record_cache.cpp``, bound with
``ctypes``).

The lazy families (LEMURS, CaloHadronic) read shuffled event batches every
step; from HDF5 those reads hold the GIL. A cache file is served from the
page cache instead, and on a host without h5py it is what the events can be
read from. The on-disk format is the JAX package's: the ``<QQQQ`` header
(magic, version 2, record count, record bytes), then the records, each the
fields flattened and concatenated in SORTED key order
(:func:`normalize_spec`), so that a file written by either package is read
by the other.

The library is built at first use with the host's C++ compiler (``c++`` or
``g++``) into ``vit4hep_tpu_torch/_build/``, named after a digest of its
source and flags; without a compiler, or when the build fails, opening a
cache raises. There is no fallback to the events it was built from.

Usage::

    spec = {"showers": (4, 3, 5), "incident_energy": (1,), ...}
    build_cache(path, iter_of_field_dicts, spec)         # once
    cache = NativeRecordCache(path, spec)
    batch = cache.gather(indices)                        # dict of arrays
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np

from vit4hep_tpu_torch.utils.logger import LOGGER

_MAGIC = 0x56344845503
_VERSION = 2  # v2: fields in sorted key order
_HEADER = struct.Struct("<QQQQ")

SOURCE = Path(__file__).resolve().parents[1] / "native" / "record_cache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("the native record cache needs a C++ compiler to build "
                       f"{SOURCE.name}: none of $CXX, c++ or g++ is on PATH")


def lib_path() -> Path:
    """The library's path: its name carries a digest of the source and the
    compiler flags, so an edited source is rebuilt and never loaded stale."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librecord_cache-{h.hexdigest()[:12]}.so"


def _load_lib():
    """Build (once) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        LOGGER.info(f"Building native record cache: {' '.join(cmd)}")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native record cache build failed ({' '.join(cmd)}):\n"
                               + proc.stderr[-4000:])
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.cache_open.restype = ctypes.c_void_p
    lib.cache_open.argtypes = [ctypes.c_char_p]
    lib.cache_close.argtypes = [ctypes.c_void_p]
    lib.cache_num_records.restype = ctypes.c_int64
    lib.cache_num_records.argtypes = [ctypes.c_void_p]
    lib.cache_record_size.restype = ctypes.c_int64
    lib.cache_record_size.argtypes = [ctypes.c_void_p]
    lib.cache_gather.restype = ctypes.c_int
    lib.cache_gather.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return lib


def normalize_spec(spec: dict) -> dict:
    """``{field: shape tuple}`` in sorted key order. Takes plain shapes
    (``{"showers": (30, 30, 48)}``, a scalar as ``()`` or ``(1,)``) or
    ``(shape, dtype)`` pairs whose dtype is float32 (the records are flat
    float32)."""
    out = {}
    for key, val in spec.items():
        if isinstance(val, tuple) and len(val) == 2 and isinstance(val[0], (tuple, list)):
            shape, dtype = val
            if np.dtype(dtype) != np.float32:
                raise ValueError(f"native cache field '{key}': only float32 is supported, "
                                 f"got {dtype}")
            val = shape
        try:
            out[key] = tuple(int(s) for s in val)
        except (TypeError, ValueError):
            raise ValueError(f"native cache spec for '{key}' must be a shape tuple "
                             f"(or (shape, float32)), got {val!r}") from None
    # the file stores no field names: writer and reader agree on this order
    return {k: out[k] for k in sorted(out)}


def record_size_of(spec: dict) -> int:
    """Bytes per record of a ``{field: shape}`` spec (float32 fields)."""
    return 4 * sum(int(np.prod(shape)) for shape in normalize_spec(spec).values())


def build_cache(path, batches, spec: dict):
    """Write a cache file from an iterable of ``{field: (N, *shape)}``
    dicts, each record its fields flattened in the spec's sorted order."""
    path = Path(path)
    spec = normalize_spec(spec)
    rec_size = record_size_of(spec)
    n_total = 0
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, 0, rec_size))
        for batch in batches:
            n = len(next(iter(batch.values())))
            cols = []
            for k, shape in spec.items():
                arr = np.asarray(batch[k], np.float32).reshape(n, -1)
                want = int(np.prod(shape))
                if arr.shape[1] != want:
                    raise ValueError(f"native cache field '{k}': batch has {arr.shape[1]} "
                                     f"elements per record, spec says {want}")
                cols.append(arr)
            f.write(np.ascontiguousarray(np.concatenate(cols, axis=1)).tobytes())
            n_total += n
        f.seek(0)
        f.write(_HEADER.pack(_MAGIC, _VERSION, n_total, rec_size))
    LOGGER.info(f"Wrote native cache {path}: {n_total} records x {rec_size} B")
    return path


class NativeRecordCache:
    """An mmap'd record file with a multithreaded gather that releases the
    GIL."""

    def __init__(self, path, spec: dict, n_threads: int | None = None):
        self.spec = normalize_spec(spec)
        self.lib = _load_lib()
        self.handle = self.lib.cache_open(str(path).encode())
        if not self.handle:
            raise OSError(f"cannot open record cache {path} (missing, truncated, or not a "
                          f"version-{_VERSION} cache)")
        self.n_records = int(self.lib.cache_num_records(self.handle))
        self.record_size = int(self.lib.cache_record_size(self.handle))
        expected = record_size_of(self.spec)
        if self.record_size != expected:
            self.close()
            raise ValueError(f"cache record size {self.record_size} != spec {expected}")
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)

    def __len__(self):
        return self.n_records

    def gather(self, indices) -> dict:
        """The records at ``indices`` as ``{field: (n, *shape) float32}``."""
        if not self.handle:
            raise ValueError("record cache is closed")
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        out = np.empty(n * self.record_size // 4, np.float32)
        rc = self.lib.cache_gather(self.handle,
                                   idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                                   out.ctypes.data_as(ctypes.c_char_p), self.n_threads)
        if rc != 0:
            raise IndexError("record index out of range")
        out = out.reshape(n, self.record_size // 4)
        result, start = {}, 0
        for key, shape in self.spec.items():
            size = int(np.prod(shape))
            result[key] = out[:, start:start + size].reshape(n, *shape)
            start += size
        return result

    def close(self):
        if self.handle:
            self.lib.cache_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
