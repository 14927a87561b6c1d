"""ctypes binding to the repository's native host data plane (counterpart of
``layout2img_tpu/data/native.py``).

``native/dataplane.cc`` decodes JPEGs with libjpeg, resizes them with a
PIL-compatible antialiased bilinear filter, mirrors them and normalizes to
[-1, 1] float HWC, one image or a whole batch on a thread pool. This module
compiles it with ``g++`` (the JAX binding's flags) into
``build/native/libl2i_dataplane-<hash>.so`` at the root of the checkout,
keyed by a hash of the source, the flags and the CPU model (the code is
``-march=native``) as ``ops/_build.py`` keys the kernels, and loads it with
ctypes. It never writes into ``native/``.

The build runs at the first call of any function here, never at import.
Where it fails (no libjpeg headers, no ``g++``), ``native_available()`` is
False and the loaders decode with PIL, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dataplane.cc"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-ffast-math", "-shared", "-fPIC",
             "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` code runs only on its kind."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("model name")), "")
    except OSError:
        return ""


def library_path() -> Path:
    """The library's path, keyed by the source, the flags and the CPU model."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_model().encode())
    return BUILD_DIR / f"libl2i_dataplane-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str | None:
    """Compile into a per-process temporary file and rename it into place, so
    concurrent builders never write one file and a reader never loads a
    half-written library. Returns the compiler's error text, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                              capture_output=True, text=True)
    except OSError as e:  # no g++
        return str(e)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr
    os.replace(tmp, out)
    return None


def _load() -> None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return
        if not SOURCE.exists():
            _build_error = f"{SOURCE} is missing"
            return
        out = library_path()
        if not out.exists():
            _build_error = _build(out)
            if _build_error is not None:
                return
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:  # e.g. libjpeg's runtime library missing
            _build_error = str(e)
            return
        lib.l2i_load_image.restype = ctypes.c_int
        lib.l2i_load_image.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.l2i_load_batch.restype = ctypes.c_int
        lib.l2i_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int]
        lib.l2i_shuffle.restype = None
        lib.l2i_shuffle.argtypes = [ctypes.c_uint64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        _lib = lib


def native_available() -> bool:
    """Whether the native decoder built and loaded (builds it on first call)."""
    _load()
    return _lib is not None


def build_error() -> str | None:
    """Why the native decoder is unavailable (None when it is available)."""
    _load()
    return _build_error


def _require() -> ctypes.CDLL:
    _load()
    if _lib is None:
        raise RuntimeError(f"the native data plane did not build: {_build_error}")
    return _lib


def load_image(path: str, out_size: int, flip: bool = False) -> np.ndarray:
    """Decode, resize and normalize one JPEG -> (s, s, 3) float32 in [-1, 1]."""
    lib = _require()
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = lib.l2i_load_image(path.encode(), out_size, int(flip),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out


def load_batch(paths: list[str], out_size: int, flips: list[bool], threads: int = 8) -> np.ndarray:
    """Decode a whole batch in parallel -> (n, s, s, 3) float32 in [-1, 1]."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_flips = (ctypes.c_int * n)(*[int(f) for f in flips])
    failures = lib.l2i_load_batch(c_paths, n, out_size, c_flips,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    if failures:
        raise IOError(f"native batch decode: {failures}/{n} failures")
    return out


def shuffle_indices(seed: int, n: int) -> np.ndarray:
    """A deterministic permutation of [0, n) (Fisher-Yates with splitmix64)."""
    lib = _require()
    out = np.empty(n, np.int64)
    lib.l2i_shuffle(seed, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out
