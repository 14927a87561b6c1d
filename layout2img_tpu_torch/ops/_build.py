"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each ``layout2img_tpu_torch/csrc/<name>.cu`` becomes one shared library with
a plain C interface, ``build/kernels/<name>-<hash>.so`` at the root of the
checkout. The hash covers the source, the shared ``*.cuh`` headers and the
flags, so an edit rebuilds and an unchanged tree reuses the library; the
compiler's output (``-Xptxas -v``: registers, shared memory, spills) is kept
beside it as ``<name>-<hash>.log``.

nvcc runs for every source not built yet, all at once (``build_all``), at
the first launch of any kernel (``library``) or when asked, never at import:
the package imports where there is no CUDA toolkit. Every C entry point returns ``cudaGetLastError()`` after
its launch, and ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("the port's CUDA kernels need nvcc: set CUDA_HOME to a CUDA toolkit")
    return nvcc


class _Build:
    """One nvcc process writing ``csrc/<name>.cu`` into a temporary file."""

    def __init__(self, name: str):
        self.name, self.out = name, library_path(name)
        self.tmp = self.out.with_name(f"{self.out.stem}.{os.getpid()}.tmp.so")
        self.t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(self.tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(self) -> float:
        text, _ = self.proc.communicate()
        self.out.with_suffix(".log").write_text(text)
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{self.name}.cu "
                               f"(exit {self.proc.returncode}):\n{text[-4000:]}")
        os.replace(self.tmp, self.out)  # atomic: a concurrent loader sees all or nothing
        return time.perf_counter() - self.t0


def build_all() -> dict[str, float]:
    """Build every source not built yet, one nvcc each, all started together.
    Returns the seconds each build took (0.0 where the library was there)."""
    builds = [_Build(n) for n in sources() if not library_path(n).exists()]
    seconds = {n: 0.0 for n in sources()}
    for b in builds:
        seconds[b.name] = b.wait()
    return seconds


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; where it is not built yet,
    every source not built yet is built first, in parallel."""
    if not library_path(name).exists():
        build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    lib.l2i_error_string.argtypes = [ctypes.c_int]
    lib.l2i_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.l2i_error_string(err).decode()})")
