"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` - no PyTorch
headers, so a build takes seconds, not minutes. Libraries land in the
checkout's ``build/kernels/`` (listed in ``.gitignore``), named by a hash of
the source and the flags, so an edited source is never served a stale
library. Nothing is built when a module is imported: the first launch
builds, and :func:`build_all` builds every kernel at once with one ``nvcc``
per source, all started together. Kernels that share a source (two entry
points of one ``.cu``) share its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

__all__ = ["CudaKernel", "build_all", "check_arg", "check_fits", "BUILD_DIR",
           "CSRC", "NVCC_FLAGS", "SMEM_BYTES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong

# Shared memory one block may use on Hopper (dynamic, after opting in).
SMEM_BYTES = 232_448


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels are built on "
                       "a machine with the CUDA toolkit")


class CudaKernel:
    """One CUDA source, its C entry point, and its launch counter.

    ``launches`` is a plain integer that :meth:`launch` adds one to, and
    nothing else touches, so a run can show that its main path went through
    this kernel.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.build_log: str = ""
        self._fn = None

    def library_path(self) -> Path:
        # The shared headers are hashed too: an edited header must not be
        # served a library built from the old one.
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        h = hashlib.sha256(self.source.read_bytes() + headers
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}_{h}.so"

    def _command(self, tmp: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]

    def _load(self, path: Path):
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def fn(self):
        """The bound C function, building the library at first use."""
        if self._fn is None:
            build_all([self])
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise on a launch error."""
        fn = self.fn()
        self.launches += 1
        err = fn(*args)
        if err:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")


def check_arg(kernel: str, name: str, t: torch.Tensor, shape) -> None:
    """Raise unless ``t`` is a contiguous int32 CUDA tensor of ``shape``
    (what every kernel of the port takes)."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{kernel}: {name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def check_fits(kernel: str, w: int, arrays: int, extra: int = 0) -> None:
    """Raise, naming the width, if one row of ``arrays`` int32 arrays of
    width ``w`` (plus ``extra`` bytes) does not fit a block's shared
    memory."""
    need = w * 4 * arrays + extra
    if need > SMEM_BYTES:
        raise ValueError(
            f"{kernel}: a row of width {w} needs {need} bytes of shared "
            f"memory for {arrays} arrays; a block has {SMEM_BYTES}")


def stream() -> int:
    """The current CUDA stream handle, for a kernel's ``stream`` argument."""
    return torch.cuda.current_stream().cuda_stream


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, float]:
    """Build (in parallel) and load every kernel not yet loaded; returns the
    seconds each build took (0.0 for a library found already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    times: Dict[str, float] = {}
    for k in kernels:
        if k._fn is not None:
            times[k.name] = 0.0
            continue
        out = k.library_path()
        if out in pending:
            pending[out][0].append(k)
            continue
        if out.exists():
            k._load(out)
            times[k.name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(k._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[out] = ([k], tmp, proc, time.perf_counter())
    failures: List[str] = []
    for out, (ks, tmp, proc, t0) in pending.items():
        log, _ = proc.communicate()
        for k in ks:
            times[k.name] = time.perf_counter() - t0
            k.build_log = log
        if proc.returncode != 0:
            failures.append(f"{ks[0].source.name}:\n{log}")
            continue
        os.replace(tmp, out)
        for k in ks:
            k._load(out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return times
