"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``colpali_tpu_torch/csrc/*.cu`` export plain C entry points.
At first use they are compiled with ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together, then one link) into one shared
library under ``build/kernels/`` at the repository root, named by a hash of
the sources and flags, and loaded with ``ctypes``. Each entry point returns
the launch's ``cudaError_t``; :meth:`CudaKernel.__call__` raises on any
non-zero value. The entry points size their own shared memory, so a launch
that would need more than a block has fails there and raises too. A
missing ``nvcc``, a failed build or a failed launch raises: nothing falls
back to the plain PyTorch versions.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_build_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built from colpali_tpu_torch/csrc")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcolpali_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel, one ``nvcc -c`` each) and
    link the objects into one library, unless it is built already. The
    compiler's register and shared-memory report (``-Xptxas -v``) is kept
    beside it as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for src, proc, text in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{text}")
        tmp = out.with_name(f"{stem}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _build_lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            lib.colpali_error_string.argtypes = [ctypes.c_int]
            lib.colpali_error_string.restype = ctypes.c_char_p
            _library = lib
    return _library


P, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


class CudaKernel:
    """One C entry point of the kernel library and its launch count.

    ``argtypes`` lists the arguments before the trailing stream pointer.
    ``launches`` counts successful launches; nothing else changes it but
    :meth:`reset`."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def reset(self) -> None:
        self.launches = 0

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = [*self.argtypes, P]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            msg = library().colpali_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {err} ({msg})")
        self.launches += 1


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain versions run), False for a CUDA
    tensor (the kernels run); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
