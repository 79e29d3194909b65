"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. The library lands
in ``build/stellard_tpu_torch/`` beside the package (git-ignored), named
by a digest of its source, so an edited source is rebuilt and an
unchanged one is loaded as built. Nothing is built at import: the first
wrapper call on a CUDA tensor builds its library, under a lock, because
the verify plane's flusher thread and the hasher can both get there
first. A failed build, load or launch raises ``KernelError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "stellard_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

class KernelError(RuntimeError):
    """A kernel that did not build, load or launch."""


_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# source name -> ptxas report (registers, spills) of the build that ran
# in this process; empty for a library found already built
PTXAS_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu -> (process, tmp path, final path),
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    PTXAS_LOG[name] = log


def build(names) -> None:
    """Compile the named sources that are not built yet, one nvcc each,
    all started together."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err} at launch")


def is_device_error(exc: BaseException) -> bool:
    """Whether ``exc`` came from the card: a kernel that did not build,
    load or launch, or an error torch raised for the CUDA device. The
    close path's helper threads count every error they absorb, but one
    of these they hand back to the close (LedgerMaster), so that a
    failing card is never hidden behind the host's recomputation."""
    if isinstance(exc, KernelError):
        return True
    import torch

    kinds = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                              getattr(torch.cuda, "CudaError", None),
                              getattr(torch.cuda, "OutOfMemoryError", None))
                  if isinstance(t, type))
    return isinstance(exc, kinds) or (isinstance(exc, RuntimeError) and "CUDA" in str(exc))
