"""Build the hand-written CUDA kernels and load them through ``ctypes``.

Each ``csrc/<name>.cu`` file exports one plain C launch function.  It is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library at first
use, under ``build/kernels/`` at the repository root (listed in
``.gitignore``); the library name carries a hash of the source and flags,
so an edited source never loads a stale build.  ``build_all`` starts one
``nvcc`` per missing library at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module, and
the CPU has neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KERNELS", "build_all", "build_dir", "check", "load",
           "ptxas_report", "require"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("lif_step", "part_degrees", "swap_deltas", "link_loads")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout holding this package."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}-{h}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    rc = proc.wait()
    if rc != 0:
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every missing kernel library, all ``nvcc`` runs in parallel."""
    started = [(n, *_start(n)) for n in names if not _lib_path(n).exists()]
    try:
        for name, proc, tmp, out in started:
            _finish(name, proc, tmp, out)
    finally:
        for _, proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {n: _lib_path(n) for n in names}


def ptxas_report(name: str) -> str:
    """The register/shared-memory lines ``ptxas -v`` printed for ``name``."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    keep = ("registers", "smem", "spill")
    return "\n".join(ln.strip() for ln in log.read_text().splitlines()
                     if any(k in ln for k in keep))


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built if missing)."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")


def require(t, name: str, dtype, shape: tuple | None = None, device=None) -> None:
    """Validate a kernel argument: a contiguous CUDA tensor of ``dtype``
    (and ``shape`` / ``device`` where given).  Raises ValueError."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
