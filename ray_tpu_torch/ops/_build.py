"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into
`build/ray_tpu_torch/<name>-<hash>.so` at the root of the checkout, where
the hash covers the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. The libraries have a plain C interface
and are loaded with `ctypes`; nothing here includes PyTorch's headers.
`ptxas -v`'s report (each kernel's registers, shared memory and spills) is
kept beside the library as `<name>-<hash>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is built already; returns the
    library's path. Raises on a failed build."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    path.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def tool(name: str) -> str:
    """A CUDA toolkit program (cuobjdump, ...) from beside nvcc."""
    return str(Path(_nvcc()).parent / name)


def load(name: str) -> ctypes.CDLL:
    """Load the library built from `csrc/<name>.cu`, building it if needed."""
    return ctypes.CDLL(str(build(name)))


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
