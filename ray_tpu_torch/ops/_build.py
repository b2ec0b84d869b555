"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into
`build/ray_tpu_torch/<name>-<hash>.so` at the root of the checkout, where
the hash covers the source, every header under `csrc/` (any of which it may
include) and the flags, so an edited source or header is rebuilt and a
stale library is never loaded. The libraries have a plain C interface
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
# -split-compile=0 optimises the kernels of one source in parallel, one
# thread a CPU (CUDA 12.x): the flash library's 64 instantiations build in
# 22.9 s instead of 50.0 on the H100 machine's 8 cores.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
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


def digest(src: Path) -> str:
    """Hash of a source, the headers beside it and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(p for p in src.parent.rglob("*") if p.is_file() and p.suffix != ".cu"):
        h.update(str(header.relative_to(src.parent)).encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{digest(CSRC / f'{name}.cu')}.so"


def compile_source(src: Path, path: Path, extra_flags=()) -> Path:
    """nvcc `src` (with NVCC_FLAGS and `extra_flags`) into the library
    `path` unless it is there already, with ptxas -v's report beside it
    (`.log`); returns `path`. Raises on a failed build."""
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    path.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is built already; returns the
    library's path. Raises on a failed build."""
    return compile_source(CSRC / f"{name}.cu", library_path(name))


def tool(name: str) -> str:
    """A CUDA toolkit program (cuobjdump, ...) from beside nvcc."""
    return str(Path(_nvcc()).parent / name)


def load(name: str) -> ctypes.CDLL:
    """Load the library built from `csrc/<name>.cu`, building it if needed."""
    return ctypes.CDLL(str(build(name)))


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
