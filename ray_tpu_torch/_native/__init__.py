"""The runtime's native extensions, built from `csrc/` at first import.

`ray_tpu_torch._native._fastpath` (the direct-call task channel and the
wire codec), `._shm` (POSIX shared-memory segments, `copy_nt`) and
`._store` (the object store's arena core) are the C++ sources of
`csrc/`, compiled by `g++` against this interpreter's headers into
`build/ray_tpu_torch/native/<name>-<hash>.so` at the root of the checkout.
The hash covers the source and the flags, so an edited source is rebuilt
under a new name and a stale library is never loaded. A file lock keeps
concurrent processes from compiling the same library twice.

A finder at the end of `sys.meta_path` resolves the three names, so the
runtime's `from ray_tpu_torch._native import _fastpath` and
`from ray_tpu_torch._native._shm import copy_nt` load the built
libraries. A failed build raises an `ImportError` carrying the compiler's
output; the runtime's modules catch it and take their pure-Python paths.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch" / "native"
CXX = os.environ.get("CXX", "g++")
# setup.py's flags for the reference's extensions, plus what setuptools
# adds to them and a build outside it needs: -DNDEBUG (a release build, as
# setuptools makes: the interpreter's headers keep the asserts of their
# inline accessors otherwise) and a position-independent shared object
# against this interpreter's headers.
FLAGS = ("-O2", "-std=c++17", "-DNDEBUG", "-shared", "-fPIC")
# module name -> (source, extra link flags)
EXTENSIONS: Dict[str, tuple] = {
    "_fastpath": ("fastpath.cc", ()),
    "_shm": ("shm_buffer.cc", ("-lrt",)),
    "_store": ("store_core.cc", ()),
}
# module name -> seconds its compile took, for each library this process built
BUILD_SECONDS: Dict[str, float] = {}


def _flags(name: str) -> tuple:
    include = sysconfig.get_paths()["include"]
    return (*FLAGS, f"-I{include}", *EXTENSIONS[name][1])


def library_path(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    src = csrc / EXTENSIONS[name][0]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join((CXX, *_flags(name))).encode()).hexdigest()[:16]
    return build_dir / f"{name}-{digest}.so"


def build(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the extension `name` unless it is built already; returns the
    library's path. Raises ImportError with the compiler's output on a
    failed build."""
    path = library_path(name, csrc, build_dir)
    if path.exists():
        return path
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be compiling it
        if path.exists():
            return path
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *_flags(name), "-o", str(tmp), str(csrc / EXTENSIONS[name][0])]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
        except OSError as e:
            raise ImportError(f"cannot build ray_tpu_torch._native.{name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise ImportError(f"cannot build ray_tpu_torch._native.{name}: "
                              f"{' '.join(cmd)} failed:\n{proc.stdout}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return path


class _Finder:
    """Resolves ray_tpu_torch._native.<name> to its built library. It sits
    at the end of sys.meta_path, so a finder placed before it (a test's
    mask) still decides first. A failed build is remembered: every later
    import in this process raises the same ImportError without compiling
    again."""

    def __init__(self):
        self.failed: Dict[str, ImportError] = {}

    def find_spec(self, fullname, path=None, target=None):
        pkg, _, name = fullname.rpartition(".")
        if pkg != __name__ or name not in EXTENSIONS:
            return None
        if name in self.failed:
            raise self.failed[name]
        try:
            lib = build(name)
        except ImportError as e:
            self.failed[name] = e
            raise
        loader = importlib.machinery.ExtensionFileLoader(fullname, str(lib))
        return importlib.util.spec_from_file_location(fullname, str(lib), loader=loader)


if not any(isinstance(f, _Finder) for f in sys.meta_path):
    sys.meta_path.append(_Finder())
