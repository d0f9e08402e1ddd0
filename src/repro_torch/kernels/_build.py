"""Builds the CUDA sources in ``kernels/csrc/`` into shared libraries and
loads them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` call per file takes seconds.  Libraries land in ``kernels/_build/``
(listed in ``.gitignore``) under a name that carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built at import: the first call that needs a kernel builds it, or
``build_all()`` builds every source at once, one compiler process per file,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source; carries the compiler's output."""


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME``/``$CUDA_PATH``, else
    from the toolkit's usual place."""
    found = shutil.which("nvcc")
    if found:
        return found
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for root in roots:
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelCompileError(
        "nvcc not found (looked in PATH, $CUDA_HOME, $CUDA_PATH, "
        "/usr/local/cuda): the CUDA kernels of repro_torch are compiled from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit")


def sources() -> list:
    """Names (without suffix) of the kernels' sources."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _source_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise KernelCompileError(f"no kernel source {src}")
    return src


def library_path(name: str, extra_flags: tuple = ()) -> Path:
    digest = hashlib.sha1()
    digest.update(_source_path(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str, out: Path, extra_flags: tuple) -> tuple:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(_source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp


def _finish(proc, cmd, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelCompileError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)       # atomic: a reader never sees a half-written file
    return log


def build_all(extra_flags: tuple = ()) -> dict:
    """Build every source that has no current library for these flags;
    returns ``{name: compiler output}`` for the ones that were compiled."""
    jobs = []
    for name in sources():
        out = library_path(name, extra_flags)
        if not out.is_file():
            jobs.append((name, out, _start(name, out, tuple(extra_flags))))
    return {name: _finish(*started, out) for name, out, started in jobs}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if need be."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        out = library_path(name)
        if not out.is_file():
            _finish(*_start(name, out, ()), out)
        lib = _libs[name] = ctypes.CDLL(str(out))
    return lib
