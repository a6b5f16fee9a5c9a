"""Build the CUDA sources under ``notorch_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/notorch_tpu_torch/
lib<name>-<hash>.so`` beside the package, and loaded with ``ctypes``. The
hash covers the source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header builds anew and a stale library is
never loaded. Nothing here includes PyTorch's headers,
which keeps a build to seconds.

Builds happen at first use, never at import: the CPU tests import every
module of the package on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "notorch_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc); "
        "the CUDA kernels of notorch_tpu_torch build only where the CUDA toolkit is installed"
    )


def library_path(name: str) -> Path:
    inputs = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in inputs) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def sources() -> list[str]:
    """Names of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names: list[str] | None = None, verbose: bool = False) -> dict[str, Path]:
    """Compile the named sources (default: all) that have no current
    library, one ``nvcc`` per source, all started together. Returns the
    library path of each name; raises :class:`KernelBuildError` with the
    compiler's output when a source does not build."""
    names = sources() if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        if verbose and out:
            print(out, flush=True)
        os.replace(tmp, todo[n])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise KernelBuildError("CUDA build failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
