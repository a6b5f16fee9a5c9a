"""The native (C++) SMILES featurizer, bound with ``ctypes``.

Port of ``notorch_tpu.native``: ``native/featurizer.cpp`` at the root of
the repo parses SMILES and writes the type-index features of
``Pipeline(SmiToMol(), MolToGraph())``, array for array, about 17 times
faster than the Python path on one thread, and spreads a batch over
threads. The port reads the same source and returns its own
:class:`~notorch_tpu_torch.data.graph.Graph`.

The library is built with the system C++ compiler (``$CXX``, else
``g++``) at first use, never at import, into ``build/notorch_tpu_torch/
libfeaturizer-<hash>.so`` beside the package, the hash covering the source
and the flags, as :mod:`notorch_tpu_torch.kernels.build` builds the CUDA
sources: each process compiles into a file of its own and moves it into
place with ``os.replace``, so a process that loads the library never sees
half of one. :func:`available` is False only where there is no compiler;
a compiler that refuses the source raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from notorch_tpu_torch.data.graph import Graph

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "featurizer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "notorch_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NUM_NODE_TYPES, NUM_EDGE_TYPES = 42, 13  # MolToGraph's vocabularies, as the source writes them


class FeaturizerCompileError(RuntimeError):
    """The C++ compiler refused ``native/featurizer.cpp``."""


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfeaturizer-{digest[:16]}.so"


@functools.cache
def _load() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None where there is no
    compiler."""
    cxx = _compiler()
    if cxx is None:
        return None
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise FeaturizerCompileError(f"{cxx} refused {SOURCE} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(path))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ntpu_featurize.argtypes = [ctypes.c_char_p, i32p, i32p, i32p, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int]
    lib.ntpu_featurize.restype = ctypes.c_int
    lib.ntpu_featurize_batch.argtypes = [ctypes.c_char_p, ctypes.c_int, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ntpu_featurize_batch.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the native featurizer runs here: False where there is no
    C++ compiler; raises :class:`FeaturizerCompileError` where the compiler
    refuses the source."""
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native featurizer needs a C++ compiler ({os.environ.get('CXX', 'g++')}); none found")
    return lib


def _graph(node_types, edge_types, src, dst, V: int, E: int) -> Graph:
    rev = np.arange(E, dtype=np.int32).reshape(-1, 2)[:, ::-1].ravel()
    return Graph(node_types=node_types[:V].copy(), edge_types=edge_types[:E].copy(),
                 src=src[:E].copy(), dst=dst[:E].copy(), rev=rev)


def featurize_smiles(smi: str, max_atoms: int = 256, max_edges: int = 512) -> Graph | None:
    """SMILES -> Graph through the native path; None where it does not parse."""
    lib = _library()
    node_types = np.zeros((max_atoms, 7), np.int32)
    edge_types = np.zeros((max_edges, 2), np.int32)
    src, dst = np.zeros(max_edges, np.int32), np.zeros(max_edges, np.int32)
    n_atoms, n_edges = np.zeros(1, np.int32), np.zeros(1, np.int32)
    rc = lib.ntpu_featurize(smi.encode(), node_types.ravel(), edge_types.ravel(), src, dst, n_atoms, n_edges,
                            max_atoms, max_edges)
    if rc != 0:
        return None
    return _graph(node_types, edge_types, src, dst, int(n_atoms[0]), int(n_edges[0]))


def featurize_batch(smis: list[str], max_atoms: int = 256, max_edges: int = 512,
                    n_threads: int = 0) -> tuple[list[Graph | None], np.ndarray]:
    """Featurize ``smis`` on ``n_threads`` threads (0: the CPU count, at most
    16). Returns ``(graphs, status)``; ``status[i] != 0`` marks a molecule
    that did not parse, whose graph is None."""
    lib = _library()
    n = len(smis)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    node_types = np.zeros((n, max_atoms, 7), np.int32)
    edge_types = np.zeros((n, max_edges, 2), np.int32)
    src, dst = np.zeros((n, max_edges), np.int32), np.zeros((n, max_edges), np.int32)
    n_atoms, n_edges, status = np.zeros(n, np.int32), np.zeros(n, np.int32), np.zeros(n, np.int32)
    lib.ntpu_featurize_batch("\n".join(smis).encode(), n, node_types.ravel(), edge_types.ravel(), src.ravel(),
                             dst.ravel(), n_atoms, n_edges, status, max_atoms, max_edges, n_threads)
    graphs = [None if status[i] else _graph(node_types[i], edge_types[i], src[i], dst[i], int(n_atoms[i]),
                                            int(n_edges[i]))
              for i in range(n)]
    return graphs, status


class NativeSmiToGraph:
    """SMILES -> Graph through the C++ featurizer: the same graphs as
    ``Pipeline(SmiToMol(), MolToGraph())``, collated by ``MolToGraph``."""

    _in_key_ = "smi"
    _out_key_ = "G"

    def __init__(self, max_atoms: int = 256, max_edges: int = 512):
        self.max_atoms = max_atoms
        self.max_edges = max_edges
        self.num_node_types = NUM_NODE_TYPES
        self.num_edge_types = NUM_EDGE_TYPES

    def __call__(self, smi: str) -> Graph:
        g = featurize_smiles(smi, self.max_atoms, self.max_edges)
        if g is None:
            raise ValueError(f"native featurizer failed to parse {smi!r}")
        return g

    @staticmethod
    def collate(graphs, node_cap=None, edge_cap=None):
        from notorch_tpu_torch.transforms.graph import MolToGraph

        return MolToGraph.collate(graphs, node_cap, edge_cap)
