"""Build and bind the port's CUDA kernels: ``nvcc`` + ``ctypes``.

Each kernel family is one :class:`CudaLibrary`: the ``*.cu`` files of its
``csrc/`` directory, compiled at first use into ``build/`` beside it
(listed in ``.gitignore``) as a shared library named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  The library has a plain C interface: device pointers
come from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``; every entry returns
``cudaGetLastError()`` after its launch.

Nothing here runs when a module is imported: the CPU tests import every
module of the package where no ``nvcc`` exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

# No --use_fast_math anywhere: divisions and expf stay IEEE.
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Headers shared by several libraries (``#include "tf32_tiles.cuh"``).
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"

# ctypes argument types for the C entries' signatures.
PTR, INT, I64, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaLibrary:
    """One kernel family's shared library.

    ``name`` names the library file; ``csrc`` holds its ``*.cu`` (and
    ``*.cuh``) sources; ``signatures`` maps each C entry to its ``ctypes``
    argument types (every entry returns ``int``); ``flags`` are added to
    :data:`BASE_FLAGS`; ``include`` names directories of shared headers,
    passed to ``nvcc -I`` and hashed with the sources, so an edited shared
    header rebuilds every library that includes it.
    """

    def __init__(self, name: str, csrc: Path,
                 signatures: Dict[str, Tuple[type, ...]],
                 flags: Sequence[str] = (), include: Sequence[Path] = ()):
        self.name = name
        self.csrc = Path(csrc)
        self.build_dir = self.csrc.parent / "build"
        self.signatures = dict(signatures)
        self.include = tuple(Path(d) for d in include)
        self.flags = BASE_FLAGS + tuple(flags)
        self._lib = None

    def sources(self):
        return (sorted(self.csrc.glob("*.cu")) + sorted(self.csrc.glob("*.cuh"))
                + [h for d in self.include for h in sorted(d.glob("*.cuh"))])

    def library_path(self) -> Path:
        """Where the library for the current sources and flags lives."""
        h = hashlib.sha256(" ".join(self.flags).encode())
        for src in self.sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return self.build_dir / f"{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless it is already built; returns its path.

        The compiler's output (``-Xptxas -v``: registers, shared memory and
        spills per kernel) is kept beside it as ``<name>.log``.
        """
        out = self.library_path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *self.flags, *(f"-I{d}" for d in self.include),
               "-o", str(tmp),
               *[str(s) for s in self.sources() if s.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        return out

    def library(self) -> ctypes.CDLL:
        """The built and bound library (built on the first call)."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for entry, argtypes in self.signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def check_contiguous(**tensors) -> None:
    """Raise unless every tensor a launch reads through its pointer is
    contiguous."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a launch would lose a gradient: grad mode is on and a
    tensor off the CPU requires grad.  A launch reads its inputs through
    their pointers and returns tensors without a ``grad_fn``, and the
    kernels have no backward (neither have the Pallas kernels they
    replace); on the CPU the wrappers run their plain, differentiable
    form, so they pass.  Called before anything else a wrapper does."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            and t.device.type != "cpu" for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no "
            f"backward; run the plain backend (\"ref\"/\"chunked\") to "
            f"differentiate, or call it under torch.no_grad()")


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
