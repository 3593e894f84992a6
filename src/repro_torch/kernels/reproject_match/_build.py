"""Build and bind the reproject-match CUDA kernel: ``nvcc`` + ``ctypes``.

The shared library is compiled at first use from ``csrc/*.cu`` alone into
``build/`` beside this file (listed in ``.gitignore``), named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  The library has a plain C interface: device pointers
come from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.

Nothing here runs when the module is imported: the CPU tests import every
module of the package where no ``nvcc`` exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

# No --use_fast_math: the divisions must be IEEE.  --fmad=false: see the
# precision note in csrc/reproject_match.cu.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # intr rgb depth origin trel frame out, n patch window h w, stream
    "rm_pallas_launch": (_P,) * 7 + (_I,) * 5 + (_P,),
    # ... out, n tile_n patch window h w, stream
    "rm_tiled_launch": (_P,) * 7 + (_I,) * 6 + (_P,),
    # ... out match ovok, n patch window h w, tau o_min c_min, stream
    "rm_fused_launch": (_P,) * 9 + (_I,) * 5 + (_F,) * 3 + (_P,),
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the reproject-match kernel cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"reproject_match_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; returns its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside it as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The built and bound library (built on the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
