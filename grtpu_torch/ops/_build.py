"""Build and load the Hopper kernels in ``grtpu_torch/csrc`` at first use.

``nvcc`` compiles ``fir_tile.cu`` for ``sm_90a`` into a shared library with
a plain C interface, which is loaded with ``ctypes``.  The library is cached
under ``build/grtpu_torch/`` at the repository root (listed in
``.gitignore``), keyed on a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing here runs when
the module is imported: :func:`library` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fir_tile.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grtpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def library_path() -> Path:
    """Path of the built library for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fir_tile-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the cached library is current."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.fir_tile_fwd.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.fir_tile_fwd.restype = i
    lib.fir_cascade_fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.fir_cascade_fwd.restype = i
    lib.fir_cascade_mma_fwd.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.fir_cascade_mma_fwd.restype = i
    lib.fir_toeplitz_fwd.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i, i, i,
                                     i, p]
    lib.fir_toeplitz_fwd.restype = i
    lib.fir_toeplitz_smem.argtypes = [i, i]
    lib.fir_toeplitz_smem.restype = ctypes.c_size_t
    lib.fir_toeplitz_rows_per_pass.argtypes = []
    lib.fir_toeplitz_rows_per_pass.restype = i
    lib.fir_tile_smem.argtypes = [i, i, i, i]
    lib.fir_tile_smem.restype = ctypes.c_size_t
    lib.fir_cascade_smem.argtypes = [i, i, i, i]
    lib.fir_cascade_smem.restype = ctypes.c_size_t
    lib.fir_tile_outputs_per_thread.argtypes = []
    lib.fir_tile_outputs_per_thread.restype = i
    lib.fir_error_string.argtypes = [i]
    lib.fir_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
