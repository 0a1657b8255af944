"""Build and load the Hopper kernels in ``grtpu_torch/csrc`` at first use.

``nvcc`` compiles each source (``fir_tile.cu``, which includes
``fir_common.cuh``; ``fir_decim.cu`` and ``fir_decim_mma.cu``, the
decimating FIR's two routes, which include ``fir_decim.cuh``;
``trellis_viterbi.cu`` and ``atsc_dfe.cu``, the two recursion kernels;
``iir1.cu``, the first-order IIR; ``mm_clock.cu``, the M&M clock
recovery) for
``sm_90a`` into a shared library of its own with a plain C interface, all
compilers started together, and the libraries are loaded with ``ctypes``.
The decimating routes are two sources so that their instances, the most
of any source, compile side by side.  The libraries are cached under
``build/grtpu_torch/`` at the repository root (listed in ``.gitignore``),
keyed on a hash of the source, the headers and the flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing here runs when the module is imported:
:func:`library` builds on its first call.

:func:`host_library` builds the host I/O runtime (``grtpu_torch/io/native``)
the same way, with the host C++ compiler, into the same directory.  A
library built with ``-march=native`` runs only on CPUs like the one that
built it, so its key also holds that CPU (:func:`cpu_identity`): a
``build/`` directory copied to another machine then builds the library
anew there and never loads one made for another CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "fir_tile.cu", CSRC / "fir_decim.cu",
           CSRC / "fir_decim_mma.cu", CSRC / "trellis_viterbi.cu",
           CSRC / "atsc_dfe.cu", CSRC / "iir1.cu", CSRC / "mm_clock.cu")
HEADERS = (CSRC / "fir_common.cuh", CSRC / "fir_decim.cuh")
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


@functools.lru_cache(maxsize=1)
def cpu_identity() -> str:
    """The CPU this process runs on, as ``-march=native`` sees it: the
    machine, and the model name and feature flags of the first processor
    in ``/proc/cpuinfo`` (where there is none, what ``platform`` says)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    return "|".join((platform.machine(),
                     fields.get("model name", platform.processor()),
                     fields.get("flags", fields.get("Features", ""))))


def hashed_path(stem: str, files, flags) -> Path:
    """The library path under ``BUILD_DIR`` for these source files and
    flags: an edited file or flag gives another path, and so, for flags
    with ``-march=native``, does another CPU."""
    h = hashlib.sha256()
    for f in files:
        h.update(Path(f).read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(cpu_identity().encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def library_paths() -> list[Path]:
    """Paths of the built libraries for the current sources and flags, one
    per source."""
    return [hashed_path(src.stem, (src, *HEADERS), NVCC_FLAGS)
            for src in SOURCES]


def build() -> list[Path]:
    """Compile the sources whose cached library is not current, all at once."""
    outs = library_paths()
    jobs = []
    for src, out in zip(SOURCES, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, tmp, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)  # atomic: no process loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def host_library(stem: str, sources, flags, libs=()) -> Path | None:
    """Compile ``sources`` into one shared library with the host C++
    compiler (``c++``, else ``g++``, else ``clang++``), linking ``libs``,
    unless the library for these sources and flags is built already; None
    where no compiler builds it."""
    out = hashed_path(stem, sources, (*flags, *libs))
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    for cc in ("c++", "g++", "clang++"):
        try:
            subprocess.run([cc, *flags, "-o", str(tmp), *map(str, sources),
                            *libs],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
        os.replace(tmp, out)  # atomic: no process loads half a file
        return out
    return None


def library() -> SimpleNamespace:
    """The kernels' C entry points, built and loaded on the first call."""
    global _lib
    if _lib is not None:
        return _lib
    tile, decim, decim_mma, viterbi, dfe, iir1, mm = (
        ctypes.CDLL(str(path)) for path in build())
    i, p, i64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
    ll, f = ctypes.c_longlong, ctypes.c_float
    sigs = {
        tile: {
            "fir_tile_fwd": ([p, i, p, p] + [i] * 11 + [p], i),
            "fir_cascade_fwd": ([p, p, p] + [i] * 7 + [p], i),
            "fir_cascade_mma_fwd": ([p, p, p] + [i] * 6 + [p], i),
            "fir_toeplitz_fwd": ([p, i, p, p, p] + [i] * 10 + [p], i),
            "fir_toeplitz_smem": ([i, i], i64),
            "fir_toeplitz_rows_per_pass": ([], i),
            "fir_tile_smem": ([i] * 5, i64),
            "fir_cascade_smem": ([i, i, i, i], i64),
            "fir_error_string": ([i], ctypes.c_char_p),
        },
        decim: {
            "fir_decim_fwd": ([p, i, p, p] + [i] * 11 + [p], i),
            "fir_decim_smem": ([i] * 6, i64),
        },
        decim_mma: {
            "fir_decim_mma_fwd": ([p, i, p, p] + [i] * 12 + [p], i),
            "fir_decim_mma_smem": ([i] * 6, i64),
        },
        viterbi: {
            "viterbi_fwd": ([p] * 4 + [i] * 11 + [p, p, p], i),
            "viterbi_smem": ([i] * 7, i64),
            "trellis_error_string": ([i], ctypes.c_char_p),
        },
        dfe: {
            "dfe_feedback_fwd": ([p, p, p, i, i, p, p, p], i),
            "dfe_error_string": ([i], ctypes.c_char_p),
        },
        iir1: {
            "iir1_fwd": ([p, p, p, i, p, p, i, p, i, i, i, i, i, p, p, p], i),
            "iir1_error_string": ([i], ctypes.c_char_p),
        },
        mm: {
            "mm_fwd": ([p, ll] + [p] * 5 + [f] * 4 + [ll, i, i] + [p] * 7, i),
            "mm_error_string": ([i], ctypes.c_char_p),
        },
    }
    lib = SimpleNamespace()
    for dll, funcs in sigs.items():
        for name, (argtypes, restype) in funcs.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = restype
            setattr(lib, name, fn)
    _lib = lib
    return lib
