"""Build the package's CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``.  No PyTorch headers are
included, so a build takes seconds.  The library lands in
``build/neilpy_tpu_torch/`` beside the package (git-ignored), named by a
hash of the sources and flags, so an edit to a source rebuilds it and an
unchanged tree reuses it.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``,
``-fmad=false`` so no multiply-add is contracted into an FMA (the kernels
must round like their plain PyTorch versions), and never
``--use_fast_math``.  A missing or failing ``nvcc`` raises with its
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
SOURCE_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "neilpy_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

def _sources():
    srcs = sorted(SOURCE_DIR.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources in {SOURCE_DIR}")
    return srcs


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(nvcc).is_file():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "CUDA kernels of neilpy_tpu_torch are built from source at "
            "first use and need the CUDA toolkit")
    return nvcc


def library_path():
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*SOURCE_DIR.glob("*.cu"), *SOURCE_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libneilpy_tpu_torch_{h.hexdigest()[:16]}.so"


def build():
    """Compile the sources unless the library for them exists; return
    its path.  nvcc's output (ptxas's per-kernel registers and spills)
    is kept beside it, in the same name with ``.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load():
    """Build if needed, then load the library once per process and
    declare its C entries."""
    lib = ctypes.CDLL(str(build()))
    p = ctypes.c_void_p
    fn = lib.openness_counts_launch
    fn.argtypes = [p, ctypes.c_longlong, ctypes.c_longlong, p, p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, p, p, p]
    fn.restype = ctypes.c_int
    return lib
