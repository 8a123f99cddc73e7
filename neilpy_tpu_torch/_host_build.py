"""Build the package's host (C++) libraries at first use.

Three plain-C libraries back the host side of the port, each from its
own source in ``native/``: ``tiffcodec`` (LZW and PackBits decoding),
``las_decoder`` (the multithreaded, mmapped LAS point decoder) and
``binning`` (float64 point binning and the origin shift).  Each is
compiled by ``g++`` on first use into ``build/neilpy_tpu_torch/host/``
beside the package (git-ignored) and loaded with ``ctypes``.

The library's name carries a hash of its source, the flags and the CPU
signature (the machine and the md5 of the cpuinfo flags line): the
build is tuned with ``-march=native`` where the compiler accepts it, so
a library built on one host is never loaded on another; it is rebuilt
there under its own name.  Concurrent processes build a library under
an ``fcntl.flock`` on ``build/neilpy_tpu_torch/host/.<name>.lock``, into
a temporary name that ``os.replace`` moves into place; the three
libraries may build at once.  Nothing is written anywhere else, and
``make`` is never run.

Flags: ``-O3 -std=c++17 -fPIC -pthread -shared`` and
``-ffp-contract=off``, so the decoder's ``X * scale + offset`` rounds
twice as numpy's does in ``io/las.read_las`` (g++ contracts it into an
FMA under ``-march=native`` otherwise, which moves z by one ulp on some
points).

A failed build or load is reported once per library with
``warnings.warn`` (with the tail of g++'s output) and the library
counts as unavailable: ``load`` returns None and the callers fall back
where the JAX package falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import warnings
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
SOURCE_DIR = _PKG_DIR / "native"
BUILD_DIR = _PKG_DIR.parent / "build" / "neilpy_tpu_torch" / "host"
NAMES = ("tiffcodec", "las_decoder", "binning")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
             "-ffp-contract=off")

_LOADED = {}  # name -> ctypes.CDLL, or None after a reported failure


def cpu_signature():
    """(machine, md5 of the cpuinfo flags line) of this host."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass  # no /proc/cpuinfo: the signature is the machine alone
    return platform.machine(), hashlib.md5(flags.encode()).hexdigest()


def _cxx():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH; the host libraries of "
                           "neilpy_tpu_torch are built from source at "
                           "first use")
    return cxx


def _flags(cxx):
    """``CXX_FLAGS`` plus ``-march=native`` where ``cxx`` accepts it."""
    probe = subprocess.run([cxx, "-march=native", "-E", "-x", "c++",
                            os.devnull], capture_output=True)
    return (*CXX_FLAGS, *(("-march=native",) if probe.returncode == 0
                          else ()))


def library_path(name, flags):
    """Path of the library ``name`` for its source, ``flags`` and this
    host's CPU signature."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(" ".join(cpu_signature()).encode())
    h.update((SOURCE_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name):
    """Compile ``native/<name>.cpp`` unless its library exists; return
    the library's path.  Raises RuntimeError with g++'s output when the
    compiler is missing or fails."""
    if name not in NAMES:
        raise ValueError(f"unknown host library {name!r}; one of {NAMES}")
    cxx = _cxx()
    flags = _flags(cxx)
    lib = library_path(name, flags)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.is_file():  # another process built it meanwhile
                return lib
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *flags, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cpp")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed on native/{name}.cpp (exit "
                    f"{proc.returncode}):\n{proc.stderr[-2000:]}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def load(name, declare):
    """The loaded library ``name``, built first if needed, after
    ``declare(lib)`` has set its functions' argtypes and restype; None
    when it cannot be built or loaded (reported once)."""
    if name in _LOADED:
        return _LOADED[name]
    try:
        lib = ctypes.CDLL(str(build(name)))
        declare(lib)
    except (RuntimeError, OSError, AttributeError) as e:
        warnings.warn(f"neilpy_tpu_torch: the host library {name!r} is "
                      f"unavailable, falling back where the package can: "
                      f"{e}", RuntimeWarning, stacklevel=3)
        lib = None
    _LOADED[name] = lib
    return lib
