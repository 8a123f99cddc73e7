"""Build the package's CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  No PyTorch headers are
included, so a build takes seconds.  The library lands in
``build/neilpy_tpu_torch/`` beside the package (git-ignored), named by a
hash of the sources (``*.cu`` and the shared ``*.cuh``) and flags, so an
edit to a source rebuilds it and an unchanged tree reuses it.

Each step is a span of ``profiling.once``, recorded in every process:
``build.library`` around ``load`` (attr ``library`` "cuda" and ``built``),
with children ``build.hash`` (the sources' hash), ``build.compile``
(nvcc, only when it runs) and ``build.load`` (``ctypes`` and the C
entries' declarations).

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
import re
import shutil
import subprocess
import time
from pathlib import Path

from . import profiling

_PKG_DIR = Path(__file__).resolve().parent
SOURCE_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "neilpy_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
# seconds this process spent compiling in ``build`` (read by
# ``profiling.compile_report``)
BUILD_SECONDS = 0.0

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


def _run_all(cmds):
    """Start every command at once, wait for all, and raise with the
    output of the first that failed; return their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build():
    """Compile the sources unless the library for them exists; return
    its path.  nvcc's output (ptxas's per-kernel registers and spills)
    is kept beside it, in the same name with ``.log``."""
    global BUILD_SECONDS
    t0 = time.perf_counter()
    with profiling.once("build.hash"):
        lib = library_path()
    if lib.is_file():
        return lib
    with profiling.once("build.compile"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        objs = [lib.with_suffix(f".{src.stem}.{os.getpid()}.o")
                for src in _sources()]
        try:
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                             str(src)]
                            for src, obj in zip(_sources(), objs)])
            log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp), *(str(o) for o in objs)]])
        except RuntimeError:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    BUILD_SECONDS += time.perf_counter() - t0
    return lib


def ptxas_summary(log):
    """[kernel, registers, spill bytes stored, spill bytes loaded] per
    function of the build's ``ptxas -v`` log (mangled names)."""
    out, fn, spill = [], None, (0, 0)
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
        elif "spill stores" in ln:
            spill = tuple(int(v) for v in re.findall(r"(\d+) bytes spill", ln))
        elif fn is not None and (m := re.search(r"Used (\d+) registers", ln)):
            out.append([fn, int(m.group(1)), *spill])
            fn, spill = None, (0, 0)
    return out


def entry_argtypes():
    """{C entry: its ctypes argument types, the stream last}."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    f = ctypes.c_float
    d = ctypes.c_double
    pp = ctypes.POINTER(ctypes.c_void_p)
    lp = ctypes.POINTER(ctypes.c_longlong)
    hw = (ll, ll)
    # every ladder entry starts (Z, H, W, ladder, scales, K, Rmax, dense);
    # every entry ends with the stream
    head = [p, *hw, p, p, i, i, i]
    plan = [ll, ll, i, ll, ll, i]  # rlo, rhi, rmasks, clo, chi, cmasks
    tile = [i] * 6  # halo, ty0, ty1, tx0, tx1, tma
    entries = {
        # (..., tile, T, num_pos, num_neg)
        "openness_counts_launch": [*head, *tile, f, p, p],
        # (..., tile, plan, T, num_pos, num_neg)
        "openness_counts_plan_launch": [*head, *tile, *plan, f, p, p],
        # (..., tile, R, org_r, org_c, GH, GW, T, num_pos, num_neg)
        "openness_counts_block_launch": [*head, *tile, i, *hw, *hw, f, p, p],
        # (..., tile, mx, mn)
        "directional_extrema_launch": [*head, *tile, p, p],
        # (..., tile, org_r, org_c, GH, GW, mx, mn)
        "directional_extrema_global_launch": [*head, *tile, *hw, *hw, p, p],
        # (..., tile, mode, neg_mode, T, out0, out1, code)
        "openness_reduced_launch": [*head, *tile, i, i, f, p, p, p],
        # (..., tile, plan, mode, neg_mode, T, out0, out1, code)
        "openness_reduced_plan_launch": [*head, *tile, *plan, i, i, f, p, p,
                                         p],
        # the spline's Thomas solve: (rhs, x, factors, m, W, f64)
        "thomas_sweep_launch": [p, p, p, ll, ll, i],
        # the springs fill's K-cycle: (levels, extents, L, r, z, scratch,
        # scratch bytes, omega, nsmooth, kdepth, coarse iterations, tail,
        # tail shared bytes, f64)
        "mg_kcycle_launch": [pp, lp, i, p, p, p, ll, d, i, i, i, i, ll, i],
        # its stages alone: (level, extents, r, x, xc, Wc, omega, mode,
        # sweep, out, f64) and (level, extents, r, x, uc, Hc, Wc, rc, f64)
        "mg_smooth_launch": [pp, lp, p, p, p, ll, d, i, i, p, i],
        "mg_restrict_launch": [pp, lp, p, p, p, ll, ll, p, i],
        # binary footprint sums, one band: (X, out, H, W, reflect, head,
        # start, piece, accumulate, shared bytes)
        "footprint_sum_launch": [p, p, *hw, i, p, p, p, i, ll],
        # Gi's: (X, sum_v, sum_w, Z, P, bins, H, W, reflect, head, start,
        # piece, accumulate, last, nf, m0, m1, star, with_p, 1 / sqrt 2,
        # shared bytes)
        "footprint_gi_launch": [p, p, p, p, p, p, *hw, i, p, p, p, i, i, p,
                                p, p, i, i, f, ll],
    }
    return {name: [*argtypes, p] for name, argtypes in entries.items()}


@functools.lru_cache(maxsize=None)
def load():
    """Build if needed, then load the library once per process and
    declare its C entries: the span ``build.library``, whose ``built``
    says whether this call compiled."""
    attr = {"library": "cuda", "built": False}
    with profiling.once("build.library", attr=attr):
        compiled = BUILD_SECONDS
        path = build()
        attr["built"] = BUILD_SECONDS != compiled
        with profiling.once("build.load"):
            lib = ctypes.CDLL(str(path))
            for name, argtypes in entry_argtypes().items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            # (halo, Rmax, K) -> the dynamic shared memory of one tile CTA
            i = ctypes.c_int
            lib.ladder_tile_smem_bytes.argtypes = [i, i, i]
            lib.ladder_tile_smem_bytes.restype = ctypes.c_longlong
            # (extents, L, tail, kdepth, tail shared bytes, f64) -> the
            # K-cycle's scratch bytes
            lib.mg_scratch_bytes.argtypes = [
                ctypes.POINTER(ctypes.c_longlong), i, i, i,
                ctypes.c_longlong, i]
            lib.mg_scratch_bytes.restype = ctypes.c_longlong
    return lib
