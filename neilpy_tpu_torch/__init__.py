"""neilpy_tpu_torch — the PyTorch / CUDA port of ``neilpy_tpu`` for
NVIDIA Hopper GPUs.

It grows slice by slice beside the JAX package, which stays the
reference each part is held against.  Ported so far: the README's main
path, DEM -> geomorphon classes, the rest of the openness family
(openness, negative openness, skyview factor, ternary codes,
geomorphons2), and its mesh-sharded form (``dist``: a single-process
mesh of torch devices, which may repeat one card)::

    import neilpy_tpu_torch as ntt
    Z, meta = ntt.imread("dem.tif")
    G = ntt.geomorphons(Z, cellsize=meta["cellsize"], lookup_pixels=50)
    ntt.imwrite("classes.tif", G, meta, colormap=ntt.geomorphon_cmap())
    pos, neg = ntt.openness_pair(Z, cellsize=meta["cellsize"],
                                 lookup_pixels=50)
    ntt.imwrite("openness.tif", pos, meta)
    mesh = ntt.dist.make_mesh(["cuda:0"] * 4)          # 2 x 2 on one card
    G2 = ntt.dist.sharded_geomorphons(Z, mesh, cellsize=meta["cellsize"],
                                      lookup_pixels=50)

Numpy input goes to the CUDA device by default, where the scan ladder
runs in hand-written kernels (``csrc/*.cu``, built with nvcc at first
use); ``device='cpu'`` runs their plain PyTorch versions instead.
Names and arguments follow ``neilpy_tpu``.  The package imports neither
``jax`` nor ``neilpy_tpu``.
"""

__version__ = "0.1.0"

# ----- core -----------------------------------------------------------
from .core.affine import Affine, from_origin
from .core.shift import ashift, gradient2d
from .core.codes import (int2base, get_lowest_equivalent,
                         terrain_code_to_geomorphon, progressive_window,
                         disk, distance_kernel, geomorphon_cmap,
                         geomorphon_cmap_old)

# ----- I/O ------------------------------------------------------------
from .io.geotiff import (imread, imwrite, read_geotiff, write_geotiff,
                         GeoTiffSource)
from .io.worldfile import write_worldfile
from .io.png import write_paletted_png

# ----- visibility / geomorphons --------------------------------------
from .ops.visibility import (openness, openness_pair, skyview_factor,
                             count_openness,
                             geomorphons, geomorphons2,
                             ternary_pattern_from_openness,
                             get_geomorphons, get_geomorphon_from_openness)

# ----- multi-device (single-process mesh) ----------------------------
from . import dist
