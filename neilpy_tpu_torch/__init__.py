"""neilpy_tpu_torch — the PyTorch / CUDA port of ``neilpy_tpu`` for
NVIDIA Hopper GPUs.

It grows slice by slice beside the JAX package, which stays the
reference each part is held against.  Ported so far: the README's main
path, DEM -> geomorphon classes, the rest of the openness family
(openness, negative openness, skyview factor, ternary codes,
geomorphons2), its mesh-sharded form (``dist``: a single-process
mesh of torch devices, which may repeat one card), and the SMRF lidar
pipeline (points -> min-surface scatter -> springs inpaint ->
disk-opening ladder -> spline lift -> ground labels; ``core/grid``,
``io/text``, ``io/las``, ``ops/pointgrid``, ``ops/morphology``,
``ops/inpaint``, ``ops/spline``, ``pipelines/smrf``)::

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
    df = ntt.read_isprs("samp12.txt")
    Zpro, t, cells, is_object = ntt.smrf(df.x, df.y, df.z, 1, 18, .15, .5,
                                         1.25)
    ntt.smrf_las("in.las", "classified.las", windows=18)

Numpy input goes to the CUDA device by default, where the scan ladder
runs in hand-written kernels (``csrc/*.cu``, built with nvcc at first
use); ``device='cpu'`` runs their plain PyTorch versions instead.  The
SMRF slice runs plain torch ops on the device (``precision='exact'`` in
float64 there).  Names and arguments follow ``neilpy_tpu``.  The
package imports neither ``jax`` nor ``neilpy_tpu``.
"""

__version__ = "0.1.0"

# ----- core -----------------------------------------------------------
from .core.affine import Affine, from_origin
from .core.grid import (Raster, keep_xyz, edges_from_IT, unique_rows,
                        cutter, normalize)
from .core.shift import ashift, gradient2d
from .core.codes import (int2base, get_lowest_equivalent,
                         terrain_code_to_geomorphon, progressive_window,
                         disk, distance_kernel, geomorphon_cmap,
                         geomorphon_cmap_old)

# ----- I/O ------------------------------------------------------------
from .io.geotiff import (imread, imwrite, read_geotiff, write_geotiff,
                         GeoTiffSource)
from .io.las import read_las, write_las
from .io.worldfile import write_worldfile
from .io.png import write_paletted_png
from .io.text import read_isprs, read_xyz

# ----- visibility / geomorphons --------------------------------------
from .ops.visibility import (openness, openness_pair, skyview_factor,
                             count_openness,
                             geomorphons, geomorphons2,
                             ternary_pattern_from_openness,
                             get_geomorphons, get_geomorphon_from_openness)

# ----- point cloud pipeline ------------------------------------------
from .ops.pointgrid import (create_dem, create_dem_from_las,
                            bin_points)
from .ops.inpaint import (inpaint_nans_by_springs, inpaint_nans_by_fda,
                          inpaint_nearest, inpaint_nearest_device)
from .ops.morphology import (grey_erosion_disk, grey_dilation_disk,
                             opening_disk, opening, erosion, dilation)
from .ops.spline import interp_spline_2d
from .pipelines.smrf import smrf, smrf_las, progressive_filter

# ----- multi-device (single-process mesh) ----------------------------
from . import dist
