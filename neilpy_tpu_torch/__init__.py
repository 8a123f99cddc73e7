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
``ops/inpaint``, ``ops/spline``, ``pipelines/smrf``), and the DEM
products (``ops/surface``: slope, aspect, hillshade, every curvature
family, TPI, ...; ``viz/shading``: Swiss and colour-table shading,
Brassel's atmospheric perspective; ``ops/stats``: Getis-Ord Gi/Gi*,
Moran's I and the accuracy metrics; their sharded forms in ``dist``),
the sharded SMRF (``dist.sharded_smrf``), the out-of-core mosaic
stream (``tiled_apply``, ``mosaic_terrain_products``), the host ingest
(the TIFF codecs of ``io/tiff_codec``, the native LAS decoder and
binning of ``io/las_native`` and ``ops/binning_native``, built with g++
at first use, which stream ``create_dem_from_las`` and ``smrf_las``) and
the host geodesy and photogrammetry helpers (``geo``, ``photo``)::

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
    H = ntt.hillshade(Z, cellsize=meta["cellsize"])
    ntt.imwrite("hillshade.tif", H, meta)
    rgb = ntt.swiss_shading(Z, cellsize=meta["cellsize"])
    Gi, P, sig = ntt.rasterGi(Z, ntt.disk(5), star=True)
    G, O, MI = ntt.mosaic_terrain_products(ntt.GeoTiffSource("big.tif"),
                                           tile_size=4096,
                                           checkpoint="mosaic.json")

Numpy input goes to the CUDA device by default, where the scan ladder
runs in hand-written kernels (``csrc/*.cu``, built with nvcc at first
use); ``device='cpu'`` runs their plain PyTorch versions instead.  The
SMRF slice and the DEM products run plain torch ops on the device
(``precision='exact'`` in float64 there).  Names and arguments follow ``neilpy_tpu``.  The
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

# ----- surface ops ----------------------------------------------------
from .ops.surface import (esri_slope, slope, aspect, curvature,
                          esri_curvature,
                          zevenbergen_and_thorne_curvature,
                          evans_curvature, wilson_gallant_curvature,
                          hillshade, multiple_illumination, pssm,
                          z_factor, triangle_height, vip_score, std,
                          std2, reduce_peaks,
                          topographic_position_index,
                          scaled_morphometry)

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
from .dist.tiling import tiled_apply, apply_parallel, TileCheckpoint

# ----- statistics -----------------------------------------------------
from .ops.stats import (gi_formula, gistar_formula, rasterGi, morans_i,
                        local_morans_i, rmse, score, shi_landslides, bdr,
                        chamfer_distance, hungarian_algorithm,
                        bdr_bootstrap)

# ----- visualization --------------------------------------------------
from .viz.shading import (swiss_shading, colortable_shade, swiss_lut,
                          brassel_atmospheric_perspective, corner_lut,
                          lut_shade)

# ----- geodesy / photogrammetry (host numpy) -------------------------
from .geo.proj import (coord_transform, great_circle_distance,
                       geodesic_inverse, utm_forward, utm_inverse)
from .geo.geoid import (geoid_height, ellipsoidal_to_orthometric,
                        orthometric_to_ellipsoidal)
from .photo.gnss import (read_llh, read_pos, stringify_time,
                         fix_gopro_bad_time_resolution,
                         fix_gopro_bad_time_resolution2, posprocessor,
                         track2azimuth, ypr2opk)
from .photo.exif import (exif_dict_to_dd, dd_to_exif_tuple,
                         read_geotags_into_df, ppk_images)
from . import geo, photo

# ----- multi-device (single-process mesh) / out-of-core --------------
from . import dist
from .pipelines.mosaic import mosaic_terrain_products
