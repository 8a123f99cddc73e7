"""neilpy_tpu_torch — the PyTorch / CUDA port of ``neilpy_tpu`` for
NVIDIA Hopper GPUs.

It grows slice by slice beside the JAX package, which stays the
reference each part is held against.  This slice is the README's main
path, DEM -> geomorphon classes::

    import neilpy_tpu_torch as ntt
    Z, meta = ntt.imread("dem.tif")
    G = ntt.geomorphons(Z, cellsize=meta["cellsize"], lookup_pixels=50)
    ntt.imwrite("classes.tif", G, meta, colormap=ntt.geomorphon_cmap())

Numpy input goes to the CUDA device by default, where the openness
counts run in a hand-written kernel (``csrc/openness_counts.cu``, built
with nvcc at first use); ``device='cpu'`` runs the plain PyTorch
version instead.  Names and arguments follow ``neilpy_tpu``.  The
package imports neither ``jax`` nor ``neilpy_tpu``.
"""

__version__ = "0.1.0"

# ----- core -----------------------------------------------------------
from .core.affine import Affine, from_origin
from .core.shift import ashift
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
from .ops.visibility import (count_openness, geomorphons, get_geomorphons,
                             get_geomorphon_from_openness)
