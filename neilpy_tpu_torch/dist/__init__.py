"""Multi-device execution layer: 2-D device meshes, halo exchange and
sharded raster pipelines (PyTorch counterpart of ``neilpy_tpu/dist/``,
its openness part, the DEM products: hillshade, Getis-Ord Gi/Gi*,
global and local Moran's I, and the sharded SMRF).

A mesh is a grid of ``torch.device`` driven from one process; it may
name one device several times, so the sharded path runs on one card or
on the host as well as across cards.
"""

from .api import (Mesh, make_mesh, pad_to_mesh, sharded_apply,
                  sharded_geomorphons, sharded_openness, sharded_skyview,
                  sharded_rastergi, sharded_morans_i,
                  sharded_local_morans_i, sharded_hillshade)
from .halo import halo_exchange_2d, block_origin
from .smrf import (sharded_smrf, sharded_springs_fill,
                   sharded_progressive_filter)

__all__ = [
    "Mesh", "make_mesh", "pad_to_mesh", "sharded_apply",
    "sharded_geomorphons", "sharded_openness", "sharded_skyview",
    "sharded_rastergi", "sharded_morans_i", "sharded_local_morans_i",
    "sharded_hillshade", "halo_exchange_2d", "block_origin",
    "sharded_smrf", "sharded_springs_fill", "sharded_progressive_filter",
]
