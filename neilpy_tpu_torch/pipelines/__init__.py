"""End-to-end pipelines: SMRF ground filtering and the out-of-core
mosaic."""

from .smrf import smrf, smrf_las, progressive_filter
from .mosaic import mosaic_terrain_products, required_overlap

__all__ = ["smrf", "smrf_las", "progressive_filter",
           "mosaic_terrain_products", "required_overlap"]
