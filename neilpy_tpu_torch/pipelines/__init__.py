"""End-to-end pipelines: SMRF ground filtering."""

from .smrf import smrf, smrf_las, progressive_filter

__all__ = ["smrf", "smrf_las", "progressive_filter"]
