"""Plain reference of ``geomorphons_l50``: geomorphon classes of a
float32 DEM at lookup 50, threshold 1 degree, ``enhance=False``
(neilpy.py:1617-1654), from the frozen plain counts ladder and the J&S
table (``plain.py``), in ``dtype`` (float32; bfloat16 for the control)."""

from __future__ import annotations

import torch

from . import plain


def classes_of(Z, cfg, call, dtype=torch.float32):
    """uint8 classes of raster ``Z`` (a tensor) for the configuration
    ``cfg`` and the traffic's call arguments ``call``."""
    if cfg["enhance"]:
        raise ValueError("the reference covers enhance=False only")
    return plain.classes(*plain.counts(
        Z.to(dtype), cfg["cellsize"], cfg["lookup_pixels"],
        cfg["threshold_angle"], fast=bool(call.get("fast", False)),
        how_fast=int(call.get("how_fast", 20))))


def class_diff_px(got, want):
    """Pixels at which the classes differ (shapes must agree)."""
    if tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"shape {tuple(got.shape)} against "
                         f"{tuple(want.shape)}")
    return int((got.to(want.device) != want).sum())
