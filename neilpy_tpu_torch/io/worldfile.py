"""ESRI worldfile output (parity: neilpy/neilpy.py:1564-1570).  A copy
of ``neilpy_tpu/io/worldfile.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["write_worldfile"]


def write_worldfile(affine_matrix, output_file):
    """Write the 6-line worldfile for ``affine_matrix``.

    Lines: pixel width, col rotation, row rotation, pixel height, then
    the world coordinates of the *center* of the upper-left pixel.
    """
    x_ul_center, y_ul_center = affine_matrix * (.5, .5)
    pixel_width, row_rotation = affine_matrix[0], affine_matrix[1]
    pixel_height, col_rotation = affine_matrix[4], affine_matrix[3]
    world_data = [pixel_width, col_rotation, row_rotation, pixel_height,
                  x_ul_center, y_ul_center]
    np.savetxt(output_file, np.array([world_data]).reshape((6, 1)),
               fmt="%0.10f")
