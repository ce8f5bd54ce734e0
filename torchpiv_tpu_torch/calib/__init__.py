"""Camera calibration and stereo reconstruction (beyond the reference);
a copy of ``torchpiv_tpu/calib/__init__.py``.

The reference is strictly single-camera planar 2C-2D PIV in pixel units.
This layer adds the standard lab workflow on top of the same engine
output: polynomial (Soloff) camera mappings fitted from calibration-target
images, image->world dewarping of displacement fields, and two-camera
stereo reconstruction of the full three-component displacement vector.
"""
from .mapping import CameraMapping, dewarp_field, dewarp_image, world_grid
from .stereo import reconstruct_from_grids, stereo_reconstruct
from .targets import detect_dot_grid, detect_dots, order_into_grid

__all__ = [
    "CameraMapping", "dewarp_field", "dewarp_image", "world_grid",
    "stereo_reconstruct", "reconstruct_from_grids",
    "detect_dot_grid", "detect_dots", "order_into_grid",
]
