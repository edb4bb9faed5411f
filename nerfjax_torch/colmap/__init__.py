"""COLMAP front end of the port (counterpart of ``nerfjax/colmap``, the same
exports): text model I/O, outlier filters, normalizers, the conversion to a
transforms JSON, re-centering and the COLMAP driver."""

from nerfjax_torch.colmap.model_io import (
    read_cameras_txt,
    read_images_txt,
    read_points3d_txt,
    write_images_txt,
    write_points3d_txt,
)
from nerfjax_torch.colmap.outliers import remove_statistical_outliers
from nerfjax_torch.colmap.normalize import (
    compute_percentile_bbox,
    robust_bbox_computation,
    scene_normalization,
)
from nerfjax_torch.colmap.convert import colmap_to_nerf, write_transforms_json
from nerfjax_torch.colmap.quaternion import quat_to_matrix, matrix_to_quat

__all__ = [
    "read_cameras_txt",
    "read_images_txt",
    "read_points3d_txt",
    "write_images_txt",
    "write_points3d_txt",
    "remove_statistical_outliers",
    "compute_percentile_bbox",
    "robust_bbox_computation",
    "scene_normalization",
    "colmap_to_nerf",
    "write_transforms_json",
    "quat_to_matrix",
    "matrix_to_quat",
]
