from kss_icp.ops.nn import (
    knn,
    masked_mean_nn_distance,
    masked_mean_nn_sqdist,
    nearest_neighbor,
    pairwise_sqdist,
)
from kss_icp.ops.resample import (
    farthest_point_sampling,
    fps_points,
    voxel_downsample,
)
from kss_icp.ops.simplify import grid_simplify, hierarchy_simplify, octree_simplify
from kss_icp.ops.spatial import build_voxel_grid, estimate_box_scale, estimate_radius
from kss_icp.ops.wlop import wlop_resample
from kss_icp.ops.aivs import aivs_resample
from kss_icp.ops.normals import estimate_oriented_normals

__all__ = [
    "knn",
    "pairwise_sqdist",
    "nearest_neighbor",
    "masked_mean_nn_distance",
    "masked_mean_nn_sqdist",
    "farthest_point_sampling",
    "fps_points",
    "voxel_downsample",
    "grid_simplify",
    "hierarchy_simplify",
    "octree_simplify",
    "build_voxel_grid",
    "estimate_box_scale",
    "estimate_radius",
    "wlop_resample",
    "aivs_resample",
    "estimate_oriented_normals",
]
