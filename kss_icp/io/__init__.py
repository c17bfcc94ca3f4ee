from kss_icp.io.formats import (
    load_normals,
    load_obj,
    load_off,
    load_ply,
    load_points,
    load_xyz,
    save_xyz,
)

__all__ = [
    "load_points",
    "load_ply",
    "load_off",
    "load_obj",
    "load_xyz",
    "load_normals",
    "save_xyz",
]
