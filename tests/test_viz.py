"""Visualization stack (viz/trackball.py, viz/render.py) and the file
utilities (utils/fileproc.py) — capability parity with trackball.{h,cpp},
View.h, and FileProcess/."""

import numpy as np

from kss_icp.utils.fileproc import browse_dir, find_point_clouds, stat_dir
from kss_icp.viz import (
    Trackball,
    add_quaternions,
    axis_angle_quaternion,
    drag_quaternion,
    quaternion_matrix,
    render_clouds,
    render_registration,
    write_png,
)
from helpers import random_cloud


# --- trackball ---------------------------------------------------------------

def test_quaternion_matrix_axis_angle():
    q = axis_angle_quaternion([0, 0, 1], np.pi / 2)
    r = quaternion_matrix(q)
    np.testing.assert_allclose(r @ [1, 0, 0], [0, 1, 0], atol=1e-12)
    # Orthonormal with det +1.
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-12)


def test_zero_drag_is_identity():
    q = drag_quaternion(0.3, 0.2, 0.3, 0.2)
    np.testing.assert_allclose(q, [0, 0, 0, 1])


def test_horizontal_drag_rotates_about_y():
    # Dragging right across the ball center rotates about the screen y axis.
    q = drag_quaternion(-0.3, 0.0, 0.3, 0.0)
    axis = q[:3] / np.linalg.norm(q[:3])
    np.testing.assert_allclose(np.abs(axis), [0, 1, 0], atol=1e-9)


def test_quaternion_accumulation_matches_matrix_product():
    q1 = axis_angle_quaternion([0, 1, 0], 0.4)
    q2 = axis_angle_quaternion([1, 0, 0], 0.7)
    q = add_quaternions(q1, q2)
    np.testing.assert_allclose(
        quaternion_matrix(q),
        quaternion_matrix(q1) @ quaternion_matrix(q2),
        atol=1e-12,
    )


def test_trackball_stateful_drag():
    tb = Trackball()
    np.testing.assert_allclose(tb.rotation, np.eye(3))
    tb.drag(0.0, 0.0, 0.4, 0.0)
    r1 = tb.rotation.copy()
    assert not np.allclose(r1, np.eye(3))
    tb.drag(0.4, 0.0, 0.0, 0.0)  # drag back ≈ undo
    np.testing.assert_allclose(tb.rotation, np.eye(3), atol=1e-9)


# --- renderer ----------------------------------------------------------------

def test_render_clouds_draws_points(rng, tmp_path):
    cloud = random_cloud(rng, 500)
    img = render_clouds([cloud], size=(200, 200))
    assert img.shape == (200, 200, 3) and img.dtype == np.uint8
    bg = np.array([18, 18, 22], np.uint8)
    assert (img != bg).any(axis=-1).sum() > 100  # plenty of lit pixels

    out = tmp_path / "x.png"
    write_png(out, img)
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IEND" in data


def test_render_zbuffer_near_wins():
    # Two points projecting to the same pixel: the nearer (greater rotated z)
    # must set the color.
    near = np.array([[0.0, 0.0, 1.0]])
    far = np.array([[0.0, 0.0, -1.0]])
    img = render_clouds([far, near], size=(64, 64), point_px=2,
                        colors=((255, 0, 0), (0, 255, 0)))
    center = img[28:36, 28:36].reshape(-1, 3)
    lit = center[(center != np.array([18, 18, 22], np.uint8)).any(axis=-1)]
    assert lit.size > 0
    assert (lit[:, 1] > lit[:, 0]).all()  # green (near) won every lit pixel


def test_render_registration_writes_overlay(rng, tmp_path):
    tgt = random_cloud(rng, 300)
    src = tgt + 0.1
    out = render_registration(tmp_path / "overlay.png", tgt, source=src,
                              aligned=tgt, size=(128, 128))
    assert out.exists() and out.stat().st_size > 100


# --- fileproc ----------------------------------------------------------------

def test_browse_and_stat_dir(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "x.xyz").write_text("1\n0 0 0\n")
    (tmp_path / "a" / "y.ply").write_text("ply")
    (tmp_path / "z.off").write_text("OFF\n0 0 0\n")
    (tmp_path / "notes.md").write_text("hi")

    files = list(browse_dir(tmp_path, "*.xyz"))
    assert [f.name for f in files] == ["x.xyz"]

    stats = stat_dir(tmp_path)
    assert stats.file_count == 4
    assert stats.subdir_count == 1
    assert stats.total_bytes > 0

    clouds = sorted(p.name for p in find_point_clouds(tmp_path))
    assert clouds == ["x.xyz", "y.ply", "z.off"]

    # Early stop via on_file.
    seen = []

    def stop_after_one(p):
        seen.append(p)
        return False

    list(browse_dir(tmp_path, "*", on_file=stop_after_one))
    assert len(seen) == 1
