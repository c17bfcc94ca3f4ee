"""Analysis-layer capabilities: mesh angle stats (measure_mesh.py ←
meshMeasure.hpp), mesh normals + normal-error metrics (ops/normals.py ←
normalCompute.hpp:34-306,439-564), 2D Voronoi/CVT (ops/voronoi2d.py ← VD.hpp)
and VCM edge detection (ops/vcm.py ← CGAL_VCM.hpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kss_icp.measure_mesh import angle_statistics, mesh_angle_report, triangle_angles
from kss_icp.ops.normals import (
    facet_normals,
    normal_angle_errors,
    normal_error_measure,
    vertex_normals_from_mesh,
)
from kss_icp.ops.vcm import vcm_edges
from kss_icp.ops.voronoi2d import lloyd_relax, voronoi_cells


# --- mesh angles -----------------------------------------------------------

def test_triangle_angles_equilateral_and_right():
    verts = jnp.array(
        [[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0],  # equilateral
         [0, 0, 1], [1, 0, 1], [0, 1, 1]],                # right isoceles
        jnp.float64,
    )
    faces = jnp.array([[0, 1, 2], [3, 4, 5]])
    ang = np.asarray(triangle_angles(verts, faces))
    np.testing.assert_allclose(ang[0], np.pi / 3, atol=1e-12)
    np.testing.assert_allclose(sorted(ang[1]), [np.pi / 4, np.pi / 4, np.pi / 2], atol=1e-12)
    # Angle sum is always pi.
    np.testing.assert_allclose(ang.sum(axis=1), np.pi, atol=1e-12)


def test_angle_statistics_report():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0.01, 0.1, 0]])  # sliver
    faces = np.array([[0, 1, 2]])
    rep = mesh_angle_report(verts, faces, sliver_threshold_deg=30.0)
    assert rep["count"] == 3
    assert rep["sliver_count"] >= 1
    assert rep["histogram"].sum() == 3
    stats = angle_statistics(triangle_angles(jnp.asarray(verts, jnp.float64), jnp.asarray(faces)))
    assert stats["min"] <= stats["mean"] <= stats["max"]


# --- mesh normals ----------------------------------------------------------

def _unit_square_mesh():
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    return jnp.asarray(verts, jnp.float64), jnp.asarray(faces)


def test_facet_normals_planar():
    verts, faces = _unit_square_mesh()
    fn = np.asarray(facet_normals(verts, faces))
    np.testing.assert_allclose(fn, [[0, 0, 1], [0, 0, 1]], atol=1e-12)


@pytest.mark.parametrize("area_weighted", [True, False])
def test_vertex_normals_planar(area_weighted):
    verts, faces = _unit_square_mesh()
    vn = np.asarray(vertex_normals_from_mesh(verts, faces, area_weighted))
    np.testing.assert_allclose(vn, np.tile([0, 0, 1.0], (4, 1)), atol=1e-12)


def test_vertex_normals_area_weighting_differs():
    # One big + one tiny coplanar-ish triangle sharing vertex 0: weighting
    # must pull the shared normal toward the big face.
    verts = jnp.asarray(np.array(
        [[0, 0, 0], [4, 0, 0], [0, 4, 0],      # big triangle in z=0
         [0.1, 0, 0.1], [0, 0.1, 0.1]], float))  # tiny tilted triangle
    faces = jnp.asarray(np.array([[0, 1, 2], [0, 3, 4]]))
    vw = np.asarray(vertex_normals_from_mesh(verts, faces, True))[0]
    vp = np.asarray(vertex_normals_from_mesh(verts, faces, False))[0]
    big_n = np.array([0, 0, 1.0])
    assert np.dot(vw, big_n) > np.dot(vp, big_n)


def test_isolated_vertex_gets_zero_normal():
    verts = jnp.asarray(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [9, 9, 9]], float))
    faces = jnp.asarray(np.array([[0, 1, 2]]))
    vn = np.asarray(vertex_normals_from_mesh(verts, faces))
    np.testing.assert_allclose(vn[3], 0.0)


# --- normal error metrics --------------------------------------------------

def test_normal_error_sign_invariant_and_skips_singles(rng):
    n = rng.normal(size=(100, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    flip = np.where(rng.uniform(size=(100, 1)) < 0.5, -1.0, 1.0)
    max_e, mean_e, singles = normal_error_measure(
        jnp.asarray(n), jnp.asarray(n * flip)
    )
    assert float(max_e) < 1e-6 and float(mean_e) < 1e-6
    assert int(singles) == 0

    # A zero row is a "single point": excluded + counted.
    n2 = n.copy()
    n2[7] = 0.0
    max_e, mean_e, singles = normal_error_measure(jnp.asarray(n), jnp.asarray(n2))
    assert int(singles) == 1
    assert float(max_e) < 1e-6


def test_normal_error_known_angle():
    a = jnp.asarray(np.array([[0, 0, 1.0]]))
    b = jnp.asarray(np.array([[np.sin(0.3), 0, np.cos(0.3)]]))
    angle, valid = normal_angle_errors(a, b)
    assert bool(valid[0])
    np.testing.assert_allclose(float(angle[0]), 0.3, atol=1e-6)


# --- 2D Voronoi / CVT ------------------------------------------------------

def test_voronoi_cells_two_sites():
    sites = jnp.asarray(np.array([[0.25, 0.5], [0.75, 0.5]], np.float32))
    mask = jnp.asarray(np.array([True, True]))
    cells = voronoi_cells(sites, mask, (0.0, 0.0, 1.0, 1.0), resolution=128)
    areas = np.asarray(cells.areas)
    np.testing.assert_allclose(areas, [0.5, 0.5], atol=2e-2)
    cent = np.asarray(cells.centroids)
    np.testing.assert_allclose(cent[0], [0.25, 0.5], atol=2e-2)
    np.testing.assert_allclose(cent[1], [0.75, 0.5], atol=2e-2)
    assert np.asarray(cells.labels).shape == (128, 128)
    # Total area conserved.
    np.testing.assert_allclose(areas.sum(), 1.0, rtol=1e-5)


def test_voronoi_masked_site_gets_nothing():
    sites = jnp.asarray(np.array([[0.5, 0.5], [0.6, 0.6]], np.float32))
    mask = jnp.asarray(np.array([True, False]))
    cells = voronoi_cells(sites, mask, (0.0, 0.0, 1.0, 1.0), resolution=64)
    np.testing.assert_allclose(float(cells.areas[1]), 0.0)
    np.testing.assert_allclose(float(cells.areas[0]), 1.0, rtol=1e-5)


def test_lloyd_relax_spreads_sites(rng):
    # Clustered sites must spread out: CVT energy (mean NN spacing variance)
    # improves and sites stay in the box.
    sites0 = rng.uniform(0.4, 0.6, size=(16, 2)).astype(np.float32)
    mask = jnp.ones((16,), bool)
    out = np.asarray(
        lloyd_relax(jnp.asarray(sites0), mask, (0.0, 0.0, 1.0, 1.0),
                    resolution=128, iterations=12)
    )
    assert out.min() >= 0.0 and out.max() <= 1.0

    def min_spacing(s):
        d = np.linalg.norm(s[:, None] - s[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min(axis=1).mean()

    assert min_spacing(out) > 2.0 * min_spacing(sites0)


# --- VCM edges -------------------------------------------------------------

def test_vcm_flags_crease_not_plane(rng):
    # An L-shaped surface: points on two half-planes meeting at the x-axis.
    n = 400
    u = rng.uniform(0, 1, n)
    v = rng.uniform(0, 1, n)
    plane1 = np.stack([u, v, np.zeros(n)], -1)            # z=0, y>0
    plane2 = np.stack([rng.uniform(0, 1, n), np.zeros(n), rng.uniform(0, 1, n)], -1)
    pts = np.concatenate([plane1, plane2]).astype(np.float32)
    pad = 1024
    padded = np.zeros((pad, 3), np.float32)
    padded[: 2 * n] = pts
    mask = np.zeros((pad,), bool)
    mask[: 2 * n] = True

    edge, ratio = vcm_edges(
        jnp.asarray(padded), jnp.asarray(mask),
        offset_radius=0.25, convolve_radius=0.12,
        key=jax.random.PRNGKey(0), samples_per_point=48,
    )
    ratio = np.asarray(ratio)[: 2 * n]
    near_crease = (np.abs(pts[:, 1]) < 0.08) & (np.abs(pts[:, 2]) < 0.08)
    interior = (pts[:, 1] > 0.4) & (np.abs(pts[:, 2]) < 1e-6)  # deep in plane1
    assert near_crease.sum() > 10 and interior.sum() > 10
    # Crease points carry a clearly larger middle-eigenvalue ratio.
    assert ratio[near_crease].mean() > 1.5 * ratio[interior].mean()
    # Padding is never flagged.
    assert not np.asarray(edge)[2 * n:].any()
