"""pointPipeline facade (kss_icp/pipeline.py), uniform normalization,
mesh IO converters and the content-hashed cache (SURVEY.md §5.4)."""

import numpy as np

from kss_icp.io.formats import (
    border_indices,
    convert_obj_to_off,
    convert_off_to_obj,
    load_mesh,
    load_normals,
    save_obj,
    save_off,
    save_xyz,
    uniform_normalize,
)
from kss_icp.pipeline import (
    pipeline_from_file,
    pipeline_from_points,
    pipeline_from_points_without_uniform,
)
from kss_icp.utils.cache import ArrayCache, content_key
from helpers import random_cloud


def test_uniform_normalize_unit_cube(rng):
    pts = random_cloud(rng, 300) * 7.0 + np.array([5.0, -2.0, 9.0])
    out, info = uniform_normalize(pts)
    lo, hi = out.min(axis=0), out.max(axis=0)
    np.testing.assert_allclose((hi - lo).max(), 2.0, rtol=1e-12)
    assert np.all(hi <= 1.0 + 1e-9) and np.all(lo >= -1.0 - 1e-9)
    # Midpoint of the AABB is at the origin.
    np.testing.assert_allclose((hi + lo) / 2, 0.0, atol=1e-9)
    # Round trip.
    np.testing.assert_allclose(info.invert(out), pts, atol=1e-9)


def test_border_indices(rng):
    pts = rng.normal(size=(50, 3))
    b = border_indices(pts)
    assert pts[b[0], 0] == pts[:, 0].min()
    assert pts[b[3], 0] == pts[:, 0].max()
    assert pts[b[2], 2] == pts[:, 2].min()
    assert pts[b[5], 2] == pts[:, 2].max()


def test_mesh_roundtrip_and_converters(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    off = tmp_path / "m.off"
    save_off(off, verts, faces)
    v2, f2 = load_mesh(off)
    np.testing.assert_allclose(v2, verts)
    np.testing.assert_array_equal(f2, faces)

    obj = convert_off_to_obj(off)
    v3, f3 = load_mesh(obj)
    np.testing.assert_allclose(v3, verts)
    np.testing.assert_array_equal(f3, faces)

    off2 = convert_obj_to_off(obj, tmp_path / "m2.off")
    v4, f4 = load_mesh(off2)
    np.testing.assert_allclose(v4, verts)
    np.testing.assert_array_equal(f4, faces)

    # Quad fan-triangulation.
    quad_obj = tmp_path / "q.obj"
    quad_obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    _, fq = load_mesh(quad_obj)
    np.testing.assert_array_equal(fq, [[0, 1, 2], [0, 2, 3]])

    # Converter skips existing outputs unless overwrite (reference semantics).
    obj.write_text("corrupt")
    assert convert_off_to_obj(off).read_text() == "corrupt"
    convert_off_to_obj(off, overwrite=True)
    assert obj.read_text() != "corrupt"


def test_pipeline_without_uniform(rng):
    pts = random_cloud(rng, 400)
    st = pipeline_from_points_without_uniform(pts)
    assert st.count == 400
    assert st.normals is None and st.uniform is None
    assert st.boxes_per_axis == 10
    assert st.radius > 0
    assert int(st.grid.counts.sum()) == 400
    np.testing.assert_array_equal(st.border, border_indices(pts))


def test_pipeline_from_points_has_unit_normals(rng):
    pts = random_cloud(rng, 300)
    st = pipeline_from_points(pts, cache=None)
    assert st.normals is not None
    norms = np.linalg.norm(st.normals[:300], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)


def test_pipeline_from_file_sidecar_cache(rng, tmp_path):
    pts = random_cloud(rng, 280)
    cloud_path = tmp_path / "cloud.xyz"
    save_xyz(cloud_path, pts)
    st = pipeline_from_file(cloud_path, cache=ArrayCache(tmp_path / "cache"))
    assert st.uniform is not None
    assert np.abs(st.points[: st.count]).max() <= 1.0 + 1e-6
    sidecar = cloud_path.with_suffix(".normal")
    assert sidecar.exists()
    cached = load_normals(sidecar)
    assert cached.shape[0] == st.count
    # Second init consumes the sidecar (same normals, no recompute path).
    st2 = pipeline_from_file(cloud_path, cache=None)
    np.testing.assert_allclose(
        st2.normals[: st2.count], st.normals[: st.count], atol=1e-5
    )


def test_array_cache_roundtrip(tmp_path, rng):
    cache = ArrayCache(tmp_path / "c")
    a = rng.normal(size=(10, 3))
    key = content_key(a, op="test", k=3)
    assert cache.get(key) is None
    cache.put(key, out=a * 2)
    hit = cache.get(key)
    np.testing.assert_allclose(hit["out"], a * 2)
    # Different params -> different key.
    assert content_key(a, op="test", k=4) != key
    # Different contents -> different key.
    assert content_key(a + 1e-9, op="test", k=3) != key
