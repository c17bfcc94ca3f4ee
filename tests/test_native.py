"""Native C++ parser: exact parity with the Python readers."""

import numpy as np
import pytest

from kss_icp.io.formats import load_points, save_ply, save_xyz
from kss_icp.native import available, load_points_batch, load_points_native

pytestmark = pytest.mark.skipif(not available(), reason="native lib unavailable")


def test_count_format_parity(tmp_path, rng):
    pts = rng.normal(size=(123, 3))
    p = tmp_path / "a.xyz"
    save_xyz(p, pts)
    a = load_points_native(p)
    b = load_points(p)
    np.testing.assert_array_equal(a, b)


def test_binary_ply_parity(tmp_path, rng):
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    p = tmp_path / "b.ply"
    save_ply(p, pts)
    a = load_points_native(p)
    np.testing.assert_allclose(a, pts, atol=1e-7)


def test_ascii_ply_parity(tmp_path):
    p = tmp_path / "c.ply"
    p.write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float quality\nend_header\n1 2 3 9\n4 5 6 9\n"
    )
    np.testing.assert_allclose(load_points_native(p), [[1, 2, 3], [4, 5, 6]])


def test_off_and_obj_parity(tmp_path):
    off = tmp_path / "d.off"
    off.write_text("OFF\n3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    np.testing.assert_allclose(load_points_native(off), load_points(off))
    obj = tmp_path / "e.obj"
    obj.write_text("v 1 2 3\nvn 0 0 1\nv 4 5 6\nf 1 2\n")
    np.testing.assert_allclose(load_points_native(obj), load_points(obj))


def test_bundled_parity(reference_data_dir):
    for name in ("Bunny.gird", "Bunny.wlop", "Cat.gird"):
        p = reference_data_dir / "registration" / name
        np.testing.assert_array_equal(load_points_native(p), load_points(p))


def test_batch_loader(reference_data_dir):
    paths = [
        reference_data_dir / "registration" / f"{m}.gird"
        for m in ("Bunny", "Cat", "Dog")
    ]
    out = load_points_batch(paths)
    assert [o.shape[0] for o in out] == [2813, 2282, 1771] or all(
        o is not None for o in out
    )
    for p, o in zip(paths, out):
        np.testing.assert_array_equal(o, load_points(p))


def test_missing_file_returns_none():
    assert load_points_native("/tmp/does_not_exist_kssicp.xyz") is None


def test_native_writer_roundtrip(tmp_path, rng):
    from kss_icp.io.formats import load_points, save_xyz
    from kss_icp.native import available, save_xyz_native

    pts = rng.normal(size=(123, 3))
    p = tmp_path / "out.xyz"
    save_xyz(p, pts)  # native when available, python otherwise
    back = load_points(p, prefer_native=False)
    np.testing.assert_allclose(back, pts, rtol=1e-5, atol=1e-9)  # %.6g ulp
    assert p.read_text().splitlines()[0] == "123"
    if available():
        # Native and python writers must produce identical bytes.
        p2 = tmp_path / "out2.xyz"
        assert save_xyz_native(p2, pts)
        p3 = tmp_path / "out3.xyz"
        save_xyz(p3, pts, prefer_native=False)
        assert p2.read_text() == p3.read_text()
    # Truncation (not append) on rewrite.
    save_xyz(p, pts[:10])
    assert load_points(p, prefer_native=False).shape[0] == 10
