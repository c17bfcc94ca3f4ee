"""TransferPC-equivalent synthetic pair generator (kss_icp/transfer.py)
against the reference tool's semantics (transferPC.hpp:66-180) and the
transfer.txt ground-truth protocol (SURVEY.md §4.2)."""

import numpy as np
import pytest

from kss_icp.transfer import (
    TransferRecord,
    apply_record,
    axis_rotation_matrix,
    inverse_rotation,
    load_transfer_log,
    make_pair,
    parse_transfer_log,
    rotate_axis,
    save_pair,
    save_transfer_log,
    scale_about_centroid,
    translate_uniform,
)
from helpers import random_cloud


def test_parse_transfer_log_reference_format():
    # Both spacings appear in the bundled log ("ant x:1.56", "Girl x: 1.1").
    recs = parse_transfer_log("ant x:1.56\nCat y:1.56\nGirl x: 1.1\n\nDog z:1.1")
    assert [r.name for r in recs] == ["ant", "Cat", "Girl", "Dog"]
    assert recs[0].axis == "x" and recs[0].angle == pytest.approx(1.56)
    assert recs[2].axis == "x" and recs[2].angle == pytest.approx(1.1)
    assert recs[3].axis == "z" and recs[3].angle == pytest.approx(1.1)


def test_parse_bundled_transfer_log(reference_data_dir):
    recs = load_transfer_log(reference_data_dir / "registration" / "transfer.txt")
    by_name = {r.name: r for r in recs}
    assert by_name["ant"].axis == "x"
    assert by_name["ant"].angle == pytest.approx(1.56)
    assert by_name["woodMan"].axis == "y"


def test_log_roundtrip(tmp_path):
    recs = [
        TransferRecord("a", "x", 1.56),
        TransferRecord("b", "z", 0.3, scale=0.5, translation=2.0),
    ]
    save_transfer_log(tmp_path / "log.txt", recs)
    back = load_transfer_log(tmp_path / "log.txt")
    assert back == recs


def test_rotation_matches_reference_formulas(rng):
    """TransferPC_Transfer's per-axis formulas (transferPC.hpp:66-98)."""
    pts = rng.normal(size=(50, 3))
    a = 0.7
    c, s = np.cos(a), np.sin(a)
    # cord==1 (x): y' = y c - z s, z' = y s + z c
    rx = rotate_axis(pts, "x", a)
    np.testing.assert_allclose(rx[:, 0], pts[:, 0])
    np.testing.assert_allclose(rx[:, 1], pts[:, 1] * c - pts[:, 2] * s)
    np.testing.assert_allclose(rx[:, 2], pts[:, 1] * s + pts[:, 2] * c)
    # cord==2 (y): x' = z s + x c, z' = z c - x s
    ry = rotate_axis(pts, "y", a)
    np.testing.assert_allclose(ry[:, 0], pts[:, 2] * s + pts[:, 0] * c)
    np.testing.assert_allclose(ry[:, 2], pts[:, 2] * c - pts[:, 0] * s)
    # cord==3 (z): x' = x c - y s, y' = x s + y c
    rz = rotate_axis(pts, "z", a)
    np.testing.assert_allclose(rz[:, 0], pts[:, 0] * c - pts[:, 1] * s)
    np.testing.assert_allclose(rz[:, 1], pts[:, 0] * s + pts[:, 1] * c)


def test_rotation_agrees_with_core_transforms(rng):
    import jax.numpy as jnp

    from kss_icp.core.transforms import rot_x, rot_y, rot_z

    for axis, fn in (("x", rot_x), ("y", rot_y), ("z", rot_z)):
        np.testing.assert_allclose(
            axis_rotation_matrix(axis, 1.1), np.asarray(fn(jnp.float64(1.1))),
            atol=1e-12,
        )


def test_scale_about_centroid_fixes_centroid(rng):
    pts = rng.normal(size=(100, 3)) + 5.0
    out = scale_about_centroid(pts, 0.35)
    np.testing.assert_allclose(out.mean(0), pts.mean(0), atol=1e-12)
    np.testing.assert_allclose(
        out - out.mean(0), (pts - pts.mean(0)) * 0.35, atol=1e-12
    )


def test_translate_uniform_is_diagonal_shift(rng):
    pts = rng.normal(size=(10, 3))
    np.testing.assert_allclose(translate_uniform(pts, 1.5), pts + 1.5)


def test_apply_record_order(rng):
    pts = rng.normal(size=(40, 3))
    rec = TransferRecord("t", "y", 0.4, scale=2.0, translation=-1.0)
    manual = translate_uniform(
        scale_about_centroid(rotate_axis(pts, "y", 0.4), 2.0), -1.0
    )
    np.testing.assert_allclose(apply_record(pts, rec), manual)


def test_make_pair_and_recover_transform(rng, tmp_path):
    """End-to-end known-transform protocol: generate a pair with a recorded
    rotation, register it back, verify the recovered rotation inverts the
    record (the transfer.txt oracle)."""
    import jax.numpy as jnp

    from kss_icp.config import KSSICPConfig
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.io.formats import load_points
    from kss_icp.metrics import registration_measure
    from kss_icp.models.kss_icp import register_pair

    cloud = random_cloud(rng, 1500)
    rec = TransferRecord("wavy", "x", 1.56)
    pair = make_pair(cloud, rec, wlop_points=600, wlop_iterations=5)
    assert pair.target.shape[0] >= 500
    assert pair.source.shape[0] > 100

    wlop_path, gird_path = save_pair(pair, tmp_path)
    src = load_points(gird_path)
    tgt = load_points(wlop_path)

    cfg = KSSICPConfig(
        rotation_steps=8, max_candidates=8, max_resample_points=256,
        resample_pad=256, max_icp_iterations=100,
    )
    res = register_pair(src, tgt, cfg)
    aligned = np.asarray(apply_similarity(res.transform, jnp.asarray(src, jnp.float32)))
    m = registration_measure(aligned, tgt.astype(np.float32))
    assert m["rmse"] < 0.05, m

    # Recovered rotation must invert the recorded one (trace-angle metric).
    r_rec = np.asarray(res.transform.rotation, np.float64)
    resid = r_rec @ axis_rotation_matrix("x", 1.56)
    cos_angle = (np.trace(resid) - 1.0) / 2.0
    assert cos_angle > np.cos(np.deg2rad(10.0)), resid
    # And inverse_rotation is that oracle.
    np.testing.assert_allclose(
        inverse_rotation(rec), axis_rotation_matrix("x", 1.56).T
    )
