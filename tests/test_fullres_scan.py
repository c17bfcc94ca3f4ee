"""Full-resolution-scan regime (the reference's Room/block CUDA-EXE path,
Method_Octree.hpp:16, ballRegionCompute.hpp:477-530): 10^5-point clouds
must flow through the whole pipeline — streaming k-NN, FPS resampling and
registration — without any (P, P) intermediate."""

import numpy as np
import pytest

from kss_icp.config import KSSICPConfig


@pytest.mark.slow
def test_register_60k_point_scan():
    import jax.numpy as jnp

    from kss_icp.core.transforms import apply_similarity
    from kss_icp.metrics import registration_measure
    from kss_icp.models.kss_icp import register_pair

    rng = np.random.default_rng(3)
    n = 60_000
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    tgt = np.stack([u, v, 0.4 * np.sin(2 * u) * np.cos(3 * v)], -1).astype(np.float32)
    ang = 0.9
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    src = (tgt @ r.T) * 1.4 + 0.3

    cfg = KSSICPConfig(max_candidates=6, coarse_points=512,
                       coarse_target_points=512, refine_candidates=2,
                       auto_escalate=False)
    res = register_pair(src, tgt, cfg)
    aligned = np.asarray(apply_similarity(res.transform, jnp.asarray(src)))
    # Measure on a subsample (the metric itself streams, but keep CI fast).
    m = registration_measure(aligned[::6], tgt)
    assert m["rmse"] < 0.05, m


@pytest.mark.slow
def test_octree_then_normals_100k():
    import jax.numpy as jnp

    from kss_icp.ops.normals import estimate_normals
    from kss_icp.ops.simplify import octree_simplify

    rng = np.random.default_rng(4)
    n = 100_000
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    pts = np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1).astype(np.float32)
    mask = np.ones(n, bool)
    # Octree downsample toward the reference's ~80k working size...
    out, keep = octree_simplify(jnp.asarray(pts), jnp.asarray(mask), 40_000)
    kept = int(np.asarray(keep).sum())
    assert 10_000 < kept < 100_000
    # ...then PCA normals over the full cloud via streaming k-NN.
    normals = estimate_normals(jnp.asarray(pts), jnp.asarray(mask))
    lens = np.linalg.norm(np.asarray(normals), axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)
    # Surface is near-planar locally: normals should be mostly +-z.
    assert (np.abs(np.asarray(normals)[:, 2]) > 0.5).mean() > 0.9
