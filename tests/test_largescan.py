"""Room/block-class large-scan protocol (kss_icp/largescan.py) at
CPU-sized shapes: the same octree -> FPS -> register -> full-res-metric
path bench.py and chip_smoke.py time at 200k points on the GPU (reference protocol:
EXE/start_Cuda.bat Room runs + Method_Octree.hpp:16-108)."""

from __future__ import annotations

import numpy as np


def test_room_scene_deterministic_and_sized():
    from kss_icp.largescan import room_scene

    a = room_scene(5000, seed=3, sample=0)
    b = room_scene(5000, seed=3, sample=0)
    c = room_scene(5000, seed=3, sample=1)
    assert a.shape == (5000, 3)
    np.testing.assert_array_equal(a, b)
    # Independent samplings of one room share geometry, not points.
    assert not np.array_equal(a, c)
    # Meters-scale scene: extent of a few meters in x/y, ~2-3 m in z.
    ext = a.max(axis=0) - a.min(axis=0)
    assert 4.0 < ext[0] < 12.0 and 4.0 < ext[1] < 12.0 and 1.5 < ext[2] < 4.0


def test_room_pair_ground_truth_roundtrip():
    from kss_icp.largescan import room_pair

    src, tgt, gt = room_pair(n_points=2000, seed=1, noise=0.0)
    # src = R @ base + t with the recorded gt; mapping back must land on
    # the base sampling of the scene (not on tgt — different sampling).
    back = ((src - gt["t"]) / gt["s"]) @ gt["R"]
    from kss_icp.largescan import room_scene

    base = room_scene(2000, 1, sample=1)
    np.testing.assert_allclose(back, base, atol=1e-4)


def test_largescan_end_to_end_small():
    from kss_icp.config import KSSICPConfig
    from kss_icp.largescan import run_largescan

    cfg = KSSICPConfig(
        max_candidates=6, coarse_points=512, coarse_target_points=512,
        refine_candidates=2, refine_tier_iterations=12,
        refine_max_iterations=48)
    out = run_largescan(n_points=20_000, pre_downsample=5_000, cfg=cfg,
                        seed=0, repeats=1)
    assert out["n_points"] == 20_000
    # The octree cut must actually reduce the working set toward target.
    assert out["pnumber"] == 2000
    # Basin-correct pose on a meters-scale room (extent ~8-10 m): a wrong
    # basin lands at meters of pose error, a correct one at centimeters.
    assert out["pose_rmse"] < 0.3, out
    # Full-res RMSE sits at the sampling-density floor (~the 9 cm mean
    # spacing at 20k points over ~150 m^2), far below the room extent.
    assert out["rmse"] < 0.2, out
    assert out["metric_pairs_per_s"] > 0
