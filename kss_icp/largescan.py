"""Room/block-class large-scan registration.

The reference ships a CUDA-accelerated binary specifically for big RGB-D
scans — `/root/reference/EXE/Readme.txt` ("Cuda acceleration"),
`EXE/start_Cuda.bat` (Room/block runs) — and its octree downsampler
targets ~80k-point working sets (Method_Octree.hpp:16). The repo bundles
no such scan, so this module procedurally generates a Room-class scene
(floor + walls + furniture cuboids + clutter, sampled area-proportionally
at >= 100k points) and runs the reference's large-scan protocol
end-to-end:

  ingest -> octree voxel downsample to ~`pre_downsample` points
  (Method_Octree.hpp:20-108: keep the real point nearest each occupied
  voxel center) -> FPS resample to the working size (KSS_ICP.hpp:57-66)
  -> coarse rotation search + multi-start ICP -> apply the similarity to
  the FULL-resolution scan -> full-res 1-NN metric
  (registrationMeasure.hpp:47-98, chunked so the (Q, R) distance matrix
  never materializes).

The full-res metric at scan scale is the engine's widest 1-NN: a 200k x
200k pass is 4e10 point pairs, against ~4e6 per ICP iteration of the
2048-point serving path. On the GPU it runs the exact-f32 1-NN kernel
(ops/nn_triton.py, through ops/nn.nearest_neighbor).

bench.py reports `largescan_*` keys from `run_largescan`; the CLI reaches
the same path via `register --pre-downsample`.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict, Tuple

import numpy as np


def _room_boxes(rng: np.random.Generator):
    """[(center, half_extents)] for a room shell + furniture."""
    # Room shell: floor + 4 walls (open ceiling, like a scan from inside).
    w = float(rng.uniform(3.0, 5.0))    # half-width  (x)
    d = float(rng.uniform(2.5, 4.5))    # half-depth  (y)
    h = float(rng.uniform(1.2, 1.6))    # half-height (z)
    t = 0.02                            # surface half-thickness
    boxes = [
        (np.array([0, 0, -h]), np.array([w, d, t])),          # floor
        (np.array([-w, 0, 0]), np.array([t, d, h])),          # walls
        (np.array([w, 0, 0]), np.array([t, d, h])),
        (np.array([0, -d, 0]), np.array([w, t, h])),
        (np.array([0, d, 0]), np.array([w, t, h])),
    ]
    # Furniture: 8-14 cuboids on the floor (tables, cabinets, boxes).
    for _ in range(int(rng.integers(8, 15))):
        fx = float(rng.uniform(0.2, 0.9))
        fy = float(rng.uniform(0.2, 0.9))
        fz = float(rng.uniform(0.2, 1.0))
        cx = float(rng.uniform(-w + fx + 0.2, w - fx - 0.2))
        cy = float(rng.uniform(-d + fy + 0.2, d - fy - 0.2))
        boxes.append((np.array([cx, cy, -h + fz]), np.array([fx, fy, fz])))
    return boxes


def room_scene(n_points: int, seed: int = 0, sample: int = 0) -> np.ndarray:
    """Area-proportional surface sampling of a procedural room scene.

    (seed) fixes the geometry; (seed, sample) fixes the surface sampling,
    so two `sample` values are independent scans of one room — the
    two-viewpoints-of-one-scene protocol of the reference's Room runs."""
    geom_rng = np.random.default_rng(seed)
    boxes = _room_boxes(geom_rng)
    rng = np.random.default_rng((seed, sample, 17))
    areas = np.array([8 * (s[0] * s[1] + s[1] * s[2] + s[0] * s[2])
                      for _, s in boxes])
    counts = rng.multinomial(n_points, areas / areas.sum())
    parts = []
    for (c, s), m in zip(boxes, counts):
        fa = np.array([s[1] * s[2], s[1] * s[2], s[0] * s[2],
                       s[0] * s[2], s[0] * s[1], s[0] * s[1]])
        face = rng.choice(6, size=m, p=fa / fa.sum())
        u = rng.uniform(-1, 1, (m, 3)) * s
        axis = face // 2
        u[np.arange(m), axis] = np.where(face % 2 == 0, s[axis], -s[axis])
        parts.append(c + u)
    return np.concatenate(parts, axis=0).astype(np.float32)


def room_pair(n_points: int = 200_000, seed: int = 0,
              noise: float = 0.01) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """(source, target, gt): two independent scans of one room, the source
    perturbed by a known rigid transform + sensor noise (meters-scale
    scene, noise ~1 cm)."""
    from kss_icp.stress import rot_xyz

    tgt = room_scene(n_points, seed, sample=0)
    base = room_scene(n_points, seed, sample=1)
    rng = np.random.default_rng((seed, 99))
    gt = {"R": rot_xyz(0.9, 2.2, 1.3), "s": 1.0,
          "t": np.array([1.5, -0.8, 0.6])}
    src = (base @ gt["R"].T) * gt["s"] + gt["t"]
    src = src + rng.normal(scale=noise, size=src.shape)
    tgt = tgt + rng.normal(scale=noise, size=tgt.shape)
    return src.astype(np.float32), tgt.astype(np.float32), gt


def _pad(pts: np.ndarray, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    out = np.zeros((pad, 3), np.float32)
    n = min(len(pts), pad)
    out[:n] = pts[:n]
    m = np.zeros((pad,), bool)
    m[:n] = True
    return out, m


def run_largescan(n_points: int = 200_000, pre_downsample: int = 80_000,
                  cfg=None, seed: int = 0, repeats: int = 1) -> Dict:
    """End-to-end Room-class benchmark; returns timings + accuracy + the
    full-res metric's rate in point pairs per second.

    Stages (all jitted, timed separately and as a total):
      octree   voxel downsample both scans to ~pre_downsample points
      register FPS to the working size + coarse + multi-start ICP
               (the standard register_resampled path on the downsampled
               clouds — the reference's own protocol: the CUDA binary
               feeds the octree output to the same pipeline)
      metric   full-res chunked 1-NN RMSE of the aligned source
    """
    import jax
    import jax.numpy as jnp

    from kss_icp.challenge import transform_rmse
    from kss_icp.config import DEFAULT_CONFIG
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.metrics import registration_measure_padded
    from kss_icp.models.kss_icp import register_resampled, resample_pairs
    from kss_icp.ops.simplify import octree_simplify

    cfg = cfg or DEFAULT_CONFIG
    src, tgt, gt = room_pair(n_points, seed)
    # Normalize the metres-scale scene into the unit cube before
    # registration (PointCloud_Uniform semantics, LoadPointCloud.hpp:
    # 347-427 — the reference's own ingest normalization): every
    # calibrated fitness threshold (escalation gate, multistart gate) is a
    # unit-scale quantity, so an unnormalized room (extent ~10 m) would
    # mis-trigger them by the scale squared. One common factor from the
    # target keeps the pair's relative geometry; metrics and pose are
    # reported back in scene units.
    center = tgt.mean(axis=0)
    nscale = float(np.abs(tgt - center).max())
    src_n = ((src - center) / nscale).astype(np.float32)
    tgt_n = ((tgt - center) / nscale).astype(np.float32)
    pad = ((max(len(src), len(tgt)) + 4095) // 4096) * 4096
    sp, sm = _pad(src_n, pad)
    tp, tm = _pad(tgt_n, pad)
    sp_j, sm_j = jnp.asarray(sp), jnp.asarray(sm)
    tp_j, tm_j = jnp.asarray(tp), jnp.asarray(tm)

    octree = jax.jit(octree_simplify, static_argnames=("target_points",))

    @partial(jax.jit, static_argnames=("out_pad",))
    def _compact(pts, keep, out_pad):
        # Gather the octree survivors to the FRONT of a narrow padded
        # array: the FPS stage scans its full padded width every round
        # (~2000 sequential rounds), so running it on the 200k-wide scan
        # pad wastes 2.5x the work of the ~80k survivor set. Stable sort
        # keeps the voxel-key order of survivors.
        order = jnp.argsort(jnp.logical_not(keep), stable=True)
        return pts[order][:out_pad], keep[order][:out_pad]

    def run_once():
        times = {}
        t0 = time.perf_counter()
        # voxel_downsample returns the SORTED cloud with survivor marks —
        # the downsampled working cloud is (s_ds, skeep), not the original
        # array under the mask.
        s_ds, skeep = octree(sp_j, sm_j, target_points=pre_downsample)
        t_ds, tkeep = octree(tp_j, tm_j, target_points=pre_downsample)
        jax.block_until_ready((skeep, tkeep))
        times["octree_s"] = time.perf_counter() - t0

        n_s = int(np.asarray(jnp.sum(skeep)))
        n_t = int(np.asarray(jnp.sum(tkeep)))
        pnumber = cfg.resample_count(n_s, n_t)
        ds_pad = ((max(n_s, n_t) + 4095) // 4096) * 4096

        t0 = time.perf_counter()
        s_c, sk_c = _compact(s_ds, skeep, ds_pad)
        t_c, tk_c = _compact(t_ds, tkeep, ds_pad)
        (rs, rsm), (rt, rtm) = resample_pairs(
            s_c[None], sk_c[None], t_c[None], tk_c[None],
            jnp.asarray([pnumber], jnp.int32), cfg)
        res = register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg)
        fit = float(res.fitness)
        if cfg.auto_escalate and fit > cfg.escalate_threshold:
            # The standard robustness ladder applies at scan scale too.
            res2 = register_resampled(rs[0], rsm[0], rt[0], rtm[0],
                                      cfg.escalation_config())
            if float(res2.fitness) < fit:
                res, fit = res2, float(res2.fitness)
        times["register_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        aligned = apply_similarity(res.transform, sp_j)
        m = registration_measure_padded(aligned, sm_j, tp_j, tm_j, chunk=4096)
        rmse = float(m["rmse"]) * nscale   # back to scene units
        times["metric_s"] = time.perf_counter() - t0
        times["total_s"] = sum(times.values())
        return times, res, fit, rmse

    # Warm-up run compiles everything; then `repeats` timed passes.
    times, res, fit, rmse = run_once()
    compile_total = times["total_s"]
    best = times
    for _ in range(max(repeats - 1, 0)):
        t2, res, fit, rmse = run_once()
        if t2["total_s"] < best["total_s"]:
            best = t2

    aligned_np = np.asarray(
        apply_similarity(jax.tree.map(jnp.asarray, res.transform),
                         jnp.asarray(src_n))) * nscale + center
    pose = transform_rmse(aligned_np, src, gt)

    # Point pairs the full-res metric scores: every valid query against
    # every padded reference row.
    metric_pairs = float(len(src)) * pad
    return {
        "n_points": int(len(src)),
        "pre_downsample": int(pre_downsample),
        "pnumber": int(cfg.resample_count(pre_downsample, pre_downsample)),
        **best,
        "compile_first_total_s": compile_total,
        "fitness": fit,
        "rmse": rmse,
        "pose_rmse": pose,
        "metric_pairs_per_s": metric_pairs / best["metric_s"],
    }
