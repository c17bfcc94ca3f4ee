"""AIVS-style stratified uniform resampling — the accelerator re-design of the
reference's `AIVS_Simplification_Pro` (Method_AIVS_SimPro.hpp).

The reference makes FPS tractable on a CPU by localizing it: voxel boxes get
sample quotas proportional to population (round-up at fraction > 0.2,
:776-794), each box runs farthest-point sampling over its own + boundary
points on a local k-d tree under an 8-color OpenMP schedule (:222-376), and
a final "accurate cut" deletes one member of the closest surviving pair
until the count is exact (:848-957). Curvature/edge classes can raise a
box's quota (prate {3,7}, :711-773) — inert in the registration path, where
normals are never computed.

This design keeps the quota idea but runs *all boxes' FPS rounds in
lockstep*: one fori_loop over rounds where round s picks, for every box with
quota > s simultaneously, the box member farthest from the already-picked
set — a segment-argmax over the whole cloud per round. Loop depth is
max-quota-per-box (≈ N/boxes) instead of N, and every round is one wide
masked reduction. The exact-N trim uses the reference's own STATIC 3-NN
table (it never updates pNdis/pNIndex after a delete, :891-943), which makes
it a fixed-depth masked loop over (P,) vectors.

Everything here is jittable end to end (static boxes_per_axis/max_rounds/
max_cuts, traced num_samples) and selectable as the pipeline resampler via
KSSICPConfig.resampler = "aivs"; `aivs_resample_packed` emits pick-round-
ordered packed clouds whose prefixes are stratified uniform subsamples (the
property coarse_points/screen_points slicing relies on).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from kss_icp.ops.nn import knn, pairwise_sqdist

_BIG = 1e30


def box_quotas(
    counts: jnp.ndarray,
    num_samples,
    class_rates: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Per-box sample quotas ∝ population, fractional round-up at > 0.2
    (AIVS_BoxSimplification_Points :776-794). `class_rates` optionally
    scales each box's weight (the prate mechanism, :711-773)."""
    w = counts.astype(jnp.float32)
    if class_rates is not None:
        w = w * class_rates.astype(jnp.float32)
    total = jnp.maximum(jnp.sum(w), 1.0)
    ideal = w * (num_samples / total)
    floor = jnp.floor(ideal)
    quota = jnp.where(ideal - floor > 0.2, floor + 1.0, floor).astype(jnp.int32)
    return jnp.minimum(quota, counts)


@partial(jax.jit, static_argnames=("max_rounds",))
def stratified_fps(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    box_id: jnp.ndarray,
    quotas: jnp.ndarray,
    max_rounds: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All-boxes-in-lockstep farthest-point sampling.

    Returns (selected (P,) bool, pick_round (P,) int32) with exactly
    min(quota_b, |box_b|) picks per box; pick_round is the lockstep round a
    point was chosen in (P for unchosen) — sorting by it yields a stratified
    pick order whose prefixes are uniform subsamples. Round s: every box
    whose quota exceeds s picks its member with the largest distance to the
    box's already-picked set (first pick = nearest the box's centroid,
    mirroring the local-Voronoi seed)."""
    p = points.shape[0]
    b = quotas.shape[0]
    dtype = points.dtype
    seg = jnp.where(mask, box_id, b).astype(jnp.int32)  # padding -> dump row

    # Seed score: negative distance to own box centroid.
    w = mask.astype(dtype)
    sums = jax.ops.segment_sum(points * w[:, None], seg, num_segments=b + 1)
    cnts = jax.ops.segment_sum(w, seg, num_segments=b + 1)
    centroid = sums / jnp.maximum(cnts, 1.0)[:, None]
    d2cent = jnp.sum((points - centroid[seg]) ** 2, axis=-1)

    def round_step(s, state):
        selected, min_d2, pick_round = state
        # Score: distance to nearest selected point in the same box; first
        # round uses closeness to the centroid.
        score = jnp.where(s == 0, -d2cent, min_d2)
        score = jnp.where(mask & ~selected, score, -_BIG)
        best = jax.ops.segment_max(score, seg, num_segments=b + 1)[:b]
        active = (quotas > s) & (best > -_BIG / 2)
        idx = jnp.arange(p, dtype=jnp.int32)
        is_best = (
            mask
            & ~selected
            & (score >= best[jnp.clip(box_id, 0, b - 1)])
            & active[jnp.clip(box_id, 0, b - 1)]
            & (box_id >= 0)
        )
        # One winner per box: the lowest index among ties.
        first = jax.ops.segment_min(
            jnp.where(is_best, idx, p), seg, num_segments=b + 1
        )[:b]
        pick = is_best & (idx == first[jnp.clip(box_id, 0, b - 1)])
        selected = selected | pick
        pick_round = jnp.where(pick, s, pick_round)
        # Update each point's distance to its box's selected set.
        picked_pos = jnp.where(
            pick[:, None], points, jnp.full_like(points, _BIG)
        )
        box_pick = jax.ops.segment_min(picked_pos, seg, num_segments=b + 1)[:b]
        d2new = jnp.sum((points - box_pick[jnp.clip(box_id, 0, b - 1)]) ** 2, axis=-1)
        valid_new = (box_pick[jnp.clip(box_id, 0, b - 1), 0] < _BIG / 2) & mask
        min_d2 = jnp.where(valid_new, jnp.minimum(min_d2, d2new), min_d2)
        return selected, min_d2, pick_round

    selected0 = jnp.zeros((p,), bool)
    min_d2_0 = jnp.full((p,), _BIG, dtype)
    round0 = jnp.full((p,), p, jnp.int32)
    selected, _, pick_round = jax.lax.fori_loop(
        0, max_rounds, round_step, (selected0, min_d2_0, round0)
    )
    return selected, pick_round


@partial(jax.jit, static_argnames=("max_cuts",))
def accurate_cut(
    points: jnp.ndarray,
    selected: jnp.ndarray,
    target,
    max_cuts: int = 64,
) -> jnp.ndarray:
    """Trim a selection to exactly `target` by repeatedly deleting one member
    of the closest selected pair — keeping the member whose second-nearest
    selected neighbour is farther (AIVS_AccurateCut_Optimization :848-957:
    delete the point in the tighter spot).

    Faithful to the reference's STATIC neighbour table: pNdis/pNIndex are
    built once from a 3-NN query and never updated after a delete
    (:891-943); deleted points are only excluded through the alive flags
    (:922). That makes each cut O(P) instead of O(P^2), and the whole trim a
    fixed-depth fori_loop. The 3-NN query streams for large P (ops/nn.knn).
    """
    # Rows: all points; columns: 3 nearest *selected* points. For a selected
    # point, column 0 is itself (the reference's pNdis[0]), so columns 1-2
    # are its nearest and second-nearest surviving neighbours.
    d2, idx = knn(points, points, selected, 3)
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    d1, i1 = d[:, 1], idx[:, 1]
    dsec = d[:, 2]
    remaining0 = (jnp.sum(selected) - target).astype(jnp.int32)

    def cut(_, state):
        alive, remaining = state
        can = alive & alive[i1]
        cand = jnp.where(can, d1, _BIG)
        b1 = jnp.argmin(cand)
        b2 = i1[b1]
        do = (remaining > 0) & (cand[b1] < _BIG / 2)
        drop = jnp.where(dsec[b1] > dsec[b2], b2, b1)
        alive = alive.at[drop].set(jnp.where(do, False, alive[drop]))
        remaining = remaining - jnp.where(do, 1, 0)
        return alive, remaining

    alive, _ = jax.lax.fori_loop(0, max_cuts, cut, (selected, remaining0))
    return alive


def classify_curvature(
    normals: jnp.ndarray,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    k: int = 12,
    curved_threshold: float = 0.1,
    edge_threshold: float = 0.3,
) -> jnp.ndarray:
    """Per-point class 0 (flat) / 1 (curved) / 2 (edge) from the mean normal
    deviation over the k-neighborhood — AIVS_NormalValue +
    AIVS_Classification_{Curvature,Edge} (:180-219, :711-773). With no
    normals the registration path leaves every point class 0 (the
    reference's de-facto behaviour, SURVEY.md §2 AIVS row)."""
    _, idx = knn(points, points, mask, k)
    neigh = normals[idx]  # (P, k, 3)
    dev = 1.0 - jnp.abs(jnp.einsum("pki,pi->pk", neigh, normals))
    mean_dev = jnp.mean(dev, axis=1)
    cls = jnp.where(mean_dev > edge_threshold, 2,
                    jnp.where(mean_dev > curved_threshold, 1, 0))
    return jnp.where(mask, cls, 0).astype(jnp.int32)


def class_rate_per_box(
    cls: jnp.ndarray,
    box_id: jnp.ndarray,
    mask: jnp.ndarray,
    num_boxes: int,
    rates=(1.0, 3.0, 7.0),
) -> jnp.ndarray:
    """Mean prate multiplier per box (flat 1x, curved 3x, edge 7x — the
    reference's prate={3,7})."""
    seg = jnp.where(mask, box_id, num_boxes).astype(jnp.int32)
    r = jnp.asarray(rates, jnp.float32)[jnp.clip(cls, 0, 2)]
    w = mask.astype(jnp.float32)
    s = jax.ops.segment_sum(r * w, seg, num_segments=num_boxes + 1)[:num_boxes]
    c = jax.ops.segment_sum(w, seg, num_segments=num_boxes + 1)[:num_boxes]
    return jnp.where(c > 0, s / jnp.maximum(c, 1.0), 1.0)


@partial(jax.jit, static_argnames=("boxes_per_axis", "max_rounds", "max_cuts"))
def aivs_select(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    num_samples,                       # traced OK (per-pair pNumber)
    boxes_per_axis: int,
    max_rounds: int = 128,
    max_cuts: int = 256,
    class_rates: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jittable AIVS core: grid → quotas → lockstep per-box FPS → exact-N
    cut. Returns (selected (P,) bool, pick_round (P,) int32). No host syncs:
    all shapes/loop depths are static (boxes with quota > max_rounds
    undersample — raise max_rounds for extremely skewed clouds; quota
    round-ups beyond max_cuts leave the count slightly above target)."""
    from kss_icp.ops.spatial import build_voxel_grid

    grid = build_voxel_grid(points, mask, boxes_per_axis)
    quotas = box_quotas(grid.counts, num_samples, class_rates)
    selected, pick_round = stratified_fps(
        points, mask, grid.box_id, quotas, max_rounds=max_rounds
    )
    target = jnp.minimum(num_samples, jnp.sum(mask))
    alive = accurate_cut(points, selected, target, max_cuts=max_cuts)
    pick_round = jnp.where(alive, pick_round, points.shape[0])
    return alive, pick_round


@partial(jax.jit, static_argnames=("pad", "boxes_per_axis", "max_rounds", "max_cuts"))
def aivs_resample_packed(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    num_samples,                       # traced OK
    pad: int,
    boxes_per_axis: int,
    max_rounds: int = 128,
    max_cuts: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pipeline-facing AIVS: returns (points (pad, 3), mask (pad,)) packed in
    pick-round order — round-s picks of every box precede round-(s+1) picks,
    so any prefix is a stratified uniform subsample (the contract
    coarse_points/screen_points slicing needs, models/kss_icp.py)."""
    selected, pick_round = aivs_select(
        points, mask, num_samples, boxes_per_axis, max_rounds, max_cuts
    )
    # Stable sort by round (ties keep original index order): selected points
    # first, in round order. (No composite int key — it would overflow int32
    # at large P, and tests run x64 while production does not.)
    order = jnp.argsort(pick_round, stable=True)[: min(pad, points.shape[0])]
    out_mask = selected[order]
    out_pts = points[order] * out_mask[:, None].astype(points.dtype)
    short = pad - out_pts.shape[0]
    if short > 0:
        out_pts = jnp.pad(out_pts, ((0, short), (0, 0)))
        out_mask = jnp.pad(out_mask, (0, short))
    return out_pts, out_mask


def aivs_resample(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    num_samples: int,
    boxes_per_axis: Optional[int] = None,
    normals: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host-facing AIVS pipeline (standalone demo / tests): grid →
    (classified) quotas → lockstep per-box FPS → exact-N cut. Returns
    (points, selection_mask) in the input's padded shape with exactly
    min(num_samples, valid) selected. For the jit/vmap path inside the
    registration pipeline use aivs_select / aivs_resample_packed."""
    from kss_icp.ops.spatial import build_voxel_grid, estimate_box_scale

    n_valid = int(jnp.sum(mask))
    nb = boxes_per_axis or estimate_box_scale(n_valid)

    grid = build_voxel_grid(points, mask, nb)
    rates = None
    if normals is not None:
        cls = classify_curvature(normals, points, mask)
        rates = class_rate_per_box(cls, grid.box_id, mask, nb**3)

    # Host path: the exact max quota is known, so the lockstep loop depth
    # guarantees every quota is met (exact-N contract) — a heuristic bound
    # here undersamples skewed clouds whose densest box dominates.
    quotas = box_quotas(grid.counts, num_samples, rates)
    max_rounds = max(int(jnp.max(quotas)), 1)
    slack = int(jnp.sum(quotas)) - min(num_samples, n_valid)
    sel, _ = aivs_select(
        points, mask, num_samples, nb,
        max_rounds=max_rounds, max_cuts=_next_pow2(max(slack, 1)),
        class_rates=rates,
    )
    return points * sel[:, None].astype(points.dtype), sel


def _next_pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(x, 1))))
