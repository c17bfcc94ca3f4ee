"""Smoke run of the registration engine on one NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
default configuration's full width (2000-point working clouds, 8^3 field,
two-phase multi-start ICP, escalation and overlap rungs on), on data that
is committed or made from a seed:

  1. device   the GPU, its power limit, the compile cache in use;
  2. kernels  each Pallas kernel (ops/resample_triton.py, ops/nn_triton.py)
              compiled at real widths, compared with its plain reference and
              timed against what XLA makes of the plain path;
  3. main     register_many on the 25 remesh transfer pairs, the CLI
              `register`/`measure` on one pair, and a CPU-backend reference
              run of two pairs in the same process;
  4. challenge every scenario of challenge_corpus(include_hard=True);
  5. scan     run_largescan on a 200k-point room scan.

    python chip_smoke.py               # one GPU, every phase
    python chip_smoke.py --four-gpus   # only the 4-GPU pairs mesh phase

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase ran and held its bars. Any failure prints its
traceback and the script exits nonzero; so does a machine without a GPU.
Files it writes go under runs/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "runs" / "chip_smoke"
SEED = 0

# Phase 3 bar: the per-pair RMSE bar of the benchmark (bench.FAIL_RMSE).
FAIL_RMSE = 0.05
# GPU vs CPU reference, in challenge.transform_rmse units (RMS distance
# between the two aligned source clouds, unit-scale). Both sides solve in
# f32 with different summation orders and tie-breaks, so ICP stops at
# fixed points a few 1e-4 apart; 5e-3 is a tenth of FAIL_RMSE, far below
# any change of basin.
GPU_CPU_POSE_BOUND = 5e-3
# Phase 4: the recorded challenge board (pairs under the pose bar per
# scenario), printed beside each result.
CHALLENGE_RECORD = {"category": 32, "partial": 8, "deform": 8, "scale": 8,
                    "partial_hard": 8}
# Kernel tolerances on unit-scale clouds: squared distances in f32 differ
# from float64 by a few ulps of values <= 12.
D2_ATOL = 1e-6
FIELD_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def timed(fn, n=5):
    """Median seconds of n calls after one warm-up, each ending in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def compile_fn(name, fn, *args):
    """AOT-compile fn at args; print compile seconds and memory analysis."""
    import jax

    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    log(f"  [{name}] compile {time.perf_counter() - t0:.2f}s (set-up); "
        f"memory {c.memory_analysis()}")
    return c


class Report:
    def __init__(self):
        self.failures = []

    def check(self, what, ok, detail=""):
        log(f"  {'PASS' if ok else 'FAIL'} {what} {detail}".rstrip())
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn, *args):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn(self, *args)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            self.failures.append(f"{name}: exception")
        log(f"== {name} done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------- phase 1
def device_phase(rep):
    import jax

    from kss_icp.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    log(f"  jax {jax.__version__}; device_kind {dev.device_kind}; "
        f"count {len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"  nvidia-smi: {smi.stdout.strip()}")
    log(f"  compile cache: {enable_compile_cache()}")


# ---------------------------------------------------------------- phase 2
def _unit_clouds(rng, shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _near_tie_ok(q, r, rm, d2, idx):
    """d2 within D2_ATOL of float64 brute force; idx equal to its argmin
    except where the two best float64 distances differ by < D2_ATOL."""
    d = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64))
         ** 2).sum(-1)
    d[:, ~rm] = np.inf
    best = d.min(1)
    err = float(np.abs(d2 - best).max())
    picked = d[np.arange(len(q)), idx]
    idx_ok = bool(np.all((idx == d.argmin(1)) | (picked - best < D2_ATOL)))
    return err, idx_ok


def fps_kernel_phase(rep):
    import jax
    import jax.numpy as jnp

    from kss_icp.ops.resample import farthest_point_sampling
    from kss_icp.ops.resample_triton import fps_batch

    rng = np.random.default_rng(SEED)
    b, p, s = 50, 8192, 2048   # 2x25 pairs at full_pad -> resample_pad
    pts = jnp.asarray(_unit_clouds(rng, (b, p, 3)))
    nvalid = rng.integers(3000, p + 1, b)
    mask = jnp.asarray(np.arange(p)[None, :] < nvalid[:, None])
    kern = compile_fn("fps kernel", lambda a, m: fps_batch(a, m, s), pts, mask)
    plain = compile_fn(
        "fps plain",
        lambda a, m: jax.vmap(
            lambda x, y: farthest_point_sampling(x, y, s))(a, m), pts, mask)
    ik, sk = map(np.asarray, kern(pts, mask))
    ip, sp = map(np.asarray, plain(pts, mask))
    same = (ik == ip).all(axis=1)
    log(f"  fps rows identical {int(same.sum())}/{b}; "
        f"index agreement {float((ik == ip).mean()):.6f}")
    worst = 0.0
    for row in np.nonzero(~same)[0]:
        # A broken near-tie: the chosen farthest-distance sequences must
        # still agree.
        n = int(sk[row].sum())
        seqs = []
        for ids in (ik[row, :n], ip[row, :n]):
            x = np.asarray(pts[row], np.float64)[ids]
            d = ((x[:, None] - x[None]) ** 2).sum(-1)
            d[np.triu_indices(n)] = np.inf
            seqs.append(d.min(1)[1:])
        worst = max(worst, float(np.max(
            np.abs(seqs[0] - seqs[1]) / np.maximum(seqs[1], 1e-30))))
    rep.check("fps kernel vs plain", bool(same.all()) or worst <= 1e-6,
              f"(max rel farthest-distance diff {worst:.3g})")
    rep.check("fps sample masks", bool((sk == sp).all()))
    tk = timed(lambda: kern(pts, mask))
    tp = timed(lambda: plain(pts, mask))
    log(f"  fps B={b} P={p} S={s}: kernel {tk:.6f}s  plain {tp:.6f}s  "
        f"(x{tp / tk:.2f})")


def nn_kernel_phase(rep):
    import jax
    import jax.numpy as jnp

    from kss_icp.ops.nn import nearest_neighbor_plain
    from kss_icp.ops.nn_triton import nearest_neighbor_kernel

    rng = np.random.default_rng(SEED + 1)

    def lanes(name, pairs, lanes_per_pair, q_n, r_n):
        q = jnp.asarray(_unit_clouds(rng, (pairs, lanes_per_pair, q_n, 3)))
        r = jnp.asarray(_unit_clouds(rng, (pairs, r_n, 3)))
        rm = jnp.asarray(np.arange(r_n)[None, :] < 2000).repeat(pairs, 0)

        def vm(f):
            return jax.vmap(jax.vmap(f, in_axes=(0, None, None)))

        kern = compile_fn(f"nn kernel {name}", vm(nearest_neighbor_kernel),
                          q, r, rm)
        plain = compile_fn(f"nn plain {name}", vm(nearest_neighbor_plain),
                           q, r, rm)
        d2k, ik = map(np.asarray, kern(q, r, rm))
        d2p, _ = map(np.asarray, plain(q, r, rm))
        log(f"  {name}: max |d2 kernel - d2 plain HIGHEST| "
            f"{float(np.abs(d2k - d2p).max()):.3g}")
        for pi, li in ((0, 0), (pairs - 1, lanes_per_pair - 1)):
            err, idx_ok = _near_tie_ok(
                np.asarray(q[pi, li]), np.asarray(r[pi]), np.asarray(rm[pi]),
                d2k[pi, li], ik[pi, li])
            rep.check(f"nn {name} lane ({pi},{li}) vs float64",
                      err <= D2_ATOL and idx_ok, f"(max d2 err {err:.3g})")
        tk = timed(lambda: kern(q, r, rm))
        tp = timed(lambda: plain(q, r, rm))
        log(f"  nn {name} {pairs}x{lanes_per_pair}x{q_n}x{r_n}: kernel "
            f"{tk:.6f}s  plain HIGHEST {tp:.6f}s  (x{tp / tk:.2f})")

    lanes("icp-screen", 25, 32, 512, 2048)
    lanes("icp-refine", 25, 4, 2000, 2048)

    # Scan scale: the full-res metric of run_largescan (200k valid rows of
    # a 204800 pad against the padded target).
    n, pad = 200_000, 204_800
    q = _unit_clouds(rng, (pad, 3))
    r = _unit_clouds(rng, (pad, 3))
    rm = np.arange(pad) < n
    qj, rj, rmj = map(jnp.asarray, (q, r, rm))
    kern = compile_fn("nn kernel scan", nearest_neighbor_kernel, qj, rj, rmj)
    plain = compile_fn(
        "nn plain scan",
        lambda a, b, c: nearest_neighbor_plain(a, b, c, chunk=4096),
        qj, rj, rmj)
    d2k, ik = map(np.asarray, kern(qj, rj, rmj))
    errs, oks = [], []
    for lo in range(0, 1000, 100):
        err, ok = _near_tie_ok(q[lo:lo + 100], r, rm, d2k[lo:lo + 100],
                               ik[lo:lo + 100])
        errs.append(err)
        oks.append(ok)
    rep.check("nn scan 1000 queries vs float64",
              max(errs) <= D2_ATOL and all(oks),
              f"(max d2 err {max(errs):.3g})")
    tk = timed(lambda: kern(qj, rj, rmj), 3)
    tp = timed(lambda: plain(qj, rj, rmj), 3)
    log(f"  nn scan {pad}x{pad}: kernel {tk:.6f}s  plain chunk=4096 "
        f"{tp:.6f}s  (x{tp / tk:.2f})")


def _plain_field(src, smask, tgt, tmask, steps=8, chunk=64):
    """The "ave" rotation field of models/coarse.score_rotation_field on the
    plain 1-NN path (ops/nn.nearest_neighbor_plain, HIGHEST precision), on
    every platform: the reference the field's kernel is checked against."""
    import jax
    import jax.numpy as jnp

    from kss_icp.core.transforms import euler_xyz_matrix
    from kss_icp.models.coarse import rotation_grid
    from kss_icp.ops.nn import nearest_neighbor_plain

    rots = euler_xyz_matrix(rotation_grid(steps, 6.3, src.dtype))
    w = smask.astype(src.dtype)

    def score(r_chunk):
        rotated = jnp.einsum("cij,pj->cpi", r_chunk, src,
                             precision=jax.lax.Precision.HIGHEST)
        d2, _ = nearest_neighbor_plain(rotated, tgt[None], tmask[None])
        return (jnp.sqrt(d2) * w).sum(-1) / jnp.maximum(w.sum(), 1.0)

    scores = jax.lax.map(score, rots.reshape(-1, chunk, 3, 3))
    return scores.reshape(steps, steps, steps)


def field_phase(rep):
    import jax
    import jax.numpy as jnp

    from kss_icp.core.transforms import euler_xyz_matrix
    from kss_icp.models.coarse import rotation_grid, score_rotation_field

    rng = np.random.default_rng(SEED + 2)
    for b, p_n, t_n in ((25, 2000, 2048), (25, 512, 512)):
        src = jnp.asarray(_unit_clouds(rng, (b, p_n, 3)))
        tgt = jnp.asarray(_unit_clouds(rng, (b, t_n, 3)))
        sm = jnp.ones((b, p_n), bool)
        tm = jnp.asarray(np.arange(t_n)[None] < t_n - 48).repeat(b, 0)
        args = (src, sm, tgt, tm)

        tag = f"{b}x512x{p_n}x{t_n}"
        kern = compile_fn(f"field kernel {tag}", jax.vmap(
            lambda a, m, c, d: score_rotation_field(a, m, c, d, steps=8)),
            *args)
        plain = compile_fn(f"field plain {tag}", jax.vmap(_plain_field),
                           *args)
        fk = np.asarray(kern(*args))
        fh = np.asarray(plain(*args))
        tk = timed(lambda: kern(*args))
        tp = timed(lambda: plain(*args))
        rel = float(np.max(np.abs(fk - fh) / fh))
        rep.check(f"field kernel vs plain HIGHEST {tag}", rel <= FIELD_RTOL,
                  f"(max rel {rel:.3g})")
        log(f"  field {tag}: kernel {tk:.6f}s  plain HIGHEST {tp:.6f}s  "
            f"(x{tp / tk:.2f})")
    # Plain field against float64 brute force on a few rotations of the
    # last pair (the removed fused field kernel's reference contract).
    rots = np.asarray(euler_xyz_matrix(rotation_grid(8, 6.3)), np.float64)
    s64 = np.asarray(src[-1], np.float64)
    t64 = np.asarray(tgt[-1], np.float64)[np.asarray(tm[-1])]
    worst = 0.0
    for ci in range(0, 512, 64):
        x = s64 @ rots[ci].T
        d = np.sqrt(((x[:, None] - t64[None]) ** 2).sum(-1).min(1)).mean()
        worst = max(worst, abs(float(fh[-1].ravel()[ci]) - d) / d)
    rep.check("field plain HIGHEST vs float64 (8 rotations)",
              worst <= FIELD_RTOL, f"(max rel {worst:.3g})")


# ---------------------------------------------------------------- phase 3
def _remesh():
    from kss_icp.stress import remesh_corpus
    from kss_icp.transfer import TransferRecord

    return [(name, src, tgt, TransferRecord(name=name, **rec))
            for name, src, tgt, rec in remesh_corpus()]


def _aligned(res, i, src):
    from kss_icp.core.transforms import Similarity, apply_similarity

    tr = res.transform
    sim = Similarity(scale=np.asarray(tr.scale)[i],
                     rotation=np.asarray(tr.rotation)[i],
                     translation=np.asarray(tr.translation)[i])
    return np.asarray(apply_similarity(sim, src.astype(np.float32)),
                      np.float64)


def _rms(a, b):
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def main_phase(rep, state):
    import jax

    from kss_icp.config import DEFAULT_CONFIG
    from kss_icp.parallel.batch import register_many
    from kss_icp.transfer import invert_record

    corpus = _remesh()
    pairs = [(s, t) for _, s, t, _ in corpus]
    cfg = DEFAULT_CONFIG
    t0 = time.perf_counter()
    base, _ = register_many(pairs, cfg, escalate=False)
    flagged = ((np.asarray(base.fitness) > cfg.escalate_threshold)
               | np.asarray(base.refine_hit_cap))
    log(f"  base pass (no escalation), first call: "
        f"{time.perf_counter() - t0:.1f}s incl. compile")
    t0 = time.perf_counter()
    res, m = register_many(pairs, cfg)
    log(f"  register_many 25 pairs, first call: "
        f"{time.perf_counter() - t0:.1f}s incl. compile")
    t0 = time.perf_counter()
    res, m = register_many(pairs, cfg)
    log(f"  register_many 25 pairs, steady: {time.perf_counter() - t0:.3f}s")
    ok = 0
    for i, (name, src, _, rec) in enumerate(corpus):
        al = _aligned(res, i, src)
        pose = _rms(al, invert_record(src, rec))
        good = m["rmse"][i] < FAIL_RMSE
        ok += good
        log(f"  {name:22s} rmse {m['rmse'][i]:.6f} fitness "
            f"{float(np.asarray(res.fitness)[i]):.6e} escalated "
            f"{bool(flagged[i])} pose {pose:.6f}{'' if good else '  FAIL'}")
    rep.check(f"remesh rmse < {FAIL_RMSE}", ok == len(corpus),
              f"({ok}/{len(corpus)})")
    state["remesh"] = (corpus, res)
    jax.block_until_ready(res)


def cli_phase(rep):
    from kss_icp import cli
    from kss_icp.io.formats import save_xyz

    name, src, tgt, _ = _remesh()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    s_path, t_path, o_path = (OUT / f"{name.replace('/', '_')}_{k}.xyz"
                              for k in ("src", "tgt", "aligned"))
    save_xyz(s_path, src)
    save_xyz(t_path, tgt)

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        text = buf.getvalue()
        log("  | " + text.strip().replace("\n", "\n  | "))
        if rc:
            raise RuntimeError(f"cli {argv[0]} exited {rc}")
        return float(next(line.split()[1] for line in text.splitlines()
                          if line.startswith("RMSE:")))

    t0 = time.perf_counter()
    r_reg = run(["register", str(s_path), str(t_path), "-o", str(o_path)])
    log(f"  cli register: {time.perf_counter() - t0:.1f}s incl. compile")
    r_meas = run(["measure", str(o_path), str(t_path)])
    rep.check("cli register RMSE == cli measure RMSE",
              abs(r_reg - r_meas) <= 1e-6, f"({r_reg} vs {r_meas})")


def cpu_reference_phase(rep, state):
    import jax

    from kss_icp.config import DEFAULT_CONFIG
    from kss_icp.parallel.batch import register_many

    corpus, res_gpu = state["remesh"]
    sub = corpus[:2]
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu, m_cpu = register_many([(s, t) for _, s, t, _ in sub],
                                       DEFAULT_CONFIG)
        jax.block_until_ready(res_cpu)
    log(f"  CPU reference, 2 pairs: {time.perf_counter() - t0:.1f}s "
        f"incl. compile")
    for i, (name, src, _, _) in enumerate(sub):
        diff = _rms(_aligned(res_gpu, i, src), _aligned(res_cpu, i, src))
        rep.check(f"GPU vs CPU pose {name}", diff <= GPU_CPU_POSE_BOUND,
                  f"({diff:.3g} <= {GPU_CPU_POSE_BOUND}; cpu rmse "
                  f"{m_cpu['rmse'][i]:.6f})")


# ---------------------------------------------------------------- phase 4
def challenge_phase(rep):
    """Every scenario through register_many. A pair that misses its pose
    bar is registered again on the CPU backend, the plain reference: the
    miss holds only if the reference lands on the same pose, so that the
    GPU kernels did not change the answer."""
    import jax

    from kss_icp.challenge import challenge_corpus, transform_rmse
    from kss_icp.parallel.batch import register_many

    for scenario, cpairs, thr in challenge_corpus(include_hard=True):
        t0 = time.perf_counter()
        res, _ = register_many([(s, t) for _, s, t, _ in cpairs])
        dt = time.perf_counter() - t0
        misses = []
        for i, (name, src, _, gt) in enumerate(cpairs):
            err = transform_rmse(_aligned(res, i, src), src, gt)
            if err > thr:
                misses.append((i, err))
        n = len(cpairs)
        log(f"  challenge {scenario}: {n - len(misses)}/{n} pose <= {thr} "
            f"(record {CHALLENGE_RECORD[scenario]}/{n}; {dt:.1f}s incl. "
            f"compile)")
        for i, err in misses:
            name, src, tgt, gt = cpairs[i]
            t0 = time.perf_counter()
            with jax.default_device(jax.devices("cpu")[0]):
                res_c, _ = register_many([(src, tgt)])
                jax.block_until_ready(res_c)
            al_c = _aligned(res_c, 0, src)
            diff = _rms(_aligned(res, i, src), al_c)
            rep.check(
                f"challenge {scenario} {name} missed the bar (pose {err:.4f}"
                f" > {thr}, fitness {float(np.asarray(res.fitness)[i]):.4e});"
                f" CPU plain reference lands on the same pose",
                diff <= GPU_CPU_POSE_BOUND,
                f"(CPU pose {transform_rmse(al_c, src, gt):.4f}, fitness "
                f"{float(np.asarray(res_c.fitness)[0]):.4e}; GPU vs CPU "
                f"{diff:.3g} <= {GPU_CPU_POSE_BOUND}; "
                f"{time.perf_counter() - t0:.1f}s)")


# ---------------------------------------------------------------- phase 5
def scan_phase(rep):
    import jax

    from kss_icp.largescan import run_largescan

    ls = run_largescan(n_points=200_000, pre_downsample=80_000, repeats=2)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  octree {ls['octree_s']}s  register {ls['register_s']}s  "
        f"metric {ls['metric_s']}s  total {ls['total_s']}s")
    log(f"  compile (first pass, set-up) {ls['compile_first_total_s']}s")
    log(f"  rmse {ls['rmse']}  pose_rmse {ls['pose_rmse']}  metric "
        f"{ls['metric_pairs_per_s']:.4g} pairs/s  peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use')}")
    rep.check("scan finite rmse", bool(np.isfinite(ls["rmse"])))


# ----------------------------------------------------------- options
def four_gpu_phase(rep):
    import jax
    import jax.numpy as jnp

    from kss_icp.metrics import registration_measure_padded
    from kss_icp.parallel.batch import register_many
    from kss_icp.parallel.mesh import make_mesh
    from kss_icp.parallel.point_shard import mean_nn_distance_sharded

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four-gpus needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    corpus = _remesh()
    corpus = corpus + corpus[:28 - len(corpus)]
    pairs = [(s, t) for _, s, t, _ in corpus]
    mesh = make_mesh(("pairs",))
    t0 = time.perf_counter()
    res_m, m_m = register_many(pairs, mesh=mesh)
    log(f"  4-GPU pairs mesh, 28 pairs: {time.perf_counter() - t0:.1f}s "
        f"incl. compile")
    t0 = time.perf_counter()
    res_m, m_m = register_many(pairs, mesh=mesh)
    log(f"  4-GPU steady: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    res_1, m_1 = register_many(pairs)
    log(f"  1-GPU, 28 pairs: {time.perf_counter() - t0:.1f}s incl. compile")
    t0 = time.perf_counter()
    res_1, m_1 = register_many(pairs)
    log(f"  1-GPU steady: {time.perf_counter() - t0:.3f}s")
    worst = max(_rms(_aligned(res_m, i, s), _aligned(res_1, i, s))
                for i, (_, s, _, _) in enumerate(corpus))
    rep.check("4-GPU vs 1-GPU transforms", worst <= GPU_CPU_POSE_BOUND,
              f"(max {worst:.3g} <= {GPU_CPU_POSE_BOUND})")
    ok = int((m_m["rmse"] < FAIL_RMSE).sum())
    rep.check(f"4-GPU remesh rmse < {FAIL_RMSE}", ok == len(pairs),
              f"({ok}/{len(pairs)})")

    rng = np.random.default_rng(SEED + 3)
    pad = 204_800
    q = jnp.asarray(_unit_clouds(rng, (pad, 3)))
    r = jnp.asarray(_unit_clouds(rng, (pad, 3)))
    qm = jnp.asarray(np.arange(pad) < 200_000)
    rm = jnp.ones((pad,), bool)
    pmesh = make_mesh(("points",))
    sharded = float(mean_nn_distance_sharded(q, qm, r, rm, mesh=pmesh))
    one = registration_measure_padded(q, qm, r, rm, chunk=4096)
    one_mae = float(one["mae"])
    rel = abs(sharded - one_mae) / one_mae
    rep.check("point-sharded metric vs 1-GPU metric (200k)", rel <= 1e-5,
              f"({sharded:.8f} vs {one_mae:.8f}, rel {rel:.3g})")
    ts = timed(lambda: mean_nn_distance_sharded(q, qm, r, rm, mesh=pmesh), 3)
    t1 = timed(lambda: registration_measure_padded(q, qm, r, rm,
                                                   chunk=4096)["mae"], 3)
    log(f"  200k metric (1-NN kernel per shard): 4-GPU sharded {ts:.6f}s  "
        f"1-GPU {t1:.6f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU pairs mesh and sharded metric")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 1

    rep = Report()
    state = {}
    rep.phase("device", device_phase)
    if args.four_gpus:
        rep.phase("four gpus", four_gpu_phase)
    else:
        rep.phase("kernel fps", fps_kernel_phase)
        rep.phase("kernel nn", nn_kernel_phase)
        rep.phase("kernel field", field_phase)
        rep.phase("main remesh", main_phase, state)
        rep.phase("main cli", cli_phase)
        if "remesh" in state:
            rep.phase("main cpu reference", cpu_reference_phase, state)
        else:
            rep.failures.append("main cpu reference: no GPU result")
        rep.phase("challenge", challenge_phase)
        rep.phase("scan", scan_phase)
    if rep.failures:
        log(f"FAILED: {rep.failures}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
