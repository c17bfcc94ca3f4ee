"""Render a qualitative registration gallery — the still-image equivalent of
the reference's Examples/{modelNet40,shrec,RGB3D}.pdf sheets.

For every model in a data directory (reference `.gird`/`.wlop` layout):
register source onto target, then write a three-panel PNG row — raw overlay
(rotated source, red), aligned overlay (green on blue target), and a
trackball-spun view — into the output directory.

Usage:
  python scripts/make_gallery.py [data_dir] [out_dir] [--platform cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("data_dir", nargs="?",
                    default="/root/reference/PS_AIS_Simplification/data/registration")
    ap.add_argument("out_dir", nargs="?", default="gallery")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--challenge", action="store_true",
                    help="render the procedural challenge corpus "
                         "(kss_icp/challenge.py) instead of a "
                         ".gird/.wlop directory")
    ap.add_argument("--hard", action="store_true",
                    help="with --challenge: include the ~60%%-overlap "
                         "hard tier")
    ap.add_argument("--largescan", action="store_true",
                    help="render the Room-class 100k scan pair "
                         "(kss_icp/largescan.py)")
    args = ap.parse_args()

    import jax

    from kss_icp.utils.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()

    import numpy as np

    import jax.numpy as jnp
    from kss_icp.config import KSSICPConfig
    from kss_icp.core.transforms import apply_similarity
    from kss_icp.io.formats import load_points
    from kss_icp.metrics import registration_measure
    from kss_icp.models.kss_icp import register_pair
    from kss_icp.viz import Trackball, render_clouds, write_png

    data = Path(args.data_dir)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.largescan:
        from kss_icp.largescan import room_pair

        src_r, tgt_r, _gt = room_pair(100_000, seed=0)
        c = tgt_r.mean(axis=0)
        sc = float(np.abs(tgt_r - c).max())
        pairs = {"largescan_room": (((src_r - c) / sc).astype(np.float32),
                                    ((tgt_r - c) / sc).astype(np.float32))}
        models = sorted(pairs)
        args.challenge = True  # reuse the in-memory pair path below
    elif args.challenge:
        from kss_icp.challenge import challenge_corpus

        pairs = {f"{scen}_{nm.replace('/', '_')}": (s, t)
                 for scen, ps, _thr in challenge_corpus(
                     include_hard=args.hard)
                 for nm, s, t, _gt in ps}
        models = args.models or sorted(pairs)
    else:
        models = args.models or sorted(
            {p.stem for p in data.glob("*.gird")} & {p.stem for p in data.glob("*.wlop")}
        )
    cfg = KSSICPConfig(max_candidates=16)

    for name in models:
        if args.challenge:
            src, tgt = pairs[name]
        else:
            src = load_points(data / f"{name}.gird")
            tgt = load_points(data / f"{name}.wlop")
        t0 = time.perf_counter()
        res = register_pair(src, tgt, cfg)
        aligned = np.asarray(apply_similarity(res.transform, jnp.asarray(src, jnp.float32)))
        m = registration_measure(aligned, tgt.astype(np.float32))
        dt = time.perf_counter() - t0

        tb = Trackball()
        tb.drag(0.0, 0.0, 0.5, 0.25)
        if len(src) > 30000:   # bound the z-buffer renderer's work
            src = src[:: len(src) // 30000 + 1]
            aligned = aligned[:: len(aligned) // 30000 + 1]
        if len(tgt) > 30000:
            tgt = tgt[:: len(tgt) // 30000 + 1]
        panels = [
            render_clouds([tgt, src], size=(400, 400)),
            render_clouds([tgt, np.zeros((0, 3)), aligned], size=(400, 400)),
            render_clouds([tgt, np.zeros((0, 3)), aligned],
                          rotation=tb.rotation, size=(400, 400)),
        ]
        row = np.concatenate(panels, axis=1)
        write_png(out / f"{name}.png", row)
        print(f"{name:12s} rmse={m['rmse']:.5f} time={dt:.1f}s -> {out}/{name}.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
