"""Generate the remesh benchmark corpus through the REAL TransferPC protocol.

Each of the 25 Remesh/Advancing OFF models is uniform-normalized
(PointCloud_Uniform semantics, LoadPointCloud.hpp:347-427) and run through
`transfer.make_pair` — target = WLOP(8000) resample, source =
grid-simplify(cell = radius/1.5) perturbed by a deterministic
transfer.txt-style similarity record — exactly how the reference built its
bundled `.gird`/`.wlop` benchmark pairs (transferPC.hpp:144-151). The
result is committed as one compressed npz (`fixtures/remesh_transfer.npz`)
so bench.py never pays WLOP at benchmark time; re-running this script
regenerates it deterministically.

Runs on CPU (WLOP at these sizes is ~1 GFLOP/model; not worth an
accelerator compile). Usage: python scripts/gen_remesh_fixtures.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

from kss_icp.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()

import numpy as np  # noqa: E402

FIXTURE = REPO / "fixtures" / "remesh_transfer.npz"
RECORDS = REPO / "fixtures" / "remesh_transfer.json"


def main() -> int:
    from kss_icp.io.formats import load_off, uniform_normalize
    from kss_icp.stress import REMESH, remesh_records
    from kss_icp.transfer import make_pair

    files = sorted(REMESH.glob("*.off"))
    if not files:
        print(f"no OFF models under {REMESH}", file=sys.stderr)
        return 1
    records = remesh_records([f.stem for f in files])
    arrays: dict[str, np.ndarray] = {}
    meta = []
    for f, rec in zip(files, records):
        t0 = time.perf_counter()
        pts, _ = uniform_normalize(load_off(f))
        pair = make_pair(pts.astype(np.float32), rec)
        arrays[f"{rec.name}_src"] = np.asarray(pair.source, np.float32)
        arrays[f"{rec.name}_tgt"] = np.asarray(pair.target, np.float32)
        meta.append({
            "name": rec.name, "axis": rec.axis, "angle": rec.angle,
            "scale": rec.scale, "translation": rec.translation,
            "radius": pair.radius,
            "n_source": int(len(pair.source)), "n_target": int(len(pair.target)),
        })
        print(f"{rec.name:24s} src={len(pair.source):5d} tgt={len(pair.target):5d} "
              f"radius={pair.radius:.4f} {time.perf_counter()-t0:.1f}s",
              file=sys.stderr, flush=True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    RECORDS.write_text(json.dumps(meta, indent=1))
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size/1e6:.1f} MB) + {RECORDS.name}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
