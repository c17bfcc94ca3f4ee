"""Calibrate the measured-baseline denominator with native hot loops.

VERDICT round-2 item #5: the Python oracle's wall time over-states what a
native (MSVC/gcc) build of the reference would take, because its rotation
scan and multi-start ICP are Python-paced around C-speed k-d queries. This
script re-runs the oracle protocol over all 23 golden pairs with those two
loops compiled to C++ (kss_icp/native/oracle_hot.cpp — same algorithm,
same convergence semantics, f32 points like PCL) and records a CALIBRATED
reference rate:

  calibrated pair time = native coarse + native multistart + native final
                         (resample counted at ZERO — strictly conservative:
                          assumes a native AIVS build costs nothing)

The bracket [pairs_per_sec (Python-paced), pairs_per_sec_calibrated
(native hot loops, free resample)] bounds the true native-build rate from
both sides; bench.py's `vs_baseline` divides by the CONSERVATIVE end
(pairs_per_sec_calibrated). Results are merged into BASELINE_ORACLE.json.

Usage: python scripts/calibrate_oracle.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
from scipy.ndimage import minimum_filter  # noqa: E402

ORACLE_JSON = REPO / "BASELINE_ORACLE.json"


def main() -> int:
    from kss_icp.native import oracle_hot as oh
    from kss_icp.oracle import (
        OracleInitRegistration,
        aivs_simplify,
        pcr_qm,
    )
    from kss_icp.stress import golden_corpus

    if not oh.available():
        print("native oracle_hot unavailable (g++ build failed)", file=sys.stderr)
        return 1

    class NativeInit(OracleInitRegistration):
        """OracleInitRegistration with the rotation scan done natively;
        local-minima extraction via a clamped 5^3 minimum filter (edge
        replication == the oracle's truncated-window min)."""

        def _scan(self):
            self._ntree = oh.NativeKDTree(self.point_target)
            self.value = oh.rotation_scan(self.point_source, self._ntree, self.step)
            n = self.value.shape[0]
            inc = 6.3 / self.step
            ii, jj, kk = np.unravel_index(np.argmin(self.value), self.value.shape)
            self.angle = np.array([ii * inc, jj * inc, kk * inc])
            mins = minimum_filter(self.value, size=5, mode="nearest")
            self.angle_list = [
                np.array([i * inc, j * inc, k * inc])
                for i, j, k in np.argwhere(self.value <= mins)
            ]

    corpus = golden_corpus()
    if not corpus:
        print("no golden pairs found", file=sys.stderr)
        return 1

    rows = {}
    tot_hot = 0.0
    tot_resample = 0.0
    for name, src, tgt in corpus:
        src = np.asarray(src, np.float64)
        tgt = np.asarray(tgt, np.float64)
        p_number = min(min(len(src), len(tgt)) // 2, 2000)

        t0 = time.perf_counter()
        cloud_t = aivs_simplify(tgt, p_number)
        cloud_s = aivs_simplify(src, p_number)
        t_resample = time.perf_counter() - t0

        t0 = time.perf_counter()
        ir = NativeInit(cloud_s, cloud_t, 8.0)
        t_coarse = time.perf_counter() - t0

        t0 = time.perf_counter()
        tree = ir._ntree
        _, judge_fit, _, _ = oh.icp_native(ir.rotate(cloud_s), tree)
        chosen = -1
        if judge_fit > 0.0005:  # the multi-start gate (KSS_ICP.hpp:99)
            best_q = 9999.0
            for i, ang in enumerate(ir.angle_list):
                _, fi, _, _ = oh.icp_native(ir.rotate(cloud_s, ang), tree)
                if 0 <= fi < best_q:
                    best_q = fi
                    chosen = i
            aligned_sss = ir.rotate(cloud_s, ir.angle_list[chosen])
            point_align = ir.rotate(src, ir.angle_list[chosen])
        else:
            aligned_sss = ir.rotate(cloud_s)
            point_align = ir.rotate(src)
        t_multistart = time.perf_counter() - t0

        t0 = time.perf_counter()
        final, fitness, _, _ = oh.icp_native(aligned_sss, tree)
        point_align = point_align @ final[:3, :3].T + final[:3, 3]
        t_final = time.perf_counter() - t0

        m = pcr_qm(point_align, tgt)
        hot = t_coarse + t_multistart + t_final
        tot_hot += hot
        tot_resample += t_resample
        rows[name] = {
            "native_hot_seconds": round(hot, 4),
            "resample_seconds_python": round(t_resample, 4),
            "coarse": round(t_coarse, 4),
            "multistart": round(t_multistart, 4),
            "final_icp": round(t_final, 4),
            "rmse": m["rmse"],
            "num_candidates": len(ir.angle_list),
        }
        print(f"{name:12s} hot={hot:.2f}s (coarse {t_coarse:.2f} "
              f"multistart {t_multistart:.2f} final {t_final:.2f}) "
              f"py-resample={t_resample:.2f}s rmse={m['rmse']:.4f}",
              file=sys.stderr, flush=True)

    n = len(corpus)
    calibrated_rate = n / tot_hot  # resample at zero: strictly conservative
    d = json.loads(ORACLE_JSON.read_text()) if ORACLE_JSON.exists() else {}
    med_rmse = float(np.median([r["rmse"] for r in rows.values()]))
    d["pairs_per_sec_calibrated"] = round(calibrated_rate, 5)
    d["calibration"] = {
        "method": ("rotation scan + multi-start/final ICP compiled to C++ "
                   "(native/oracle_hot.cpp, f32 points, serial — the "
                   "reference hot path is single-threaded); AIVS resample "
                   "counted at ZERO seconds (strictly conservative bound on "
                   "a native build)"),
        "native_hot_seconds_total": round(tot_hot, 3),
        "python_resample_seconds_total": round(tot_resample, 3),
        "median_rmse": round(med_rmse, 6),
        "pairs": rows,
    }
    ORACLE_JSON.write_text(json.dumps(d, indent=1))
    print(json.dumps({
        "pairs_per_sec_python": d.get("pairs_per_sec"),
        "pairs_per_sec_calibrated": d["pairs_per_sec_calibrated"],
        "median_rmse_calibrated": med_rmse,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
