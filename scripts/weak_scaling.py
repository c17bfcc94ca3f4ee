"""Weak-scaling measurement for batched pair registration.

Shards a pair batch proportional to device count over a "pairs" mesh and
reports throughput + efficiency vs the 1-device run (BASELINE.md target:
>=80% at >=2 hosts). On a real multi-chip slice run as-is; elsewhere it
fakes an N-device CPU mesh (xla_force_host_platform_device_count), which
measures partitioning overhead rather than real interconnect behavior — cross-pair
communication is zero by construction, so the CPU-mesh number is the
pessimistic bound.

Usage: python scripts/weak_scaling.py [--devices 8] [--pairs-per-device 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--pairs-per-device", type=int, default=2)
    ap.add_argument("--real-devices", action="store_true",
                    help="use the machine's own devices instead of a CPU mesh")
    args = ap.parse_args()

    # CPU-mesh mode is the default; pass --real-devices on a multi-GPU host.
    # Flags must land before backend init.
    if not args.real_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    from kss_icp.utils.compile_cache import enable_compile_cache

    if not args.real_devices:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kss_icp.config import KSSICPConfig
    from kss_icp.parallel.batch import register_batch
    from kss_icp.parallel.mesh import make_mesh

    n_dev = min(args.devices, jax.device_count())
    cfg = KSSICPConfig(
        rotation_steps=4, max_candidates=4, max_resample_points=256,
        resample_pad=256, max_icp_iterations=30,
    )

    rng = np.random.default_rng(0)

    def batch_for(n_pairs, seed):
        r = np.random.default_rng(seed)
        u = r.uniform(-1, 1, (n_pairs, cfg.resample_pad))
        v = r.uniform(-1, 1, (n_pairs, cfg.resample_pad))
        pts = np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1)
        return pts.astype(np.float32), np.ones((n_pairs, cfg.resample_pad), bool)

    results = {}
    for nd in sorted({1, 2, n_dev}):
        if nd > jax.device_count():
            continue
        import numpy as _np

        if nd > 1:
            from jax.sharding import Mesh

            mesh = Mesh(_np.asarray(jax.devices()[:nd]), axis_names=("pairs",))
        else:
            mesh = None
        b = args.pairs_per_device * nd
        src, smask = batch_for(b, 1)
        tgt, tmask = batch_for(b, 2)
        arrs = [jnp.asarray(x) for x in (src, smask, tgt, tmask)]
        if mesh is not None:
            shard = NamedSharding(mesh, P("pairs"))
            arrs = [jax.device_put(a, shard) for a in arrs]
        res = register_batch(*arrs, cfg, mesh=mesh)  # compile
        jax.block_until_ready(res.fitness)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = register_batch(*arrs, cfg, mesh=mesh)
            jax.block_until_ready(res.fitness)
            ts.append(time.perf_counter() - t0)
        thr = b / min(ts)
        results[nd] = thr
        print(f"devices={nd:2d} batch={b:3d} {min(ts)*1e3:8.1f} ms "
              f"-> {thr:8.2f} pairs/s", file=sys.stderr)
        del _np

    # --- escalating batch (round 5, VERDICT r4 item 5): the full ladder —
    # base pass + escalate_rerun + overlap rungs — host-chunked and
    # dispatched through the SAME mesh. Thresholds forced so every tier
    # launches; measures the sharded ladder's partitioning overhead.
    import dataclasses

    from kss_icp.parallel.batch import register_many

    force = dataclasses.replace(
        cfg, escalate_threshold=0.0, overlap_threshold=0.0,
        overlap_gate_ratio=100.0, escalate_rotation_steps=8)
    esc_results = {}
    for nd in sorted({1, n_dev}):
        if nd > jax.device_count():
            continue
        if nd > 1:
            from jax.sharding import Mesh

            mesh = Mesh(np.asarray(jax.devices()[:nd]), axis_names=("pairs",))
        else:
            mesh = None
        b = args.pairs_per_device * nd
        src, _sm = batch_for(b, 1)
        tgt, _tm = batch_for(b, 2)
        pair_list = [(src[i], tgt[i]) for i in range(b)]
        register_many(pair_list, force, mesh=mesh,
                      full_pad=cfg.resample_pad)  # compile
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            register_many(pair_list, force, mesh=mesh,
                          full_pad=cfg.resample_pad)
            ts.append(time.perf_counter() - t0)
        esc_results[nd] = b / min(ts)
        print(f"[escalating] devices={nd:2d} batch={b:3d} "
              f"{min(ts)*1e3:8.1f} ms -> {esc_results[nd]:8.2f} pairs/s",
              file=sys.stderr)

    base = results.get(1)
    effs = {
        nd: thr / (base * nd) for nd, thr in results.items() if base and nd > 1
    }
    out = {
        "metric": "weak_scaling_efficiency",
        "mode": "devices" if args.real_devices else "cpu_mesh",
        "throughput_pairs_per_sec": results,
    }
    if args.real_devices:
        # Real devices: throughput should grow ~linearly with device count.
        out["efficiency_vs_1dev"] = effs
    else:
        # Virtual host devices SHARE the physical cores, so throughput cannot
        # grow; the measurable quantity is partitioning overhead:
        # serial_fraction = time(nd) / (nd * time(1)) -> 1.0 means the
        # sharded program costs exactly the serial work (zero overhead).
        out["partition_overhead"] = {
            nd: (base * nd) / thr / nd for nd, thr in results.items() if nd > 1
        }
    out["escalating_throughput_pairs_per_sec"] = esc_results
    ebase = esc_results.get(1)
    if ebase:
        if args.real_devices:
            out["escalating_efficiency_vs_1dev"] = {
                nd: thr / (ebase * nd)
                for nd, thr in esc_results.items() if nd > 1}
        else:
            out["escalating_partition_overhead"] = {
                nd: (ebase * nd) / thr / nd
                for nd, thr in esc_results.items() if nd > 1}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
