"""Worker for the multi-process distributed test (SURVEY.md §5.8).

Launched N times by scripts/run_multiprocess.py (or tests/test_multiprocess.py)
with args: <process_id> <num_processes> <coordinator_address>. Each process
owns `--xla_force_host_platform_device_count` virtual CPU devices; together
they form one global mesh (the DCN analogue — on real hardware the same code
paths shard over several GPU hosts via jax.distributed).

Exercises, over the GLOBAL mesh:
  1. register_batch sharded along "pairs" (shard_map; zero cross-pair
     collectives — the weak-scaling axis);
  2. resample_pairs on pair-sharded global arrays (the driver-dryrun stage);
  3. a psum across all processes (the cross-covariance reduction pattern of
     point-sharded Kabsch, parallel/point_shard.py).
Prints "MULTIPROC OK ..." and exits 0 on success.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count="
    + os.environ.get("KSSICP_LOCAL_DEVICES", "4")
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from kss_icp.parallel.mesh import distributed_init, make_mesh

    distributed_init(coordinator_address=coord, num_processes=nproc,
                     process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == nproc * n_local

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kss_icp.config import KSSICPConfig
    from kss_icp.models.kss_icp import resample_pairs
    from kss_icp.parallel.batch import register_batch

    cfg = KSSICPConfig(
        rotation_steps=4, max_candidates=4, max_resample_points=128,
        resample_pad=128, max_icp_iterations=64, rotation_chunk=16,
        screen_points=64, auto_escalate=False,
    )
    mesh = make_mesh(("pairs",))
    assert mesh.shape["pairs"] == n_global

    # Deterministic global batch, identical in every process; each process
    # materializes only its addressable shards.
    b, pad = n_global, 256
    rng = np.random.default_rng(0)
    u = rng.uniform(-1, 1, (b, pad))
    v = rng.uniform(-1, 1, (b, pad))
    tgt = np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1).astype(np.float32)
    # Modest rotations: the worker's 4^3 grid / 8-iteration ICP budget is a
    # plumbing test, not a robustness test (scripts/stress_test.py is that).
    ang = rng.uniform(0.2, 1.2, b)
    src = np.empty_like(tgt)
    for i in range(b):
        c, s = np.cos(ang[i]), np.sin(ang[i])
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        src[i] = tgt[i] @ r.T
    mask = np.ones((b, pad), bool)

    shard = NamedSharding(mesh, P("pairs"))

    def globalize(x):
        return jax.make_array_from_callback(x.shape, shard, lambda idx: x[idx])

    g_src, g_tgt = globalize(src), globalize(tgt)
    g_sm, g_tm = globalize(mask), globalize(mask)

    # Stage 2 of the dryrun contract: resampling under the mesh.
    pn = globalize(np.full((b,), cfg.max_resample_points, np.int32))
    (rs, rsm), (rt, rtm) = resample_pairs(g_src, g_sm, g_tgt, g_tm, pn, cfg)
    jax.block_until_ready(rs)

    res = register_batch(rs, rsm, rt, rtm, cfg, mesh=mesh)
    jax.block_until_ready(res.fitness)

    local_fit = np.concatenate(
        [np.asarray(s.data).reshape(-1) for s in res.fitness.addressable_shards]
    )
    assert np.isfinite(local_fit).all(), local_fit
    assert (local_fit < 0.05).all(), local_fit  # plumbing test, not robustness

    # Cross-process psum (the Kabsch cross-covariance reduction pattern).
    @jax.jit
    def total(x):
        return jnp.sum(x)

    tot = float(total(g_sm.astype(jnp.float32)))
    assert tot == b * pad, tot

    print(f"MULTIPROC OK pid={pid} procs={jax.process_count()} "
          f"devices={n_global} local={n_local} "
          f"fit_max={local_fit.max():.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
