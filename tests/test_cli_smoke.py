"""CLI smoke tests in a production-like interpreter.

The test harness enables jax_enable_x64 (conftest), which hides ops that
only work in x64 mode (a voxel_downsample int64 bug escaped exactly this
way). These tests run the CLI in a subprocess with the default (x64-OFF)
config on small inputs."""

import subprocess
import sys

import numpy as np
import pytest

from kss_icp.io.formats import load_points, save_xyz
from helpers import random_cloud


def _run(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "kss_icp", *args, "--platform", "cpu"],
        capture_output=True, text=True, timeout=timeout,
    )


@pytest.fixture(scope="module")
def cloud_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("cli") / "cloud.xyz"
    save_xyz(path, random_cloud(rng, 1200))
    return path


@pytest.mark.parametrize("method", ["fps", "grid", "hierarchy", "octree", "aivs"])
def test_simplify_methods_no_x64(cloud_file, tmp_path, method):
    out = tmp_path / f"{method}.xyz"
    r = _run(["simplify", str(cloud_file), str(out), "-m", method, "-n", "200"])
    assert r.returncode == 0, r.stderr[-2000:]
    pts = load_points(out)
    assert 1 <= pts.shape[0] <= 1200


def test_measure_no_x64(cloud_file, tmp_path):
    r = _run(["measure", str(cloud_file), str(cloud_file)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RMSE: 0" in r.stdout  # identical clouds -> zero error


def test_serve_jsonl_no_x64(cloud_file, tmp_path):
    import json

    out = tmp_path / "served.xyz"
    req = json.dumps({"source": str(cloud_file), "target": str(cloud_file),
                      "output": str(out)})
    bad = json.dumps({"source": "/nonexistent.xyz", "target": str(cloud_file)})
    r = subprocess.run(
        [sys.executable, "-m", "kss_icp", "serve", "--platform", "cpu",
         "--full-pad", "2048", "--accurate", "2", "--iterations", "20",
         "--max-candidates", "2"],
        input=req + "\n" + bad + "\n",
        capture_output=True, text=True, timeout=240,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    assert lines[0]["event"] == "ready"
    ok = lines[1]
    assert ok["ok"] and ok["rmse"] < 1e-3  # identical clouds
    assert out.exists()
    assert lines[2]["ok"] is False  # bad request reported, server kept going


def test_register_pre_downsample_no_x64(cloud_file, tmp_path):
    # Room/block large-scan protocol: octree pre-downsample before
    # registration (Method_Octree.hpp:16).
    out = tmp_path / "pre.xyz"
    r = _run(["register", str(cloud_file), str(cloud_file), "-o", str(out),
              "--pre-downsample", "600", "--accurate", "2",
              "--iterations", "20", "--max-candidates", "2"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "pre-downsampled" in r.stdout
    assert out.exists()


def test_bench_dir_no_x64(tmp_path):
    """Real-dataset ingestion entry (VERDICT r3 item 8): discovery +
    batched protocol + manifest pose scoring over a directory."""
    import json

    from kss_icp.transfer import TransferRecord, apply_record, save_transfer_log

    rng = np.random.default_rng(3)
    d = tmp_path / "ds"
    d.mkdir()
    recs = []
    # angles within ICP range of the 4^3 grid's nodes (no escalation
    # here), on an ASYMMETRIC surface so no impostor basin competes
    for i, ang in enumerate((0.7, 1.5)):
        u = rng.uniform(-1, 1, 900)
        v = rng.uniform(-1, 1, 900)
        z = 0.3 * np.sin(3 * u) * np.cos(2 * v) + 0.25 * u + 0.15 * v * v
        tgt = np.stack([u, v, z], axis=-1)
        rec = TransferRecord(name=f"m{i}", axis="z", angle=ang)
        save_xyz(d / f"m{i}.wlop", tgt)
        save_xyz(d / f"m{i}.gird", apply_record(tgt[::2], rec))
        recs.append(rec)
    save_transfer_log(d / "transfer.txt", recs)
    (d / "orphan.gird").write_text("1\n0 0 0\n")  # no target -> ignored

    out = tmp_path / "bd.json"
    # --no-escalate: this smoke test covers discovery + batched solve +
    # manifest pose scoring; the escalation/overlap ladder would compile
    # multi-minute programs in a subprocess (covered elsewhere).
    r = _run(["bench-dir", str(d), "--accurate", "4", "--iterations", "60",
              "--max-candidates", "4", "--no-escalate", "--json", str(out)],
             timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["pairs"] == 2 and res["pose_scored"] == 2
    assert res["pose_success_rate"] == 1.0, res
    assert res["median_rmse"] < 0.05, res
