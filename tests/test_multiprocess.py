"""Multi-process distributed execution (SURVEY.md §5.8; VERDICT round-1
item #4): 2 OS processes x 4 virtual CPU devices = one 8-device global mesh
via jax.distributed + gloo CPU collectives.

The worker (scripts/multiprocess_worker.py) runs resample_pairs +
register_batch over the global "pairs" mesh and a cross-process psum; this
launcher asserts both workers succeed. On real hardware the same code paths
shard over several GPU hosts, which this environment cannot
provide — this is the faithful CPU stand-in.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "scripts" / "multiprocess_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_mesh_registration():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    env["KSSICP_LOCAL_DEVICES"] = "4"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(REPO),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multiprocess workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIPROC OK" in out, out
        assert "procs=2 devices=8 local=4" in out, out
