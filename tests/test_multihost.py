"""2-process ``jax.distributed`` test: the multi-process path, exercised.

Spawns two local processes that form a real multi-process JAX runtime
(coordinator on localhost), build a mesh over the combined device set
(2 virtual CPU devices per process), and run the halo-exchange sharded
FIR with cross-process collectives, bit-checking every output shard
against the numpy golden (VERDICT r1 item 2; SURVEY.md §5.8 mandate —
the reference's only transport is the filesystem,
``pipeline_fir_1d.py:53-96``).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

_REPO_ROOT = Path(__file__).resolve().parent.parent
_WORKER = _REPO_ROOT / "tests" / "_multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_process_distributed_fir_bit_exact():
    # Hard guard: subprocess.communicate(timeout=150) below — the workers
    # can never hang the suite.
    port = _free_port()
    num_procs = 2
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["PYTHONPATH"] = str(_REPO_ROOT)

    procs = [
        subprocess.Popen(
            [sys.executable, str(_WORKER), str(pid), str(num_procs),
             str(port)],
            cwd=_REPO_ROOT,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(num_procs)
    ]
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=150)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        pytest.fail(
            "multihost workers timed out; partial output:\n"
            + "\n---\n".join(outputs)
        )

    for pid, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, (
            f"worker {pid} exited rc={proc.returncode}:\n{out}"
        )
        assert f"[OK] multihost worker process={pid}" in out, out
        assert "bit-exact" in out
        assert "all_to_all roundtrip + psum metric reduction" in out
