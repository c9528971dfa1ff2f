"""The port's batch path across processes: real OS processes of
``python -m seqalign_torch.parallel.worker`` join one gloo group, two CPU
mesh entries each, as ``tests/test_distributed.py`` runs the JAX worker.
Each process byte-checks its own shard against the native oracle
(``sharded_batch_score`` in five modes, ``BatchAligner.align`` linear
local and affine semi-global), checks that ``.score`` all-gathers the
whole array and that ``.align`` leaves the other processes' pairs None;
here the gathered scores must equal one process's on one device."""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from seqalign_torch.parallel import BatchAligner, worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Seconds a worker may take (they take a few).
TIMEOUT = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(num: int, local_devices: int, pairs: int):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "seqalign_torch.parallel.worker", str(rank),
         str(num), str(port), str(local_devices), str(pairs), "--device",
         "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for rank in range(num)]
    outs = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=TIMEOUT)
            outs.append(out)
            assert proc.returncode == 0, f"worker {rank} failed:\n{out}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def one_device_digest(pairs: int) -> str:
    texts, patterns = worker.batch(pairs)
    scores = BatchAligner(worker.SM, 4, worker.GAP, local=True,
                          device="cpu").score(list(texts), list(patterns))
    return hashlib.sha1(scores.astype(np.int32).tobytes()).hexdigest()


@pytest.mark.parametrize("num,pairs", [(2, 64), (4, 16)])
def test_worker_processes_check_their_shards(num, pairs):
    outs = run_workers(num, 2, pairs)
    digest = one_device_digest(num * pairs)
    for rank, out in enumerate(outs):
        line = [x for x in out.splitlines() if x.startswith("OK ")]
        assert len(line) == 1, out
        fields = line[0].split()
        assert fields[1:3] == [str(rank), str(pairs)], out
        # Each process aligned its two entries' tiles in both modes.
        assert fields[4] == f"aligned={2 * 2 * 128}", out
        assert fields[5] == f"scores={digest}", out


def test_worker_needs_a_group(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit) as e:
        worker.main(["--device", "cpu"])
    assert e.value.code == 2
