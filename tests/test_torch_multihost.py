"""The port's multi-process runs (bowtie2_tpu_torch/dist/multihost.py) on
the CPU: two processes joined by torch.distributed (gloo, on a port
picked at run time) align their round-robin shares of 4 windows of 128
reads and write one shard file a window; the merged bytes equal a
one-process run's (the reference's ordered-output contract, outq.h:38).
The genome and reads are made by the test (the test_torch_corpus recipe)
and handed to the workers as .npy files."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import corpus  # noqa: E402

N_READS, WINDOW = 512, 128
TIMEOUT_S = 300

WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from bowtie2_tpu_torch.dist.multihost import (init_multihost, shard_path,
                                              shard_windows)

P = int(os.environ["BT2X_NUM_PROCESSES"])
pid = int(os.environ["BT2X_PROCESS_ID"])
if P > 1:
    init_multihost(backend="gloo")

from bowtie2_tpu_torch.index.build import build_index_from_refs
from bowtie2_tpu_torch.io.fastx import SeqRecord
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner
from bowtie2_tpu_torch.pipeline.policy import make_policy

d = os.environ["BT2X_DATA"]
genome = np.load(os.path.join(d, "genome.npy"))
codes = np.load(os.path.join(d, "codes.npy"))
lens = np.load(os.path.join(d, "lens.npy"))
data = build_index_from_refs([("rep", genome)])
al = UnpairedAligner(data, make_policy("sensitive"), device="cpu")
reader = (SeqRecord(name=f"r{i}", seq=codes[i, :lens[i]],
                    qual=np.full(lens[i], 35, np.uint8))
          for i in range(len(lens)))
prefix = os.environ["BT2X_OUT"]
for w, records in shard_windows(reader, pid, P, window=int(
        os.environ["BT2X_WINDOW"])):
    with open(shard_path(prefix, w), "wb") as f:
        for g in al.collect_raw(al.submit(records)):
            for _, line in g:
                f.write(line + b"\n")
if P > 1:
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
print("worker done", pid)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(tmp_path):
    from bowtie2_tpu_torch.dist.multihost import merge_shards
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g, reads = corpus(N_READS)
    L = max(r.size for _, r, _ in reads)
    codes = np.full((N_READS, L), 4, np.uint8)
    lens = np.array([r.size for _, r, _ in reads], np.int64)
    for i, (_, r, _) in enumerate(reads):
        codes[i, :r.size] = r
    for name, a in (("genome", g), ("codes", codes), ("lens", lens)):
        np.save(tmp_path / f"{name}.npy", a)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    def run(nproc, tag):
        prefix = str(tmp_path / f"out_{tag}")
        port = _free_port()
        procs = []
        for pid in range(nproc):
            env = dict(os.environ, PYTHONPATH=repo,
                       BT2X_NUM_PROCESSES=str(nproc),
                       BT2X_PROCESS_ID=str(pid),
                       BT2X_COORDINATOR=f"localhost:{port}",
                       BT2X_OUT=prefix, BT2X_DATA=str(tmp_path),
                       BT2X_WINDOW=str(WINDOW))
            procs.append(subprocess.Popen(
                [sys.executable, str(script)], env=env, cwd=str(tmp_path),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        try:
            for p in procs:
                out, err = p.communicate(timeout=TIMEOUT_S)
                assert p.returncode == 0, err.decode()[-2000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        shards = sorted(os.listdir(tmp_path))
        assert sum(s.startswith(f"out_{tag}.shard") for s in shards) == \
            N_READS // WINDOW
        merged = str(tmp_path / f"merged_{tag}.sam")
        assert merge_shards(prefix, merged) == N_READS // WINDOW
        with open(merged, "rb") as f:
            return f.read()

    single = run(1, "single")
    double = run(2, "double")
    assert single == double
    assert single.count(b"\n") >= N_READS
