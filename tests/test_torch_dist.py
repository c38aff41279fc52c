"""The port's data mesh (`BatchAligner(mesh=)`, bowtie2_tpu_torch/dist/
mesh.py) on the CPU, with tests/test_dist.py's toy recipe (a 20-kbp
random genome, 64 reads, 32 pairs): a mesh of eight CPU entries takes
every batch in turn, and its SAM equals the port's one-device run and the
JAX package's `mesh=` run over conftest.py's 8 virtual devices.
Tolerance: byte-identical SAM."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from bowtie2_tpu.dist.mesh import make_mesh as jmake_mesh  # noqa: E402
from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.dist.mesh import (make_mesh, replicate_index,  # noqa: E402
                                         shard_batch)
from bowtie2_tpu_torch.index.fmindex import FMIndex as PFMIndex  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner as PPaired  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402

ENTRIES = 8


@pytest.fixture(scope="module")
def toy():
    """tests/test_dist.py's genome, reads and pairs, as numpy arrays."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    data = build_index_from_refs([("t", genome)], ftab_chars=4)

    def reads(n, rng, L=64):
        out = []
        for i in range(n):
            p = int(rng.integers(0, genome.size - L))
            s = genome[p:p + L].copy()
            if i % 4 == 0:
                s[L // 3] = (s[L // 3] + 1) % 4
            out.append((f"r{i}", s.astype(np.uint8)))
        return out

    se = reads(64, np.random.default_rng(5))
    m1 = reads(32, np.random.default_rng(6))
    m2 = []
    for i, (name, _s) in enumerate(m1):
        p = int(np.random.default_rng(i).integers(0, genome.size - 300))
        s = (3 - genome[p + 150:p + 214][::-1]) % 4
        m2.append((name, s.astype(np.uint8)))
    return data, se, list(zip(m1, m2))


def _rec(cls, name, codes):
    return cls(name=name, seq=codes, qual=np.full(codes.size, 35, np.uint8))


def _jax_lines(data, se, pe):
    """The JAX package's mesh= runs (8 devices), one batch each."""
    mesh = jmake_mesh(ENTRIES)
    jal = JAligner(data, jpolicy("sensitive"), mesh=mesh)
    jse = [r.line() for r in jal.align_batch([_rec(JRec, *r) for r in se])]
    jpa = JPaired(data, jpolicy("sensitive"), mesh=mesh)
    jpe = [r.line() for r in jpa.align_batch(
        [(_rec(JRec, *a), _rec(JRec, *b)) for a, b in pe])]
    return jse, jpe


@pytest.fixture(scope="module")
def jax_lines(toy):
    data, se, pe = toy
    return _jax_lines(data, se, pe)


def _mk(item, paired):
    if paired:
        return (_rec(PRec, *item[0]), _rec(PRec, *item[1]))
    return _rec(PRec, *item)


def _port_lines(al, batches, paired):
    """The port's lines over `batches` (collect), each batch submitted
    before the previous one is collected, and the same batches'
    collect_raw groups."""
    recs = [[_mk(x, paired) for x in b] for b in batches]
    pend, lines = [], []
    for b in recs:
        pend.append(al.submit(b))
        if len(pend) > 1:
            lines += [r.line() for r in al.collect(pend.pop(0))]
    lines += [r.line() for r in al.collect(pend.pop(0))]
    groups = []
    for h in [al.submit(b) for b in recs]:
        groups += al.collect_raw(h)
    return lines, groups


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_data_mesh_matches_one_device_and_jax(toy, jax_lines, paired):
    data, se, pe = toy
    items = pe if paired else se
    k = len(items) // ENTRIES
    batches = [items[i:i + k] for i in range(0, len(items), k)]
    assert len(batches) == ENTRIES
    cls = PPaired if paired else PAligner
    al = cls(data, ppolicy("sensitive"),
             mesh=make_mesh(devices=["cpu"] * ENTRIES))
    assert al.device.type == "cpu"
    lines, groups = _port_lines(al, batches, paired)
    # every mesh entry took a batch in each of the two passes
    assert al.mesh_batches == [2] * ENTRIES
    one = cls(data, ppolicy("sensitive"), device="cpu")
    recs = [_mk(x, paired) for x in items]
    assert lines == [r.line() for r in one.collect(one.submit(recs))]
    assert groups == one.collect_raw(one.submit(recs))
    assert lines == jax_lines[paired]


def test_mesh_helpers(toy):
    data = toy[0]
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.axis == "data"
    idx = PFMIndex.from_host(data, device="cpu")
    reps = replicate_index(idx, mesh)
    assert list(reps) == [torch.device("cpu")] and reps[mesh.devices[0]] is idx
    a = torch.arange(10)
    parts = shard_batch([a, 2 * a], mesh)
    assert [p[0].tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6],
                                              [7, 8, 9]]
    assert torch.equal(torch.cat([p[1] for p in parts]), 2 * a)
    with pytest.raises(ValueError, match="axis"):
        make_mesh(devices=["cpu"], axis="model")
    with pytest.raises(ValueError, match="data"):
        PAligner(data, ppolicy("sensitive"),
                 mesh=make_mesh(devices=["cpu"], axis="shard"))
    # a data mesh over the sharded index: every entry reads the one set
    # of shards (tests/test_torch_bothmesh.py holds its SAM to the JAX
    # package's)
    al = PAligner(data, ppolicy("sensitive"), mesh=mesh,
                  shard_mesh=make_mesh(devices=["cpu"] * 2, axis="shard"))
    assert al.sidx.fw.fm_blocks.S == 2 and list(al._homes) == [mesh.devices[0]]
