"""A data mesh over the sharded index (`BatchAligner(mesh=, shard_mesh=)`)
in the port, against the JAX package, which takes both meshes when they
hold the same devices: with a `data` mesh and a `shard` mesh over the same
4 of conftest.py's 8 virtual CPU devices it aligns, and the port (a mesh
of 4 CPU entries over 4 CPU shards, every entry reading the one set of
shards) gives the same SAM, and the same as one device; with the two
meshes over different devices the JAX package refuses the batch (its
fused pipeline's arguments lie on two device sets), which the second test
records. tests/test_torch_dist.py's toy recipe (64 reads, 32 pairs).
Tolerance: byte-identical SAM."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from jax.sharding import Mesh as JMesh  # noqa: E402

from bowtie2_tpu.dist.mesh import make_mesh as jmake_mesh  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from bowtie2_tpu_torch.ops import _build  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner as PPaired  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_dist import _mk, _port_lines, _rec, toy  # noqa: E402,F401

N = 4     # devices of each mesh


def _jax_run(data, items, paired, shard_devices):
    """The JAX package's lines with a data mesh over the first N devices
    and a shard mesh over `shard_devices`."""
    smesh = JMesh(np.array(shard_devices), ("shard",))
    cls = JPaired if paired else JAligner
    al = cls(data, jpolicy("sensitive"), mesh=jmake_mesh(N),
             shard_mesh=smesh)
    recs = [(_rec(JRec, *a), _rec(JRec, *b)) for a, b in items] if paired \
        else [_rec(JRec, *r) for r in items]
    return [r.line() for r in al.align_batch(recs)]


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_data_mesh_over_shards_matches_jax(toy, paired):  # noqa: F811
    data, se, pe = toy
    items = pe if paired else se
    want = _jax_run(data, items, paired, jax.devices()[:N])
    k = len(items) // N
    batches = [items[i:i + k] for i in range(0, len(items), k)]
    cls = PPaired if paired else PAligner
    al = cls(data, ppolicy("sensitive"),
             mesh=make_mesh(devices=["cpu"] * N),
             shard_mesh=make_mesh(devices=["cpu"] * N, axis="shard"))
    assert al.sidx.fw.fm_blocks.S == N
    _build.reset_counts()
    lines, groups = _port_lines(al, batches, paired)
    # every mesh entry took a batch in each pass, over the shards
    assert al.mesh_batches == [2] * N
    assert _build.PLAIN_CALLS["ref_gather_aligned_sh"] >= 2 * N
    one = cls(data, ppolicy("sensitive"), device="cpu")
    recs = [_mk(x, paired) for x in items]
    assert lines == [r.line() for r in one.collect(one.submit(recs))]
    assert groups == one.collect_raw(one.submit(recs))
    assert lines == want


def test_jax_refuses_meshes_over_different_devices(toy):  # noqa: F811
    data, se, _pe = toy
    with pytest.raises(ValueError, match="incompatible devices"):
        _jax_run(data, se, False, jax.devices()[N:2 * N])
