"""The port's fused single-end pipeline vs the JAX program: the result
blob (packed backtrace ops + int32 metadata) must be byte-equal for the
same batch. Tolerance: exact (bytes).

400 reads pad to 512 rows, so end to end the DP-lane bypass compacts the
DP problems (NCDP < NC); 200 reads pad to 256 rows, where every candidate
takes the DP; local mode always runs the full DP and the walk."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.ops.fused import CHOSEN_FIELDS  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    g, reads = corpus(400)
    return build_index_from_refs([("rep", g)]), reads


@pytest.mark.parametrize("local,n", [(False, 400), (False, 200), (True, 400)],
                         ids=["e2e_bypass", "e2e_full_dp", "local"])
def test_fused_se_blob_equal(setup, local, n):
    data, reads = setup
    jrecs = [JRec(name=a, seq=s, qual=q) for a, s, q in reads[:n]]
    precs = [PRec(name=a, seq=s, qual=q) for a, s, q in reads[:n]]
    jfb = JAligner(data, jpolicy("sensitive", local=local)).submit(jrecs)
    pfb = PAligner(data, ppolicy("sensitive", local=local),
                   device="cpu").submit(precs)
    jb = np.asarray(jfb.blob)
    pb = pfb.blob.numpy()
    assert jb.dtype == pb.dtype == np.uint8
    assert jb.shape == pb.shape
    np.testing.assert_array_equal(jb, pb)
    # the batch stayed inside the fused DP budget, and aligned reads
    meta = pb[pfb.S * pfb.Bp * pfb.kk_bt:].view(np.int32)
    kk, Bp = pfb.kk, pfb.Bp
    assert meta[2 * kk * Bp + CHOSEN_FIELDS * Bp * pfb.kk_bt] == 0
    assert (meta[kk * Bp:kk * Bp + Bp] != 0).sum() > 0.9 * n
