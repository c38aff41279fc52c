"""A genome of three references, one entirely N, one with leading and
trailing N runs, one shorter than a pair (test_torch_corpus
`refs_with_all_n`), in the port against the JAX package on the CPU, in
the small index mode (tests/test_torch_zmultiref.py holds the large one):
single-end and paired-end `collect_raw`. Tolerance: byte-identical SAM.

The all-N reference stays in the index as the JAX package keeps it: in
`ref_names` (so in the CLI's @SQ lines) and in the global coordinates,
which it shifts for the references after it; SAM positions are offsets
within a reference, so the records equal those against the two other
references alone, which the last test holds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner as PPaired  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_corpus import (multiref_pairs, multiref_reads,  # noqa: E402
                               refs_with_all_n)

N_SE, N_PE = 160, 96


def run_se(data, reads, jax_pkg: bool):
    """collect_raw of one single-end batch, by either package."""
    if jax_pkg:
        al = JAligner(data, jpolicy("sensitive"))
        recs = [JRec(name=n, seq=c, qual=q) for n, c, q in reads]
    else:
        al = PAligner(data, ppolicy("sensitive"), device="cpu")
        recs = [PRec(name=n, seq=c, qual=q) for n, c, q in reads]
    return al.collect_raw(al.submit(recs))


def run_pe(data, pairs, jax_pkg: bool):
    """collect_raw of one paired-end batch, by either package."""
    cls, al = (JRec, JPaired(data, jpolicy("sensitive"))) if jax_pkg else \
        (PRec, PPaired(data, ppolicy("sensitive"), device="cpu"))
    return al.collect_raw(al.submit([
        (cls(name=n, seq=a, qual=qa), cls(name=n, seq=b, qual=qb))
        for n, a, b, qa, qb in pairs]))


@pytest.fixture(scope="module")
def genome():
    refs = refs_with_all_n()
    return refs, build_index_from_refs(refs)


def test_all_n_reference_keeps_its_place(genome):
    refs, data = genome
    assert data.ref_names == ["allN", "chrB", "tiny"]
    assert list(data.ref_cum) == [0, 700, 8700, 8850]
    assert data.seg_global_start[0] == 700 + 40       # chrB's first base


def test_multiref_se_matches_jax(genome):
    refs, data = genome
    reads = multiref_reads(refs, N_SE)
    p = run_se(data, reads, False)
    assert p == run_se(data, reads, True)
    rnames = {ln.split(b"\t")[2] for grp in p for _f, ln in grp}
    assert {b"chrB", b"tiny", b"*"} <= rnames


def test_multiref_pe_matches_jax(genome):
    refs, data = genome
    pairs = multiref_pairs(refs, N_PE)
    p = run_pe(data, pairs, False)
    assert p == run_pe(data, pairs, True)
    # mates on two references: RNEXT names the other one
    assert any(ln.split(b"\t")[6] not in (b"=", b"*")
               for grp in p for _f, ln in grp)


def test_all_n_reference_shifts_no_sam_position(genome):
    """The port's records with the all-N reference equal those against
    the other two references alone."""
    refs, data = genome
    reads = multiref_reads(refs, 48)
    without = build_index_from_refs(refs[1:])
    assert run_se(data, reads, False) == run_se(without, reads, False)
