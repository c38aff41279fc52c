"""Both CLIs on the lambda phage fixtures: the port's (`--device cpu`)
against the JAX package's, SAM identical apart from the @PG line's CL:
field, for `align -U` over mate 1 and `align -1/-2` over the first 1,000
pairs. Tolerance: exact (bytes).

The fixtures are rebuilt at test time from tests/golden/lambda_pe.sam.gz
(no fixture file is committed): the genome from each aligned primary
record's POS, CIGAR and MD (they cover all 48,502 bp), the mates from SEQ
and QUAL, records flagged 0x10 reverse-complemented back to their input
strand.
"""

import gzip
import os
import re
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_cli import (MODES, PORT_PROCS, _build_both,  # noqa: E402
                            _fastq, align_both, start_port_runs)

GOLDEN_PE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "golden", "lambda_pe.sam.gz")


def rebuild_lambda(path, n_pairs):
    """(reference name, genome string, mate-1 records, mate-2 records)
    from a golden paired-end SAM: the genome from every aligned primary
    record's POS, CIGAR and MD, the mates from SEQ/QUAL in input strand."""
    comp = str.maketrans("ACGTN", "TGCAN")
    genome = name = None
    mates = ({}, {})
    with gzip.open(path, "rt") as f:
        for line in f:
            if line[0] == "@":
                m = re.search(r"@SQ\tSN:(\S+)\tLN:(\d+)", line)
                if m:
                    name, genome = m.group(1), [None] * int(m.group(2))
                continue
            t = line.rstrip("\n").split("\t")
            flag, seq, qual = int(t[1]), t[9], t[10]
            if flag & 0x100:
                continue
            if not flag & 4:
                md = next(x[5:] for x in t[11:] if x.startswith("MD:Z:"))
                ref = []             # MD's reference base, None = read's
                for num, dele, mm in re.findall(r"(\d+)|\^([A-Z]+)|([A-Z])",
                                                md):
                    ref.extend([None] * int(num) if num else
                               list(dele) if dele else [mm])
                r, q, k = int(t[3]) - 1, 0, 0
                for n, op in re.findall(r"(\d+)([MIDS=X])", t[5]):
                    for _ in range(int(n)):
                        if op in "M=XD":
                            b = ref[k]
                            genome[r] = seq[q] if b is None else b
                            r += 1
                            k += 1
                        if op in "M=XIS":
                            q += 1
            if flag & 0x10:
                seq, qual = seq.translate(comp)[::-1], qual[::-1]
            mates[0 if flag & 0x40 else 1][t[0]] = (seq, qual)
    names = list(mates[0])[:n_pairs]
    return (name, "".join(b or "N" for b in genome),
            [(n,) + mates[0][n] for n in names],
            [(n,) + mates[1][n] for n in names])


@pytest.fixture(scope="module")
def lambda_fixture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_lambda"))
    name, genome, m1, m2 = rebuild_lambda(GOLDEN_PE, 1000)
    assert len(genome) == 48502 and "N" not in genome
    fa = os.path.join(d, "lambda_virus.fa")
    with open(fa, "w") as f:
        f.write(f">{name}\n" + "\n".join(
            genome[i:i + 70] for i in range(0, len(genome), 70)) + "\n")
    _fastq(os.path.join(d, "reads_1.fq"), m1)
    _fastq(os.path.join(d, "reads_2.fq"), m2)
    jidx, pidx = _build_both(d, fa)
    # the port's runs of both modes start now, beside the JAX CLI's
    with ThreadPoolExecutor(PORT_PROCS) as pool:
        yield d, jidx, start_port_runs(pool, d, pidx, [
            (mode, _inputs(d, mode), []) for mode in MODES])


def _inputs(d, mode):
    return (["-U", os.path.join(d, "reads_1.fq")] if mode == "-U" else
            ["-1", os.path.join(d, "reads_1.fq"),
             "-2", os.path.join(d, "reads_2.fq")])


@pytest.mark.parametrize("mode", MODES)
def test_cli_lambda_matches_jax(lambda_fixture, mode):
    d, jidx, port = lambda_fixture
    (jsam, _), (psam, _) = align_both(d, mode, jidx, port[mode],
                                      _inputs(d, mode), [])
    n = 1000 if mode == "-U" else 2000
    assert len([x for x in psam if x[0] != "@"]) == n
    assert psam == jsam
