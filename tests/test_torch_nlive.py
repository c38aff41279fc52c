"""Nothing downstream of the rectangle DP reads what its n_live contract
leaves unspecified (ops/sw.py SWResult): the direction words of the dead
lanes and of the rows at or past each read's length.

The plain DP is wrapped so that it poisons that region with -1 (every
cell H_START with both extension bits: a walk that read one would stop
or run a gap it should not, and its op bytes, fields and SAM would
change), and the port's paths on the CPU must give the same output with
the poison as without: the fused single-end blob (with the DP-lane
bypass, with every candidate in the DP, and --local), the single-end
host path (a batch that overflows the fused DP budget), and the
paired-end blob, slot export and SAM (the fused path end to end and
--local, and the host path with mate rescue). Tolerance: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

from bowtie2_tpu_torch.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord  # noqa: E402
from bowtie2_tpu_torch.ops import sw as psw  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402
from test_torch_pe import mk_pairs  # noqa: E402

POISON = -1


@pytest.fixture
def poison(monkeypatch):
    """Switch for the plain DP's poison (`on`), and the count of cells it
    poisoned."""
    plain = psw._sw_banded_plain
    ctl = {"on": False, "cells": 0}

    def poisoned(reads, mmpen, read_lens, refwins, p, rect_cols, col_lo,
                 n_live=None, track_origin=False):
        res = plain(reads, mmpen, read_lens, refwins, p, rect_cols, col_lo,
                    n_live, track_origin=track_origin)
        if not ctl["on"]:
            return res
        Lmax, B, _ = res.dirs.shape
        n = B if n_live is None else int(n_live)
        dead = (torch.arange(Lmax)[:, None] >= read_lens[None, :]) | \
            (torch.arange(B)[None, :] >= n)
        dirs = res.dirs.clone()
        dirs[dead] = POISON
        ctl["cells"] += int(dead.sum())
        return res._replace(dirs=dirs)
    monkeypatch.setattr(psw, "_sw_banded_plain", poisoned)
    return ctl


def _clean_and_poisoned(ctl, run):
    clean = run()
    ctl["on"] = True
    got = run()
    assert ctl["cells"] > 0
    return clean, got


def _se(data, reads, local, n):
    recs = [SeqRecord(name=a, seq=s, qual=q) for a, s, q in reads[:n]]
    al = UnpairedAligner(data, make_policy("sensitive", local=local),
                         device="cpu")
    fb = al.submit(recs)
    blob = getattr(fb, "blob", None)
    return (None if blob is None else blob.numpy().copy(),
            al.collect_raw(fb), al.metrics.counters.get("host_batches", 0))


@pytest.fixture(scope="module")
def se_data():
    g, reads = corpus(400)
    return build_index_from_refs([("rep", g)]), reads


@pytest.fixture(scope="module")
def dense_data():
    g, reads = corpus(400, n_alu=60)
    return build_index_from_refs([("rep", g)]), reads


@pytest.mark.parametrize("local,n", [(False, 400), (False, 200), (True, 200)],
                         ids=["e2e_bypass", "e2e_full_dp", "local"])
def test_fused_se_ignores_unspecified_dirs(se_data, poison, local, n):
    data, reads = se_data
    clean, got = _clean_and_poisoned(
        poison, lambda: _se(data, reads, local, n))
    assert clean[2] == got[2] == 0                  # the fused path
    np.testing.assert_array_equal(got[0], clean[0])
    assert got[1] == clean[1]


def test_se_host_path_ignores_unspecified_dirs(dense_data, poison):
    data, reads = dense_data
    clean, got = _clean_and_poisoned(
        poison, lambda: _se(data, reads, False, 400))
    assert clean[2] == got[2] == 1                  # the host path
    assert got[1] == clean[1]


@pytest.mark.parametrize("batch,local", [("fast", False), ("fast", True),
                                         ("overflow", False)],
                         ids=["fused_e2e", "fused_local", "host_e2e"])
def test_pe_ignores_unspecified_dirs(poison, batch, local):
    n_alu, err = {"fast": (5, 0.005), "overflow": (60, 0.02)}[batch]
    g, _ = corpus(8, n_alu=n_alu)
    data = build_index_from_refs([("rep", g)])
    pairs = [(SeqRecord(name=a, seq=x, qual=q), SeqRecord(name=a, seq=y,
                                                          qual=q))
             for a, x, y, q in mk_pairs(data, np.random.default_rng(7), 256,
                                        err=err)]

    def run():
        pa = PairedAligner(data, make_policy("sensitive", local=local),
                           device="cpu")
        h = pa.submit(pairs)
        res = getattr(h, "res", None)
        return (None if res is None else res.blob.numpy().copy(),
                None if res is None else res.slots.numpy().copy(),
                pa.collect_raw(h), pa.metrics.counters.get("host_batches", 0))
    clean, got = _clean_and_poisoned(poison, run)
    assert got[3] == clean[3] == (1 if batch == "overflow" else 0)
    for a, b in zip(got[:2], clean[:2]):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert got[2] == clean[2]
