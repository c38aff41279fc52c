"""Port index vs the JAX package's: build, save/load, device tables.

Tolerance: exact equality (every array is integer)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
pytest.importorskip("jax")

from bowtie2_tpu.index import build as jbuild  # noqa: E402
from bowtie2_tpu.index.fmindex import FMIndex as JFMIndex  # noqa: E402
from bowtie2_tpu_torch.index import build as pbuild  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import FMIndex as PFMIndex  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import row_mode  # noqa: E402
from test_torch_corpus import corpus, n_refs_with_ns  # noqa: E402


def _refs(kind):
    if kind == "rep":
        g, _ = corpus(8)
        return [("rep", g)]
    return n_refs_with_ns()


def _assert_index_equal(a, b):
    assert a.ref_names == b.ref_names
    assert a.off_rate == b.off_rate
    for f in ("ref_lens", "ref_cum", "seg_joined_start", "seg_global_start",
              "seg_len", "ref_words", "refn_words"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for tag in ("fw", "bw"):
        ha, hb = getattr(a, tag), getattr(b, tag)
        assert (ha is None) == (hb is None)
        if ha is None:
            continue
        for fld in dataclasses.fields(ha):
            x, y = getattr(ha, fld.name), getattr(hb, fld.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, (tag, fld.name)
                np.testing.assert_array_equal(x, y, err_msg=fld.name)
            else:
                assert x == y, (tag, fld.name)


@pytest.mark.parametrize("kind", ["rep", "with_ns"])
@pytest.mark.parametrize("ftab_chars", [10, 4])
def test_build_index_equal(kind, ftab_chars):
    refs = _refs(kind)
    _assert_index_equal(jbuild.build_index_from_refs(refs, ftab_chars),
                        pbuild.build_index_from_refs(refs, ftab_chars))


def test_save_load_round_trip_across_packages(tmp_path):
    refs = n_refs_with_ns()
    jd = jbuild.build_index_from_refs(refs, mirror=True)
    pd = pbuild.build_index_from_refs(refs, mirror=True)
    jbuild.save_index(jd, str(tmp_path / "j" / "idx"))
    pbuild.save_index(pd, str(tmp_path / "p" / "idx"))
    _assert_index_equal(pbuild.load_index(str(tmp_path / "j" / "idx")), jd)
    _assert_index_equal(jbuild.load_index(str(tmp_path / "p" / "idx")), pd)


@pytest.mark.parametrize("kind", ["rep", "with_ns"])
def test_fmindex_tables_equal(kind):
    data = jbuild.build_index_from_refs(_refs(kind))
    j = JFMIndex.from_host(data)
    p = PFMIndex.from_host(data, device="cpu")
    for tag in ("fw",):
        jh, ph = getattr(j, tag), getattr(p, tag)
        assert int(jh.n) == ph.n and int(jh.z_off) == ph.z_off
        for f in ("fm_blocks", "mark_rows", "fchr", "ftab", "offs"):
            x = np.asarray(getattr(jh, f))
            y = getattr(ph, f).numpy()
            assert y.dtype == np.int32, f
            np.testing.assert_array_equal(x.view(np.int32) if x.dtype ==
                                          np.uint32 else x, y, err_msg=f)
    for f in ("ref_words", "refn_words", "ref_cum"):
        x = np.asarray(getattr(j, f))
        np.testing.assert_array_equal(
            x.view(np.int32) if x.dtype == np.uint32 else x,
            getattr(p, f).numpy(), err_msg=f)
    assert int(j.n_ref_total) == p.n_ref_total
    assert p.bw is None and j.bw is None


def test_large_index_mode_raises():
    """The uint32 large mode loads (tests/test_torch_zlarge.py holds it to
    the JAX package), and an index of 2^32 rows or more loads in the int64
    row mode, which raised before it was ported: occ_cp64 holds the full
    checkpoints, fchr, ftab and offs are int64 tensors of the host values
    (tests/test_torch_zzint64.py holds the mode to the JAX package)."""
    data = pbuild.build_index_from_refs(n_refs_with_ns(), large=True)
    assert PFMIndex.from_host(data, device="cpu").fw.large
    assert row_mode(data) == "large"
    data.fw.n = (1 << 32) - 1
    assert row_mode(data) == "int64"
    h = PFMIndex.from_host(data, device="cpu").fw
    assert h.i64 and h.large and h.row_dtype == torch.int64
    assert h.occ_cp64.dtype == torch.int64
    assert tuple(h.occ_cp64.shape) == (data.fw.occ_cp.shape[0], 4)
    np.testing.assert_array_equal(h.occ_cp64.numpy(), data.fw.occ_cp)
    for f in ("fchr", "ftab", "offs"):
        assert getattr(h, f).dtype == torch.int64, f
        np.testing.assert_array_equal(getattr(h, f).numpy(),
                                      getattr(data.fw, f), f)
