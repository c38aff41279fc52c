"""The sharded index mode: the FM index and the 2-bit reference split over
a mesh's `shard` axis, each row read from the shard that owns it.

Port of bowtie2_tpu/dist/sharded.py. The JAX package splits every large
index table (BWT blocks with their occ checkpoints, SA-sample mark rows
and offsets, the 2-bit reference and its N mask) into contiguous
per-device ranges and turns each row gather into owner-computes plus a
psum over the axis (ops/fm.py:55 _take_sharded). Here one process runs
the pipeline once on a home device; each shard is a separate tensor
(ops/fm.py ShardedRows) on its mesh device, and every row read goes to
the owner shard through a device array of the shards' addresses: inside
the searches' and the SA walk's own LF loops (the `_sh` C entries) and
the window gather's (K7, `ref_gather_aligned_sh`). No collective runs
per step. On one card the shards are separate
allocations there; a shard on another card is read through peer access,
which `shard_index` turns on (and refuses where the cards cannot).

The function computed is the JAX mode's, edges included: the tables are
padded with zero rows to a multiple of the shard count, and a row no
shard owns (negative, or past the padding) reads as zeros, where the
replicated mode's take fills or clips. Tiny tables (fchr, ftab, ref_cum)
stay whole on the home device. As in the JAX package, only the fused
pipelines read the sharded tables; the host, overflow, mate-rescue and
long-read paths use the aligner's whole index. Under a data mesh as well
(`BatchAligner(mesh=, shard_mesh=)`) each mesh entry reads the one set of
shards as its own home (`index_home`).

The JAX package's `sharded_in_specs` (shard_map's partition specs) has no
meaning without shard_map and is not ported.
"""

from typing import NamedTuple

import torch

from bowtie2_tpu_torch.dist.mesh import Mesh, device_key
from bowtie2_tpu_torch.index.build import IndexData
from bowtie2_tpu_torch.index.fmindex import FMIndex, ShardedFMHalf
from bowtie2_tpu_torch.ops import _build
from bowtie2_tpu_torch.ops.fm import SHARD_AXIS, shard_rows
from bowtie2_tpu_torch.ops.ref import ShardedWords


class ShardedIndex(NamedTuple):
    fw: ShardedFMHalf
    ref_words: ShardedWords
    refn_words: ShardedWords
    ref_cum: torch.Tensor       # whole, home device
    n_ref_total: int
    mesh: Mesh


def _enable_peers(home: torch.device, mesh: Mesh) -> None:
    """Let the home card read every other card's shards (peer access),
    once; shards and home must be of one device type."""
    others = []
    for d in mesh.devices:
        if d.type != home.type:
            raise ValueError(f"a shard on {d} cannot be read from {home}")
        if d.type == "cuda" and d != home and d not in others:
            others.append(d)
    for d in others:
        if not torch.cuda.can_device_access_peer(home.index, d.index):
            raise RuntimeError(f"{home} cannot read {d}'s memory (no peer "
                               f"access): its shards cannot be read there")
        fn = _build.lib("take_sharded").enable_peer
        fn.argtypes = [_build.I, _build.I]
        err = fn(home.index, d.index)
        if err != 0:
            raise RuntimeError(f"enabling peer access {home} -> {d}: CUDA "
                               f"error {err}")


def shard_index(data: IndexData, mesh: Mesh, device=None,
                int64_rows=None) -> ShardedIndex:
    """Split the host index over the mesh's devices; `device` is the home
    device that runs the pipeline (default: the mesh's first). The row
    mode (small, large or int64) is FMIndex.from_host's, which takes
    `int64_rows`; in the int64 mode occ_cp64 is split as fm_blocks is
    (bowtie2_tpu/dist/sharded.py:118-119)."""
    if mesh.axis != SHARD_AXIS:
        raise ValueError(f"shard_index needs a {SHARD_AXIS!r} mesh, not "
                         f"{mesh.axis!r}")
    home = device_key(device if device is not None else mesh.devices[0])
    _enable_peers(home, mesh)
    rep = FMIndex.from_host(data, device="cpu", int64_rows=int64_rows)
    h = rep.fw

    def split(t):
        return shard_rows(t, mesh.devices, home)

    fw = ShardedFMHalf(
        n=h.n, z_off=h.z_off, fm_blocks=split(h.fm_blocks),
        fchr=h.fchr.to(home), ftab=h.ftab.to(home),
        mark_rows=split(h.mark_rows), offs=split(h.offs),
        row_dtype=h.row_dtype,
        occ_cp64=split(h.occ_cp64) if h.i64 else None)
    return ShardedIndex(
        fw=fw, ref_words=ShardedWords(split(rep.ref_words)),
        refn_words=ShardedWords(split(rep.refn_words)),
        ref_cum=rep.ref_cum.to(home), n_ref_total=rep.n_ref_total,
        mesh=mesh)


def index_home(sidx: ShardedIndex, device) -> ShardedIndex:
    """The same shards read from another home device (a data mesh's
    entry): each table's shard addresses and the whole tiny tables copied
    there, peer access turned on; the shards themselves are shared."""
    home = device_key(device)
    _enable_peers(home, sidx.mesh)

    def rows(r):
        return r._replace(addrs=r.addrs.to(home))
    fw = sidx.fw._replace(
        fm_blocks=rows(sidx.fw.fm_blocks), mark_rows=rows(sidx.fw.mark_rows),
        offs=rows(sidx.fw.offs), fchr=sidx.fw.fchr.to(home),
        ftab=sidx.fw.ftab.to(home),
        occ_cp64=rows(sidx.fw.occ_cp64) if sidx.fw.i64 else None)
    return sidx._replace(
        fw=fw, ref_words=ShardedWords(rows(sidx.ref_words.words)),
        refn_words=ShardedWords(rows(sidx.refn_words.words)),
        ref_cum=sidx.ref_cum.to(home))


def _checked(mesh: Mesh, large: bool, sidx: ShardedIndex) -> None:
    """The index is sharded over `mesh`, and `large` (int64 rows and
    positions at the API: the large or the int64 row mode) is its mode."""
    if sidx.mesh != mesh:
        raise ValueError("the index is sharded over another mesh")
    if sidx.fw.large != large:
        raise ValueError(f"large={large} for an index whose large mode is "
                         f"{sidx.fw.large}")


def make_fused_se_sharded(mesh: Mesh, large: bool = False, **statics):
    """fused_se over a ShardedIndex for one combination of static
    arguments: f(sidx, seg, jboth, jquals, lens, offs_all, valid_all,
    minsc, live_read, live_or) -> FusedResult."""
    from bowtie2_tpu_torch.ops.fused import fused_se

    def run(sidx, seg, *batch):
        _checked(mesh, large, sidx)
        return fused_se(sidx.fw, sidx.ref_words, sidx.refn_words, seg,
                        *batch, **statics)
    return run


def make_fused_pe_sharded(mesh: Mesh, large: bool = False, **statics):
    """fused_pe over a ShardedIndex: f(sidx, seg, jboth, jquals, lens,
    offs_all, valid_all, minsc, live_read, live_or, inst_read, filtered)
    -> FusedPEResult. Mate rescue, on the host side, reads the aligner's
    whole index, as in the JAX package."""
    from bowtie2_tpu_torch.ops.fused import fused_pe

    def run(sidx, seg, *batch):
        _checked(mesh, large, sidx)
        return fused_pe(sidx.fw, sidx.ref_words, sidx.refn_words, seg,
                        *batch, **statics)
    return run
