"""Single-end batched alignment on the device (torch + CUDA kernels), and
the machinery the aligners share.

Port of bowtie2_tpu/pipeline/align.py; its paired-end half is
pipeline/paired.py. A batch runs
as one device pipeline (`ops/fused.py::fused_se`) that `submit` enqueues
without synchronising; `collect_raw` reads its one result blob back,
applies the RNG-replay overrides (pipeline/replay.py for exact multimaps,
pipeline/traj_replay.py for the trajectory class) and builds the SAM lines
with the native line builder. Output is byte-identical to the JAX
package's for the same index and reads.

A batch whose fused DP budget overflows is rerun on the uncapped
phase-by-phase host path (`_align_batch_host`), which drives the same
kernels, as the JAX package does. A batch with a read longer than the
rectangle buckets (8192 bp) takes the host path too, in long mode: no
exact or half-read search, up to 512 seeds a read, and the band-coordinate
DP and walk (`sw_banded_diag`, `backtrace_diag`; linear in the read
length).

Entry points take device=None, meaning the CUDA card; device="cpu" runs the
kernels' plain PyTorch versions (the tests do).
"""

import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bowtie2_tpu_torch.constants import decode_seq
from bowtie2_tpu_torch.index.build import IndexData
from bowtie2_tpu_torch.index.fmindex import FMIndex, resolve_device
from bowtie2_tpu_torch.io.fastx import SeqRecord
from bowtie2_tpu_torch.io.sam import (FLAG_REVERSE, FLAG_UNMAPPED,
                                      SamAlignment, cigar_string,
                                      qual_string)
from bowtie2_tpu_torch.ops import fm
from bowtie2_tpu_torch.ops.fused import (CHOSEN_FIELDS, SegTables, fused_pe,
                                         fused_se, se_walks)
from bowtie2_tpu_torch.ops.ref import gather_windows
from bowtie2_tpu_torch.ops.sw import (OP_NONE, backtrace, backtrace_diag,
                                      bt_steps, sw_banded, sw_banded_diag)
from bowtie2_tpu_torch.pipeline.backtrace import cigar_md_from_packed
from bowtie2_tpu_torch.pipeline.mapq import mapq_v2
from bowtie2_tpu_torch.pipeline.policy import Policy
from bowtie2_tpu_torch.utils.metrics import TRACE, Metrics

# length buckets of the rectangle DP (= the JAX package's)
LEN_BUCKETS = (96, 128, 192, 384, 768, 1536, 3072, 8192)

BT_FIELDS = ("read_start", "ref_start_win", "n_mm", "n_go",
             "n_gc", "n_refn", "score_check")

LONG_READ_MAX = 1 << 20      # 1 Mbp: sanity ceiling for the long path


def bucket_groups(lengths, merge_below: int = 1024):
    """Group read indices by length bucket for dispatch, merging sparse
    groups into the next-present larger bucket. Returns {bucket:
    [indices]} with sorted keys in insertion order."""
    by = {}
    for i, ln in enumerate(lengths):
        by.setdefault(_bucket(max(int(ln), 1)), []).append(i)
    bkts = sorted(by)
    out = {}
    pending = None
    for j, b in enumerate(bkts):
        idxs = by[b]
        if pending is not None:
            idxs = pending + idxs
            pending = None
        if len(idxs) < merge_below and j + 1 < len(bkts):
            pending = idxs
        else:
            out[b] = idxs
    if pending is not None:
        if bkts[-1] in out:
            out[bkts[-1]] = out[bkts[-1]] + pending
        else:
            out[bkts[-1]] = pending
    return out


def _bucket(n: int, buckets=LEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n and b < LONG_READ_MAX:
        b *= 2
    if n > b:
        raise ValueError(f"read length {n} exceeds max supported {b}")
    return b


def _u32pos(a: np.ndarray) -> np.ndarray:
    """Decode an int32-wrapped global position back to int64.

    The fused PE metadata exports global reference positions as int32 to
    keep the blob one dtype; in the large-index mode true positions span
    [-(G+31), 4.29e9) — an interval shorter than 2^32, so the mod-2^32
    image is unambiguous: values in the top 4096 slots are the (small)
    negatives, everything else is the non-negative position."""
    v = a.astype(np.int64) & 0xFFFFFFFF
    return np.where(v >= (1 << 32) - 4096, v - (1 << 32), v)


def _pow2_at_least(n: int, lo: int = 256) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _round_batch(n: int, lo: int = 256) -> int:
    """Batch-row padding: pow2 below 1024, multiples of 1024 above."""
    b = lo
    while b < n and b < 1024:
        b *= 2
    if b >= n:
        return b
    return -(-n // 1024) * 1024


def _np(t: torch.Tensor) -> np.ndarray:
    """Device tensor → host numpy: the one place results leave the card,
    so every wait of the host on it is a `fetch` span."""
    with TRACE.span("fetch"):
        return t.cpu().numpy()


def _batch_of(h) -> int:
    """The batch number `submit` gave a handle: a fused batch's field, or
    the last item of a ("long", records, k) / ("host", pairs, k) tuple."""
    return h[2] if isinstance(h, tuple) else h.batch


@dataclass
class AlignStats:
    reads: int = 0
    unal: int = 0
    al_one: int = 0
    al_multi: int = 0
    filtered: int = 0
    # paired-end
    pairs: int = 0
    conc_one: int = 0
    conc_multi: int = 0
    disc: int = 0
    mate_al_one: int = 0   # mates of non-conc/disc pairs aligning once
    mate_al_multi: int = 0

    def merge(self, o: "AlignStats") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(o, f))

    def summary(self) -> str:
        """stderr summary in the reference's format (aln_sink.cpp printAlSumm)."""
        if self.pairs:
            return self._summary_paired()
        n = max(self.reads, 1)
        lines = [f"{self.reads} reads; of these:",
                 f"  {self.reads} (100.00%) were unpaired; of these:",
                 f"    {self.unal} ({100.0*self.unal/n:.2f}%) aligned 0 times",
                 f"    {self.al_one} ({100.0*self.al_one/n:.2f}%) aligned exactly 1 time",
                 f"    {self.al_multi} ({100.0*self.al_multi/n:.2f}%) aligned >1 times",
                 f"{100.0*(self.al_one+self.al_multi)/n:.2f}% overall alignment rate"]
        return "\n".join(lines)

    def _summary_paired(self) -> str:
        np_ = max(self.pairs, 1)
        conc0 = self.pairs - self.conc_one - self.conc_multi
        nodisc = conc0 - self.disc
        nmates = max(2 * nodisc, 1)
        mate0 = 2 * nodisc - self.mate_al_one - self.mate_al_multi
        tot = 2 * self.pairs
        al = tot - mate0 if tot else 0
        lines = [
            f"{self.pairs} reads; of these:",
            f"  {self.pairs} (100.00%) were paired; of these:",
            f"    {conc0} ({100.0*conc0/np_:.2f}%) aligned concordantly 0 times",
            f"    {self.conc_one} ({100.0*self.conc_one/np_:.2f}%) aligned concordantly exactly 1 time",
            f"    {self.conc_multi} ({100.0*self.conc_multi/np_:.2f}%) aligned concordantly >1 times",
            "    ----",
            f"    {conc0} pairs aligned concordantly 0 times; of these:",
            f"      {self.disc} ({100.0*self.disc/max(conc0,1):.2f}%) aligned discordantly 1 time",
            "    ----",
            f"    {nodisc} pairs aligned 0 times concordantly or discordantly; of these:",
            f"      {2*nodisc} mates make up the pairs; of these:",
            f"        {mate0} ({100.0*mate0/nmates:.2f}%) aligned 0 times",
            f"        {self.mate_al_one} ({100.0*self.mate_al_one/nmates:.2f}%) aligned exactly 1 time",
            f"        {self.mate_al_multi} ({100.0*self.mate_al_multi/nmates:.2f}%) aligned >1 times",
            f"{100.0*al/max(tot,1):.2f}% overall alignment rate"]
        return "\n".join(lines)


def pad_reads(records: Sequence[SeqRecord], Lmax: int):
    """Batch padding: → (fw, qu, rc, qu_r, lens), arrays (B, Lmax) int8.
    Pad code is 4 (N) for sequence, 0 for quals. Native C scatter with a
    numpy fallback."""
    B = len(records)
    lens = np.array([r.seq.size for r in records], dtype=np.int32)
    if B == 0:
        return (np.full((0, Lmax), 4, np.int8), np.zeros((0, Lmax), np.int8),
                np.full((0, Lmax), 4, np.int8), np.zeros((0, Lmax), np.int8),
                lens)
    allseq = np.concatenate([r.seq for r in records]).astype(np.int8)
    allq = np.concatenate([r.qual for r in records]).astype(np.int8)
    try:
        from bowtie2_tpu_torch.native.samemit import pad_reads_c
        starts = np.zeros(B, np.int64)
        starts[1:] = np.cumsum(lens[:-1], dtype=np.int64)
        fw, qu, rc, qu_r = pad_reads_c(allseq, allq, starts, lens, B, Lmax)
        return fw, qu, rc, qu_r, lens
    except ImportError:
        pass
    fw = np.full((B, Lmax), 4, dtype=np.int8)
    qu = np.zeros((B, Lmax), dtype=np.int8)
    rc = np.full((B, Lmax), 4, dtype=np.int8)
    qu_r = np.zeros((B, Lmax), dtype=np.int8)
    row = np.repeat(np.arange(B), lens)
    col = np.arange(allseq.size) - np.repeat(np.cumsum(lens) - lens, lens)
    rcol = np.repeat(lens, lens) - 1 - col
    fw[row, col] = allseq
    qu[row, col] = allq
    rc[row, rcol] = np.where(allseq < 4, 3 - allseq, 4)
    qu_r[row, rcol] = allq
    return fw, qu, rc, qu_r, lens


@dataclass
class DPPool:
    """One batch of banded-DP problems + results (device tensors kept)."""
    G: int
    Lmax: int
    n: int                       # live problems (rest is padding)
    win_start: np.ndarray        # (NC,) global window start per problem
    rid: np.ndarray              # (n,) reference id
    scores: np.ndarray           # (n,) int64
    rows_end: np.ndarray         # (NC,)
    lanes_end: np.ndarray        # (NC,)
    dirs: torch.Tensor           # (Lmax, NCDP, Wp): NCDP <= NC when the
                                 # fused DP-lane bypass compacted
    jreads: torch.Tensor         # (NC, Lmax)
    jquals: torch.Tensor         # (NC, Lmax)
    wins: torch.Tensor           # (NC, Lmax + 2G + 1)
    mm_ug: np.ndarray = None     # (n,) ungapped anchor-diagonal mismatches
    dplane: np.ndarray = None    # (NC,) candidate -> dirs lane (-1 =
                                 # bypassed); None = identity
    diag: bool = False           # dirs in band coordinates (long reads)
    band_lanes: np.ndarray = None  # (NC,) band column of the best cell
                                   # (diag; lanes_end holds rect columns)

    def end_pos(self, k) -> np.ndarray:
        """Global position of the last ref char consumed."""
        return (self.win_start[k] + self.lanes_end[k]).astype(np.int64)


@dataclass
class CandSet:
    """Search result of the host path for a batch: candidates + DP."""
    B: int
    Lmax: int
    lens: np.ndarray
    fw: np.ndarray
    qu: np.ndarray
    rc: np.ndarray
    qu_r: np.ndarray
    minsc: np.ndarray
    perfect: np.ndarray
    filtered: np.ndarray
    yf: np.ndarray = None         # (B,) int8 filter-reason codes (YF_*)
    jboth: torch.Tensor = None    # device (2B, Lmax) fw+rc reads
    jquals: torch.Tensor = None   # device (2B, Lmax) quals fw+rev
    n_cand: int = 0
    cand_read: np.ndarray = None
    cand_or: np.ndarray = None
    anchor: np.ndarray = None
    rid: np.ndarray = None
    valid: np.ndarray = None
    end_pos: np.ndarray = None
    pool: Optional[DPPool] = None
    cand_exact: np.ndarray = None    # candidate from exact end-to-end hit
    cand_half: np.ndarray = None     # candidate from half-read (1mm) range
    cand_rangej: np.ndarray = None   # source range id (width-sorted index;
                                     # -2/-1 for exact fw/rc)
    cand_rwidth: np.ndarray = None   # SA width of the source range
    ee_elts: np.ndarray = None       # (2B,) exact end-to-end elements
    inst0: np.ndarray = None         # (2B,) N-free instantiated seeds
    seed_elts: np.ndarray = None     # (B,) summed seed SA widths (fw+rc)
    seed_nz: np.ndarray = None       # (B,) nonzero seed ranges (fw+rc)
    sw_top: np.ndarray = None        # (2B,) exact-sweep SA tops
    sw_bot: np.ndarray = None        # (2B,) bots (strand suppression applied)
    sw_ned: np.ndarray = None        # (2B,) sweep edit lower bounds


class BatchAligner:
    """Shared device machinery of the aligners."""

    _names_tab = None      # RefNameTable for the native line builders

    MAX_EXACT_ROWS = 4      # rows resolved per exact-hit range per orientation
    NC_PER_READ = 16        # candidate extension budget per read

    def __init__(self, data: IndexData, policy: Policy, device=None,
                 mesh=None, shard_mesh=None):
        """device: None for the CUDA card (raises when there is none), or
        an explicit torch device such as "cpu".

        mesh: a dist/mesh.py Mesh on the "data" axis: batches go to its
        devices in turn, each device with its own copy of the index, and
        every batch is collected on the device it ran on (the output is a
        one-device run's). The device is the mesh's first.

        shard_mesh: a Mesh on the "shard" axis: the sharded index mode
        (dist/sharded.py). The fused pipelines read the index split over
        the mesh's devices from `device`; the host, overflow, mate-rescue
        and long-read paths read the whole index, as in the JAX package.
        With both, every entry of the data mesh reads the one set of
        shards (the JAX package takes both when the two meshes hold the
        same devices)."""
        if mesh is not None:
            from bowtie2_tpu_torch.dist.mesh import device_key
            if mesh.axis != "data":
                raise ValueError(f"mesh= takes a 'data' mesh, not "
                                 f"{mesh.axis!r}")
            if device is not None and \
                    device_key(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"({mesh.devices[0]})")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.data = data
        self.pol = policy
        self.idx = FMIndex.from_host(data, self.device)
        self.stats = AlignStats()
        self.metrics = Metrics()
        self.dp_log = None       # --log-dp sink
        self._stats_lock = threading.Lock()
        self._seg_end_joined = data.seg_joined_start + data.seg_len
        # device segment tables and host row arrays follow the index's row
        # mode: int64 in the large mode (global positions past 2^31,
        # uint32 rows), int32 otherwise
        sdt = np.int64 if self.idx.fw.large else np.int32
        self.seg = SegTables(
            seg_joined_start=self._put(data.seg_joined_start.astype(sdt)),
            seg_global_start=self._put(data.seg_global_start.astype(sdt)),
            seg_end_joined=self._put(self._seg_end_joined.astype(sdt)),
            ref_cum=self._put(data.ref_cum.astype(sdt)))
        self._row_dtype = sdt
        self.mesh = mesh
        self.mesh_batches = [0] * mesh.size if mesh is not None else []
        self._turn = 0
        if mesh is not None:
            from bowtie2_tpu_torch.dist.mesh import replicate_index
            self._replicas = {
                d: (ix, self.seg if ix is self.idx else SegTables(
                    *(t.to(d) for t in self.seg)))
                for d, ix in replicate_index(self.idx, mesh).items()}
        self.shard_mesh = shard_mesh
        if shard_mesh is not None:
            from bowtie2_tpu_torch.dist.sharded import index_home, shard_index
            self.sidx = shard_index(data, shard_mesh, self.device)
            if mesh is not None:
                # every mesh entry reads the one set of shards
                self._homes = {d: self.sidx if d == self.device
                               else index_home(self.sidx, d)
                               for d in self._replicas}

    def _put(self, a) -> torch.Tensor:
        """Host → device. On the card the copy goes from pinned memory and
        does not block the host."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _use(self, device) -> None:
        """Point the device state (device, index, segment tables) at one
        device of the data mesh, and make its card the current one."""
        self.device = device
        self.idx, self.seg = self._replicas[device]
        if self.shard_mesh is not None:
            self.sidx = self._homes[device]
        if device.type == "cuda":
            torch.cuda.set_device(device)

    def _take_turn(self) -> None:
        """With a data mesh, the next mesh entry's device takes the batch
        being submitted."""
        if self.mesh is None:
            return
        k = self._turn % self.mesh.size
        self._turn += 1
        self.mesh_batches[k] += 1
        self._use(self.mesh.devices[k])

    def _use_batch(self, h) -> None:
        """With a data mesh, collect a submitted batch (not None) on its
        own device."""
        if self.mesh is not None and not isinstance(h, tuple):
            self._use(h.device)

    def _fused(self, kind: str, batch, statics):
        """fused_se ("se") or fused_pe ("pe") of one batch's device arrays
        over the aligner's index: the whole one, or, with shard_mesh, the
        sharded one."""
        if self.shard_mesh is None:
            fn = fused_se if kind == "se" else fused_pe
            return fn(self.idx.fw, self.idx.ref_words, self.idx.refn_words,
                      self.seg, *batch, **statics)
        from bowtie2_tpu_torch.dist.sharded import (make_fused_pe_sharded,
                                                    make_fused_se_sharded)
        make = make_fused_se_sharded if kind == "se" else make_fused_pe_sharded
        return make(self.shard_mesh, large=self.sidx.fw.large, **statics)(
            self.sidx, self.seg, *batch)

    # YF filter-reason codes (= native samemit mode values)
    YF_NS, YF_LN, YF_QC, YF_SC = 2, 3, 4, 5
    YF_STR = {0: None, 2: "NS", 3: "LN", 4: "QC", 5: "SC"}

    def _filters(self, records, lens, n_count, nceil, minsc):
        """Pre-alignment read filters → (filtered, yf_codes)
        (bt2_search.cpp:3385-3408; YF priority LN > NS > SC > QC)."""
        pol = self.pol
        lenf = (lens <= pol.seed_mms) | (lens < 2)
        nsf = n_count > nceil
        scf = lens.astype(np.int64) * pol.match_bonus < minsc
        qcf = np.zeros(lens.size, bool)
        for i, r in enumerate(records):
            if getattr(r, "qc_fail", False):
                qcf[i] = True
        yf = np.where(lenf, self.YF_LN,
                      np.where(nsf, self.YF_NS,
                               np.where(scf, self.YF_SC,
                                        np.where(qcf, self.YF_QC, 0))))
        return lenf | nsf | scf | qcf, yf.astype(np.int8)

    def _live_orient(self, B: int, paired: bool = False
                     ) -> Optional[np.ndarray]:
        """--nofw/--norc per-orientation-row liveness (rows < B fw, >= B
        rc), or None if both orientations are live. In paired mode the
        flags pertain to the fragment, so each mate's suppression flips
        with its expected orientation (bt2_search.cpp:3418-3424); mate-1
        reads are read indices [0, B/2), mate-2 [B/2, B)."""
        pol = self.pol
        if not (pol.nofw or pol.norc):
            return None
        live = np.ones(2 * B, bool)
        if not paired:
            if pol.nofw:
                live[:B] = False
            if pol.norc:
                live[B:] = False
            return live
        nb = B // 2
        for mate in (0, 1):
            matefw = pol.mate_fw_rc[mate] == "f"
            nofw_m = pol.nofw if matefw else pol.norc
            norc_m = pol.norc if matefw else pol.nofw
            if nofw_m:
                live[mate * nb:(mate + 1) * nb] = False
            if norc_m:
                live[B + mate * nb:B + (mate + 1) * nb] = False
        return live

    def _run_dp(self, win_start, rid, read_idx, orient, jboth, jquals,
                lens, G: int, Lmax: int, n: int, full_width: bool = False,
                diag_kernel: bool = False) -> DPPool:
        """Gather windows + run the banded DP for n problems (the
        rectangle DP's padded to a power of two, as the JAX package pads
        them); read/qual rows are gathered on the device.
        full_width: every column of the window is a rect column (the
        mate-rescue windows span the whole fragment range). diag_kernel:
        the band-coordinate DP (long reads) on the same rect-aligned
        windows."""
        pol = self.pol
        B = lens.size
        width = Lmax + 2 * G + 1
        # the band DP takes the live problems only: a padding problem would
        # run every one of up to 2^20 rows and keep their direction words,
        # and no walk reads it
        NC = max(n, 1) if diag_kernel else _pow2_at_least(max(n, 1))
        starts = np.zeros(NC, dtype=self._row_dtype)
        lo = np.zeros(NC, dtype=self._row_dtype)
        hi = np.zeros(NC, dtype=self._row_dtype)
        starts[:n] = win_start
        lo[:n] = self.data.ref_cum[rid]
        hi[:n] = self.data.ref_cum[rid + 1]
        wins = gather_windows(self.idx.ref_words, self.idx.refn_words,
                              self._put(starts), self._put(lo),
                              self._put(hi), width)
        cr = np.zeros(NC, dtype=np.int64)
        cr[:n] = read_idx
        co = np.zeros(NC, dtype=np.int64)
        co[:n] = orient
        jrows = self._put((co * B + cr).astype(np.int64))
        jreads_c = jboth.index_select(0, jrows)
        jquals_c = jquals.index_select(0, jrows)
        lens_c = np.maximum(lens[cr], 1).astype(np.int32)
        lens_c[n:] = 1
        jlens_c = self._put(lens_c)
        rect_cols = np.full(NC, width, np.int32) if full_width \
            else (lens_c + 2 * G + 1).astype(np.int32)
        if diag_kernel:
            res = sw_banded_diag(jreads_c, jquals_c, jlens_c, wins,
                                 pol.sw_params(), G)
        else:
            # the lanes past n pad to the power of two: not computed
            res = sw_banded(jreads_c, jquals_c, jlens_c, wins,
                            pol.sw_params(), G, self._put(rect_cols),
                            n_live=n)
        # ungapped mismatch count at the anchor diagonal (half-candidate
        # 1mm admission gate)
        diag = wins[:, G:G + Lmax]
        ar = torch.arange(Lmax, device=wins.device)
        mm_ug_d = (((jreads_c != diag) | (jreads_c >= 4))
                   & (ar[None, :] < jlens_c[:, None])).sum(dim=1)
        sw4 = _np(torch.stack([res.score.long(), res.row.long(),
                               res.lane.long(), mm_ug_d.long()]))
        ws = np.zeros(NC, dtype=np.int64)
        ws[:n] = win_start
        # the band DP's lanes are band columns: the pool keeps rect columns
        # (row + band column), so end_pos() and emission are the same for
        # both DPs, and the band column for backtrace_diag
        return DPPool(G=G, Lmax=Lmax, n=n, win_start=ws, rid=rid,
                      scores=sw4[0, :n].astype(np.int64), rows_end=sw4[1],
                      lanes_end=sw4[2] + (sw4[1] if diag_kernel else 0),
                      dirs=res.dirs, jreads=jreads_c, jquals=jquals_c,
                      wins=wins, mm_ug=sw4[3, :n], diag=diag_kernel,
                      band_lanes=sw4[2])

    # ---------------- phase 6: backtrace of chosen problems ----------------
    def _gapless_core(self, pool: DPPool, sel: np.ndarray,
                      codes_sel: np.ndarray, quals_sel: np.ndarray,
                      lens_sel: np.ndarray, end_sel: np.ndarray):
        """Vectorized gapless-diagonal readout for emission (e2e only).

        A candidate whose DP score equals the pure diagonal score ending at
        its best cell walks that diagonal exactly (the forward pass prefers
        DIAG on ties — see ops/sw.diag_readout for the induction), so its
        CIGAR/MD/edit counts can be synthesized from the reference words
        directly, skipping the device backtrace round trip. Returns
        (okg, eq, fc, g0, nmm, nrefn) over sel."""
        pol = self.pol
        p = pol.sw_params()
        L = lens_sel.astype(np.int64)
        rows_end = pool.rows_end[sel]
        rid = pool.rid[sel].astype(np.int64)
        lo = self.data.ref_cum[rid]
        hi = self.data.ref_cum[rid + 1]
        g0 = end_sel.astype(np.int64) - (L - 1)
        Lm = codes_sel.shape[1]
        ar = np.arange(Lm, dtype=np.int64)
        gp = g0[:, None] + ar[None, :]
        live = ar[None, :] < L[:, None]
        inref = (gp >= lo[:, None]) & (gp < hi[:, None])
        gpc = np.clip(gp, 0, int(self.data.ref_cum[-1]) - 1)
        rw = self.data.ref_words
        rn = self.data.refn_words
        fc = ((rw[gpc >> 4] >> (2 * (gpc & 15))) & 3).astype(np.int64)
        fc = np.where((rn[gpc >> 5] >> (gpc & 31)) & 1, 4, fc)
        fc = np.where(inref, fc, 5)
        rd = codes_sel.astype(np.int64)
        is_n = (rd >= 4) | (fc == 4)
        oob = fc >= 5
        eq = (fc == rd) & ~is_n & ~oob
        q = np.minimum(quals_sel.astype(np.int64), 40)
        mmpen = p.mm_pen_min + (q * (p.mm_pen_max - p.mm_pen_min)) // 40
        sub = np.where(eq, p.match_bonus,
                       np.where(is_n & ~oob, -p.n_pen, -mmpen))
        dscore = np.where(live & ~oob, sub, 0).sum(axis=1)
        okg = ~(live & oob).any(axis=1) \
            & (dscore == pool.scores[sel]) \
            & (rows_end == L - 1) \
            & (g0 >= pool.win_start[sel])   # full diagonal inside the rect
        nmm = ((live & ((~eq & (rd < 4) & (fc != 4)) | is_n))
               .astype(np.int64)).sum(axis=1)
        nrefn = (live & (fc == 4)).sum(axis=1)
        return okg, eq, fc, g0, nmm, nrefn

    def _gapless_tb(self, pool: DPPool, sel: np.ndarray,
                    codes_sel: np.ndarray, quals_sel: np.ndarray,
                    lens_sel: np.ndarray, end_sel: np.ndarray):
        """_gapless_core + per-candidate CIGAR/MD string synthesis.

        Returns (tb dict for the gapless members, remaining sel array)."""
        pol = self.pol
        if sel.size == 0 or pol.local:
            return {}, sel
        okg, eq, fc, g0, nmm, nrefn = self._gapless_core(
            pool, sel, codes_sel, quals_sel, lens_sel, end_sel)
        L = lens_sel.astype(np.int64)

        from bowtie2_tpu_torch.pipeline.backtrace import _REF_CHARS
        tb = {}
        sc_sel = pool.scores[sel]
        mop = "=" if pol.xeq else "M"
        for t in np.nonzero(okg)[0].tolist():
            k = int(sel[t])
            Lt = int(L[t])
            ev = np.nonzero(~eq[t, :Lt])[0]
            if pol.xeq and ev.size:
                key = eq[t, :Lt]
                change = np.nonzero(np.diff(key))[0]
                bounds = np.concatenate([[0], change + 1, [Lt]])
                cigar = [("=" if key[s] else "X", int(e - s))
                         for s, e in zip(bounds[:-1], bounds[1:])]
            else:
                cigar = [(mop, Lt)]
            parts = []
            prev = 0
            for e in ev.tolist():
                parts.append(str(e - prev))
                parts.append(_REF_CHARS[int(fc[t, e])])
                prev = e + 1
            parts.append(str(Lt - prev))
            sc = {"read_start": 0,
                  "ref_start_win": int(g0[t] - pool.win_start[k]),
                  "n_mm": int(nmm[t]), "n_go": 0, "n_gc": 0,
                  "n_refn": int(nrefn[t]),
                  "score_check": int(sc_sel[t]),
                  "cigar_ops": cigar, "md": "".join(parts)}
            tb[k] = (None, sc)
        return tb, sel[~okg]

    def _gapless_tb_raw(self, pool: DPPool, sel: np.ndarray,
                        codes_sel: np.ndarray, quals_sel: np.ndarray,
                        lens_sel: np.ndarray, end_sel: np.ndarray):
        """_gapless_core + VECTORIZED packed-op column synthesis for the
        native line builder (no per-candidate Python): gapless candidates
        get an all-OP_M walk column carrying (refchar, ismatch) bits, the
        same byte layout the device backtrace emits (ops/sw.py
        diag_readout), so the C decoder handles both uniformly.

        Returns (okg, ops_syn (nsel, Lmax) uint8 walk rows,
        ref_start_win, nmm, nrefn)."""
        from bowtie2_tpu_torch.ops.sw import OP_M
        if sel.size == 0 or self.pol.local:
            z = np.zeros(0, np.int64)
            return (np.zeros(0, bool),
                    np.zeros((0, codes_sel.shape[1]), np.uint8), z, z, z)
        okg, eq, fc, g0, nmm, nrefn = self._gapless_core(
            pool, sel, codes_sel, quals_sel, lens_sel, end_sel)
        L = lens_sel.astype(np.int64)
        Lm = codes_sel.shape[1]
        ar = np.arange(Lm, dtype=np.int64)
        pos = L[:, None] - 1 - ar[None, :]          # walk step -> read pos
        posc = np.clip(pos, 0, Lm - 1)
        opb = (OP_M
               | (np.take_along_axis(fc, posc, axis=1) << 2)
               | (np.take_along_axis(eq.astype(np.int64), posc, axis=1)
                  << 5))
        ops_syn = np.where(pos >= 0, opb, OP_NONE).astype(np.uint8)
        return okg, ops_syn, g0 - pool.win_start[sel], nmm, nrefn

    @TRACE.traced("host_backtrace")
    def _backtrace_sel(self, pool: DPPool, sel: np.ndarray):
        """Backtrace pool problems sel → {k: (opcol, scalars dict)}."""
        if sel.size == 0:
            return {}
        Bc = _pow2_at_least(sel.size, lo=64)
        sel_pad = np.zeros(Bc, np.int32)
        sel_pad[:sel.size] = sel
        jsel = self._put(sel_pad)
        jsel_dirs = jsel
        if pool.dplane is not None:
            # fused DP-lane bypass: dirs are indexed by compacted DP lane.
            # A candidate reaching the walk is gapped, hence DP'd; a -1
            # here would walk lane 0, which score_check downstream rejects
            n_miss = int((pool.dplane[sel] < 0).sum())
            if n_miss:
                sys.stderr.write(
                    f"warning: {n_miss} DP-bypassed candidates reached "
                    "the backtrace walk (gapless recompute mismatch); "
                    "their score_check will reject them\n")
                self.metrics.add(host_dplmiss=n_miss)
            jsel_dirs = self._put(
                np.clip(pool.dplane[sel_pad], 0, None).astype(np.int32))
        walk, lanes = ((backtrace_diag, pool.band_lanes) if pool.diag
                       else (backtrace, pool.lanes_end))
        bt = walk(pool.dirs, jsel_dirs,
                  self._put(pool.rows_end[sel_pad].astype(np.int32)),
                  self._put(lanes[sel_pad].astype(np.int32)),
                  pool.jreads.index_select(0, jsel.long()),
                  pool.jquals.index_select(0, jsel.long()),
                  pool.wins.index_select(0, jsel.long()),
                  self.pol.sw_params(), pool.G)
        sc_host = _np(torch.stack([getattr(bt, f) for f in BT_FIELDS]))
        ops_host = _np(bt.ops)                 # (S, Bc)
        out = {}
        for ci, k in enumerate(sel.tolist()):
            out[k] = (ops_host[:, ci],
                      {f: int(sc_host[fi, ci])
                       for fi, f in enumerate(BT_FIELDS)})
        self.metrics.add(backtraces=int(sel.size))
        return out

    # ---------------- SAM record construction ----------------
    def _emit_aligned(self, rec: SeqRecord, L: int, orient: int,
                      read_codes, read_quals, pool: DPPool, k: int,
                      tb, best: int, sec: Optional[int], mapq: int,
                      yt: str, flag_extra: int = 0, rnext: str = "*",
                      pnext: int = 0, tlen: int = 0,
                      ys: Optional[int] = None,
                      pending: Optional[list] = None
                      ) -> Optional[SamAlignment]:
        """One aligned record. pending: a list that takes the records
        whose CIGAR and MD:Z need the walk decoded, left blank for
        _decode_pending to fill in with one native call for the batch;
        without it such a record is decoded here on its own."""
        opcol, sc = tb
        if sc["score_check"] != int(pool.scores[k]):
            return None
        read_end = int(pool.rows_end[k]) + 1
        clip = sc["read_start"] + L - read_end
        if clip:
            self.metrics.add(clipped_records=1, clipped_bases=clip)
        walk = None
        if "cigar_ops" in sc:      # host gapless fast path (_gapless_tb)
            cigar, md = cigar_string(sc["cigar_ops"]), sc["md"]
        elif sc["n_mm"] == 0 and sc["n_gc"] == 0 and sc["n_refn"] == 0:
            span = read_end - sc["read_start"]
            cigar_ops = []
            if sc["read_start"] > 0:
                cigar_ops.append(("S", sc["read_start"]))
            cigar_ops.append(("=" if self.pol.xeq else "M", span))
            if read_end < L:
                cigar_ops.append(("S", L - read_end))
            cigar, md = cigar_string(cigar_ops), str(span)
        else:
            bound = (read_end - sc["read_start"]) + sc["n_gc"] + 1
            walk = (opcol[:bound], sc["read_start"], read_end, L, read_codes)
            if pending is None:
                cigar, md = self._decode_one(*walk)
            else:
                cigar = md = None
        r_id = int(pool.rid[k])
        g_start = int(pool.win_start[k]) + sc["ref_start_win"]
        roff = g_start - int(self.data.ref_cum[r_id])
        flag = flag_extra | (FLAG_REVERSE if orient else 0)
        opts = [("AS", "i", best)]
        if sec is not None:
            opts.append(("XS", "i", sec))
        opts += [("XN", "i", sc["n_refn"]),
                 ("XM", "i", sc["n_mm"]),
                 ("XO", "i", sc["n_go"]),
                 ("XG", "i", sc["n_gc"]),
                 ("NM", "i", sc["n_mm"] + sc["n_gc"]),
                 ("MD", "Z", md)]
        if ys is not None:
            opts.append(("YS", "i", ys))
        opts.append(("YT", "Z", yt))
        out = SamAlignment(
            qname=rec.name, flag=flag, rname=self.data.ref_names[r_id],
            pos=roff + 1, mapq=mapq, cigar=cigar,
            rnext=rnext, pnext=pnext, tlen=tlen,
            seq=decode_seq(read_codes.astype(np.uint8)).decode(),
            qual=qual_string(read_quals), opts=opts,
            raw_tags=getattr(rec, "tags", None))
        if cigar is None:
            pending.append((out, walk))
        return out

    def _decode_one(self, opcol, read_start, read_end, L, read_codes):
        """(CIGAR, MD:Z) of one walk by the per-record decoder."""
        self.metrics.add(host_decode_numpy=1)
        cigar_ops, md = cigar_md_from_packed(opcol, read_start, read_end, L,
                                             read=read_codes,
                                             xeq=self.pol.xeq)
        return cigar_string(cigar_ops), md

    def _decode_pending(self, pending: list) -> None:
        """Fill in the CIGAR and MD:Z of the records _emit_aligned left
        blank in pending: their walks, gathered into one op matrix, are
        decoded by one native cigar_md_batch call (by the per-record
        decoder where the native library cannot be built)."""
        if not pending:
            return
        walks = [w for _r, w in pending]
        try:
            from bowtie2_tpu_torch.native.samemit import cigar_md_batch
        except Exception:
            strs = [self._decode_one(*w) for w in walks]
        else:
            n = len(walks)
            bound = np.array([w[0].size for w in walks], np.int32)
            L = np.array([w[3] for w in walks], np.int32)
            S = max(int(bound.max()), 1)
            ops = np.full((n, S), OP_NONE, np.uint8)
            reads = np.full((n, max(int(L.max()), 1)), 4, np.int8)
            for i, (col, _rs, _re, Li, codes) in enumerate(walks):
                ops[i, :col.size] = col
                reads[i, :Li] = codes
            # one walk a row: as an (n * S, 1) op matrix the walk of record
            # i starts at row i * S and its steps lie one byte apart
            strs = zip(*cigar_md_batch(
                ops.reshape(-1, 1), np.arange(n) * S,
                np.array([w[1] for w in walks]),
                np.array([w[2] for w in walks]), L, bound, reads,
                xeq=self.pol.xeq))
            self.metrics.add(host_decode_native=n)
        for (rec, _w), (cigar, md) in zip(pending, strs):
            rec.cigar = cigar
            rec.opts = [("MD", "Z", md) if t == "MD" else (t, ty, v)
                        for t, ty, v in rec.opts]
        pending.clear()

    def _unaligned(self, rec: SeqRecord, yf: Optional[str] = None,
                   yt: str = "UU", flag_extra: int = 0, rname: str = "*",
                   pos: int = 0, rnext: str = "*",
                   pnext: int = 0) -> SamAlignment:
        opts = [("YT", "Z", yt)]
        if yf:
            opts.append(("YF", "Z", yf))
        return SamAlignment(
            qname=rec.name, flag=FLAG_UNMAPPED | flag_extra, rname=rname,
            pos=pos, mapq=0, cigar="*", rnext=rnext, pnext=pnext,
            seq=decode_seq(rec.seq.astype(np.uint8)).decode(),
            qual=qual_string(rec.qual), opts=opts,
            raw_tags=getattr(rec, "tags", None))

    def _mapq(self, best, sec, per, minsc, paired: bool = False) -> int:
        """MAPQ by the policy's --mapq-v version (V2 default)."""
        if self.pol.mapq_v == 3:
            from bowtie2_tpu_torch.pipeline.mapq import mapq_v3
            return mapq_v3(best, sec, per, minsc, paired)
        return mapq_v2(best, sec, per, minsc, self.pol.local)

    def _merge_stats(self, st: AlignStats) -> None:
        with self._stats_lock:
            self.stats.merge(st)
        self.metrics.add(reads=st.reads, unal=st.unal, al_one=st.al_one,
                         al_multi=st.al_multi)

    def _seed_offsets(self, lens, ival_boost=None, smax_min: int = 1,
                      nrounds: int = 1, max_seeds: int = 64):
        """Instantiated seed offsets of both orientations (host numpy):
        fw seeds start at depth d from the 5' end, rc seeds are anchored
        from the 3' end (reference instantiateSeeds aligner_seed.cpp:498).
        Round r of `nrounds` (the --seed-boost rerun pools the -R rounds)
        is offset by interval * r / nrounds. Returns (offs_all,
        valid_all), each (2B, smax): rows < B fw."""
        pol = self.pol
        B = lens.size
        slen = pol.seed_len
        nrounds = max(nrounds, 1)
        ulen, inv = np.unique(lens, return_inverse=True)
        ival_u = np.array([pol.interval(int(l)) if l else 1
                           for l in ulen], np.int32)
        ivals = ival_u[inv]
        if ival_boost is not None:
            # paired reads with both mates passing the filters get a
            # 20%-longer seed interval (bt2_search.cpp:3445-3448)
            ivals = np.where(ival_boost,
                             (ivals * 1.2 + 0.5).astype(np.int32), ivals)
            ivals = np.maximum(ivals, 1)
        base = (ivals[:, None] * np.arange(nrounds, dtype=np.int32)[None, :]
                ) // nrounds                             # (B, nrounds)
        per_round = np.arange(max_seeds, dtype=np.int32)
        offs = base[:, :, None] + per_round[None, None, :] \
            * ivals[:, None, None]
        valid_off = offs + slen <= lens[:, None, None]
        valid_off &= (np.arange(nrounds, dtype=np.int32)[None, :, None]
                      < ivals[:, None, None])
        offs = offs.reshape(B, -1)
        valid_off = valid_off.reshape(B, -1)
        nkeep = int(valid_off.sum(axis=1).max()) if B else 1
        smax = max(nkeep, smax_min, 1)
        smax = 1 << int(np.ceil(np.log2(smax)))          # bucket for stability
        order = np.argsort(~valid_off, axis=1, kind="stable")[:, :smax]
        valid_off = np.take_along_axis(valid_off, order, axis=1)
        offs = np.where(valid_off,
                        np.take_along_axis(offs, order, axis=1), 0)
        offs_rc = np.where(valid_off, lens[:, None] - offs - slen, 0)
        offs_all = np.concatenate([offs, offs_rc], axis=0).astype(np.int32)
        valid_all = np.concatenate([valid_off, valid_off], axis=0)
        return offs_all, valid_all

    # ------- host phase-by-phase path (fused DP-budget overflow) -------
    @TRACE.traced("host_search")
    def _search_candidates(self, records: Sequence[SeqRecord],
                           paired: bool = False,
                           nrounds: int = 1) -> "CandSet":
        """Phases 1-4 of the unfused path: searches → canonical candidate
        list (uncapped by the fused NC budget) → SA resolve → dedupe → DP.
        Device calls go through the same kernels as fused_se."""
        pol = self.pol
        B = len(records)
        fw, qu, rc, qu_r, lens = pad_reads(
            records, _bucket(max(max(int(r.seq.size) for r in records), 1)))
        Lmax = fw.shape[1]
        ulen, inv = np.unique(lens, return_inverse=True)
        minsc = np.array([pol.min_score(int(l)) if l else 0
                          for l in ulen], np.int64)[inv]
        perfect = np.array([pol.perfect_score(int(l)) if pol.local else 0
                            for l in ulen], np.int64)[inv]
        nceil = np.array([pol.nceil(int(l)) if l else 0
                          for l in ulen], np.int32)[inv]
        n_count = (fw >= 4).sum(axis=1) - (Lmax - lens)
        filtered, yf = self._filters(records, lens, n_count, nceil, minsc)
        cs = CandSet(B=B, Lmax=Lmax, lens=lens, fw=fw, qu=qu, rc=rc,
                     qu_r=qu_r, minsc=minsc, perfect=perfect,
                     filtered=filtered, yf=yf)

        # long reads (over the rectangle buckets): the whole-read exact
        # sweep and the half-read search, Lmax-step searches, are skipped
        # (an exact or one-mismatch hit at 8 kbp and more is vanishing, and
        # the seeds find the same alignment), and the DP is the band DP
        long_mode = Lmax > LEN_BUCKETS[-1]

        # phase 1+2: enqueue all three searches before reading any back
        both = np.concatenate([fw, rc], axis=0)          # (2B, Lmax) int8
        both_lens = np.concatenate([lens, lens])
        cs.jboth = self._put(both).to(torch.int32)
        cs.jquals = self._put(np.concatenate([qu, qu_r], axis=0)).to(
            torch.int32)
        if long_mode:
            z2 = np.zeros(2 * B, dtype=self._row_dtype)
            sweep_d = torch.from_numpy(np.stack(
                [z2, z2, np.full(2 * B, 99, np.int32).astype(z2.dtype)]))
        else:
            sweep = fm.exact_sweep(self.idx.fw, cs.jboth,
                                   self._put(both_lens))
            sweep_d = torch.stack([sweep.top, sweep.bot, sweep.nedit])
        # paired reads with both mates passing the filters get a boosted
        # seed interval; mate 2 of read i is read B/2 + i
        ival_boost = None
        if paired:
            okm = ~filtered
            ival_boost = okm & np.roll(okm, B // 2)
        seed_off, seed_mlen, seed_tb_d, sshape, cs.inst0 = \
            self._seed_search(fw, rc, lens, ival_boost, nrounds=nrounds,
                              max_seeds=512 if long_mode else 64)
        if long_mode:       # empty half-read ranges (top 1 > bot 0)
            half_off = np.zeros((2 * B, 2), np.int64)
            half_mlen = np.ones((2 * B, 2), np.int64)
            half_tb_d = torch.from_numpy(np.stack(
                [np.ones((2, 2 * B), self._row_dtype),
                 np.zeros((2, 2 * B), self._row_dtype)]).reshape(2, -1))
        else:
            half_off, half_mlen, half_tb_d = self._half_search(both,
                                                               both_lens)
        if pol.seed_mms >= 1:
            sh_off, sh_mlen, sh_tb_d = self._seed_half_search(fw, rc,
                                                              seed_off)
        sw_top, sw_bot, sw_ned = _np(sweep_d)
        if pol.no_exact:   # --no-exact-upfront: drop the exact-sweep phase
            sw_bot = sw_top.copy()
        cs.ee_elts = np.where((sw_ned == 0) & (sw_bot > sw_top),
                              sw_bot - sw_top, 0)
        st_bt = _np(seed_tb_d)
        seed_top = st_bt[0, :sshape[0]].reshape(sshape[1], sshape[2])
        seed_bot = st_bt[1, :sshape[0]].reshape(sshape[1], sshape[2])
        # per-read seed-hit demand for the --seed-boost gate
        # (SeedResults::averageHitsPerSeed, bt2_search.cpp:4146)
        sw_ = np.maximum(seed_bot - seed_top, 0)
        cs.seed_elts = sw_[:B].sum(axis=1) + sw_[B:].sum(axis=1)
        cs.seed_nz = (sw_[:B] > 0).sum(axis=1) + (sw_[B:] > 0).sum(axis=1)
        ht_bt = _np(half_tb_d)
        half_top = ht_bt[0].reshape(2, -1).T
        half_bot = ht_bt[1].reshape(2, -1).T
        if pol.no_1mm:   # --no-1mm-upfront: drop the 1-mismatch phase
            half_bot = half_top.copy()
        # merge half-read hits into the seed-range arrays (2B, smax+2)
        smax0 = seed_off.shape[1]
        seed_off = np.concatenate([seed_off, half_off], axis=1)
        seed_top = np.concatenate([seed_top, half_top], axis=1)
        seed_bot = np.concatenate([seed_bot, half_bot], axis=1)
        seed_mlen = np.concatenate([seed_mlen, half_mlen], axis=1)
        seed_half = np.zeros_like(seed_off, dtype=bool)
        seed_half[:, smax0:] = True
        if pol.seed_mms >= 1:
            st_sh = _np(sh_tb_d)
            nsh = sh_off.shape[1]
            seed_off = np.concatenate([seed_off, sh_off], axis=1)
            seed_top = np.concatenate(
                [seed_top, st_sh[0].reshape(2 * B, nsh)], axis=1)
            seed_bot = np.concatenate(
                [seed_bot, st_sh[1].reshape(2 * B, nsh)], axis=1)
            seed_mlen = np.concatenate([seed_mlen, sh_mlen], axis=1)
            seed_half = np.concatenate(
                [seed_half, np.zeros_like(sh_off, dtype=bool)], axis=1)
        self.metrics.add(
            fm_lf_steps=2 * B * Lmax + seed_off.size * 12
            + 2 * B * (Lmax // 2))

        # --nofw/--norc: suppressed orientation rows get empty SA ranges
        live_or = self._live_orient(B, paired)
        if live_or is not None:
            sw_bot = np.where(live_or, sw_bot, sw_top)
            seed_bot = np.where(live_or[:, None], seed_bot, seed_top)
        cs.sw_top, cs.sw_bot, cs.sw_ned = sw_top, sw_bot, sw_ned

        # phase 3: rank + resolve
        (cand_read, cand_or, cand_off, cand_row, cand_exact, cand_mlen,
         cand_half, cand_rangej, cand_rwidth) = \
            self._assemble_candidates(B, lens, filtered, sw_top, sw_bot,
                                      sw_ned, seed_off, seed_top,
                                      seed_bot, seed_mlen, seed_half)
        n_cand = cand_row.size
        if not n_cand:
            cs.n_cand = 0
            cs.cand_read = np.zeros(0, np.int64)
            return cs
        NR = _pow2_at_least(n_cand)
        rows_pad = np.zeros(NR, dtype=self._row_dtype)
        rows_pad[:n_cand] = cand_row
        jpos = _np(fm.sa_resolve(self.idx.fw, self._put(rows_pad),
                                 period=1 << self.data.off_rate)
                   )[:n_cand].astype(np.int64)

        # straddle filter: the matched stretch stays in one segment; for
        # half-read hits the whole read's joined extent must fit
        seg = np.searchsorted(self.data.seg_joined_start, jpos,
                              side="right") - 1
        ok = jpos + cand_mlen <= self._seg_end_joined[seg]
        r0 = jpos - cand_off
        full_ok = (r0 >= self.data.seg_joined_start[seg]) & \
                  (r0 + lens[cand_read] <= self._seg_end_joined[seg])
        ok &= ~cand_half | full_ok
        (cand_read, cand_or, cand_off, cand_exact, cand_half, cand_rangej,
         cand_rwidth, jpos, seg) = (
            a[ok] for a in (cand_read, cand_or, cand_off, cand_exact,
                            cand_half, cand_rangej, cand_rwidth, jpos, seg))
        self.metrics.add(sa_resolves=int(jpos.size))
        gpos = (self.data.seg_global_start[seg]
                + (jpos - self.data.seg_joined_start[seg]))
        anchor = gpos - cand_off
        rid = np.searchsorted(self.data.ref_cum, gpos, side="right") - 1

        # dedupe by (read, orient, anchor); canonical order keeps exacts;
        # source flags aggregate across the duplicate group
        key = (cand_read.astype(np.int64) * 2 + cand_or) * (1 << 40) \
            + (anchor + (1 << 35))
        uniq, first_raw, inv = np.unique(key, return_index=True,
                                         return_inverse=True)
        g_exact = np.zeros(uniq.size, bool)
        np.logical_or.at(g_exact, inv, cand_exact)
        g_half = np.zeros(uniq.size, bool)
        np.logical_or.at(g_half, inv, cand_half)
        g_seed = np.zeros(uniq.size, bool)
        np.logical_or.at(g_seed, inv, ~cand_exact & ~cand_half)
        first_idx = np.sort(first_raw)
        grp = inv[first_idx]
        (cand_read, cand_or, cand_rangej, cand_rwidth, anchor, rid) = (
            a[first_idx] for a in (cand_read, cand_or, cand_rangej,
                                   cand_rwidth, anchor, rid))
        cand_exact = g_exact[grp]
        cand_half = g_half[grp]
        cand_half_only = cand_half & ~g_seed[grp] & ~cand_exact

        # phase 4: windows + DP
        n_cand = anchor.size
        G = pol.band_halfwidth(Lmax)
        pool = self._run_dp(anchor - G, rid, cand_read, cand_or,
                            cs.jboth, cs.jquals, lens, G, Lmax, n_cand,
                            diag_kernel=long_mode)
        valid = pool.scores >= minsc[cand_read]
        # half-read candidates model the up-front 1-mismatch search: admit
        # them only when the implied ungapped alignment has <= 1 mismatch
        valid &= ~(cand_half_only & (pool.mm_ug > 1))
        self.metrics.add(
            dp_problems=n_cand,
            dp_cells=n_cand * Lmax * (Lmax + 2 * G + 1))
        cs.n_cand = n_cand
        cs.cand_read = cand_read
        cs.cand_or = cand_or
        cs.anchor = anchor
        cs.rid = rid
        cs.valid = valid
        cs.end_pos = pool.end_pos(np.arange(n_cand))
        cs.pool = pool
        cs.cand_exact = cand_exact
        cs.cand_half = cand_half
        cs.cand_rangej = cand_rangej
        cs.cand_rwidth = cand_rwidth
        return cs

    def _inst_counts(self, both, offs_all, valid_all):
        """# seeds per row surviving the N filter (reference
        instantiateSeeds skips seeds whose window holds an N)."""
        slen = self.pol.seed_len
        B2, Lmax = both.shape
        cumn = np.zeros((B2, Lmax + 1), np.int32)
        cumn[:, 1:] = np.cumsum(both >= 4, axis=1)
        o = np.clip(offs_all, 0, max(Lmax - slen, 0))
        nwin = np.take_along_axis(cumn, o + slen, axis=1) \
            - np.take_along_axis(cumn, o, axis=1)
        return (valid_all & (nwin == 0)).sum(axis=1)

    def _seed_search(self, fw, rc, lens, ival_boost=None, nrounds: int = 1,
                     max_seeds: int = 64):
        """Search the instantiated seeds of both orientations on the
        device (windows holding N die inside the search kernel)."""
        pol = self.pol
        B = fw.shape[0]
        slen = pol.seed_len
        offs_all, valid_all = self._seed_offsets(lens, ival_boost,
                                                 nrounds=nrounds,
                                                 max_seeds=max_seeds)
        smax = offs_all.shape[1]
        both = np.concatenate([fw, rc], axis=0).astype(np.int32)
        top, bot = fm.seed_search_offsets(
            self.idx.fw, self._put(both), self._put(offs_all),
            self._put(valid_all), slen, ftab_chars=self.data.fw.ftab_chars)
        mlen = np.full_like(offs_all, slen)
        return (offs_all, mlen, torch.stack([top, bot]),
                (2 * B * smax, 2 * B, smax),
                self._inst_counts(both, offs_all, valid_all))

    def _half_search(self, both, both_lens):
        """Pigeonhole half-read exact search (the reference's up-front
        1-mismatch search, SeedAligner::oneMmSearch aligner_seed.cpp:975):
        an end-to-end alignment with <= 1 edit has one exact half."""
        B2, Lmax = both.shape
        mid = both_lens // 2
        Hmax = Lmax // 2 + 1
        h1 = both[:, :Hmax].astype(np.int32)
        idx = np.minimum(mid[:, None]
                         + np.arange(Hmax, dtype=np.int32)[None, :], Lmax - 1)
        h2 = both[np.arange(B2)[:, None], idx].astype(np.int32)
        seqs = np.concatenate([h1, h2], axis=0)
        hlens = np.concatenate([mid, both_lens - mid]).astype(np.int32)
        top, bot = fm.substring_search(self.idx.fw, self._put(seqs),
                                       self._put(hlens))
        off = np.stack([np.zeros(B2, np.int32), mid], axis=1)
        mlen = np.stack([mid, both_lens - mid], axis=1)
        return off, mlen, torch.stack([top, bot])

    def _seed_half_search(self, fw, rc, seed_off):
        """-N 1: exact search of both halves of every instantiated seed."""
        pol = self.pol
        Lmax = fw.shape[1]
        slen = pol.seed_len
        hlen = slen // 2
        both = np.concatenate([fw, rc], axis=0).astype(np.int32)
        offs = np.concatenate([seed_off, seed_off + hlen], axis=1)
        offs = np.clip(offs, 0, Lmax - 1).astype(np.int32)
        valid = np.concatenate(
            [seed_off + slen <= np.full_like(seed_off, Lmax)] * 2, axis=1)
        top, bot = fm.seed_search_offsets(
            self.idx.fw, self._put(both), self._put(offs),
            self._put(valid), hlen,
            ftab_chars=min(self.data.fw.ftab_chars, hlen))
        mlen = np.full_like(offs, hlen)
        return offs.astype(np.int64), mlen.astype(np.int64), \
            torch.stack([top, bot])

    def _assemble_candidates(self, B, lens, filtered, sw_top, sw_bot,
                             sw_ned, seed_off, seed_top, seed_bot, seed_mlen,
                             seed_half):
        """Canonical-order candidate list under the per-read budget:
        exact end-to-end hits first (fw then rc), then seed/half SA ranges
        by ascending width, rows round-robin over ranges depth-major."""
        T = self.NC_PER_READ
        M2 = seed_off.shape[1]
        live_read = ~filtered & (lens > 0)

        ex_w = np.where((sw_ned == 0) & (sw_bot > sw_top),
                        sw_bot - sw_top, 0)              # (2B,)
        ex_w = np.minimum(ex_w, self.MAX_EXACT_ROWS)
        ex_w[:B][~live_read] = 0
        ex_w[B:][~live_read] = 0
        t_fw = np.minimum(ex_w[:B], T)
        t_rc = np.minimum(ex_w[B:], T - t_fw)
        rem = T - t_fw - t_rc                            # (B,)

        w = np.concatenate([seed_bot[:B] - seed_top[:B],
                            seed_bot[B:] - seed_top[B:]], axis=1)
        w = np.maximum(w, 0)
        w[~live_read] = 0
        tops = np.concatenate([seed_top[:B], seed_top[B:]], axis=1)
        offs = np.concatenate([seed_off[:B], seed_off[B:]], axis=1)
        mlens = np.concatenate([seed_mlen[:B], seed_mlen[B:]], axis=1)
        halfs = np.concatenate([seed_half[:B], seed_half[B:]], axis=1)
        oris = np.concatenate([np.zeros((B, M2), np.int64),
                               np.ones((B, M2), np.int64)], axis=1)
        dead = w == 0
        order = np.argsort(np.where(dead, 1 << 30, w), axis=1, kind="stable")
        w = np.take_along_axis(w, order, axis=1)
        tops = np.take_along_axis(tops, order, axis=1)
        offs = np.take_along_axis(offs, order, axis=1)
        mlens = np.take_along_axis(mlens, order, axis=1)
        halfs = np.take_along_axis(halfs, order, axis=1)
        oris = np.take_along_axis(oris, order, axis=1)

        # deepest full round D with sum_j min(w_j, D) <= rem, leftover to
        # the narrowest still-live ranges
        ds = np.arange(T + 1, dtype=np.int64)
        f = np.minimum(w[:, :, None], ds[None, None, :]).sum(axis=1)
        Dstar = np.maximum((f <= rem[:, None]).sum(axis=1) - 1, 0)
        used = np.take_along_axis(f, Dstar[:, None], axis=1)[:, 0]
        extra_budget = rem - used
        alive = w > Dstar[:, None]
        extra = alive & (np.cumsum(alive, axis=1) <= extra_budget[:, None])
        n = np.minimum(w, Dstar[:, None]) + extra        # (B, 2*M2)

        # emit: exacts (fw then rc), then (depth, range) order
        parts = []
        for oi, t_or in ((0, t_fw), (1, t_rc)):
            tot = int(t_or.sum())
            if tot:
                r_ids = np.repeat(np.arange(B), t_or)
                d = np.arange(tot) - np.repeat(np.cumsum(t_or) - t_or, t_or)
                ex_full = (sw_bot[oi * B:oi * B + B]
                           - sw_top[oi * B:oi * B + B])[r_ids]
                parts.append((r_ids, np.full(tot, oi, np.int64),
                              np.zeros(tot, np.int64),
                              (sw_top[oi * B:oi * B + B][r_ids]
                               + d).astype(np.int64),
                              np.ones(tot, bool),
                              lens[r_ids].astype(np.int64),
                              np.zeros(tot, bool),
                              np.full(tot, -2 + oi, np.int64),  # phase key
                              d,
                              np.full(tot, -2 + oi, np.int64),  # range id
                              ex_full.astype(np.int64)))        # width
        nf = n.reshape(-1)
        tot = int(nf.sum())
        if tot:
            flat_read = np.repeat(np.arange(B * 2 * M2) // (2 * M2), nf)
            flat_j = np.repeat(np.arange(B * 2 * M2) % (2 * M2), nf)
            d = np.arange(tot) - np.repeat(np.cumsum(nf) - nf, nf)
            parts.append((flat_read,
                          oris[flat_read, flat_j],
                          offs[flat_read, flat_j].astype(np.int64),
                          (tops[flat_read, flat_j] + d).astype(np.int64),
                          np.zeros(tot, bool),
                          mlens[flat_read, flat_j].astype(np.int64),
                          halfs[flat_read, flat_j],
                          d,                              # phase key: depth
                          flat_j,
                          flat_j.astype(np.int64),        # range id
                          w[flat_read, flat_j].astype(np.int64)))
        if not parts:
            z = np.zeros(0, np.int64)
            return (z, z.copy(), z.copy(), z.copy(),
                    np.zeros(0, bool), z.copy(), np.zeros(0, bool),
                    z.copy(), z.copy())
        cat = [np.concatenate([p[i] for p in parts]) for i in range(11)]
        key_order = np.lexsort((cat[8], cat[7], cat[0]))
        return (cat[0][key_order], cat[1][key_order].astype(np.int64),
                cat[2][key_order], cat[3][key_order],
                cat[4][key_order], cat[5][key_order], cat[6][key_order],
                cat[9][key_order], cat[10][key_order])

    def _rank_per_read(self, cs: "CandSet") -> Dict[int, List[int]]:
        """read → candidate indices: deduped by (orient, end), sorted by
        (-score, canonical order)."""
        by_read: Dict[int, List[int]] = {}
        if not cs.n_cand:
            return by_read
        scores = cs.pool.scores
        for k in np.nonzero(cs.valid)[0]:
            by_read.setdefault(int(cs.cand_read[k]), []).append(int(k))
        out = {}
        for ri, ks in by_read.items():
            seen = {}
            for k in ks:
                kk = (int(cs.cand_or[k]), int(cs.end_pos[k]))
                if kk not in seen or scores[k] > scores[seen[kk]]:
                    seen[kk] = k
            out[ri] = sorted(seen.values(),
                             key=lambda k: (-scores[k], ks.index(k)))
        return out

    def _oriented(self, cs: "CandSet", ri: int, orient: int):
        L = int(cs.lens[ri])
        if orient == 0:
            return cs.fw[ri, :L], cs.qu[ri, :L]
        return cs.rc[ri, :L], cs.qu_r[ri, :L]


@dataclass
class FusedBatch:
    """In-flight batch: the device blob + host-side context. submit()
    enqueues the device work and returns; collect*() reads the blob."""
    records: Sequence[SeqRecord]
    B: int
    Bp: int
    Lmax: int
    S: int
    kk: int
    kk_bt: int
    lens: np.ndarray
    fw: np.ndarray
    qu: np.ndarray
    rc: np.ndarray
    qu_r: np.ndarray
    minsc: np.ndarray
    perfect: np.ndarray
    filtered: np.ndarray
    yf: np.ndarray               # (Bp,) int8 filter-reason codes (YF_*)
    blob: torch.Tensor           # device (S*Bc + 4*meta,) uint8
    batch: int = -1              # submit's batch number (TRACE)

    @property
    def device(self) -> torch.device:
        return self.blob.device


class UnpairedAligner(BatchAligner):
    """Aligns batches of unpaired reads against a loaded index through
    the fused device pipeline."""

    def _ee_meta(self, fb: FusedBatch, meta: np.ndarray) -> np.ndarray:
        """The (8, Bp) exact-sweep / seed-demand block of the metadata."""
        base = 2 * fb.kk * fb.Bp + CHOSEN_FIELDS * fb.Bp * fb.kk_bt + 1
        return meta[base:base + 8 * fb.Bp].reshape(8, fb.Bp)

    def _ee_replay_overrides(self, fb: FusedBatch, meta: np.ndarray):
        """RNG-parity selection for exact-multimap reads: reads with >= 2
        exact end-to-end hits get the position(s) the reference's per-read
        LCG picks (pipeline/replay.py). Returns {read_idx: ([(rid, roff,
        orient), ...], maxed, n_alns, None)}."""
        if self.pol.local:
            return {}
        ee = self._ee_meta(fb, meta)
        top_fw = ee[0].astype(np.uint32).astype(np.int64) | \
            (ee[1].astype(np.int64) << 32)
        top_rc = ee[3].astype(np.uint32).astype(np.int64) | \
            (ee[4].astype(np.int64) << 32)
        return self._replay_from_ranges(
            fb.records, fb.lens, fb.filtered, fb.B,
            top_fw, ee[2], top_rc, ee[5])

    def _resolve(self, rows: List[int]) -> np.ndarray:
        """sa_resolve of host rows → joined offsets (int64)."""
        NR = _pow2_at_least(len(rows), lo=64)
        rows_pad = np.zeros(NR, dtype=self._row_dtype)
        rows_pad[:len(rows)] = rows
        return _np(fm.sa_resolve(self.idx.fw, self._put(rows_pad),
                                 period=1 << self.data.off_rate)
                   )[:len(rows)].astype(np.int64)

    def _joined_to_ref(self, jpos: np.ndarray):
        seg = np.searchsorted(self.data.seg_joined_start, jpos,
                              side="right") - 1
        gpos = (self.data.seg_global_start[seg]
                + (jpos - self.data.seg_joined_start[seg]))
        rid_all = np.searchsorted(self.data.ref_cum, gpos, side="right") - 1
        return seg, rid_all, gpos - self.data.ref_cum[rid_all]

    def _read_seed(self, rec) -> int:
        pol = self.pol
        if pol.non_deterministic:
            import random as _random
            return _random.getrandbits(32)
        from bowtie2_tpu_torch.pipeline.rng import gen_rand_seed, rng_name
        return int(gen_rand_seed(rec.seq, rec.qual + 33, rng_name(rec),
                                 seed=pol.rng_seed))

    def _replay_from_ranges(self, records, lens, filtered, B,
                            top_fw, w_fw, top_rc, w_rc):
        """Exact-multimap replay over the exact-sweep ranges."""
        pol = self.pol
        from bowtie2_tpu_torch.pipeline.replay import EE_MAXELT, replay_ee_read
        tot = w_fw.astype(np.int64) + w_rc
        app = (tot >= 2) & (tot <= EE_MAXELT) & ~filtered[:len(tot)] & \
            (np.arange(len(tot)) < B)
        idxs = np.nonzero(app)[0]
        if idxs.size == 0:
            return {}
        rows = []
        spans = []
        for ri in idxs:
            spans.append(len(rows))
            rows.extend(range(int(top_fw[ri]), int(top_fw[ri] + w_fw[ri])))
            rows.extend(range(int(top_rc[ri]), int(top_rc[ri] + w_rc[ri])))
        jpos = self._resolve(rows)
        seg, rid_all, roff_all = self._joined_to_ref(jpos)
        overrides = {}
        for t, ri in enumerate(idxs):
            s0 = spans[t]
            wf, wr = int(w_fw[ri]), int(w_rc[ri])
            L = int(lens[ri])
            ok = jpos[s0:s0 + wf + wr] + L <= \
                self._seg_end_joined[seg[s0:s0 + wf + wr]]
            res = replay_ee_read(self._read_seed(records[ri]), wf, wr,
                                 ok[:wf], ok[wf:],
                                 pol.khits, pol.mhits, pol.all_hits)
            if res is None:
                continue
            acc, perm, maxed = res
            recs = []
            for j in perm:
                ori, elt = acc[j]
                k = s0 + (elt if ori == 0 else wf + elt)
                recs.append((int(rid_all[k]), int(roff_all[k]), ori))
            overrides[int(ri)] = (recs, maxed, len(acc), None)
        return overrides

    def submit(self, records: Sequence[SeqRecord]) -> Optional[FusedBatch]:
        """Enqueue the fused device pipeline for one batch (no host sync).
        A batch with a read over the rectangle buckets is returned as
        ("long", records, batch number): collect runs it on the host path
        in long mode."""
        if not records:
            return None
        batch = TRACE.next_batch()
        with TRACE.span("submit"):
            self._take_turn()
            if max(int(r.seq.size) for r in records) > LEN_BUCKETS[-1]:
                return ("long", records, batch)
            return self._submit_fused(records, batch)

    def _submit_fused(self, records, batch: int) -> FusedBatch:
        pol = self.pol
        B = len(records)
        Bp = _round_batch(B, lo=256)
        fw, qu, rc, qu_r, lens = pad_reads(
            records, _bucket(max(max(int(r.seq.size) for r in records), 1)))
        Lmax = fw.shape[1]
        if Bp != B:
            pad = ((0, Bp - B), (0, 0))
            fw = np.pad(fw, pad, constant_values=4)
            qu = np.pad(qu, pad)
            rc = np.pad(rc, pad, constant_values=4)
            qu_r = np.pad(qu_r, pad)
            lens = np.pad(lens, (0, Bp - B))

        ulen, inv = np.unique(lens, return_inverse=True)
        minsc = np.array([pol.min_score(int(l)) if l else 0
                          for l in ulen], np.int64)[inv]
        perfect = np.array([pol.perfect_score(int(l)) if pol.local else 0
                            for l in ulen], np.int64)[inv]
        nceil = np.array([pol.nceil(int(l)) if l else 0
                          for l in ulen], np.int32)[inv]
        n_count = (fw >= 4).sum(axis=1) - (Lmax - lens)
        filtered, yf = self._filters(records, lens, n_count, nceil, minsc)
        live = ~filtered & (lens > 0)

        offs_all, valid_all = self._seed_offsets(lens)

        khits = 10**9 if pol.all_hits else pol.khits
        T = self.NC_PER_READ
        kk = min(max(khits, 1) + 1, T)
        kk_bt = min(max(khits, 1), T)
        G = pol.band_halfwidth(Lmax)
        NC = 2 * Bp
        W = Lmax + 2 * G + 1

        i32 = torch.int32
        jboth = self._put(np.concatenate([fw, rc], axis=0)).to(i32)
        jquals = self._put(np.concatenate([qu, qu_r], axis=0)).to(i32)
        live_or = self._live_orient(Bp)
        res = self._fused("se", (
            jboth, jquals, self._put(lens), self._put(offs_all),
            self._put(valid_all), self._put(minsc.astype(np.int32)),
            self._put(live),
            None if live_or is None else self._put(live_or)), dict(
            params=pol.sw_params(), band=G, seed_len=pol.seed_len,
            ftab_chars=self.data.fw.ftab_chars,
            half_ftab=min(self.data.fw.ftab_chars, pol.seed_len // 2),
            period=1 << self.data.off_rate, T=T, kk=kk, kk_bt=kk_bt,
            NC=NC, n1=pol.seed_mms >= 1, no_1mm=getattr(pol, "no_1mm", False),
            no_exact=getattr(pol, "no_exact", False), NCDP=max(Bp, 512)))
        self.metrics.add(
            bases=int(lens[:B].sum()),
            unpaired=B, unf_reads=int((~filtered[:B]).sum()),
            unf_bases=int(lens[:B][~filtered[:B]].sum()),
            ex_attempts=int(live.sum()), seed_searches=int(live.sum()),
            dp_problems=NC, dp_cells=NC * Lmax * W, backtraces=Bp * kk_bt,
            bt_walks=se_walks(Bp * kk_bt, pol.local))
        return FusedBatch(records=records, B=B, Bp=Bp, Lmax=Lmax,
                          S=bt_steps(Lmax, W, pol.local), kk=kk, kk_bt=kk_bt,
                          lens=lens, fw=fw, qu=qu, rc=rc, qu_r=qu_r,
                          minsc=minsc, perfect=perfect, filtered=filtered,
                          yf=yf, blob=res.blob, batch=batch)

    def _decode(self, fb: FusedBatch):
        """Read the batch's blob back and split it: (ops, meta, r_score,
        r_valid, chosen fields, replay overrides), or None when the fused
        DP budget overflowed and the host path must take the batch
        (counted in `overflow_batches`, its dropped candidates in
        `overflow_dropped`)."""
        kk, kk_bt, Bp, S = fb.kk, fb.kk_bt, fb.Bp, fb.S
        Bc = Bp * kk_bt
        blob = _np(fb.blob)
        ops = blob[:S * Bc].reshape(S, Bc)
        meta = blob[S * Bc:].view(np.int32)
        r_score = meta[:kk * Bp].reshape(kk, Bp)
        r_valid = meta[kk * Bp:2 * kk * Bp].reshape(kk, Bp) != 0
        ch = meta[2 * kk * Bp:2 * kk * Bp + CHOSEN_FIELDS * Bc]\
            .reshape(CHOSEN_FIELDS, Bc)
        n_dropped = int(meta[2 * kk * Bp + CHOSEN_FIELDS * Bc])
        if n_dropped > 0:
            # DP budget overflow: rerun the batch on the uncapped
            # phase-by-phase path (keeps output identical)
            self.metrics.add(host_batches=1, overflow_batches=1,
                             overflow_dropped=n_dropped)
            return None
        ovr = self._ee_replay_overrides(fb, meta)
        return ops, meta, r_score, r_valid, ch, ovr

    def collect(self, fb: Optional[FusedBatch]) -> List[SamAlignment]:
        """Block on a submitted batch's single transfer and emit SAM
        records as objects."""
        if fb is None:
            return []
        TRACE.batch = _batch_of(fb)
        with TRACE.span("collect"):
            self._use_batch(fb)
            if isinstance(fb, tuple) and fb[0] == "long":
                return self._align_batch_host(fb[1])
            pol = self.pol
            B, Bp, kk_bt = fb.B, fb.Bp, fb.kk_bt
            Bc = Bp * kk_bt
            dec = self._decode(fb)
            if dec is None:
                return self._align_batch_host(fb.records)
            ops, meta, r_score, r_valid, ch, ovr = dec
            (ch_ok, ch_or, ch_rid, ch_roff, ch_rdstart, ch_rdend, ch_nmm,
             ch_ngo, ch_ngc, ch_nrefn, ch_sccheck, ch_score) = ch
            khits = 10**9 if pol.all_hits else pol.khits
            st = AlignStats()
            out: List[SamAlignment] = []
            n_rank = r_valid.sum(axis=0)
            from bowtie2_tpu_torch.pipeline.traj_replay import traj_overrides
            ee = self._ee_meta(fb, meta)
            tovr = traj_overrides(self, fb, n_rank, ovr, rep_ctx=ee[6] > ee[7])

            # batched CIGAR/MD decode (native C; numpy fallback)
            n_rep = np.minimum(np.minimum(n_rank, khits), kk_bt)
            emit2 = (ch_ok.reshape(kk_bt, Bp).astype(bool)
                     & (np.arange(kk_bt)[:, None] < n_rep[None, :])
                     & (~fb.filtered & (np.arange(Bp) < B))[None, :]
                     & (ch_sccheck == ch_score).reshape(kk_bt, Bp))
            cis = np.nonzero(emit2.reshape(-1))[0].astype(np.int32)
            ri_arr = cis % Bp
            L_arr = fb.lens[ri_arr]
            codes_n = np.where((ch_or[cis] == 0)[:, None],
                               fb.fw[ri_arr], fb.rc[ri_arr])
            bound_n = (ch_rdend[cis] - ch_rdstart[cis]) + ch_ngc[cis] + 1
            decoded = np.full(Bc, -1, np.int32)
            decoded[cis] = np.arange(cis.size, dtype=np.int32)
            try:
                from bowtie2_tpu_torch.native.samemit import cigar_md_batch
                cigars, mds = cigar_md_batch(
                    ops, cis, ch_rdstart[cis], ch_rdend[cis], L_arr,
                    bound_n, codes_n, xeq=pol.xeq)
            except Exception:
                cigars, mds = [], []
                for t, ci in enumerate(cis.tolist()):
                    co, md = cigar_md_from_packed(
                        ops[:bound_n[t], ci], int(ch_rdstart[ci]),
                        int(ch_rdend[ci]), int(L_arr[t]),
                        read=codes_n[t, :L_arr[t]], xeq=pol.xeq)
                    cigars.append(cigar_string(co))
                    mds.append(md)
            for ri in range(B):
                rec = fb.records[ri]
                st.reads += 1
                L = int(fb.lens[ri])
                if fb.filtered[ri]:
                    st.filtered += 1
                    st.unal += 1
                    out.append(self._unaligned(
                        rec, self.YF_STR[int(fb.yf[ri])]))
                    continue
                if ri in ovr:
                    recs_o, _maxed_o, _cnt_o, _tp_o = ovr[ri]
                    out.extend(self._synth_replay_group(
                        rec, recs_o, _cnt_o, L, int(fb.minsc[ri]),
                        lambda o, _ri=ri, _L=L:
                        (fb.fw[_ri, :_L], fb.qu[_ri, :_L]) if o == 0
                        else (fb.rc[_ri, :_L], fb.qu_r[_ri, :_L]),
                        template=_tp_o))
                    st.al_multi += 1
                    continue
                if ri in tovr:
                    t_recs, t_nalns = tovr[ri]
                    out.extend(t_recs)
                    if t_nalns == 0:
                        st.unal += 1
                    elif t_nalns > 1:
                        st.al_multi += 1
                    else:
                        st.al_one += 1
                    continue
                nr = int(n_rank[ri])
                if nr == 0:
                    st.unal += 1
                    out.append(self._unaligned(rec))
                    continue
                n_report = min(nr, khits, kk_bt)
                n_emitted = 0
                for j in range(n_report):
                    ci = j * Bp + ri
                    if not ch_ok[ci]:
                        break
                    best = int(ch_score[ci])
                    if khits > 1:
                        sec = int(r_score[1, ri]) if nr > 1 else None
                        if j == 0 and sec is not None:
                            per = int(fb.perfect[ri]) if pol.local else 0
                            mq = self._mapq(best, sec, per, int(fb.minsc[ri]))
                        else:
                            mq = 255
                    else:
                        sec = int(r_score[1, ri]) if r_valid[1, ri] else None
                        per = int(fb.perfect[ri]) if pol.local else 0
                        mq = self._mapq(best, sec, per, int(fb.minsc[ri]))
                    di = decoded[ci]
                    if di < 0:
                        continue   # backtrace inconsistency: skip (safety net)
                    orient = int(ch_or[ci])
                    if orient == 0:
                        codes, quals = fb.fw[ri, :L], fb.qu[ri, :L]
                    else:
                        codes, quals = fb.rc[ri, :L], fb.qu_r[ri, :L]
                    flag = (FLAG_REVERSE if orient else 0) \
                        | (0x100 if n_emitted > 0 else 0)
                    opts = [("AS", "i", best)]
                    if sec is not None:
                        opts.append(("XS", "i", sec))
                    opts += [("XN", "i", int(ch_nrefn[ci])),
                             ("XM", "i", int(ch_nmm[ci])),
                             ("XO", "i", int(ch_ngo[ci])),
                             ("XG", "i", int(ch_ngc[ci])),
                             ("NM", "i", int(ch_nmm[ci] + ch_ngc[ci])),
                             ("MD", "Z", mds[di]), ("YT", "Z", "UU")]
                    out.append(SamAlignment(
                        qname=rec.name, flag=flag,
                        rname=self.data.ref_names[int(ch_rid[ci])],
                        pos=int(ch_roff[ci]) + 1, mapq=mq,
                        cigar=cigars[di],
                        seq=decode_seq(codes.astype(np.uint8)).decode(),
                        qual=qual_string(quals), opts=opts))
                    n_emitted += 1
                if n_emitted == 0:
                    st.unal += 1
                    out.append(self._unaligned(rec))
                elif nr > 1:
                    st.al_multi += 1
                else:
                    st.al_one += 1
            self._merge_stats(st)
            return out

    def align_batch(self, records: Sequence[SeqRecord]) -> List[SamAlignment]:
        return self.collect(self.submit(records))

    @staticmethod
    def _groups_from_objects(records, out, suffix):
        """Per-read (flag, line) groups of a flat SamAlignment list: each
        read's primary record and the secondaries that follow it."""
        groups, t = [], 0
        for rec in records:
            grp = [(out[t].flag, out[t].line().encode() + suffix)]
            t += 1
            while t < len(out) and out[t].qname == rec.name \
                    and out[t].flag & 0x100:
                grp.append((out[t].flag, out[t].line().encode() + suffix))
                t += 1
            groups.append(grp)
        return groups

    def collect_raw(self, fb: Optional[FusedBatch], suffix: bytes = b""
                    ) -> List[List[Tuple[int, bytes]]]:
        """collect(), but emit finished SAM line bytes via the native line
        builder: one group per read, each entry (flag, line). `suffix` is
        appended to every line (RG)."""
        if fb is None:
            return []
        TRACE.batch = _batch_of(fb)
        with TRACE.span("collect"):
            self._use_batch(fb)
            if isinstance(fb, tuple) and fb[0] == "long":
                return self._groups_from_objects(
                    fb[1], self._align_batch_host(fb[1]), suffix)
            dec = self._decode(fb)
            if dec is None:
                return self._groups_from_objects(
                    fb.records, self._align_batch_host(fb.records), suffix)
            with TRACE.span("emit_fused"):
                return self._emit_fused_raw(fb, dec, suffix)

    def _emit_fused_raw(self, fb: FusedBatch, dec, suffix: bytes
                        ) -> List[List[Tuple[int, bytes]]]:
        """collect_raw's fused emission of a decoded batch: the replay
        overrides, the native CIGAR/MD and line builder, the groups."""
        from bowtie2_tpu_torch.native.samemit import (RefNameTable, XS_OMIT,
                                                      sam_tails_batch)
        pol = self.pol
        B, Bp, kk, kk_bt = fb.B, fb.Bp, fb.kk, fb.kk_bt
        ops, meta, r_score, r_valid, ch, ovr = dec
        (ch_ok, ch_or, ch_rid, ch_roff, ch_rdstart, ch_rdend, ch_nmm,
         ch_ngo, ch_ngc, ch_nrefn, ch_sccheck, ch_score) = ch

        khits = 10**9 if pol.all_hits else pol.khits
        n_rank = r_valid.sum(axis=0)
        from bowtie2_tpu_torch.pipeline.traj_replay import traj_overrides
        ee = self._ee_meta(fb, meta)
        tovr = traj_overrides(self, fb, n_rank, ovr, rep_ctx=ee[6] > ee[7])
        n_rep = np.minimum(np.minimum(n_rank, khits), kk_bt)
        live_col = ~fb.filtered & (np.arange(Bp) < B)
        emit2 = (ch_ok.reshape(kk_bt, Bp).astype(bool)
                 & (np.arange(kk_bt)[:, None] < n_rep[None, :])
                 & live_col[None, :]
                 & (ch_sccheck == ch_score).reshape(kk_bt, Bp))
        if ovr:
            ovr_arr = np.zeros(Bp, bool)
            ovr_arr[list(ovr)] = True
            emit2 &= ~ovr_arr[None, :]   # replay reads emit synth groups
        if tovr:
            tovr_arr = np.zeros(Bp, bool)
            tovr_arr[list(tovr)] = True
            emit2 &= ~tovr_arr[None, :]  # trajectory-replay groups below
        n_emit = emit2.sum(axis=0)
        unal = (np.arange(Bp) < B) & (n_emit == 0)
        if ovr:
            unal &= ~ovr_arr
        if tovr:
            unal &= ~tovr_arr

        # record table: aligned records (ci order) then unaligned reads
        cis = np.nonzero(emit2.reshape(-1))[0].astype(np.int32)
        ri_al = cis % Bp
        ri_un = np.nonzero(unal)[0].astype(np.int32)
        nal, nun = cis.size, ri_un.size
        ri_all = np.concatenate([ri_al, ri_un])
        L_all = fb.lens[ri_all]
        orient = np.zeros(nal + nun, np.int32)
        orient[:nal] = ch_or[cis]
        codes_n = np.where((orient == 0)[:, None],
                           fb.fw[ri_all], fb.rc[ri_all])
        quals_n = np.where((orient == 0)[:, None],
                           fb.qu[ri_all], fb.qu_r[ri_all])

        mode = np.zeros(nal + nun, np.int8)
        mode[:nal] = 1
        mode[nal:] = fb.yf[ri_un]      # 0 or the YF reason code
        flag = np.zeros(nal + nun, np.int32)
        # secondary = per-read EMISSION rank > 0
        emit_rank = np.cumsum(emit2, axis=0).reshape(-1)[cis]   # 1-based
        flag[:nal] = (orient[:nal] != 0) * 0x10 + (emit_rank > 1) * 0x100
        flag[nal:] = FLAG_UNMAPPED

        # MAPQ + XS (khits == 1) / 255 (k/a mode)
        mapq = np.full(nal + nun, 255, np.int32)
        xs = np.full(nal + nun, XS_OMIT, np.int32)
        has2 = r_valid[1] if kk > 1 else np.zeros(Bp, bool)
        if khits == 1:
            for t in range(nal):
                ri = ri_al[t]
                sec = int(r_score[1, ri]) if has2[ri] else None
                per = int(fb.perfect[ri]) if pol.local else 0
                mapq[t] = self._mapq(int(ch_score[cis[t]]), sec, per,
                                     int(fb.minsc[ri]))
                if sec is not None:
                    xs[t] = sec
        else:
            first = emit_rank == 1
            xs[:nal] = np.where(has2[ri_al], r_score[1, ri_al]
                                if kk > 1 else XS_OMIT, XS_OMIT)
            for t in np.nonzero(first & has2[ri_al])[0]:
                ri = ri_al[t]
                per = int(fb.perfect[ri]) if pol.local else 0
                mapq[t] = self._mapq(int(ch_score[cis[t]]),
                                     int(r_score[1, ri]), per,
                                     int(fb.minsc[ri]))

        live = ~fb.filtered & (np.arange(Bp) < B)
        wf, wr = ee[2], ee[5]
        self.metrics.add(
            ex_ranges=int(((wf > 0) & live).sum() + ((wr > 0) & live).sum()),
            ex_rows=int(wf[live].sum() + wr[live].sum()),
            ex_succ=int((((wf + wr) > 0) & live).sum()),
            seed_nrange=int(ee[7][live].sum()),
            seed_nelt=int(ee[6][live].sum()),
            mm1_attempts=int(live.sum()), mm1_ranges=0)
        if self.dp_log is not None:
            for t in range(nal):
                ri = int(ri_al[t])
                self.dp_log.write(
                    f"{fb.records[ri].name}\t{'-' if orient[t] else '+'},"
                    f"{int(ch_rid[cis[t]])},{int(ch_roff[cis[t]])},"
                    f"{int(fb.minsc[ri])},{int(ch_score[cis[t]])}\n")
        if self._names_tab is None:
            self._names_tab = RefNameTable(self.data.ref_names)
        z = np.zeros(nal + nun, np.int32)
        tails = sam_tails_batch(
            mode, flag, np.concatenate([ch_rid[cis], z[nal:]]),
            np.concatenate([ch_roff[cis] + 1, z[nal:]]), mapq,
            np.concatenate([ch_score[cis], z[nal:]]), xs,
            np.concatenate([ch_nrefn[cis], z[nal:]]),
            np.concatenate([ch_nmm[cis], z[nal:]]),
            np.concatenate([ch_ngo[cis], z[nal:]]),
            np.concatenate([ch_ngc[cis], z[nal:]]),
            codes_n, quals_n, L_all, ops,
            np.concatenate([cis, z[nal:]]),
            np.concatenate([ch_rdstart[cis], z[nal:]]),
            np.concatenate([ch_rdend[cis], z[nal:]]),
            np.concatenate([(ch_rdend[cis] - ch_rdstart[cis])
                            + ch_ngc[cis] + 1, z[nal:]]),
            self._names_tab, suffix, xeq=self.pol.xeq)

        # group per read, aligned ranks ascending
        groups: List[List[Tuple[int, bytes]]] = [[] for _ in range(B)]

        def _tg(rec):
            tg = getattr(rec, "tags", None)
            return tg.encode() if tg else b""

        for t in range(nal):
            rec_t = fb.records[ri_al[t]]
            groups[ri_al[t]].append(
                (int(flag[t]), rec_t.name.encode() + tails[t] + _tg(rec_t)))
        for t in range(nun):
            rec_t = fb.records[ri_un[t]]
            groups[ri_un[t]].append(
                (int(flag[nal + t]),
                 rec_t.name.encode() + tails[nal + t] + _tg(rec_t)))
        for ri_o, (recs_o, _maxed_o, _cnt_o, _tp_o) in ovr.items():
            L_o = int(fb.lens[ri_o])
            rec_o = fb.records[ri_o]
            for r in self._synth_replay_group(
                    rec_o, recs_o, _cnt_o, L_o, int(fb.minsc[ri_o]),
                    lambda o, _ri=ri_o, _L=L_o:
                    (fb.fw[_ri, :_L], fb.qu[_ri, :_L]) if o == 0
                    else (fb.rc[_ri, :_L], fb.qu_r[_ri, :_L]),
                    template=_tp_o):
                groups[ri_o].append((r.flag, r.line().encode() + suffix))
        n_t_unal = n_t_multi = n_t_one = 0
        for ri_t, (t_recs, t_nalns) in tovr.items():
            for r in t_recs:
                groups[ri_t].append((r.flag, r.line().encode() + suffix))
            if t_nalns == 0:
                n_t_unal += 1
            elif t_nalns > 1:
                n_t_multi += 1
            else:
                n_t_one += 1

        st = AlignStats()
        st.reads = B
        st.filtered = int(fb.filtered[:B].sum())
        st.unal = int(unal.sum()) + n_t_unal
        multi = (n_emit > 0) & (n_rank > 1) & live_col
        st.al_multi = int(multi.sum()) + len(ovr) + n_t_multi
        st.al_one = int(((n_emit > 0) & ~multi).sum()) + n_t_one
        self._merge_stats(st)
        return groups

    def _synth_replay_group(self, rec: SeqRecord, recs, cnt: int, L: int,
                            minsc_ri: int, oriented,
                            template: dict = None) -> List[SamAlignment]:
        """SAM record group of an RNG-replayed exact-multimap read: clones
        of one perfect end-to-end record differing in position and
        orientation. recs: [(rid, roff, orient)] in reference priority
        order; cnt: alignments found; oriented: orient → (codes, quals)."""
        pol = self.pol
        kmode = pol.all_hits or pol.khits > 1 or pol.mhits == 0
        has_sec = cnt > 1
        tp = template or dict(as_=0, xm=0, md=str(L),
                              cigar=f"{L}{'=' if pol.xeq else 'M'}")
        mq0 = self._mapq(tp["as_"], tp["as_"] if has_sec else None, 0,
                         minsc_ri)
        out = []
        for j, (rid_, roff_, ori) in enumerate(recs):
            codes, quals = oriented(ori)
            flag = (FLAG_REVERSE if ori else 0) | (0x100 if j else 0)
            if kmode:
                mq = mq0 if (j == 0 and has_sec) else 255
            else:
                mq = mq0
            opts = [("AS", "i", tp["as_"])]
            if has_sec:
                opts.append(("XS", "i", tp["as_"]))
            opts += [("XN", "i", 0),
                     ("XM", "i", tp["xm"]), ("XO", "i", 0), ("XG", "i", 0),
                     ("NM", "i", tp["xm"]), ("MD", "Z", tp["md"]),
                     ("YT", "Z", "UU")]
            out.append(SamAlignment(
                qname=rec.name, flag=flag,
                rname=self.data.ref_names[rid_], pos=roff_ + 1, mapq=mq,
                cigar=tp["cigar"],
                seq=decode_seq(codes.astype(np.uint8)).decode(),
                qual=qual_string(quals), opts=opts))
        return out

    def _se_effort_filter(self, cs: CandSet) -> None:
        """SE -D fail-streak model (bt2_search.cpp:464-472, the unpaired
        extendSeeds loop): an attempt that does not produce a NEW valid
        alignment builds the streak; `-D` consecutive fails end the phase;
        maxIters(400)/maxDp(300) are hard per-read caps. Phases (exact,
        1mm/half, seed) each reset the streak; ranges are visited
        width-ascending round-robin. Candidates the reference would never
        have attempted are marked invalid (cs.valid &= attempted)."""
        pol = self.pol
        if pol.all_hits or not cs.n_cand:
            return
        from bowtie2_tpu_torch.pipeline.pe_effort import (attempt_order,
                                                          pe_streak_limit)
        limit = pe_streak_limit(pol.fail_streak, pol.khits, False)
        MAX_ITERS, MAX_DP = 400, 300
        by_read: Dict[int, List[int]] = {}
        for k in range(cs.n_cand):
            by_read.setdefault(int(cs.cand_read[k]), []).append(k)
        drop: List[int] = []
        for ri, ks in by_read.items():
            if len(ks) <= limit:      # no phase can build a full streak
                continue
            exact = [k for k in ks if cs.cand_exact[k]]
            halfp = [k for k in ks
                     if cs.cand_half[k] and not cs.cand_exact[k]]
            seedp = [k for k in ks
                     if not cs.cand_exact[k] and not cs.cand_half[k]]
            iters = 0
            seen_ends = set()
            hard_stop = False
            for ks_p in (exact, halfp, seedp):
                if hard_stop or not ks_p:
                    continue
                order = attempt_order(ks_p, cs.cand_rangej, cs.cand_rwidth)
                streak = 0
                for k in order:
                    if iters >= min(MAX_ITERS, MAX_DP):
                        hard_stop = True
                    if hard_stop or streak >= limit:
                        drop.append(k)
                        continue
                    iters += 1
                    key = (int(cs.cand_or[k]), int(cs.end_pos[k]))
                    if cs.valid[k] and key not in seen_ends:
                        seen_ends.add(key)
                        streak = 0
                    else:
                        streak += 1
        if drop:
            cs.valid[np.array(drop, np.int64)] = False

    @TRACE.traced("host_path")
    def _align_batch_host(self, records: Sequence[SeqRecord],
                          nrounds: int = 1,
                          _merge: bool = True) -> List[SamAlignment]:
        """Phase-by-phase path for a batch whose fused DP budget
        overflowed, or that holds a read over the rectangle buckets (long
        mode, see _search_candidates): uncapped candidate search, -D
        effort model, ranking, backtrace, replay overrides and the
        --seed-boost rerun of ultra-repetitive reads
        (bowtie2_tpu/pipeline/align.py _align_batch_host, single-end)."""
        if not records:
            return []
        pol = self.pol
        khits = 10**9 if pol.all_hits else pol.khits
        cs = self._search_candidates(records, nrounds=nrounds)
        self._se_effort_filter(cs)
        ranked = self._rank_per_read(cs)
        B = len(records)
        ovr = {}
        if not pol.local and cs.sw_top is not None:
            ee_wf = np.where((cs.sw_ned[:B] == 0)
                             & (cs.sw_bot[:B] > cs.sw_top[:B]),
                             cs.sw_bot[:B] - cs.sw_top[:B], 0)
            ee_wr = np.where((cs.sw_ned[B:] == 0)
                             & (cs.sw_bot[B:] > cs.sw_top[B:]),
                             cs.sw_bot[B:] - cs.sw_top[B:], 0)
            ovr = self._replay_from_ranges(
                records, cs.lens, cs.filtered, B,
                cs.sw_top[:B].astype(np.int64), ee_wf,
                cs.sw_top[B:].astype(np.int64), ee_wr)
        chosen = {ri: ks[:max(khits, 1) + (0 if khits > 1 else 1)]
                  for ri, ks in ranked.items()}
        sel = np.array(sorted({k for ks in chosen.values() for k in ks}),
                       np.int32)
        tb_of = self._backtrace_sel(cs.pool, sel) if chosen else {}

        with TRACE.span("host_emit"):
            st = AlignStats()
            out: List[SamAlignment] = []
            pending: list = []
            # per-read class for the summary (0=unal, 1=unique, 2=multi);
            # the group replacements below update it
            cls = np.zeros(B, np.int8)
            rd_start = np.zeros(len(records) + 1, np.int64)
            for ri, rec in enumerate(records):
                rd_start[ri] = len(out)
                st.reads += 1
                L = int(cs.lens[ri])
                if cs.filtered[ri]:
                    st.filtered += 1
                    out.append(self._unaligned(
                        rec, self.YF_STR[int(cs.yf[ri])]))
                    continue
                ks = chosen.get(ri)
                if not ks:
                    out.append(self._unaligned(rec))
                    continue
                scores = cs.pool.scores
                n_report = min(len(ks), khits)
                n_emitted = 0
                for rank, k in enumerate(ks[:n_report]):
                    best = int(scores[k])
                    if khits > 1:
                        sec = int(scores[ks[1]]) if len(ks) > 1 else None
                        if rank == 0 and sec is not None:
                            per = int(cs.perfect[ri]) if pol.local else 0
                            mq = self._mapq(best, sec, per, int(cs.minsc[ri]))
                        else:
                            mq = 255
                    else:
                        sec_k = ks[1] if len(ks) > 1 else None
                        sec = int(scores[sec_k]) if sec_k is not None else None
                        per = int(cs.perfect[ri]) if pol.local else 0
                        mq = self._mapq(best, sec, per, int(cs.minsc[ri]))
                    orient = int(cs.cand_or[k])
                    codes, quals = self._oriented(cs, ri, orient)
                    flag_extra = 0x100 if n_emitted > 0 else 0
                    rec_out = self._emit_aligned(
                        rec, L, orient, codes, quals, cs.pool, k, tb_of[k],
                        best, sec, mq, "UU", flag_extra, pending=pending)
                    if rec_out is not None:
                        out.append(rec_out)
                        n_emitted += 1
                if n_emitted == 0:
                    out.append(self._unaligned(rec))
                elif len(ks) > 1:
                    cls[ri] = 2
                else:
                    cls[ri] = 1
            self._decode_pending(pending)
        rd_start[len(records)] = len(out)
        repl = {}
        for ri in ovr:
            recs_o, _maxed_o, _cnt_o, _tp_o = ovr[ri]
            repl[ri] = self._synth_replay_group(
                records[ri], recs_o, _cnt_o, int(cs.lens[ri]),
                int(cs.minsc[ri]),
                lambda o, _ri=ri: self._oriented(cs, _ri, o),
                template=_tp_o)
            cls[ri] = 2 if _cnt_o > 1 else 1
        # --seed-boost re-seeding rounds (bt2_search.cpp:3881): a read
        # continues into round 1+ only when its average seed range is
        # >= seedBoostThresh elements; those reads rerun with the pooled
        # round-0..R-1 seed offsets
        if nrounds == 1 and pol.seed_rounds > 1 and not pol.local \
                and cs.seed_nz is not None:
            gated = [ri for ri in range(B)
                     if ri not in repl and not cs.filtered[ri]
                     and cs.seed_nz[ri] > 0
                     and cs.seed_elts[ri] / cs.seed_nz[ri]
                     >= self.pol.seed_boost]
            if gated:
                sub = self._align_batch_host([records[i] for i in gated],
                                             nrounds=pol.seed_rounds,
                                             _merge=False)
                t = 0
                for gi, ri in enumerate(gated):
                    grp = [sub[t]]
                    t += 1
                    while t < len(sub) and (sub[t].flag & 0x100):
                        grp.append(sub[t])
                        t += 1
                    repl[ri] = grp
        # trajectory-RNG replay (pipeline/traj_replay.py): it models the
        # full round schedule, so it supersedes the seed-boost group
        from bowtie2_tpu_torch.pipeline import traj_replay as _traj
        if _merge and nrounds == 1 and _traj.eligible(pol):
            rep_ctx = (cs.seed_nz is not None
                       and (cs.seed_elts > cs.seed_nz))
            tris = [ri for ri in range(B)
                    if not cs.filtered[ri] and ri not in ovr
                    and cls[ri] != 0
                    and (len(ranked.get(ri, ())) >= 2
                         or (rep_ctx is not False and bool(rep_ctx[ri])))]
            if tris:
                preds = _traj.run_replays(self, records, tris)
                if preds:
                    import types as _types
                    shim = _types.SimpleNamespace(
                        records=records, B=B, lens=cs.lens, fw=cs.fw,
                        rc=cs.rc, qu=cs.qu, qu_r=cs.qu_r, minsc=cs.minsc,
                        Lmax=cs.Lmax, filtered=cs.filtered)
                    tout = _traj.emit_overrides(self, shim, preds)
                    if tout:
                        self.metrics.add(traj_overridden=len(tout))
                    for ri, t_recs in tout.items():
                        repl[ri] = t_recs
                        n_t = preds[ri].nalns
                        cls[ri] = 0 if n_t == 0 else (2 if n_t > 1 else 1)
        for ri in sorted(repl, reverse=True):
            out[int(rd_start[ri]):int(rd_start[ri + 1])] = repl[ri]
        st.unal = int((cls == 0).sum())
        st.al_one = int((cls == 1).sum())
        st.al_multi = int((cls == 2).sum())
        if _merge:
            self._merge_stats(st)
        return out
