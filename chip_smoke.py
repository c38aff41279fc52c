#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bowtie2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads 50000] [--batch 8192] [--seed 7]
                          [--pairs 50000] [--mixed 1024] [--long-reads 1024]
                          [--compare-parent DIR]

Phases, each of which exits non-zero when it fails:

1. The card: prints `nvidia-smi`'s name and power limit and the torch and
   CUDA versions, then builds every CUDA kernel of the port from
   `bowtie2_tpu_torch/csrc/` (one nvcc process per source, all at once)
   and prints each kernel's registers, spills and shared memory as
   `ptxas -v` reports them (the `ptxas:` line).
2. The corpus: the default genome of scripts/make_repcorpus.py (5 Mbp,
   1200 Alu-like copies, 5 tandem arrays) and --reads 100-bp reads drawn
   from it with --seed, as that script draws them. The index is built on
   the host and its tables are moved to the card.
3. The main path: `UnpairedAligner.submit` / `collect_raw` over batches of
   --batch reads, driven as bench.py's run() drives the JAX package, at
   --sensitive defaults (end to end). The kernel launch counts are set to 0
   just before and read just after: every kernel must have launched, and
   no plain PyTorch version may have run. Then the same run once more,
   with a fresh aligner, apart from the timed window: CUDA events around
   every kernel launch give each kernel's total device time over the run,
   printed with
   the sum's share of the main path's wall time (the `device time:`
   line), a lower bound on the card's busy share; the `call shapes:` line
   splits the walk's and the SA walk's totals by the sizes that pick
   their kernels' launch shape, and the seed and half-read searches'
   totals by their calls' sizes.
4. The output: the SAM groups of the first batch must be byte-identical
   to the same aligner's run with device="cpu" (the plain versions).
5. The --local path: the first batch again with --sensitive-local, with
   its own counts and the same two checks.
6. The kernels: each kernel is run again on the inputs the end-to-end
   path gave it first and held to its plain version on the same card
   tensors (exact equality: every contract is integer; the rectangle DP
   over what its n_live contract specifies, ops/sw.py SWResult: the live
   lanes' fields and dirs rows below each read's length, and the dead
   lanes' fill; the SE host path's first DP call too), and so are the
   inputs the --local path gave it and, for the walk and the SA walk, the
   first end-to-end call large enough to take another launch shape, and
   for the seed and half-read searches the first end-to-end call of
   another size than their first (the host path's; the `bulk` entry);
   the end-to-end ones are timed with
   CUDA events, back to back (`ms`) and each launch alone after the card
   has idled IDLE_S seconds (`idle_ms`), as it idles between the
   host-paced calls of the main path, and the least time the card could
   take is computed from
   them: the larger of the bytes the function must move over 3.35 TB/s
   and the integer operations it needs over 67 T/s (see OPS_* below).
   Every kernel is also held to its plain version on every synthetic case
   of bowtie2_tpu_torch/ops/cases.py at scale 1 and 8 (the CPU tests hold
   those plain versions to the JAX package on the same cases), and timed
   on one block's worth of problems, which measures the dependency chain
   of one problem alone (`chain_ms`). The DP's log line also gives the
   cells its data needs and, derived from them, its issue floor; the
   walk's, the share of its steps past the walk's end (`tail_share`); the
   SA walk's log line, as figures derived from a replay of the plain walk
   and not measured, the share of lane-steps its 32-row warps idle
   (`lane_idle_share`) and the L2 sectors its steps ask for, over the
   kernel's time; the seed and half-read searches' log lines, derived
   from a replay of the plain search, the share of state-steps that take
   a LF step (`live_step_share`), the share of those whose range lies in
   one 128-row block (`same_block_share`) and the L2 sectors the search
   asks for, over the kernel's time. The SE gapless
   readout (K10 SE) is held and timed as the window gather is (below).
   The DP's sweep runs the origin-tracking variant
   (`sw_rect_origin`) on the same cases and on `origin_cases`, and both
   on `padded_origin_cases` at their n_live, as a host int and as a 0-d
   tensor on the card. Each DP entry gives the cells its data needs
   (`cells`) and those its kernel computes (`cells_launched`: the live
   lanes' rows up to their lengths, over the whole window). With
   --compare-parent DIR holding another sw_rect.cu, the fused SE path's
   first DP call and the host path's first are timed in turns with that
   design (see below; the `turns` of the `sw_rect` entry).
7. The E. coli-sim corpus: bench.py's gen_ecoli_corpus recipe (a 4.6-Mbp
   random genome, 100-bp reads and FR pairs at 0.5 % substitutions),
   --pairs of its 50,000 pairs; the genome, 8,192 of its SE reads and
   3,125 of its pairs are written to a temporary directory, and the index
   is built there by the port's CLI (`build`) and loaded.
8. The paired-end path: after one warm-up batch, `PairedAligner.
   align_pairs_fast(pairs, batch=3125, raw=True)` as bench.py drives the
   JAX package, at --sensitive; pairs/s, the port's spans and the launch
   counts, set to 0 just before and read just after: the origin DP
   (`sw_rect_origin`) and the block DP kernel at the 533-column
   mate-rescue windows (`sw_rect@block`, as the DP's C entry reports the
   kernel it launched) must have launched, and no plain
   version may have run. Then the run again under CUDA events (the
   `paired-end device time:` line).
9. The paired-end output: the first batch's SAM groups must equal the
   same aligner's on the CPU, end to end and --local, and the device
   pairing's must equal `force_host_pairing`'s on the card; and so for a
   mixed-outcome batch over the repcorpus genome (--mixed pairs of
   tests/test_pe_devpair.py's recipe at 0.5 % errors: 15 % garbage
   mates, 15 % fragments too long), whose hostneed pairs are counted;
   and the same recipe at its own 2 % errors, whose batch overflows the
   fused DP budget and must take the phase-by-phase host path
   (`align_batch_host`, with mate rescue), checked against the CPU.
10. The paired-end kernels: `sw_rect_origin` on the first fused_pe call's
   inputs (and the --local batch's first) and `sw_rect@rescue` on the
   first call that launched the block kernel (and the --local batch's, if
   it made one), each held to its plain version and timed as in
   phase 6 (both go into the `kernels` line); the block origin kernel
   (`sw_rect_origin@block`, not on the main path) on a 533-column origin
   case, with its `ptxas` (the `block` of the `sw_rect_origin` entry),
   and at the longer length buckets (`buckets`, BLOCK_ORIGIN_CALLS: at
   768 bp 8,192 lanes of which 384 live, laid out as fused_pe lays out
   its DP lanes, and 512 lanes all live; one call at 1,536 and at 3,072
   bp), end to end and --local held to the plain version, end to end
   timed; with --compare-parent, the first fused_pe call's origin DP (end
   to end and --local) and those calls in turns with the parent's design;
   K10's paired-end half, the device pairing (`_pe_pairing`, torch ops),
   timed as the gathers are.
11. The CLI: `align -U` (8,192 reads) and `align -1/-2` (3,125 pairs) on
   the card and with `--device cpu`: the SAM files must be identical
   apart from the @PG line's CL: field.
12. Long reads, over the E. coli-sim genome: --long-reads reads of 10-25
   kbp (lengths uniform; 0.5 % substitutions and 0.02 % 1-3-bp indels,
   half reverse-complemented, quals 25-40, from --seed) through
   `UnpairedAligner.submit` / `collect_raw` at --sensitive in batches of
   256 of one length-bucket group (32,768; the sparse 16,384 group merges
   into it and leads, and a batch pads to its own longest read's bucket,
   so the first batches run 16,384 rows): reads/s and aligned bases/s on
   the host's clock, the launch counts set to 0 just before and read just after (the
   band DP `sw_diag` and band walk `bt_diag` must have launched, no plain
   version), at least 95 % of the reads at their sampled position; the
   run again under CUDA events (`long-read device time:`). Then the first
   64 reads on the card against the CPU, end to end and --local; 32 pairs
   with one mate of 9-12 kbp against the CPU (the paired-end host path);
   two reads of about 1 Mbp (the top bucket, substitutions only), each at
   its sampled position with NM == XM and its walk's score equal to the
   DP's, with the two kernels' times on them. Each kernel is held to its
   plain version on the first long call (its plain time taken there, one
   call) and the --local batch's first call, and on every case of
   ops/cases.py `diag_cases` / `bt_diag_cases` at scale 1 and 8, and
   timed as in phase 6 (`chain_ms`: one problem or one walk alone); its
   bound counts each problem's len rows of BW cells and what they move,
   and each walk's steps, as the data needs them. The first call of each
   length bucket (16,384 and 32,768 rows) of both kernels is held to the
   plain version and timed back to back over a window of about
   WINDOW_MS, with nvidia-smi's clocks.sm sampled beside it (cycles a DP
   row of the bucket, or a step of the longest walk), and after IDLE_S
   idle (the `kernel sw_diag @ L rows` lines, `buckets` in the JSON
   entries). With --compare-parent, another design's sw_diag.cu is held
   to this one's output on those calls and the two timed in turns.
13. The large index mode (uint32 rows, int64 positions): (a) the four FM
   kernels' `_u32` entries on ops/cases.py `large_fm_case` (2^31 + 2^27 -
   1 rows: fm_blocks 0.86 GB, mark_rows 0.36 GB, offs 0.27 GB on the
   card; read, half-read and seed states at the main path's first-call
   shapes, SA rows mostly past 2^31), each held to its plain version,
   some of its results past 2^31, timed, its bound from what the states
   touch (fm_work, resolve_work); (b) global coordinates past 2^31: an
   all-N reference of PAD_BP bp, then the E. coli-sim genome split into
   two references with N runs (the two references by the port's
   builder, the padding laid out in numpy as the builder lays it out,
   `pad_genome`); the first SE
   batch (--batch reads) and the first PE batch (3,125 pairs) on the card
   must equal the same reads against the two references alone, and
   LARGE_CPU_SE reads and LARGE_CPU_PE pairs on the card the CPU's; (c)
   the repcorpus and E. coli-sim genomes indexed with `large=True`: the
   first SE batch, the first PE batch (fused path) and the first long
   reads of phase 12 must equal their small-index runs, with SE reads/s
   and PE pairs/s beside the small index's on the same batch (one run
   each, in turns, with the host timers of each), and each
   `_u32` kernel is held to its plain version on the forced-large main
   path's first call and timed on phase 6's first-call inputs beside the
   small-mode kernel. Every large-mode run is counted from 0: only `_u32`
   FM entries may launch, no plain version may run, and each `_u32` entry
   must launch.
14. The multi-device layer on one card (dist/, the JAX package's
   `shard_mesh=` and `mesh=`): (c) the repcorpus SE path's first two
   batches over the sharded index mode at 4 shards, and its first at 8,
   on the card
   (each a separate allocation, read through the shards' address array),
   the first batch over the forced-large index of phase 13 at 4 shards,
   and the E. coli-sim PE path's first two batches at 4 shards: every
   batch's SAM equals the replicated card run's, the first batch's the
   CPU's; counts set to 0 before each run and read after, no plain
   version may run, and K12 (`take_sharded`) and each `_sh` (and, on the
   forced-large run, `_sh_u32`) FM entry must launch; the 4-shard, forced-
   large and PE runs go under CUDA events (`total_ms`), after a warm-up
   batch of 256 reads over each index outside the counts and events. (d) The data mesh
   over every card (one on this machine) and over cuda:0 twice: four SE
   batches of E. coli-sim reads and the two PE batches, SAM equal to the
   one-device runs, every mesh entry taking a batch. (e) One process
   against two (torch.distributed over gloo, since NCCL refuses two ranks
   on one card; each process on cuda:0), each aligning its round-robin
   share of four windows of E. coli-sim reads: the merged bytes are
   equal. (a) K12 against its plain version on the repcorpus index's
   fm_blocks, mark_rows, offs, ref_words and refn_words split into 4 and
   8 shards, at indices negative, in range, in the padding and past it
   (int32 and int64), and on phase 13's large table split into 4 shards;
   timed on the sharded SE path's first call (`ms`, `idle_ms`, bytes
   bound). (b) The eight `_sh` entries against their plain versions on
   the sharded paths' first calls, on phase 6's first-call inputs at 4
   and 8 shards, and on every ops/cases.py FM case of phase 6's indexes
   at scale 1 and 8 (4 shards); timed on the sharded path's first call
   and, in turns with their flat twins (flat, sharded, sharded, flat), on
   phase 6's first-call inputs: the cost of the owner lookup. The
   multi-card parts of the mode (a shard read over peer access, NCCL
   between cards) need more than one card and do not run here.
15. The int64 row mode (past 2^32 rows: int64 rows and positions, the
   full occ checkpoints in a second table, occ_cp64): (a) the eight
   `_i64` entries (`fm_sweep_i64`, `fm_seed_i64`, `fm_substring_i64`,
   `sa_resolve_i64` and their `_sh_i64` twins) against their plain
   versions on ops/cases.py i64_fm_case (2^32 + 2^27 - 1 rows, about 4.6
   GB on the card; its host build time is logged), flat and split into 4
   shards, with results past 2^32, each timed with its bound and
   registers; (b) the repcorpus and E. coli-sim genomes forced into the
   mode (aligners over their forced-large indexes of phase 13 take
   `FMIndex.from_host(..., int64_rows=True)` and, sharded,
   `shard_index(..., int64_rows=True)` in place of their own index): the
   first SE batch (flat, and over 4
   shards), the first PE batch (fused path) and the first long reads of
   phase 12 must equal their small-index runs, only `_i64` FM entries may
   launch and each must; (c) single end past 2^32 global coordinates: an
   all-N reference of 2^32 + 2^24 bp ahead of the E. coli-sim genome
   (`pad_genome`, the builder's layout): the first SE batch must equal
   the genome alone, and the PairedAligner must refuse the index.

The window gather (K7: `ref_gather_aligned`, `ref_gather_aligned_sh` over
sharded word tables, `ref_gather`, csrc/ref_gather.cu), the device
pairing (K10 PE: `pe_pairing`, csrc/pe_pairing.cu) and the SE gapless
readout (K10 SE: `diag_readout`, csrc/diag_readout.cu) are held to their
plain versions at every call the run makes on the card (Holder): the
first call of each shape (windows, width, position type, shards) of the
gathers and every call of the pairing and of the readout, phase by phase
after the phase has read its counts (the `new kernels held` lines,
`checks` in their JSON entries): the SE main path and its host path
(phase 3), --local (5), the PE main path (8), the mixed-outcome batch's
hostneed pairs and the overflow batch's host path (9), the long reads'
wide windows (12), the large index mode's int64 positions past 2^31 and
int64 extents (13), the sharded tables at 4 and 8 shards (14), the int64
row mode and global coordinates past 2^32 (15); and on every
ops/cases.py window_cases case (both forms, and the aligned form over 4
shards), pairing_cases case (int32 and int64 extents) and readout_cases
case, at scale 1 and 8. Each must launch on its paths (no plain version
may run there): the gathers in phases 3, 5, 8 and 12, the pairing in
phase 8, the readout in phase 3 (the --local path of phase 5 walks every
record and reads no diagonal out), `_sh` in phase 14.
Each is timed as in phase 6 at its main path's first call (phase 3's
fused and host-path calls, phase 8's pairing, phase 14's sharded call;
the unaligned form also at the long path's widest call, `wide`; the
readout at the fused path's first call, and at a call of its shape for
250-300-bp reads, Lmax 384, past the kernel's 256-step tile, `long`,
held to the plain version too), and under torch.profiler
(CUPTI) with its plain version (`cupti_ms`, `plain_cupti_ms`). Each is
also timed on one block's worth of its first call alone (`chain_ms`: the
gathers' first windows that hold 2,048 codes, the pairing's first 8
pairs, the readout's first 32 candidates; the aligned gathers' and the
readout's held to the plain version too, `chain_err`). With
--compare-parent, the unaligned gather on its first call and the long
path's widest, the aligned gather on the first fused SE and fused PE
calls and over 4 shards on phase 14's first, the pairing and the
readout on their first calls (the readout also on its Lmax 384 call),
and each on those calls' one-block floors are timed in turns with the
other design (`turns` in the JSON entries); and every shape of gather,
in either form, that the SE, PE and (the unaligned form) long main paths
launched, and of readout that the SE main path launched, is timed in
turns, weighted by its launches on the path (`launch_classes`: the
launches below one block's worth of codes, 2,048, or of candidates, 32,
and the rest, with their summed times in each design). One whole
fused_se batch and one fused_pe batch run under CUPTI too (the `CUPTI
split` lines: device time by kernel and by region: fused `_core`, the
gather, the SE readout, the pairing). Since the aligned gather
reads sharded words itself, K12 (`take_sharded`) runs on no path; phase 14
times it on the word indices of the sharded path's first gather.

--compare-parent DIR (e.g. the parent commit's bowtie2_tpu_torch/csrc,
unpacked under the gitignored build/): every CUDA source in DIR that
differs from the port's own is built with the port's flags (DIR's headers
first) and, where its kernel has a call to be timed on (sw_rect, sw_diag,
ref_gather, pe_pairing, diag_readout), held to this design's output there
and timed in turns with it: parent, this, this, parent, each window of about
WINDOW_MS with clocks.sm sampled beside it, or TURN_REPS launches for a
kernel too short for that, and each design after IDLE_S idle.

The lines before the last are a JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import ctypes
import dataclasses
import datetime
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, SXM part): HBM bandwidth, and 67e12
# float32 operations a second outside the tensor cores. The data sheet
# gives no 32-bit integer rate; no unit of the card issues more 32-bit
# integer operations a second than that (the float32 figure counts a
# fused multiply-add as two), so integer operations over it give a time
# no longer than the least the card could take.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# the least integer operations each unit of work needs, counted from the
# function each kernel computes (not from the kernels' instruction mix):
# - one LF step, occ(c, i) = fchr[c] + cp[c] + #(c among the block's first
#   i mod 128 codes) - [c == 0 and i > z]. The codes lie 16 to a 32-bit
#   word, so a step needs on average 4.5 of the block's 8 words, each an
#   XOR with c's pattern, a fold of every 2-bit code to one bit (shift,
#   AND, AND), a popcount and an add (6); then the two adds and the
#   z-row test and subtract (4): 31;
# - one sa_resolve step: the code at the row (shift, AND), its mark bit
#   (shift, AND) and an LF step: 35; per row, the marked row's rank (on
#   average 2 of 4 mark words below it: mask, popcount, add each), the
#   rank add and offs[rank] + steps: 9;
# - one DP cell of the affine-gap recurrence: the substitution score
#   (compare, select), E and F (two subtracts and a max each), the
#   diagonal add, H as the max of three (two maxes), the best-cell
#   compare: 12;
# - one backtrace step: the cell's direction bits (shift, AND), the move
#   (compare, select), row and column (two adds), the op byte (shift, OR)
#   and the score term (add): 9.
# A model, for a derived figure only: the SA walk asks for SECTORS_STEP
# 32-byte sectors a LF step (the mark word's, and the two the 48-byte FM
# row spans at its 16-byte alignment) and SECTORS_ROW a row (the marked
# row's mark word, its rank words and the offset).
OPS_LF = 31
OPS_RESOLVE_STEP = 35
OPS_RESOLVE_ROW = 9
OPS_DP_CELL = 12
# - one DP cell with origin tracking: the 12 above, and the origin of the
#   diagonal move (compare, select), of E (select), of H without F
#   (select), the F payload (select) and the cell's origin (select): 17.
OPS_DP_CELL_ORIGIN = 17
OPS_BT_STEP = 9
# - one window code (K7): its crumb (shift, AND), its N bit (shift, AND,
#   select), the reference bounds (two compares, OR, select): 9;
# - one combination of the device pairing (K10 PE, T^2 a pair): the
#   concordance test (two lengths and the fragment: subtract-adds, maxes,
#   a min; the size compares, containment, overlap and dovetail
#   compares and the policy's selects: 20), the key (add, two shifts, two
#   subtracts, select: 6) and the argmax compare: 27; and one (slot,
#   slot) pair of a read (T^2 a read): the dedupe (two compares, the
#   score order: 5) and the rank (3): 8.
# - one read position of the SE gapless readout (K10 SE): the window
#   index and its bounds (add, two compares, select), is_n, oob and eq
#   (four compares, three ANDs/ORs), the qual penalty (min, multiply,
#   divide by a constant as a multiply and shift, add), the score term
#   (two selects) and its masked add (compare, AND, add), n_mm and n_refn
#   (three compares, two ANDs/ORs, two adds), the op byte (two shifts,
#   two ORs, a select): 30.
OPS_GATHER_CODE = 9
OPS_PAIR_COMBO = 27
OPS_PAIR_SLOTS = 8
OPS_READOUT_POS = 30
SECTORS_STEP = 3
SECTORS_ROW = 3

# a spin of the stream before each timed span, so its start event fires
# only once the host has queued the work inside it: the span then holds
# device time and not launch latency (about 0.1 ms and 0.5 ms at 2 GHz)
SPIN_KERNEL = 200_000
SPIN_TORCH_OPS = 1_000_000
# and a spin for each launch of a back-to-back timing, longer than any
# wrapper's host time (a short kernel is otherwise timed at the host's
# pace: the walk's wrapper takes about 0.1 ms on the host)
SPIN_REP = 1_000_000

# the host's sleep before each launch that `idle_ms` times
IDLE_S = 0.05
# the least span of a timing window beside which clocks.sm is sampled
WINDOW_MS = 800.0
# launches of a timing in turns of a short kernel (--compare-parent): few
# enough that the launch queue holds them all while the stream spins, so
# the span holds device time and not the host's pace; such a window is too
# short to sample clocks.sm in
TURN_REPS = 200
# the sources whose kernels --compare-parent times in turns on some call
TURN_SOURCES = ("sw_rect", "sw_diag", "ref_gather", "pe_pairing",
                "diag_readout")
# codes a block of K7 covers, either form: 128 threads of 16 codes
BLOCK_CODES = 2048
# candidates a block of K10 SE takes
READOUT_BLOCK = 32
# the LEN_BUCKETS length of the K10 SE call past its 256-step tile
READOUT_LONG_LMAX = 384

# positions in the C call's arguments of the sizes that pick a kernel's
# launch shape: backtrace (walks, Lmax, W, S), sa_resolve (rows); and of
# the calls' sizes: fm_seed (seeds, seed length, K), fm_substring (states,
# pattern columns), sw_diag (problems, Lmax), bt_diag (walks, Lmax, S),
# ref_gather (windows, width), ref_gather_aligned (windows, aligned width),
# diag_readout (candidates, Lmax, window width)
SHAPE_ARGS = {"backtrace": (10, 1, 11, 12), "sa_resolve": (8,),
              "ref_gather": (8, 9), "ref_gather_aligned": (8, 9),
              "diag_readout": (6, 7, 8),
              "fm_seed": (8, 9, 10), "fm_substring": (6, 7),
              "sw_diag": (4, 5), "bt_diag": (10, 1, 12)}

# backtrace.cu runs one thread a walk past LANE_WAVES (4) waves of its
# warp kernel, two blocks of NW (8) walks an SM: past this many walks an SM
BT_WARP_WALKS_PER_SM = 4 * 2 * 8

# the kernels of each entry in `ptxas -v`'s report of its source: a
# prefix, or (prefix, suffix) pairs; the DP's warp kernel by its ORIGIN
# template flag (`sw_warp_kernel<WPT,LOCAL,ORIGIN>`), and the block
# kernels by name (`sw_block_kernel<WPT,LOCAL>`; the origin block kernels
# `sw_block_origin_reg_kernel<S,LOCAL>` and `sw_block_origin_kernel<LOCAL>`)
PTXAS_FUNCS = {"fm_sweep": ("sweep_kernel", "<int>"),
               "fm_seed": ("seed_kernel", "<int>"),
               "fm_substring": ("substring_kernel", "<int>"),
               "sa_resolve": ("resolve_kernel", "<int>"),
               "fm_sweep_u32": ("sweep_kernel", "<uint32>"),
               "fm_seed_u32": ("seed_kernel", "<uint32>"),
               "fm_substring_u32": ("substring_kernel", "<uint32>"),
               "sa_resolve_u32": ("resolve_kernel", "<uint32>"),
               "sw_rect": [("sw_warp_kernel", ",0>"),
                           ("sw_block_kernel", "")],
               "sw_rect_origin": [("sw_warp_kernel", ",1>"),
                                  ("sw_block_origin", "")],
               "sw_rect_origin@block": ("sw_block_origin", ""),
               "sw_rect@rescue": ("sw_block_kernel", ""),
               "backtrace": "bt_", "sw_diag": "sw_diag_kernel",
               "bt_diag": "bt_diag_kernel",
               "ref_gather_aligned": ("aligned_kernel", ",0>"),
               "ref_gather_aligned_sh": ("aligned_kernel", ",1>"),
               "ref_gather": "unaligned_kernel",
               "pe_pairing": "pairing_kernel"}

# the window gather's entries (K7) and the device pairing (K10 PE): name
# -> (source, TPU-side function it replaces)
K7 = {"ref_gather_aligned": ("bowtie2_tpu_torch/csrc/ref_gather.cu",
                             "bowtie2_tpu/ops/ref.py:94"),
      "ref_gather": ("bowtie2_tpu_torch/csrc/ref_gather.cu",
                     "bowtie2_tpu/ops/ref.py:42"),
      "ref_gather_aligned_sh": ("bowtie2_tpu_torch/csrc/ref_gather.cu",
                                "bowtie2_tpu/ops/ref.py:94")}
K10PE = ("pe_pairing", "bowtie2_tpu_torch/csrc/pe_pairing.cu",
         "bowtie2_tpu/ops/fused.py:721")

# the block origin kernel's calls at the PE length buckets past 512
# columns, each an ops/cases.py padded_origin_cases shape (Lmax, live
# lanes, padding lanes) and its shortest read: at 768 bp fused_pe's NCDP
# of 8,192 lanes with 384 live, and 512 lanes all live (128 threads a
# block); at 1,536 and 3,072 bp (256 and 512 threads) a few lanes
BLOCK_ORIGIN_CALLS = {"768 fused": ((768, 384, 7808), 700),
                      "768 all live": ((768, 512, 0), 700),
                      "1536": ((1536, 64, 0), 1400),
                      "3072": ((3072, 32, 0), 2900)}

# the paired-end path's DP entries: the origin-tracking DP of fused_pe and
# the DP of the mate-rescue windows, whose width takes the block kernel
# (launch counts under `sw_rect@block`)
PE_KERNELS = {
    "sw_rect_origin": ("bowtie2_tpu_torch/csrc/sw_rect.cu",
                       "bowtie2_tpu/ops/sw.py:144"),
    "sw_rect@rescue": ("bowtie2_tpu_torch/csrc/sw_rect.cu",
                       "bowtie2_tpu/ops/pallas_sw.py:145"),
}

# the long-read path's kernels (K11): the band DP and the band walk
LONG_KERNELS = {
    "sw_diag": ("bowtie2_tpu_torch/csrc/sw_diag.cu",
                "bowtie2_tpu/ops/sw.py:655"),
    "bt_diag": ("bowtie2_tpu_torch/csrc/sw_diag.cu",
                "bowtie2_tpu/ops/sw.py:765"),
}
# the long-read corpus over the E. coli-sim genome: read lengths, errors
# (substitutions, and 1-3-bp indels a base), the batch, the reads held to
# the CPU, the paired-end check's pairs and mate lengths, and the two reads
# of about 1 Mbp (substitutions only)
LONG_LEN = (10_000, 25_000)
LONG_SUB, LONG_INDEL = 0.005, 0.0002
LONG_BATCH = 256
LONG_CPU = 64
LONG_PAIRS, LONG_MATE = 32, (9_000, 12_000)
MBP_LENS, MBP_SUB = (1_000_000, 1_040_000), 0.002

# the E. coli-sim corpus (bench.py gen_ecoli_corpus's recipe)
ECOLI_GENOME = 4_600_000
ECOLI_SE = 100_000
ECOLI_PAIRS = 50_000
PE_BATCH = 3125
CLI_SE = 8192

# the large index mode's C entries (uint32 rows), by the wrapper that
# launches each: name -> (wrapper, source, TPU-side function it replaces)
LARGE_KERNELS = {
    "fm_sweep_u32": ("fm_sweep", "bowtie2_tpu_torch/csrc/fm_search.cu",
                     "bowtie2_tpu/ops/fm.py:215"),
    "fm_seed_u32": ("fm_seed", "bowtie2_tpu_torch/csrc/fm_search.cu",
                    "bowtie2_tpu/ops/fm.py:335"),
    "fm_substring_u32": ("fm_substring",
                         "bowtie2_tpu_torch/csrc/fm_search.cu",
                         "bowtie2_tpu/ops/fm.py:275"),
    "sa_resolve_u32": ("sa_resolve", "bowtie2_tpu_torch/csrc/sa_resolve.cu",
                       "bowtie2_tpu/ops/fm.py:408"),
}
# phase 13's genome whose global coordinates pass 2^31: an all-N leading
# reference of PAD_BP, then the E. coli-sim genome split at its middle
# into two references, the first with an N run at N_RUN, the second with
# N_ENDS Ns at both ends; and the reads held to the CPU there
PAD_BP = (1 << 31) + (1 << 24)
N_RUN, N_ENDS = (1_000_000, 1_001_000), 100
LARGE_CPU_SE, LARGE_CPU_PE = 512, 256
# the row that the large table's states must pass
PAST_ROW = 1 << 31

# the sharded index mode's C entries (phase 14), by the wrapper that
# launches each: name -> (wrapper, source, TPU-side function it replaces)
SHARD_KERNELS = {
    f"{w}_sh{u}": (w, src, repl)
    for u in ("", "_u32") for w, src, repl in (
        ("fm_sweep", "bowtie2_tpu_torch/csrc/fm_search.cu",
         "bowtie2_tpu/ops/fm.py:215"),
        ("fm_seed", "bowtie2_tpu_torch/csrc/fm_search.cu",
         "bowtie2_tpu/ops/fm.py:335"),
        ("fm_substring", "bowtie2_tpu_torch/csrc/fm_search.cu",
         "bowtie2_tpu/ops/fm.py:275"),
        ("sa_resolve", "bowtie2_tpu_torch/csrc/sa_resolve.cu",
         "bowtie2_tpu/ops/fm.py:408"))}
K12 = ("take_sharded", "bowtie2_tpu_torch/csrc/take_sharded.cu",
       "bowtie2_tpu/ops/fm.py:55")
# their kernels in ptxas's report: the flat twins' with the row source
PTXAS_FUNCS.update({k: (PTXAS_FUNCS[w][0], "<uint32,sh>" if k.endswith(
    "_u32") else "<int,sh>") for k, (w, _s, _r) in SHARD_KERNELS.items()})
PTXAS_FUNCS[K12[0]] = "take_kernel"
# phase 14's shard counts on one card, the E. coli-sim reads of the data
# mesh's SE batches and of the process windows
SHARDS = (4, 8)
MESH_SE, MESH_SE_BATCHES = 2048, 4
MH_WINDOW, MH_WINDOWS = 1024, 4
# the large table's gather: indices in range, and the K12 timing reps
K12_LARGE_IDX = 1 << 20

# the int64 row mode's C entries (phase 15), flat and sharded, by the
# wrapper that launches each: name -> (wrapper, source, TPU-side function
# it replaces)
I64_KERNELS = {
    f"{w}{sh}_i64": (w, src, repl)
    for sh in ("", "_sh") for w, src, repl in (
        ("fm_sweep", "bowtie2_tpu_torch/csrc/fm_search.cu",
         "bowtie2_tpu/ops/fm.py:215"),
        ("fm_seed", "bowtie2_tpu_torch/csrc/fm_search.cu",
         "bowtie2_tpu/ops/fm.py:335"),
        ("fm_substring", "bowtie2_tpu_torch/csrc/fm_search.cu",
         "bowtie2_tpu/ops/fm.py:275"),
        ("sa_resolve", "bowtie2_tpu_torch/csrc/sa_resolve.cu",
         "bowtie2_tpu/ops/fm.py:408"))}
PTXAS_FUNCS.update({k: (PTXAS_FUNCS[w][0], "<int64,sh>" if "_sh" in k
                        else "<int64>")
                    for k, (w, _s, _r) in I64_KERNELS.items()})
# the SE gapless readout (K10 SE)
K10SE = ("diag_readout", "bowtie2_tpu_torch/csrc/diag_readout.cu",
         "bowtie2_tpu/ops/sw.py:463")
PTXAS_FUNCS[K10SE[0]] = "readout_kernel"
# phase 15's genome whose global coordinates pass 2^32: an all-N leading
# reference of I64_PAD_BP ahead of the E. coli-sim genome; the row and
# the offset the int64 table's results must pass; its shard count
I64_PAD_BP = (1 << 32) + (1 << 24)
PAST_ROW_I64 = 1 << 32
I64_SHARDS = 4

KERNELS = {  # name -> (source, TPU-side function it replaces)
    "fm_sweep": ("bowtie2_tpu_torch/csrc/fm_search.cu",
                 "bowtie2_tpu/ops/fm.py:215"),
    "fm_seed": ("bowtie2_tpu_torch/csrc/fm_search.cu",
                "bowtie2_tpu/ops/fm.py:335"),
    "fm_substring": ("bowtie2_tpu_torch/csrc/fm_search.cu",
                     "bowtie2_tpu/ops/fm.py:275"),
    "sa_resolve": ("bowtie2_tpu_torch/csrc/sa_resolve.cu",
                   "bowtie2_tpu/ops/fm.py:408"),
    "sw_rect": ("bowtie2_tpu_torch/csrc/sw_rect.cu",
                "bowtie2_tpu/ops/pallas_sw.py:145"),
    "backtrace": ("bowtie2_tpu_torch/csrc/backtrace.cu",
                  "bowtie2_tpu/ops/sw.py:365"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.time()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(n: int, what: str) -> None:
    """A phase's header line, with the seconds since the script began."""
    log(f"== phase {n}: {what} ({time.time() - T_START:.1f} s)")


def load_repcorpus():
    path = os.path.join(HERE, "scripts", "make_repcorpus.py")
    spec = importlib.util.spec_from_file_location("make_repcorpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """Wraps each kernel's wrapper to keep the arguments of its first
    call, so phase 6 replays the kernels at the main path's shapes; and,
    under name + "@bulk", of its first call on the card of more than
    bulk[name] problems (walks, SA rows), which takes another launch
    shape, or, where bulk[name] is None, of another number of problems
    (seeds, half-read states) than its first call had."""

    def __init__(self, fm, sw, fused, bulk):
        self.args = {}
        self.bulk = bulk
        self._sized = {}
        i32 = torch.int32
        self._patch(fm, "exact_sweep_rr", "fm_sweep",
                    lambda half, rr: (half, rr.to(i32).contiguous()))
        self._patch(fm, "substring_search_rr", "fm_substring",
                    lambda half, rr: (half, rr.to(i32).contiguous()),
                    lambda half, rr: rr)
        self._patch(fm, "seed_search_exact", "fm_seed",
                    lambda half, seeds, valid, seed_len, ftab_chars=0: (
                        half, seeds.to(i32).contiguous(),
                        valid.to(torch.bool).contiguous(), seed_len,
                        ftab_chars),
                    lambda half, seeds, *a, **k: seeds)
        self._patch(fm, "sa_resolve", "sa_resolve",
                    lambda half, rows, period=32: (
                        half, rows.to(half.row_dtype).contiguous(), period),
                    lambda half, rows, period=32: rows)
        self._patch_sw(sw)
        self._patch(sw, "_sw_banded_diag_cuda", "sw_diag", lambda *a: a)
        self._patch(sw, "_backtrace_diag_cuda", "bt_diag", lambda *a: a)
        self._patch(sw, "_backtrace_cuda", "backtrace", lambda *a: a,
                    lambda dirs, sel, *a: sel)
        self._patch(fused, "diag_readout", "diag_readout", lambda *a: a)

    def _patch_sw(self, sw):
        """The DP: `sw_rect` and `sw_rect_origin` (track_origin) by the
        entry they launch, and `sw_rect@rescue`, the first call of the
        plain DP that launched the block kernel (counted by the entry as
        `sw_rect@block`); `<entry>@host`, the first call whose n_live is
        a host count (the host path's). The arguments hold n_live."""
        orig = sw._sw_banded_cuda
        launches = sw._build.LAUNCHES

        def wrapped(*a, track_origin=False):
            name = "sw_rect_origin" if track_origin else "sw_rect"
            self.args.setdefault(name, a)
            if isinstance(a[7], int):
                # a host count: the host path's call (the fused
                # pipelines give a tensor)
                self.args.setdefault(name + "@host", a)
            n_block = launches["sw_rect@block"]
            out = orig(*a, track_origin=track_origin)
            if launches["sw_rect@block"] > n_block:
                self.args.setdefault("sw_rect@rescue", a)
            return out
        sw._sw_banded_cuda = wrapped
        self.orig_sw_rect = orig
        self.orig_sw_rect_origin = lambda *a: orig(*a, track_origin=True)
        setattr(self, "orig_sw_rect@rescue", orig)

    def take(self):
        """The arguments recorded so far; recording starts afresh."""
        args, self.args = self.args, {}
        return args

    def first_size(self, name, args=None):
        """The number of problems of `name`'s first call; `args` are the
        recorded arguments (the current recording's by default)."""
        first = (self.args if args is None else args)[name]
        return self._sized[name](*first).shape[0]

    def _patch(self, mod, attr, name, norm, sized=None):
        """sized(*args) gives the tensor whose length is the call's size."""
        orig = getattr(mod, attr)

        def wrapped(*a, **k):
            if name not in self.args:
                self.args[name] = norm(*a, **k)
            big = name + "@bulk"
            if sized is not None and big not in self.args:
                t = sized(*a, **k)
                lim = self.bulk[name]
                n = t.shape[0]
                if t.is_cuda and (n > lim if lim is not None else
                                  n != self.first_size(name)):
                    self.args[big] = norm(*a, **k)
            return orig(*a, **k)
        setattr(mod, attr, wrapped)
        setattr(self, "orig_" + name, orig)
        self._sized[name] = sized


class Holder:
    """Keeps the calls of the window gather's two forms (K7: `ref_gather_
    aligned`, `_sh` over sharded word tables, and `ref_gather`), of the
    device pairing (K10 PE, `pe_pairing`) and of the SE gapless readout
    (K10 SE, `diag_readout`) on the card, under the label of the phase
    that made them: the first call of each shape (windows, width, position
    type, word source) of the gathers, every call of the pairing (each PE
    batch) and of the readout (each fused SE batch). `check` holds each
    kept call's kernel result to the plain version on the same inputs,
    after the phase has read its counts, and starts afresh; `first` keeps
    each entry's first call, and `kept` a call of each shape of the gathers
    and of the readout (candidates, Lmax, window width) by phase, for
    good."""

    def __init__(self, ref, fused, align_mod, sw):
        i32 = torch.int32
        self.plain = {"ref_gather_aligned": ref._gather_windows_aligned_plain,
                      "ref_gather": ref._gather_windows_plain,
                      "pe_pairing": fused._pe_pairing_plain,
                      # the wrapper's int32 copies, then the plain version
                      "diag_readout": lambda *x: sw._diag_readout_plain(
                          *(t.to(i32).contiguous() for t in x[:6]), x[6])}
        self.kern = {"ref_gather_aligned": ref.gather_windows_aligned,
                     "ref_gather": ref.gather_windows,
                     "pe_pairing": fused._pe_pairing,
                     "diag_readout": fused.diag_readout}
        self.calls = {}            # entry -> {key: args}
        self.kept = {}             # (label, entry) -> {shape: args}
        self.first = {}            # entry -> (label, args)
        self.checks = {}           # entry -> {label: record}
        self.label = None
        self._ref = ref
        for mod, attr, name in ((fused, "gather_windows_aligned",
                                 "ref_gather_aligned"),
                                (align_mod, "gather_windows", "ref_gather"),
                                (fused, "_pe_pairing", "pe_pairing"),
                                (fused, "diag_readout", "diag_readout")):
            self._patch(mod, attr, name)

    def entry(self, name, args):
        """The C entry a call launches: the aligned gather's `_sh` one over
        sharded word tables."""
        if name == "ref_gather_aligned" and isinstance(
                args[0], self._ref.ShardedWords):
            return "ref_gather_aligned_sh"
        return name

    @staticmethod
    def key(name, args):
        if name in ("pe_pairing", "diag_readout"):
            return None                   # every call
        starts = args[2]
        return (starts.shape[0], args[5], str(starts.dtype).split(".")[-1],
                args[0].words.S if hasattr(args[0], "words") else 1)

    @staticmethod
    def shape(name, args):
        """The shape a kept call is filed under (None: not kept)."""
        if name == "diag_readout":
            return tuple(args[0].shape) + (args[2].shape[1],)
        return None if name == "pe_pairing" else Holder.key(name, args)

    def _patch(self, mod, attr, name):
        orig = getattr(mod, attr)

        def wrapped(*a, **k):
            t = a[2] if name != "pe_pairing" else a[5]     # on the card?
            if self.label is not None and t.is_cuda:
                e = self.entry(name, a)
                self.first.setdefault(e, (self.label, a))
                d = self.calls.setdefault(e, {})
                key = self.key(name, a)
                d.setdefault(len(d) if key is None else key, a)
                shape = self.shape(name, a)
                if shape is not None:
                    self.kept.setdefault((self.label, e), {}).setdefault(
                        shape, a)
            return orig(*a, **k)
        setattr(mod, attr, wrapped)

    def plain_of(self, entry):
        return self.plain["ref_gather_aligned" if entry.startswith(
            "ref_gather_aligned") else entry]

    def kern_of(self, entry):
        return self.kern["ref_gather_aligned" if entry.startswith(
            "ref_gather_aligned") else entry]

    def check(self, label=None):
        """Each kept call's kernel result against the plain version's, by
        entry: {entry: (calls, max abs err)}; recording goes on under
        `label` (None: stops)."""
        out = {}
        for e, d in self.calls.items():
            errs = [max_err(self.kern_of(e), self.plain_of(e), args)[1]
                    for args in d.values()]
            rec = self.checks.setdefault(e, {}).setdefault(
                self.label, dict(calls=0, max_abs_err=0))
            rec["calls"] += len(errs)
            rec["max_abs_err"] = max([rec["max_abs_err"]] + errs)
            keys = [list(k) for k in d if not isinstance(k, int)]
            if keys:
                rec["shapes"] = rec.get("shapes", []) + keys
            out[e] = (len(errs), rec["max_abs_err"])
        if out:
            log(f"new kernels held to their plain versions ({self.label}): "
                f"{json.dumps({e: self.checks[e][self.label] for e in out})}")
        self.calls = {}
        self.label = label
        torch.cuda.synchronize()
        return out

    def max_err(self, entry):
        return max((r["max_abs_err"] for r in self.checks.get(
            entry, {}).values()), default=0)


def host_timers(targets):
    """Wall seconds spent in each (object, attribute) callable: where the
    host's time goes on the main path. Returns the accumulating dict."""
    acc = {}
    for obj, attr in targets:
        fn = getattr(obj, attr)

        def timed(*a, _fn=fn, _name=attr, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc[_name] = acc.get(_name, 0.0) + time.perf_counter() - t0
        setattr(obj, attr, timed)
    return acc


def span_totals(trace):
    """The port's spans (utils/metrics.py TRACE) of a run: {name: [calls,
    total s, self s]}."""
    return {n: [c, round(t, 3), round(s, 3)]
            for n, (c, t, s) in trace.totals().items()}


class LaunchTimer:
    """CUDA events around every kernel launch (`_build.call`) and around
    named torch-op functions, summed by name after the run's final
    synchronise."""

    def __init__(self, build_mod):
        self.spans = []
        self.spin = getattr(torch.cuda, "_sleep", None)
        self._undo = []
        orig = build_mod.call

        def call(name, symbol, argtypes, *args, kinds=None):
            e0, e1 = self._start(SPIN_KERNEL)
            counted = orig(name, symbol, argtypes, *args, kinds=kinds)
            e1.record()
            if counted is not None:
                self.spans.append((counted, e0, e1, tuple(
                    args[k] for k in SHAPE_ARGS.get(counted, ()))))
            return counted
        build_mod.call = call
        self._undo.append((build_mod, "call", orig))

    def wrap(self, mod, attr, name):
        orig = getattr(mod, attr)

        def timed(*a, **k):
            e0, e1 = self._start(SPIN_TORCH_OPS)
            out = orig(*a, **k)
            e1.record()
            self.spans.append((name, e0, e1, ()))
            return out
        setattr(mod, attr, timed)
        self._undo.append((mod, attr, orig))

    def _start(self, cycles):
        if self.spin is not None:
            self.spin(cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        return e0, e1

    def totals(self, by_shape=False):
        """{name: [total ms, spans]}, or with by_shape {name: {shape:
        [total ms, spans]}} for the kernels of SHAPE_ARGS; call after a
        synchronise."""
        out = {}
        for name, e0, e1, shape in self.spans:
            if by_shape and name not in SHAPE_ARGS:
                continue
            d = out.setdefault(name, {}) if by_shape else out
            t = d.setdefault(shape if by_shape else name, [0.0, 0])
            t[0] += e0.elapsed_time(e1)
            t[1] += 1
        return out

    def restore(self):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)


def _short_kernel(name: str) -> str:
    """A CUPTI kernel name without its return type and argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            return name[:i][:90]
    return name[:90]


def cupti(fn, reps: int = 5, regions=()):
    """Device time of fn() under torch.profiler (CUPTI), after one warm-up
    call: (ms a call over every kernel, memcpy and memset on the card,
    {kernel: ms a call}, {region: ms a call}); `regions` are (module,
    attribute, label) functions run inside a record_function range of
    that label, whose device time is that of the work launched in it.
    The total is None where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    undo = []
    for mod, attr, label in regions:
        orig = getattr(mod, attr)

        def ranged(*a, _f=orig, _l=label, **k):
            with record_function(_l):
                return _f(*a, **k)
        setattr(mod, attr, ranged)
        undo.append((mod, attr, orig))
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)
    by, reg = {}, {}
    labels = {lb for _m, _a, lb in regions}
    events = prof.events()
    for ev in events:
        if ev.name in labels:
            # the range on the host; its twin on the card's timeline (the
            # range's span there, gaps included) is not a kernel
            if ev.device_type != DeviceType.CUDA:
                reg[ev.name] = reg.get(ev.name, 0.0) + \
                    ev.device_time_total / 1e3 / reps
        elif ev.device_type == DeviceType.CUDA:
            k = _short_kernel(ev.name)
            by[k] = by.get(k, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    if not by:
        log(f"torch.profiler saw no device activity ({len(events)} events: "
            f"{sorted({e.name for e in events})[:8]})")
    total = sum(by.values()) if by else None
    return total, dict(sorted(by.items(), key=lambda kv: -kv[1])), reg


def time_cuda(fn, reps: int, spin: int = SPIN_REP) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up.
    The stream first spins for reps x `spin` cycles, so the host has
    queued every launch before the start event fires and the span holds
    device time only (a kernel shorter than its wrapper's host time would
    otherwise be timed at the host's pace); spin=0 times as it comes."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if spin and hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(reps * spin)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_after_idle(fn, reps: int) -> float:
    """Mean milliseconds of fn() launched alone after the card has idled
    IDLE_S seconds, as it idles between the host-paced calls of the main
    path; the stream spins first as in time_cuda, so each span holds
    device time only."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        time.sleep(IDLE_S)
        if hasattr(torch.cuda, "_sleep"):
            torch.cuda._sleep(SPIN_KERNEL)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def max_err(kern, plain, args, err=None):
    """(kernel's result, max abs difference from the plain version's on
    the same inputs, by `err(got, want, args)` or result_err); a differing
    shape or arity counts as 2^31."""
    got = kern(*args)
    want = plain(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return got, (result_err(got, want) if err is None
                 else err(got, want, args))


def live_count(args):
    """The live lanes of a rectangle-DP call (sw_args' n_live)."""
    B = args[2].shape[0]
    n = args[7]
    return B if n is None else min(max(int(n), 0), B)


def rect_err(got, want, args, fills=True):
    """result_err of two rectangle-DP results over what sw_banded's n_live
    contract specifies (ops/sw.py SWResult): score, row, lane and origin of
    the live lanes and their dirs rows below each read's length; with
    `fills`, a dead lane of `got` off the fill (sw.DEAD_FILL) counts as
    2^31."""
    from bowtie2_tpu_torch.ops.sw import DEAD_FILL
    lens = args[2]
    n = live_count(args)
    err = 0
    for f, fill in zip(("score", "row", "lane", "origin"), DEAD_FILL):
        g, w = getattr(got, f), getattr(want, f)
        if g is None or w is None:
            if g is not None or w is not None:
                return 1 << 31
            continue
        if g.shape != w.shape or (fills and bool((g[n:] != fill).any())):
            return 1 << 31
        err = max(err, result_err(g[:n], w[:n]))
    if got.dirs.shape != want.dirs.shape:
        return 1 << 31
    Lmax = got.dirs.shape[0]
    rows = torch.arange(Lmax, device=lens.device)[:, None] < lens[None, :n]
    diff = (got.dirs[:, :n].long() - want.dirs[:, :n].long()).abs()
    if diff.numel():
        err = max(err, int(torch.where(rows[:, :, None], diff, 0).max()))
    return err


def first_lanes(args, n):
    """A rectangle-DP call's arguments cut to its first n lanes (n_live
    cut to n, in its own form)."""
    out = [x[:n].contiguous() if isinstance(x, torch.Tensor) and x.dim()
           else x for x in args]
    nl = out[7]
    out[7] = None if nl is None else (
        torch.clamp(nl, max=n) if isinstance(nl, torch.Tensor) else min(nl, n))
    return tuple(out)


def rect_cells(args):
    """(cells, cells_launched) of a rectangle-DP call: what its data needs
    (dp_work), and what the kernel computes, each live lane's rows up to
    its length over every window column."""
    _bytes, cells = dp_work(args, False)
    n = live_count(args)
    W = args[3].shape[1]
    rows = int(args[2][:n].long().clamp(0, args[0].shape[1]).sum())
    return cells, rows * 8 * ((W + 7) // 8)


def result_err(got, want):
    """Max abs difference of two results (tuples of tensors, or tensors);
    a differing shape or arity counts as 2^31."""
    got_t = list(got) if isinstance(got, tuple) else [got]
    want_t = list(want) if isinstance(want, tuple) else [want]
    if len(got_t) != len(want_t):
        return 1 << 31
    err = 0
    for g, w in zip(got_t, want_t):
        if g is None or w is None:        # an output only one mode has
            if g is not None or w is not None:
                return 1 << 31
            continue
        if g.shape != w.shape:
            return 1 << 31
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def exactness_sweep(port, kerns, plains, data, genome, device, keep=None):
    """{kernel: [(case, max abs err)]} over ops/cases.py: the cases the CPU
    tests hold the plain versions to the JAX package on (seed 0, scale 1)
    and the same generator at eight times the problems (seed 1). The read
    sweep, the half-read search (on the read sweep's patterns) and the
    seed search run on `data` (the genome's index) and on a genome whose
    n + 1 = 2048 rows fill whole blocks, where the first LF of bot reads
    the row past the last block; the SA walk on both genomes indexed with
    marks every 1, 16 and 32 text positions. `keep`, a dict, receives
    each (genome name, period): (index, genome) the FM cases ran on."""
    def put(x):
        return None if x is None else torch.from_numpy(x).to(device)

    sw = port.sw
    out = {k: [] for k in kerns}
    for seed, scale in ((0, 1), (1, 8)):
        padded = port.cases.padded_origin_cases(seed=seed, scale=scale)
        for c, n_live in (
                [(c, None) for c in port.cases.dp_cases(seed=seed, scale=scale)
                 + port.cases.origin_cases(seed=seed, scale=scale)]
                + [(c, c.n_live) for c in padded]
                + [(c, torch.tensor(c.n_live, dtype=torch.int32,
                                    device=device)) for c in padded]):
            args = sw.sw_args(put(c.reads), put(c.quals), put(c.lens),
                              put(c.wins), sw.SWParams(**c.params()),
                              c.band, put(c.rect_cols), put(c.col_lo), n_live)
            form = "" if n_live is None else (
                "@n_live_tensor" if isinstance(n_live, torch.Tensor)
                else "@n_live_int")
            for k in ("sw_rect", "sw_rect_origin"):
                out[k].append((f"{c.name}{form}@x{scale}", max_err(
                    kerns[k], plains[k], args, rect_err)[1]))

        def dp(c):
            res = plains["sw_rect"](*sw.sw_args(
                put(c.reads), put(c.quals), put(c.lens), put(c.wins),
                sw.SWParams(**c.params()), c.band, put(c.rect_cols),
                put(c.col_lo)))
            return (res.row.cpu().numpy(), res.lane.cpu().numpy(),
                    res.dirs.cpu().numpy())
        for c in port.cases.bt_cases(dp, seed=seed, scale=scale):
            p = sw.SWParams(**c.params())
            args = (put(c.dirs), put(c.sel), put(c.rows), put(c.lanes),
                    put(c.reads), sw.mm_penalty_from_qual(put(c.quals), p),
                    put(c.wins), p,
                    sw.bt_steps(c.dirs.shape[0], c.wins.shape[1], c.local))
            out["backtrace"].append((f"{c.name}@x{scale}", max_err(
                kerns["backtrace"], plains["backtrace"], args)[1]))
    g_fill = np.random.default_rng(2047).integers(0, 4, 2047).astype(
        np.uint8)
    for gname, g in (("repcorpus", genome), ("fill", g_fill)):
        for period in port.cases.RESOLVE_PERIODS:
            off_rate = period.bit_length() - 1
            d = data if gname == "repcorpus" and off_rate == data.off_rate \
                else port.build_index_from_refs(
                    [("g", g.astype(np.uint8))], off_rate=off_rate,
                    **({"ftab_chars": 4} if gname == "fill" else {}))
            h = port.FMIndex.from_host(d, device=device).fw
            if keep is not None:
                keep[gname, period] = (d, g)
            if gname == "fill" and h.nrows % 128:
                fail(f"fill genome: {h.nrows} rows is not a multiple of 128")
            for seed, scale in ((0, 1), (1, 8)):
                # the BWT is the same at every period: sweep it once
                sweeps = port.cases.sweep_cases(g, seed=seed, scale=scale) \
                    if period == port.cases.RESOLVE_PERIODS[0] else []
                for cname, rr in sweeps:
                    for k in ("fm_sweep", "fm_substring"):
                        out[k].append((f"{gname}_{cname}@x{scale}", max_err(
                            kerns[k], plains[k], (h, put(rr)))[1]))
                seeds = port.cases.seed_cases(
                    g, d.fw.ftab_chars, seed=seed, scale=scale) \
                    if period == port.cases.RESOLVE_PERIODS[0] else []
                for cname, sd, valid, slen, K in seeds:
                    out["fm_seed"].append((
                        f"{gname}_{cname}@x{scale}", max_err(
                            kerns["fm_seed"], plains["fm_seed"],
                            (h, put(sd), put(valid), slen, K))[1]))
                for kind, rows in port.cases.resolve_cases(
                        d.fw, period, seed=seed, scale=scale):
                    out["sa_resolve"].append((
                        f"{gname}_p{period}_{kind}@x{scale}", max_err(
                            kerns["sa_resolve"], plains["sa_resolve"],
                            (h, put(rows), period))[1]))
    return out


def split_line(label, total, by, reg, build_mod):
    """The log line of a CUPTI split: device time by kernel, the
    hand-written kernels (those ptxas reported for this repo's sources)
    apart from the torch ops' kernels and the copies, and by region (the
    torch-op kernels launched inside each range; a ctypes launch is not
    linked to its range). Returns the hand-written kernels' times."""
    hand = {n.split("<")[0] for src in build_mod.PTXAS.values() for n in src}
    ours = {k.split("::")[-1]: round(v, 4) for k, v in by.items()
            if k.split("<")[0].split("::")[-1] in hand}
    mem = [v for k, v in by.items() if k.startswith("Mem")]
    torch_ops = (total or 0.0) - sum(ours.values()) - sum(mem)
    log(f"CUPTI split of {label}: {total} ms on the card over {len(by)} "
        f"kernels and copies: hand-written {json.dumps(ours)} (sum "
        f"{sum(ours.values()):.4f}), torch ops {torch_ops:.4f} over "
        f"{len(by) - len(ours) - len(mem)} kernels, copies {sum(mem):.4f}; "
        f"regions "
        f"{json.dumps({k: round(v, 4) for k, v in reg.items()})}; top "
        f"{json.dumps({k: round(v, 4) for k, v in list(by.items())[:10]})}")
    return ours


def window_sweep(ref, fm, cases, holder, dev):
    """{K7 entry: [(case, max abs err)]}: both forms on every ops/cases.py
    window_cases case at scale 1 and 8 on the card, the aligned form also
    over the case's word tables split into 4 shards."""
    out = {k: [] for k in K7}

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for seed, scale in ((0, 1), (1, 8)):
        for c in cases.window_cases(seed=seed, scale=scale):
            w, n = put(c.ref_words), put(c.refn_words)
            ws = ref.ShardedWords(fm.shard_rows(w, [dev] * 4, dev))
            ns = ref.ShardedWords(fm.shard_rows(n, [dev] * 4, dev))
            rest = (put(c.starts), put(c.lo), put(c.hi), c.width)
            for e, tabs in (("ref_gather_aligned", (w, n)),
                            ("ref_gather", (w, n)),
                            ("ref_gather_aligned_sh", (ws, ns))):
                out[e].append((c.name, max_err(
                    holder.kern_of(e), holder.plain_of(e), tabs + rest)[1]))
    return out


def ptxas_of(build_mod, name, src_name):
    """ptxas's report of the kernels behind entry `name`."""
    pats = PTXAS_FUNCS[name]
    pats = pats if isinstance(pats, list) else [
        pats if isinstance(pats, tuple) else (pats, "")]
    return {k: v for k, v in build_mod.PTXAS.get(src_name, {}).items()
            if any(k.startswith(p) and k.endswith(s) for p, s in pats)}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def fm_work(fm, name, args):
    """(bytes, LF steps, derived facts) that the search needs on these
    inputs: each input read once, each output written once. Each search
    replays the plain version's state on the card and is charged only
    what it touches: the 48-byte row of each distinct block where a live
    step (a LF step of a range that is not empty, code < 4; the read
    sweep restarts an empty range and steps every code < 4) reads top or
    bot (and in the int64 mode its 32-byte occ_cp64 row), two ftab
    entries (4 bytes each, int32 bits in the small and large modes, 8 in
    the int64 mode) for each distinct ftab key a valid seed with no N in
    its tail looks up, and fchr. Rows in and out count at the tensor API's
    row type: 8 bytes in the large mode, whose rows are int64 tensors
    holding uint32 values, and in the int64 mode.
    LF steps are two a live step. The facts are derived from the replay,
    not measured:
    - live_step_share: live steps over the state-steps the search has (a
      seed's seed_len - K columns; a half-read state's columns of code
      < 5);
    - same_block_share: live steps whose top and bot lie in one 128-row
      block, over live steps;
    - l2_sectors: the 32-byte sectors the search asks for, under the model
      that a row's loads (bwt words 0-3 and 4-7, cp[c]) span two sectors
      at its 16-byte alignment: two a live step, two more when bot lies in
      another block, and the inputs and outputs read or written once (one
      sector a ftab lookup)."""
    half = args[0]
    rdt = half.row_dtype
    rsize = torch.empty(0, dtype=rdt).element_size()
    keys = lookups = 0
    if name in ("fm_sweep", "fm_substring"):
        rr = args[1]
        B = rr.shape[0]
        top = torch.zeros(B, dtype=rdt, device=rr.device)
        bot = torch.full((B,), half.nrows, dtype=rdt, device=rr.device)
        cols = [rr[:, p] for p in range(rr.shape[1])]
        slots = int((rr < 5).sum())
        # outputs: top and bot (and the sweep's int32 edit count)
        io = nbytes(rr) + 2 * B * rsize + 4 * B * (name == "fm_sweep")
    else:
        _, seeds, valid, seed_len, K = args
        B = seeds.shape[0]
        if not 0 < K <= seed_len:
            K = 0
        if K:
            # the ftab start (last K chars), then LF steps right to left
            tail = seeds[:, seed_len - K:]
            w = 4 ** torch.arange(K - 1, -1, -1, dtype=torch.int32,
                                  device=seeds.device)
            key = (torch.clamp(tail, 0, 3) * w).sum(dim=1)
            top0, bot0 = fm.ftab_lookup_batch(half, key)
            ok = valid & ~(tail >= 4).any(dim=1)
            keys = torch.unique(key[ok]).numel()
            lookups = int(ok.sum())
            top = torch.where(ok, top0, 1)
            bot = torch.where(ok, bot0, 0)
        else:
            top = torch.zeros(B, dtype=rdt, device=seeds.device)
            bot = torch.where(valid, half.nrows, 0).to(rdt)
        cols = [seeds[:, q] for q in range(seed_len - K - 1, -1, -1)]
        slots = B * len(cols)
        io = nbytes(seeds, valid) + 2 * B * rsize
    nb = half.fm_blocks.shape[0]
    live_n = same_n = 0
    blocks = []
    for c in cols:
        if name == "fm_sweep":
            live = c < 4
        else:
            live = (c < 4) & (top < bot)
        bt, bb = top[live] // 128, bot[live] // 128
        live_n += int(live.sum())
        same_n += int((bt == bb).sum())
        blocks.append(torch.unique(torch.cat([bt, bb]).clamp(max=nb - 1)))
        ntop, nbot = fm._lf2(half, top, bot, torch.clamp(c, 0, 3))
        if name == "fm_sweep":       # restart on an empty range or an N
            empty = (ntop >= nbot) | (c == 4)
            ntop = torch.where(empty, 0, ntop)
            nbot = torch.where(empty, half.nrows, nbot)
        else:
            dead = (c >= 4) | ~(top < bot)
            ntop = torch.where(dead, 1, ntop)
            nbot = torch.where(dead, 0, nbot)
        act = c < 5 if name != "fm_seed" else torch.ones_like(live)
        top = torch.where(act, ntop, top)
        bot = torch.where(act, nbot, bot)
    rows = torch.unique(torch.cat(blocks)).numel() if blocks else 0
    facts = dict(live_step_share=round(live_n / max(slots, 1), 4),
                 same_block_share=round(same_n / max(live_n, 1), 4),
                 live_steps=live_n, rows_touched=rows, ftab_keys=keys,
                 l2_sectors=2 * live_n + 2 * (live_n - same_n) + lookups
                 + -(-io // 32))
    # a block's fused row, and in the int64 mode its 32-byte occ_cp64 row
    row_bytes = 48 + 32 * half.i64
    return (row_bytes * rows + 2 * half.ftab.element_size() * keys
            + nbytes(half.fchr) + io,
            2 * live_n, facts)


def resolve_work(fm, args):
    """sa_resolve: (bytes, operations, facts) on these inputs. The plain
    walk is replayed to count each row's LF steps (offset minus the marked
    row's sample) and what the walks touch. The bytes are what the
    function must read and write: the mark row (20 bytes) of each distinct
    block where a walk tests a mark, the FM row (48 bytes, and in the int64
    mode its 32-byte occ_cp64 row) of each distinct block where a walk
    takes a LF step, one offset (4 bytes, 8 in the int64 mode) for each
    distinct row a walk ends on, fchr, the rows and the output. The facts
    are derived from the replay, not measured:
    - lane_idle_share: over the input's 32-row warps (one row a lane),
      1 - (sum of steps) / (sum over warps of 32 x the warp's most steps);
    - sectors: the 32-byte sectors the walk asks for, lane by lane
      (SECTORS_STEP a LF step, SECTORS_ROW a row);
    - sectors_warp: the same sectors counted once a warp at each step
      (what coalescing leaves of `sectors`): the distinct mark-word sectors
      of the warp's walking lanes, and the distinct FM-row sectors of those
      that take a LF step, plus two a row for the rank words and offset."""
    half, rows, period = args
    B = rows.numel()
    steps = torch.zeros(B, dtype=torch.int64, device=rows.device)
    warp = torch.arange(B, device=rows.device) // 32
    row = rows.clone()
    done = torch.zeros_like(row, dtype=torch.bool)
    sectors_warp = 0
    mark_blocks, lf_blocks = [], []
    for it in range(period + 1):
        block = row // 128
        pos = (row % 128)[:, None]
        live = ~done
        mark_blocks.append(torch.unique(block[live]))
        mb, _ = fm._mark_bits(half, block)
        if it < period:
            done = done | (mb.gather(1, pos.long())[:, 0] == 1)
        step = ~done
        b64 = block.long()
        keys = torch.cat([
            ((b64 * 20 + (pos[:, 0].long() >> 5) * 4) >> 5)[live],
            (1 << 40) + ((b64 * 48) >> 5)[step],
            (1 << 40) + ((b64 * 48 + 47) >> 5)[step]])
        wl = torch.cat([warp[live], warp[step], warp[step]])
        sectors_warp += int(torch.unique(wl * (1 << 42) + keys).numel())
        if it == period:
            break
        lf_blocks.append(torch.unique(block[step]))
        steps += step.long()
        frows = fm._rows(half, block)
        c = fm._crumbs(frows[:, :8]).gather(1, pos.long())[:, 0]
        row = torch.where(done, row, fm.lf_row(half, row, c, frows))
    total = int(steps.sum())
    pad = torch.zeros((-B) % 32, dtype=torch.int64, device=rows.device)
    wmax = torch.cat([steps, pad]).view(-1, 32).max(dim=1).values
    facts = dict(
        steps=total,
        lane_idle_share=1 - total / max(1, 32 * int(wmax.sum())),
        sectors=SECTORS_STEP * total + SECTORS_ROW * B,
        sectors_warp=sectors_warp + 2 * B)
    rsize = rows.element_size()         # rows and offsets: the row type
    # the int64 mode: a block's occ_cp64 row beside its fused row, and
    # 8-byte offsets
    byt = (20 * torch.unique(torch.cat(mark_blocks)).numel()
           + (48 + 32 * half.i64) * torch.unique(torch.cat(lf_blocks)).numel()
           + (4 + 4 * half.i64) * torch.unique(row).numel()
           + nbytes(half.fchr, rows) + B * rsize)
    return byt, total * OPS_RESOLVE_STEP + B * OPS_RESOLVE_ROW, facts


def walk_work(got, sel, rows, lanes):
    """A walk call's (bytes, operations, share of steps past the walks'
    ends) from its op bytes: a direction word a step and one for the test
    that ends each walk; a read code and a penalty a row moved through (M
    or I), a window code a column moved through (M or D); sel, rows and
    lanes; the ops and the seven fields written; OPS_BT_STEP operations a
    step walked."""
    op = got.ops & 3
    none = int((op == 3).sum())
    walked = got.ops.numel() - none
    moved_rows = int((op < 2).sum())
    moved_cols = int(((op & 1) == 0).sum())
    byt = (walked + sel.numel()) * 4 + moved_rows * 8 + moved_cols * 4 + \
        nbytes(sel, rows, lanes, got.ops) + 7 * sel.numel() * 4
    return byt, walked * OPS_BT_STEP, round(none / got.ops.numel(), 4)


def diag_work(args):
    """What a band-DP call's data needs: each problem's len rows of BW
    cells at OPS_DP_CELL operations; its len rows' direction words (Wp
    words a row), read code, penalty and the one window code that enters
    the band a row, the first row's BW codes, its length and the best
    cell's three fields. Returns (bytes, operations, cells)."""
    reads, _m, lens, _w, _p, band = args
    BW = 2 * band + 1
    Wp = (BW + 7) // 8
    rows = int(lens.long().clamp(0, reads.shape[1]).sum())
    B = reads.shape[0]
    byt = rows * (4 * Wp + 12) + B * (4 * BW + 16)
    return byt, rows * BW * OPS_DP_CELL, rows * BW


def clock_window(fn, reps):
    """time_cuda(fn, reps) with nvidia-smi's clocks.sm sampled every 50 ms
    beside it: (ms, mean MHz of the samples taken inside the window, or
    None, sample count)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)                  # nvidia-smi's own start
        t0 = datetime.datetime.now()
        ms = time_cuda(fn, reps)
        t1 = datetime.datetime.now()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    mhz = []
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        try:
            ts = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
            if t0 <= ts <= t1:
                mhz.append(float(parts[1]))
        except (ValueError, IndexError):
            continue
    return ms, (sum(mhz) / len(mhz) if mhz else None), len(mhz)


def window_reps(fn, least):
    """Launches for a timing window of about WINDOW_MS (at least `least`)."""
    est = time_cuda(fn, 1)
    return max(least, min(4000, int(math.ceil(WINDOW_MS / max(est, 1e-3)))))


def parent_libs(_build, d):
    """--compare-parent DIR: every CUDA source in DIR that differs from the
    port's own csrc/ file of its name, built by nvcc with the port's flags
    (DIR's headers before the port's) into a temporary directory:
    {source name: library}."""
    if not os.path.isdir(d):
        fail(f"--compare-parent {d}: not a directory")
    libs = {}
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".cu"):
            continue
        name, path = fname[:-3], os.path.join(d, fname)
        own = os.path.join(_build.CSRC, fname)
        with open(path, "rb") as f:
            text = f.read()
        if os.path.exists(own):
            with open(own, "rb") as f:
                if f.read() == text:
                    log(f"--compare-parent {path}: the port's own source")
                    continue
        so = os.path.join(tempfile.mkdtemp(prefix="cmp_"), name + ".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-I",
               _build.CSRC, "-o", so, path]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"--compare-parent build of {path}: {r.stdout}{r.stderr}")
        libs[name] = ctypes.CDLL(so)
        log(f"--compare-parent {path}: built; ptxas "
            f"{json.dumps(_build.ptxas_usage(r.stdout + r.stderr), sort_keys=True)}"
            + ("" if name in TURN_SOURCES else
               "; no call of its kernels is timed in turns"))
    return libs


def with_lib(build, lib, fn, name):
    """fn() with the C entries of csrc/<name>.cu taken from `lib`."""
    saved = build.lib(name)
    build._LIBS[name] = lib
    try:
        return fn()
    finally:
        build._LIBS[name] = saved


def turns(a, run, parent, err=result_err, reps=None, per=None, idle=True):
    """run() (this design) timed alone, or in turns with parent() (the same
    call through another build of its source, --compare-parent): parent,
    this, this, parent; then, with `idle`, each after IDLE_S idle. `reps`
    launches a window; None for a window of about WINDOW_MS with clocks.sm
    sampled beside it (`*_mhz`, `*_clk_samples`, and with per=(unit, n)
    the cycles a unit, `*_clk_<unit>`). parent()'s output is held to
    run()'s by err(parent's, this)."""
    sample = reps is None
    res = {"reps": window_reps(run, a.reps) if sample else reps,
           "max_abs_err": 0}
    order = [("this", run)]
    if parent is not None:
        res["max_abs_err"] = err(parent(), run())
        order = [("parent", parent), ("this", run), ("this", run),
                 ("parent", parent)]
    for tag, fn in order:
        if sample:
            ms, mhz, n = clock_window(fn, res["reps"])
            res.setdefault(f"{tag}_mhz", []).append(
                None if mhz is None else round(mhz, 1))
            res.setdefault(f"{tag}_clk_samples", []).append(n)
            if per is not None:
                res.setdefault(f"{tag}_clk_{per[0]}", []).append(
                    None if mhz is None else round(ms * mhz * 1e3 / per[1], 1))
        else:
            ms = time_cuda(fn, res["reps"])
        res.setdefault(f"{tag}_ms", []).append(round(ms, 5))
    if idle:
        for tag, fn in dict(order).items():
            res[f"{tag}_idle_ms"] = round(time_after_idle(fn, 5), 4)
    return res


def rect_turns(a, m, label, kern, args, parent_lib):
    """The DP call `args` in turns with the parent's build of sw_rect.cu,
    held to this design's output over what the n_live contract specifies
    (rect_err); clocks a row over the longest live read's rows."""
    n = live_count(args)
    rows = max(int(args[2][:n].max()) if n else 1, 1)

    def run():
        return kern(*args)
    res = {"call": label, "lanes": args[0].shape[0], "n_live": n,
           "rows": rows, "Lmax": args[0].shape[1], "W": args[3].shape[1],
           **turns(a, run,
                   lambda: with_lib(m._build, parent_lib, run, "sw_rect"),
                   lambda got, want: rect_err(got, want, args),
                   per=("row", rows))}
    log(f"compare sw_rect {label}: {json.dumps(res)}")
    return res


def gather_floor(args):
    """One block's worth of a K7 unaligned call (BLOCK_CODES: 128 threads
    of 16 codes): its first windows that hold 2,048 codes, at least one."""
    w, n, starts, lo, hi, width = args
    rows = max(1, BLOCK_CODES // max(width, 1))
    return (w, n) + tuple(t[:rows].contiguous() for t in (starts, lo, hi)) \
        + (width,)


def aligned_floor(args):
    """One block's worth of a K7 aligned call (BLOCK_CODES codes): its
    first windows of aligned width that hold 2,048 codes, at least one."""
    w, n, starts, lo, hi, width = args
    rows = max(1, BLOCK_CODES // (32 * ((width + 62) // 32)))
    return (w, n) + tuple(t[:rows].contiguous() for t in (starts, lo, hi)) \
        + (width,)


def readout_floor(args):
    """One block's worth of a K10 SE call: its first READOUT_BLOCK
    candidates."""
    return tuple(t[:READOUT_BLOCK].contiguous() for t in args[:6]) + \
        (args[6],)


def readout_call(Bc, Lmax, Wf, base, params, seed, dev):
    """Inputs of a K10 SE call of the fused path's kind: Bc candidates of
    the LEN_BUCKETS bucket Lmax, windows of width Wf and the diagonals'
    start columns `base` (Bc,); reads of lengths over the bucket's range
    copied off their diagonals with 1 % substitutions and 4 past their
    ends, windows of random codes with 0.1 % Ns, quals 2-40, rows = lens -
    1 and lens = rows + 1 as the fused path passes them."""
    from bowtie2_tpu_torch.pipeline.align import LEN_BUCKETS
    rng = np.random.default_rng(seed)
    prev = max([b for b in LEN_BUCKETS if b < Lmax], default=0)
    lens = rng.integers(prev + 1, Lmax + 1, Bc).astype(np.int32)
    base = np.clip(np.asarray(base, np.int64), 0, Wf - Lmax)
    wins = rng.integers(0, 4, (Bc, Wf)).astype(np.int32)
    wins[rng.random((Bc, Wf)) < 0.001] = 4
    reads = np.take_along_axis(wins, base[:, None] + np.arange(Lmax), 1)
    sub = rng.random((Bc, Lmax)) < 0.01
    reads[sub] = (reads[sub] + 1) % 4
    past = np.arange(Lmax)[None, :] >= lens[:, None]
    reads[past] = 4
    quals = np.where(past, 0, rng.integers(2, 41, (Bc, Lmax)))
    rows = lens - 1
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
                 for x in (reads, quals, wins, rows, base + rows, rows + 1)) \
        + (params,)


def long_readout_args(args, Lmax, seed):
    """readout_call at the bucket Lmax (past the kernel's 256-step tile)
    after a main-path call `args` (Lmax0, window Wf0): its candidates,
    windows Lmax - Lmax0 wider (to a multiple of 32, as aligned_width
    gives them), its diagonals' start columns."""
    reads0, wins0, rows0, lanes0 = (args[k] for k in (0, 2, 3, 4))
    Bc, L0 = reads0.shape
    Wf = 32 * -(-(Lmax + wins0.shape[1] - L0) // 32)
    base = (lanes0.long() - rows0.long()).cpu().numpy()
    return readout_call(Bc, Lmax, Wf, base, args[6], seed, reads0.device)


def pairing_floor(args, n=8):
    """One block's worth of a K10 PE call (8 pairs at T <= 16): its first
    n pairs, both mates."""
    pairing, _B, Bp, T = args[:4]
    n = min(n, Bp)
    return (pairing, 2 * n, n, T) + tuple(
        torch.cat([t[:n], t[Bp:Bp + n]]).contiguous() for t in args[4:])


def short_turns(a, build, name, label, kern, args, floor_args, parent_lib,
                plain=None):
    """A call of a short kernel of csrc/<name>.cu (`kern` on `args`) and
    its one-block floor (`floor_args`) in turns with the parent's build,
    TURN_REPS launches a window; with `plain`, the floor's result is held
    to the plain version's too (`floor.plain_err`)."""
    def timed(x, idle):
        def run():
            return kern(*x)
        return turns(a, run, lambda: with_lib(build, parent_lib, run, name),
                     reps=TURN_REPS, idle=idle)
    res = {"call": label, **timed(args, True),
           "floor": timed(floor_args, False)}
    if plain is not None:
        res["floor"]["plain_err"] = max_err(kern, plain, floor_args)[1]
        res["floor"]["max_abs_err"] = max(res["floor"]["max_abs_err"],
                                          res["floor"]["plain_err"])
    res["max_abs_err"] = max(res["max_abs_err"],
                             res["floor"]["max_abs_err"])
    log(f"compare {name} {label}: {json.dumps(res)}")
    return res


def floor_turns(a, build, entry, src, label, kern, plain, args, floor,
                what, parent_lib):
    """A held kernel's one-block floor (`floor`, `what` in words): timed
    alone (`chain_ms`) and held to its plain version (`chain_err`); with
    a parent build of csrc/<src>.cu, the call `args` and that floor in
    turns with it (`turns`). Every error goes into the entry's
    max_abs_err."""
    entry["chain_ms"] = round(time_cuda(lambda: kern(*floor), a.reps), 5)
    entry["chain_err"] = max_err(kern, plain, floor)[1]
    log(f"kernel {entry['name']}: one block alone (chain_ms) "
        f"{entry['chain_ms']} on {what}, max abs err {entry['chain_err']}")
    if parent_lib is not None:
        entry.setdefault("turns", []).append(short_turns(
            a, build, src, label, kern, args, floor, parent_lib, plain))
    entry["max_abs_err"] = max([entry["max_abs_err"], entry["chain_err"]]
                               + [t["max_abs_err"]
                                  for t in entry.get("turns", [])])
    entry["equal"] = entry["max_abs_err"] == 0


def gather_classes(a, build, kern, kept, counts, parent_lib,
                   entry="ref_gather", src="ref_gather",
                   below=lambda B, w: B * w < BLOCK_CODES):
    """Each shape of call of `entry` (a kernel of csrc/<src>.cu: K7's
    unaligned or aligned form, or K10 SE) that a main path launched
    (`counts`: {shape: [ms, launches]} from its device-time pass, the
    SHAPE_ARGS of the C call: (windows, width), the aligned width for the
    aligned form, or (candidates, Lmax, window width); `kept`: {shape: a
    call's arguments}) in turns with the parent's build, TURN_REPS
    launches a window: by class, the launches below one block's worth of
    work (`below(*shape)`: BLOCK_CODES codes, or READOUT_BLOCK candidates)
    and the rest, with their summed times in each design (launches x the
    mean of its two windows) and, by shape, [*shape, launches, this ms,
    parent ms] a launch."""
    out = {c: dict(shapes=[], launches=0, this_ms=0.0, parent_ms=0.0,
                   max_abs_err=0) for c in ("below_block", "rest")}
    for shape, (_ms, n) in sorted(counts.items()):
        args = kept.get(shape)
        if args is None:
            fail(f"no call of {entry} at {shape} was kept")

        def run():
            return kern(*args)
        t = turns(a, run, lambda: with_lib(build, parent_lib, run, src),
                  reps=TURN_REPS, idle=False)
        c = out["below_block" if below(*shape) else "rest"]
        mean = {tag: sum(t[f"{tag}_ms"]) / 2 for tag in ("this", "parent")}
        c["shapes"].append(list(shape) + [n, round(mean["this"], 5),
                                          round(mean["parent"], 5)])
        c["launches"] += n
        for tag in ("this", "parent"):
            c[f"{tag}_ms"] += n * mean[tag]
        c["max_abs_err"] = max(c["max_abs_err"], t["max_abs_err"])
    for c in out.values():
        for tag in ("this", "parent"):
            c[f"{tag}_ms"] = round(c[f"{tag}_ms"], 5)
    return out


def mutate(rng, codes, sub, indel=0.0):
    """codes with substitutions at rate sub and a 1-3-bp insertion or
    deletion at rate indel a base (none within 100 bp of either end)."""
    c = codes.astype(np.int8).copy()
    err = rng.random(c.size) < sub
    c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
    for _ in range(int(rng.binomial(c.size, indel))):
        q = int(rng.integers(100, c.size - 100))
        n = int(rng.integers(1, 4))
        c = (np.concatenate([c[:q], rng.integers(0, 4, n), c[q:]])
             if rng.random() < 0.5 else np.delete(c, range(q, q + n)))
    return c.astype(np.uint8)


def long_corpus(genome, rng, n, lens, sub, indel):
    """n reads of lengths uniform in lens[0]..lens[1] from the genome with
    mutate()'s errors, half reverse-complemented, quals 25-40. Returns
    [(name, codes, quals, 0-based start)]."""
    out = []
    for i in range(n):
        L = int(rng.integers(lens[0], lens[1] + 1))
        p = int(rng.integers(0, genome.size - L))
        c = mutate(rng, genome[p:p + L], sub, indel)
        if rng.random() < 0.5:
            c = (3 - c)[::-1].copy()
        out.append((f"lr{i}", c, rng.integers(25, 41, c.size).astype(
            np.uint8), p))
    return out


def ecoli_corpus(n_pairs):
    """bench.py gen_ecoli_corpus's recipe (default_rng(42)): a 4.6-Mbp
    random genome, 100,000 x 100-bp SE reads and 50,000 FR pairs (insert
    150-550), 0.5 % substitutions, quals 25-40. Returns (genome int8,
    SE (codes, quals), pairs (c1, c2, q1, q2) cut to n_pairs)."""
    rng = np.random.default_rng(42)
    G = ECOLI_GENOME
    genome = rng.integers(0, 4, G, dtype=np.int8)

    def reads(n, L):
        pos = rng.integers(0, G - L, n)
        idx = pos[:, None] + np.arange(L)[None, :]
        codes = genome[idx].astype(np.int8)
        err = rng.random((n, L)) < 0.005
        codes = np.where(err, (codes + rng.integers(1, 4, (n, L))) % 4, codes)
        rc = rng.random(n) < 0.5
        codes = np.where(rc[:, None], (3 - codes)[:, ::-1], codes)
        quals = rng.integers(25, 41, (n, L)).astype(np.uint8)
        return codes, quals

    se = reads(ECOLI_SE, 100)
    pos = rng.integers(0, G - 600, ECOLI_PAIRS)
    ins = rng.integers(150, 551, ECOLI_PAIRS)
    L = 100
    i1 = pos[:, None] + np.arange(L)[None, :]
    i2 = (pos + ins - L)[:, None] + np.arange(L)[None, :]
    c1 = genome[i1].astype(np.int8)
    c2 = (3 - genome[i2].astype(np.int8))[:, ::-1]
    for c in (c1, c2):
        err = rng.random(c.shape) < 0.005
        c[...] = np.where(err, (c + rng.integers(1, 4, c.shape)) % 4, c)
    q1 = rng.integers(25, 41, c1.shape).astype(np.uint8)
    q2 = rng.integers(25, 41, c2.shape).astype(np.uint8)
    return genome, se, (c1[:n_pairs], c2[:n_pairs], q1[:n_pairs],
                        q2[:n_pairs])


def mk_pairs(data, rng, n, L=100, err=0.02, bad_frac=0.15):
    """tests/test_pe_devpair.py's _mk_pairs recipe: FR pairs over the
    indexed genome in every outcome class: concordant, fragment too long
    (discordant), mate 2 garbage (rescue / mixed). Returns [(name, c1, c2,
    quals)]."""
    g_words = data.ref_words
    G = int(data.ref_cum[-1])

    def ref_codes(lo, k):
        gp = np.arange(lo, lo + k)
        return ((g_words[gp >> 4] >> (2 * (gp & 15))) & 3).astype(np.int8)

    out = []
    for i in range(n):
        pos = int(rng.integers(0, G - 700))
        kind = rng.random()
        if kind < bad_frac:                       # mate 2 garbage
            c1 = ref_codes(pos, L)
            c2 = rng.integers(0, 4, L).astype(np.int8)
        elif kind < 2 * bad_frac:                 # fragment too long
            ins = int(rng.integers(1200, 2000))
            if pos + ins + L >= G:
                ins = 600
            c1 = ref_codes(pos, L)
            c2 = ((3 - ref_codes(pos + ins - L, L)) % 4)[::-1].copy()
        else:                                     # concordant
            ins = int(rng.integers(150, 500))
            c1 = ref_codes(pos, L)
            c2 = ((3 - ref_codes(pos + ins - L, L)) % 4)[::-1].copy()
        for c in (c1, c2):
            e = rng.random(L) < err
            c[e] = (c[e] + rng.integers(1, 4, int(e.sum()))) % 4
        out.append((f"m{i}", c1.astype(np.uint8), c2.astype(np.uint8),
                    np.full(L, 35, np.uint8)))
    return out


def write_fastq(path, names, codes, quals):
    alpha = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for nm, c, q in zip(names, codes, quals):
            f.write(f"@{nm}\n{alpha[np.asarray(c, np.int64)].tobytes().decode()}"
                    f"\n+\n{(np.asarray(q, np.uint8) + 33).tobytes().decode()}"
                    "\n")


def sam_without_cl(path):
    """A SAM file's lines, with the @PG line's CL: field (the command
    line) cut off."""
    out = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@PG"):
                line = b"\t".join(x for x in line.rstrip(b"\n").split(b"\t")
                                  if not x.startswith(b"CL:"))
            out.append(line)
    return out


def hostneed_pairs(fpb, fused):
    """Pairs of a submitted PE batch whose device pairing raised
    `hostneed` (read back from the blob)."""
    meta = fpb.res.blob.cpu().numpy()
    off = fused.PE_READ_FIELDS * fpb.B2
    pf = meta[off:off + fused.PE_PAIR_FIELDS * fpb.Bp].reshape(
        fused.PE_PAIR_FIELDS, fpb.Bp)
    return int(pf[fused.PE_PAIR_FIELDS - 1, :fpb.B].sum())


def dp_work(args, origin):
    """What a DP call's data needs moved and computed: each problem's read
    rows (a code and a penalty each) and its rect columns of the window (a
    code each), its length, rect columns and first column; the direction
    words of its rows over its rect columns; the best cell's fields (and
    origin) written. Padding problems count with their own (short) lengths.
    Returns (bytes, cells)."""
    _r, _m, lens, _w, _p, rect_cols, col_lo, _n = args
    ln = lens.long().clamp(min=0)
    rc = rect_cols.long().clamp(min=0)
    cells = int((ln * rc).sum())
    dir_words = int((ln * ((rc + 7) // 8)).sum())
    per_problem = 4 * (2 + (col_lo is not None)) + 4 * (3 + bool(origin))
    byt = int(ln.sum()) * 8 + int(rc.sum()) * 4 + dir_words * 4 + \
        ln.numel() * per_problem
    return byt, cells


def dp_entry(name, kern, plain, args, more_args, reps, total, launches,
             chain_ms, sweep, build_mod, origin):
    """A DP kernel's entry of the `kernels` line (and its log line): exact
    against the plain version on args and each of more_args (rect_err),
    timed back to back and after idle, its bound from what its data needs
    (dp_work)."""
    _got, err = max_err(kern, plain, args, rect_err)
    errs = [max_err(kern, plain, m, rect_err)[1] for m in more_args]
    sweep_err = max((e for _, e in sweep), default=0)
    ms = time_cuda(lambda: kern(*args), reps)
    idle_ms = time_after_idle(lambda: kern(*args), 5)
    plain_ms = time_cuda(lambda: plain(*args), 2, spin=0)
    byt, cells = dp_work(args, origin)
    cells_launched = rect_cells(args)[1]
    ops = cells * (OPS_DP_CELL_ORIGIN if origin else OPS_DP_CELL)
    t_bytes = byt / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    e = max([err, sweep_err] + errs)
    entry = dict(
        name=name, route="cuda", source=PE_KERNELS[name][0],
        replaces=PE_KERNELS[name][1], launches=launches, max_abs_err=e,
        equal=e == 0, ms=round(ms, 4), idle_ms=round(idle_ms, 4),
        plain_ms=round(plain_ms, 3), bound_ms=round(max(t_bytes, t_ops), 5),
        bytes_ms=round(t_bytes, 5), ops_ms=round(t_ops, 5),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, total_ms=round(total[0], 4), total_spans=total[1],
        ptxas=ptxas_of(build_mod, name, "sw_rect"),
        shape=[list(t.shape) for t in args
               if isinstance(t, torch.Tensor)][:4], cells=cells,
        cells_launched=cells_launched, n_live=live_count(args))
    if chain_ms is not None:
        entry["chain_ms"] = round(chain_ms, 4)
    if sweep:
        entry["sweep_cases"] = len(sweep)
    log(f"kernel {name}: equal={e == 0} max_abs_err={err} (other calls "
        f"{errs}, sweep {sweep_err} over {len(sweep)} cases) ms={ms:.4f} "
        f"idle_ms={idle_ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={max(t_bytes, t_ops):.5f} (bytes {t_bytes:.5f}, "
        f"operations {t_ops:.5f}) total_ms={total[0]:.4f} over {total[1]} "
        f"launches; launches on the PE path {launches}; cells={cells} "
        f"cells_launched={cells_launched} n_live={live_count(args)}"
        + (f" chain_ms={chain_ms:.4f}" if chain_ms is not None else "")
        + f" shape {entry['shape']} ptxas {entry['ptxas']}")
    return entry



def gather_work(args, aligned):
    """K7's (bytes, operations) on a call's inputs: the reference and N
    words each window spans, its start, lo and hi read once, its codes
    (and, aligned, its shift) written once; OPS_GATHER_CODE a code."""
    _w, _n, starts, _lo, _hi, width = args
    B, pb = starts.shape[0], starts.element_size()
    s = starts.long()
    if aligned:
        W = 32 * ((width + 62) // 32)
        words = B * (W // 16 + W // 32)
        out = B * (W + 1) * 4
    else:
        W = width
        e = s + max(width, 1) - 1
        words = int(((e >> 4) - (s >> 4) + 1).sum()
                    + ((e >> 5) - (s >> 5) + 1).sum())
        out = B * W * 4
    return words * 4 + 3 * B * pb + out, B * W * OPS_GATHER_CODE


def pairing_work(args, out):
    """K10 PE's (bytes, operations) on a call's inputs: every slot and read
    field read once, the fields written once; OPS_PAIR_COMBO a
    combination, OPS_PAIR_SLOTS a (slot, slot) pair of a read."""
    B, Bp, T = args[1], args[2], args[3]
    byt = nbytes(*[t for t in args if isinstance(t, torch.Tensor)]) + \
        nbytes(*out)
    return byt, Bp * T * T * OPS_PAIR_COMBO + B * T * T * OPS_PAIR_SLOTS


def readout_work(args, out):
    """K10 SE's (bytes, operations) on a call's inputs, as far as the data
    needs them: rows, lanes and lengths read once; a candidate's read
    codes, and its window codes where the diagonal lies in the window, at
    the positions the function reads (below max(lens, rows + 1), at most
    Lmax: the sums' live ones and the walk's; all Lmax where a wrapped
    rows - s reaches position Lmax - 1); its quals only where a live
    position is a mismatch, whose penalty they give; the (Lmax, Bc) op
    bytes and the per-candidate outputs (four int32, one byte) written
    once; OPS_READOUT_POS a position read."""
    reads, quals, wins, rows, lanes, lens, _p = args
    Bc, L = reads.shape
    r, n = rows.long(), lens.long()
    ar = torch.arange(L, device=reads.device)[None, :]
    top = torch.where(r >= 0, torch.clamp(r, max=L - 1) + 1,
                      torch.where(r < -(1 << 31) + L - 1, L, 0))
    need = ar < torch.maximum(torch.clamp(n, 0, L), top)[:, None]
    idx = (lanes.long() - r)[:, None] + ar
    inwin = (idx >= 0) & (idx < wins.shape[1])
    diag = torch.where(inwin, wins.gather(
        1, torch.clamp(idx, 0, wins.shape[1] - 1)), 5)
    mism = (ar < n[:, None]) & (diag < 4) & (reads < 4) & (diag != reads)
    byt = 4 * int(need.sum() + (need & inwin).sum() + mism.sum()) + \
        nbytes(rows, lanes, lens) + Bc * L + (4 * 4 + 1) * Bc
    return byt, int(need.sum()) * OPS_READOUT_POS


def readout_sweep(cases, sw, holder, dev):
    """The readout kernel against its plain version on every
    ops/cases.py readout_cases case at scale 1 and 8: [(case, max abs
    err)]."""
    out = []
    kern, plain = holder.kern_of(K10SE[0]), holder.plain_of(K10SE[0])
    for scale in (1, 8):
        for c in cases.readout_cases(scale=scale):
            args = tuple(torch.from_numpy(x).to(dev) for x in (
                c.reads, c.quals, c.wins, c.rows, c.lanes, c.lens)) + (
                sw.SWParams(**c.params),)
            out.append((f"{c.name} x{scale}", max_err(kern, plain, args)[1]))
    return out


def new_entry(name, src, repl, holder, args, work, reps, launches, total,
              build_mod, sweep=(), more=None, shape=None):
    """The `kernels` entry (and log line) of a kernel held by the Holder
    (K7, K10 PE, K10 SE) at one main-path call: exact against its plain
    version there, on every call the Holder kept (`checks`) and on the
    ops/cases.py sweep; timed back to back, after idle and under CUPTI
    (kernel and plain version); its bound from `work(args, result)`."""
    kern, plain = holder.kern_of(name), holder.plain_of(name)
    got, err = max_err(kern, plain, args)
    ms = time_cuda(lambda: kern(*args), reps)
    idle_ms = time_after_idle(lambda: kern(*args), 5)
    plain_ms = time_cuda(lambda: plain(*args), 2, spin=0)
    k_cupti, k_by, _r = cupti(lambda: kern(*args))
    p_cupti, p_by, _r = cupti(lambda: plain(*args))
    byt, ops = work(args, got)
    t_bytes = byt / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    sweep_err = max((e for _, e in sweep), default=0)
    e = max(err, sweep_err, holder.max_err(name))
    entry = dict(
        name=name, route="cuda", source=src, replaces=repl,
        launches=launches, max_abs_err=e, equal=e == 0, ms=round(ms, 4),
        idle_ms=round(idle_ms, 4), plain_ms=round(plain_ms, 3),
        bound_ms=round(max(t_bytes, t_ops), 5), bytes_ms=round(t_bytes, 5),
        ops_ms=round(t_ops, 5),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, total_ms=round(total[0], 4), total_spans=total[1],
        cupti_ms=None if k_cupti is None else round(k_cupti, 4),
        plain_cupti_ms=None if p_cupti is None else round(p_cupti, 4),
        plain_cupti_kernels=len(p_by),
        ptxas=ptxas_of(build_mod, name, os.path.splitext(
            os.path.basename(src))[0]),
        shape=shape if shape is not None else
        [args[2].shape[0], args[5]] if name in K7 else [args[2], args[3]],
        checks=holder.checks.get(name, {}))
    if sweep:
        entry["sweep_cases"] = len(sweep)
    entry.update(more or {})
    log(f"kernel {name}: equal={e == 0} max_abs_err={err} (kept calls "
        f"{holder.max_err(name)}, sweep {sweep_err} over {len(sweep)} "
        f"cases) ms={ms:.4f} idle_ms={idle_ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={entry['bound_ms']} (bytes {t_bytes:.5f}, operations "
        f"{t_ops:.5f}) total_ms={total[0]:.4f} over {total[1]} launches; "
        f"launches {launches}; CUPTI: kernel {entry['cupti_ms']} ms, plain "
        f"version {entry['plain_cupti_ms']} ms over {len(p_by)} kernels "
        f"(top {json.dumps({k: round(v, 4) for k, v in list(p_by.items())[:4]})}"
        f"); shape {entry['shape']} ptxas {entry['ptxas']}"
        + "".join(f" {k}={v}" for k, v in (more or {}).items()))
    return entry


def bucket_times(a, m, name, kern, plain_fn, firsts, first_args, first_got,
                 cmp_lib):
    """K11 `name` on the first call of each length bucket of the long-read
    path: held to its plain version (the path's first call already was),
    timed back to back over a window of about WINDOW_MS with clocks.sm
    sampled beside it, and after IDLE_S idle; with cmp_lib (another build
    of sw_diag.cu) the two in turns (`turns`), the other held to this
    one's output. Cycles a row (sw_diag: the bucket's Lmax) or a step
    (bt_diag: the longest walk's steps) are ms x MHz."""
    out = []
    for L in sorted(firsts):
        args = firsts[L]
        got = first_got if args is first_args else kern(*args)
        torch.cuda.synchronize()
        err = 0 if args is first_args else result_err(got, plain_fn(*args))
        if name == "sw_diag":
            unit, n_unit = "row", L
            size = dict(problems=args[0].shape[0],
                        longest=int(args[2].max()))
        else:
            steps = ((got.ops & 3) != 3).sum(dim=0)
            unit, n_unit = "step", max(int(steps.max()), 1)
            size = dict(walks=args[1].shape[0], steps=args[9],
                        longest_walk=n_unit)

        def run():
            return kern(*args)
        other = None if cmp_lib is None else (
            lambda: with_lib(m._build, cmp_lib, run, "sw_diag"))
        res = {"rows": L, **size,
               **turns(a, run, other, per=(unit, n_unit))}
        res["max_abs_err"] = max(err, res["max_abs_err"])
        out.append(res)
        log(f"kernel {name} @ {L} rows: {json.dumps(res)}")
    return out


def long_phase(a, m, egenome, edata, pol, lpol, rec):
    """Phase 12, the long-read path on the card (see the module's
    docstring). m: the port's modules and classes. Returns the `kernels`
    entries of sw_diag and bt_diag, and the first LONG_CPU reads with
    their end-to-end SAM groups on the card."""
    t_phase = time.time()
    sw, build = m.sw, m._build
    cmp_lib = m.parent_libs.get("sw_diag")
    rng = np.random.default_rng(a.seed)
    reads = long_corpus(egenome, rng, a.long_reads, LONG_LEN, LONG_SUB,
                        LONG_INDEL)
    recs = [m.SeqRecord(name=n, seq=c, qual=q) for n, c, q, _p in reads]
    start = {n.encode(): p for n, _c, _q, p in reads}

    def run(al, rs):
        by_bucket = m.bucket_groups([r.seq.size for r in rs])
        handles = []
        for bkt in sorted(by_bucket):
            idxs = by_bucket[bkt]
            for k in range(0, len(idxs), LONG_BATCH):
                handles.append(al.submit([rs[j] for j in
                                          idxs[k:k + LONG_BATCH]]))
        return [g for h in handles for g in al.collect_raw(h)], \
            sorted(by_bucket)

    # the full-size run, timed on the host's clock; the first call of each
    # length bucket (Lmax) of both kernels is kept for the bucket timings
    firsts = {k: {} for k in LONG_KERNELS}
    undo = []
    for name, attr, lmax in (("sw_diag", "_sw_banded_diag_cuda", 1),
                             ("bt_diag", "_backtrace_diag_cuda", 0)):
        inner = getattr(sw, attr)

        def keep(*args, _f=inner, _d=firsts[name], _ax=lmax):
            _d.setdefault(args[0].shape[_ax], args)
            return _f(*args)
        setattr(sw, attr, keep)
        undo.append((attr, inner))
    rec.take()
    al = m.UnpairedAligner(edata, pol)
    spent = host_timers([(al, n) for n in (
        "submit", "collect_raw", "_align_batch_host", "_search_candidates",
        "_run_dp", "_se_effort_filter", "_rank_per_read", "_backtrace_sel",
        "_emit_aligned", "_groups_from_objects")]
        + [(m.traj_replay, "run_replays")])
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.time()
    try:
        groups, buckets = run(al, recs)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"long-read path: {type(e).__name__}: {e}")
    wall = time.time() - t0
    launches = dict(build.LAUNCHES)
    plain = dict(build.PLAIN_CALLS)
    long_args = rec.take()
    for attr, inner in undo:
        setattr(sw, attr, inner)
    prim = [g[0][1].split(b"\t") for g in groups]
    aligned = [f for f in prim if not int(f[1]) & 4]
    at_start = sum(1 for f in aligned if int(f[3]) == start[f[0]] + 1)
    bases = sum(len(f[9]) for f in aligned)
    log(f"long-read path: {len(recs)} reads of {LONG_LEN[0]}-{LONG_LEN[1]} "
        f"bp (length buckets {buckets}, batches of {LONG_BATCH}) in "
        f"{wall:.2f} s = {len(recs) / wall:.2f} reads/s, "
        f"{bases / wall:.0f} aligned bases/s; {len(aligned)} aligned, "
        f"{at_start} at their sampled position; trajectory overrides "
        f"{al.metrics.counters.get('traj_overridden', 0)}; launches "
        f"{launches}; plain calls {plain}; wall s in "
        f"{({k: round(v, 2) for k, v in spent.items()})}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(groups) != len(recs):
        fail(f"{len(groups)} SAM groups for {len(recs)} long reads")
    missing = [k for k in list(LONG_KERNELS) + ["ref_gather"]
               if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels never launched on the long-read path: {missing}")
    m.long_launches = launches
    if plain:
        fail(f"plain versions ran on the card's long-read path: {plain}")
    if at_start < 0.95 * len(recs):
        fail(f"only {at_start} of {len(recs)} long reads aligned at their "
             f"sampled position")

    # the same run again under CUDA events, apart from the timed window
    timer = LaunchTimer(build)
    t0 = time.time()
    try:
        run(m.UnpairedAligner(edata, pol), recs)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"long-read device-time pass: {type(e).__name__}: {e}")
    twall = time.time() - t0
    timer.restore()
    dev_ms = timer.totals()
    m.long_dev_ms = dev_ms
    m.long_gather_shapes = timer.totals(by_shape=True).get("ref_gather", {})
    busy = sum(v[0] for v in dev_ms.values()) / 1e3
    shapes = {k: {str(sh): [round(v[0], 4), v[1]] for sh, v in
                  sorted(d.items())}
              for k, d in timer.totals(by_shape=True).items()
              if k in LONG_KERNELS}
    log(f"long-read device time: "
        f"{json.dumps({k: [round(v[0], 4), v[1]] for k, v in sorted(dev_ms.items())})}"
        f" (total ms, spans); sum {busy:.4f} s = {100 * busy / wall:.4f} % "
        f"of the long-read path's {wall:.2f} s wall time; this pass "
        f"{twall:.2f} s; call shapes {json.dumps(shapes)} (sw_diag by "
        f"(problems, Lmax), bt_diag by (walks, Lmax, S))")

    # the card's SAM against the CPU's: the first reads, e2e and --local
    first_recs = recs[:LONG_CPU]
    for label, policy in (("end to end", pol), ("--local", lpol)):
        t1 = time.time()
        card = m.UnpairedAligner(edata, policy)
        rec.take()
        cg = card.collect_raw(card.submit(first_recs))
        torch.cuda.synchronize()
        if policy is lpol:
            local_args = rec.take()
        else:
            first_groups = cg
        cpu = m.UnpairedAligner(edata, policy, device="cpu")
        pg = cpu.collect_raw(cpu.submit(first_recs))
        nd = sum(1 for x, y in zip(cg, pg) if x != y)
        log(f"long-read SAM check ({label}): {len(first_recs)} reads, card "
            f"vs CPU plain versions: {nd} groups differ "
            f"({time.time() - t1:.1f} s)")
        if nd or len(cg) != len(pg):
            fail(f"long reads {label}: card and CPU SAM differ in {nd} reads")
    for k in LONG_KERNELS:
        if k not in local_args:
            fail(f"the --local long-read batch recorded no {k} call")

    # a paired-end batch, one mate of each pair long: the host path
    t1 = time.time()
    prng = np.random.default_rng(a.seed + 1)
    pairs = []
    for i in range(LONG_PAIRS):
        L = int(prng.integers(LONG_MATE[0], LONG_MATE[1] + 1))
        p = int(prng.integers(0, egenome.size - L))
        lc = mutate(prng, egenome[p:p + L], LONG_SUB)
        q0 = int(prng.integers(0, L - 100))
        sc = (prng.integers(0, 4, 100).astype(np.uint8) if i % 8 == 7 else
              (3 - mutate(prng, egenome[p + q0:p + q0 + 100], LONG_SUB)
               )[::-1].copy())
        m1, m2 = (lc, sc) if i % 2 == 0 else (sc, lc)
        pairs.append(tuple(m.SeqRecord(
            name=f"lp{i}", seq=x, qual=prng.integers(25, 41, x.size).astype(
                np.uint8)) for x in (m1, m2)))
    card = m.PairedAligner(edata, pol)
    build.reset_counts()
    cg = card.collect_raw(card.submit(pairs))
    torch.cuda.synchronize()
    pe_launch = dict(build.LAUNCHES)
    cpu = m.PairedAligner(edata, pol, device="cpu")
    pg = cpu.collect_raw(cpu.submit(pairs))
    nd = sum(1 for x, y in zip(cg, pg) if x != y)
    log(f"long-read PE SAM check: {len(pairs)} pairs, one mate of "
        f"{LONG_MATE[0]}-{LONG_MATE[1]} bp; host-path batches "
        f"{card.metrics.counters.get('host_batches', 0)}; launches "
        f"{pe_launch}; card vs CPU plain versions: {nd} groups differ "
        f"({time.time() - t1:.1f} s)")
    if nd or len(cg) != len(pg):
        fail(f"long-read PE: card and CPU SAM differ in {nd} pairs")
    if not all(pe_launch.get(k, 0) for k in LONG_KERNELS):
        fail("the long-read PE batch did not run on the band kernels")

    # two reads of about 1 Mbp (the top bucket): aligned at their sampled
    # positions, NM == XM (substitutions only), the walk's score equal to
    # the DP's
    mrng = np.random.default_rng(a.seed + 2)
    big, big_start = [], {}
    for i, L in enumerate(MBP_LENS):
        p = int(mrng.integers(0, egenome.size - L))
        c = mutate(mrng, egenome[p:p + L], MBP_SUB)
        if i % 2:
            c = (3 - c)[::-1].copy()
        big.append(m.SeqRecord(name=f"mbp{i}", seq=c,
                               qual=np.full(c.size, 35, np.uint8)))
        big_start[f"mbp{i}"] = p
    mal = m.UnpairedAligner(edata, pol)
    walked = []
    bt_sel = mal._backtrace_sel

    def keep_walks(pool, sel):
        out = bt_sel(pool, sel)
        walked.extend((int(pool.scores[k]), v[1]["score_check"])
                      for k, v in out.items())
        return out
    mal._backtrace_sel = keep_walks
    rec.take()
    t1 = time.time()
    try:
        out = mal.collect(mal.submit(big))
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"1-Mbp reads: {type(e).__name__}: {e}")
    mwall = time.time() - t1
    margs = rec.take()
    for r in out:
        o = {t: v for t, _y, v in r.opts}
        if r.flag & 4 or r.pos != big_start[r.qname] + 1 or \
                o.get("NM") != o.get("XM"):
            fail(f"1-Mbp read {r.qname}: flag {r.flag} pos {r.pos} (want "
                 f"{big_start[r.qname] + 1}) NM {o.get('NM')} XM "
                 f"{o.get('XM')}")
    if not walked or any(sc != chk for sc, chk in walked):
        fail(f"1-Mbp reads: walk scores differ from the DP's: {walked}")
    if any(k not in margs for k in LONG_KERNELS):
        fail("the 1-Mbp reads did not run on the band kernels")
    mb_ms = {k: time_cuda(lambda k=k: getattr(rec, "orig_" + k)(*margs[k]),
                          2) for k in LONG_KERNELS}
    log(f"1-Mbp reads: {[r.seq.size for r in big]} bp in {mwall:.2f} s on "
        f"the host's clock; {len(out)} records at their sampled positions, "
        f"NM == XM; walks (DP score, walk score) {walked}; sw_diag "
        f"{mb_ms['sw_diag']:.3f} ms over {margs['sw_diag'][0].shape[0]} "
        f"problems of {margs['sw_diag'][0].shape[1]} rows, bt_diag "
        f"{mb_ms['bt_diag']:.3f} ms over "
        f"{margs['bt_diag'][1].shape[0]} walks of {margs['bt_diag'][-1]} "
        f"steps")

    # each kernel against its plain version: the first long call (timed
    # there, each plain call once), the --local batch's first call, and
    # every diag_cases / bt_diag_cases case at scale 1 and 8
    dev = torch.device("cuda")

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    plains = {"sw_diag": sw._sw_banded_diag_plain,
              "bt_diag": sw._backtrace_diag_plain}
    kerns = {k: getattr(rec, "orig_" + k) for k in LONG_KERNELS}
    sweep = {k: [] for k in LONG_KERNELS}
    t1 = time.time()
    for seed, scale in ((0, 1), (1, 8)):
        for c in m.cases.diag_cases(seed=seed, scale=scale):
            args = sw.diag_args(put(c.reads), put(c.quals), put(c.lens),
                                put(c.wins), sw.SWParams(**c.params()),
                                c.band)
            sweep["sw_diag"].append((f"{c.name}@x{scale}", max_err(
                kerns["sw_diag"], plains["sw_diag"], args)[1]))

        def dp(c):
            r = plains["sw_diag"](*sw.diag_args(
                put(c.reads), put(c.quals), put(c.lens), put(c.wins),
                sw.SWParams(**c.params()), c.band))
            return r.row.cpu().numpy(), r.lane.cpu().numpy(), \
                r.dirs.cpu().numpy()
        for c in m.cases.bt_diag_cases(dp, seed=seed, scale=scale):
            p = sw.SWParams(**c.params())
            args = (put(c.dirs), put(c.sel), put(c.rows), put(c.lanes),
                    put(c.reads), sw.mm_penalty_from_qual(put(c.quals), p),
                    put(c.wins), p, c.band,
                    sw.bt_steps(c.dirs.shape[0], 2 * c.band + 1, c.local))
            sweep["bt_diag"].append((f"{c.name}@x{scale}", max_err(
                kerns["bt_diag"], plains["bt_diag"], args)[1]))
    for name, errs in sweep.items():
        bad = [(c, e) for c, e in errs if e]
        log(f"exactness sweep {name}: {len(errs)} cases, "
            f"{len(errs) - len(bad)} equal to the plain version, max abs "
            f"err {max(e for _, e in errs)}" + (f"; differ: {bad}" if bad
                                                 else "")
            + f" ({time.time() - t1:.1f} s)")

    def first(args, n):
        return tuple(x[:n].contiguous() if isinstance(x, torch.Tensor)
                     else x for x in args)
    entries = []
    for name, (src, repl) in LONG_KERNELS.items():
        kern, plain_fn = kerns[name], plains[name]
        args = long_args[name]
        got = kern(*args)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = plain_fn(*args)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        err = result_err(got, want)
        del want
        lerr = max_err(kern, plain_fn, local_args[name])[1]
        sweep_err = max((e for _, e in sweep[name]), default=0)
        ms = time_cuda(lambda: kern(*args), a.reps)
        idle_ms = time_after_idle(lambda: kern(*args), 5)
        if name == "sw_diag":
            chain = first(args, 1)
            byt, ops, cells = diag_work(args)
            extra = dict(cells=cells, band=args[5])
        else:
            chain = (args[0],) + first(args[1:], 1)
            byt, ops, tail = walk_work(got, *args[1:4])
            extra = dict(tail_share=tail, steps=args[9])
        chain_ms = time_cuda(lambda: kern(*chain), a.reps)
        t_bytes = byt / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_OPS_S * 1e3
        total = dev_ms.get(name, [0.0, 0])
        e = max(err, lerr, sweep_err)
        entry = dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches.get(name, 0), max_abs_err=e, equal=e == 0,
            ms=round(ms, 4), idle_ms=round(idle_ms, 4),
            chain_ms=round(chain_ms, 4), plain_ms=round(plain_ms, 3),
            bound_ms=round(max(t_bytes, t_ops), 5),
            bytes_ms=round(t_bytes, 5), ops_ms=round(t_ops, 5),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, total_ms=round(total[0], 4),
            total_spans=total[1], ptxas=ptxas_of(build, name, "sw_diag"),
            shape=[list(t.shape) for t in args
                   if isinstance(t, torch.Tensor)][:2],
            sweep_cases=len(sweep[name]))
        entry.update(extra)
        entry["buckets"] = bucket_times(a, m, name, kern, plain_fn,
                                        firsts[name], args, got, cmp_lib)
        e = max([e] + [b["max_abs_err"] for b in entry["buckets"]])
        entry.update(max_abs_err=e, equal=e == 0)
        entries.append(entry)
        log(f"kernel {name}: equal={e == 0} max_abs_err={err} (local "
            f"{lerr}, sweep {sweep_err} over {len(sweep[name])} cases) "
            f"ms={ms:.4f} idle_ms={idle_ms:.4f} chain_ms={chain_ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={max(t_bytes, t_ops):.5f} "
            f"(bytes {t_bytes:.5f}, operations {t_ops:.5f}) "
            f"total_ms={total[0]:.4f} over {total[1]} launches; "
            + "".join(f" {k}={v}" for k, v in extra.items())
            + f" shape {entry['shape']} ptxas {entry['ptxas']}")
    log(f"long-read phase: {time.time() - t_phase:.1f} s")
    return entries, first_recs, first_groups


def large_phase(a, m, ctx):
    """Phase 13, the large index mode on the card (see the module's
    docstring). m: the port's modules and classes; ctx: what earlier
    phases made (genomes, indexes, batches and their SAM). Returns the
    `kernels` entries of the four `_u32` entries."""
    t_phase = time.time()
    fm, build, rec = m.fm, m._build, ctx["rec"]
    dev = torch.device("cuda")
    pol = ctx["pol"]

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def launched(label, fn):
        """fn() with the counts set to 0 just before and read just after;
        every large-mode run must launch only `_u32` FM entries."""
        torch.cuda.synchronize()
        build.reset_counts()
        t1 = time.time()
        try:
            out = fn()
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"{label}: {type(e).__name__}: {e}")
        wall = time.time() - t1
        ln, pl = dict(build.LAUNCHES), dict(build.PLAIN_CALLS)
        if pl:
            fail(f"{label}: plain versions ran on the card: {pl}")
        small = [k for k in LARGE_KERNELS.values() if ln.get(k[0], 0)]
        if small:
            fail(f"{label}: small-mode FM entries launched: {small}")
        for k in LARGE_KERNELS:
            large_launch[k] = large_launch.get(k, 0) + ln.get(k, 0)
        return out, wall, ln

    large_launch = {}
    kerns = {k: getattr(rec, "orig_" + w) for k, (w, _s, _r) in
             LARGE_KERNELS.items()}
    plains = {"fm_sweep_u32": fm._sweep_plain,
              "fm_substring_u32": fm._substring_plain,
              "fm_seed_u32": fm._seed_plain,
              "sa_resolve_u32": fm._resolve_plain}

    # (a) the kernels past 2^31 rows, on ops/cases.py large_fm_case
    t1 = time.time()
    c = m.cases.large_fm_case(seed=a.seed)
    t_case = time.time() - t1
    half = m.half_from_tables(c.n, c.z_off, c.fm_blocks, c.fchr, c.ftab,
                              c.mark_rows, c.offs, True, dev)
    big_args = {
        "fm_sweep_u32": (half, put(c.sweep_rr)),
        "fm_substring_u32": (half, put(c.substring_rr)),
        "fm_seed_u32": (half, put(c.seeds), put(c.seed_valid), c.seed_len,
                        c.ftab_chars),
        "sa_resolve_u32": (half, put(c.resolve_rows), 32)}
    log(f"large table: {c.n + 1} rows ({half.fm_blocks.shape[0]} blocks; "
        f"fm_blocks {nbytes(half.fm_blocks) / 1e9:.3f} GB, mark_rows "
        f"{nbytes(half.mark_rows) / 1e9:.3f} GB, offs "
        f"{nbytes(half.offs) / 1e9:.3f} GB on the card), fchr "
        f"{c.fchr.tolist()}, made in {t_case:.1f} s")
    ctx["large_fm_blocks"] = c.fm_blocks      # phase 14's K12 table
    del c
    big = {}
    for name, args in big_args.items():
        got, err = max_err(kerns[name], plains[name], args)
        out0 = got[0] if isinstance(got, tuple) else got
        past = int((out0 >= PAST_ROW).sum())
        if name == "sa_resolve_u32":
            past = int((args[1] >= PAST_ROW).sum())
        if past == 0:
            fail(f"{name}: no state reached a row past 2^31")
        ms = time_cuda(lambda: kerns[name](*args), a.reps)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        plains[name](*args)
        e1.record()
        torch.cuda.synchronize()
        if name == "sa_resolve_u32":
            byt, ops, _facts = resolve_work(fm, args)
        else:
            byt, lf, _facts = fm_work(fm, name.replace("_u32", ""), args)
            ops = lf * OPS_LF
        big[name] = dict(err=err, ms=ms, plain_ms=e0.elapsed_time(e1),
                         bytes_ms=byt / PEAK_BYTES_S * 1e3,
                         ops_ms=ops / PEAK_OPS_S * 1e3, past=past,
                         shape=[list(t.shape) for t in args
                                if isinstance(t, torch.Tensor)][:1])
        log(f"large kernel {name} on the large table: max_abs_err={err}; "
            f"{past} of {out0.numel()} results (SA walk: rows) past 2^31; "
            f"ms={ms:.4f} plain_ms={big[name]['plain_ms']:.3f} bound_ms="
            f"{max(big[name]['bytes_ms'], big[name]['ops_ms']):.5f} (bytes "
            f"{big[name]['bytes_ms']:.5f}, operations "
            f"{big[name]['ops_ms']:.5f}) shape {big[name]['shape']}")
    del big_args, half
    torch.cuda.empty_cache()

    # (b) global coordinates past 2^31 on the alignment path: an all-N
    # reference of PAD_BP, then the E. coli-sim genome in two references
    t1 = time.time()
    eg = ctx["egenome"].astype(np.uint8)
    half_g = eg.size // 2
    ra, rb = eg[:half_g].copy(), eg[half_g:].copy()
    ra[N_RUN[0]:N_RUN[1]] = 4
    rb[:N_ENDS] = 4
    rb[-N_ENDS:] = 4
    refs = [("ecoli_a", ra), ("ecoli_b", rb)]
    d_small = m.build_index_from_refs(refs)
    # the builder's tables for [("pad", PAD_BP Ns)] + refs, laid out in
    # numpy (an all-N reference adds nothing to the joined text)
    d_big = pad_genome(d_small, PAD_BP)
    log(f"padded genome: references {d_big.ref_names} of "
        f"{d_big.ref_lens.tolist()} bp, global coordinates to "
        f"{int(d_big.ref_cum[-1])}, joined text {d_big.fw.n} bp (host "
        f"tables {d_big.fw.occ_cp.dtype}); built in {time.time() - t1:.1f} "
        f"s")
    se_recs = [m.SeqRecord(name=f"e{i}", seq=ctx["se_codes"][i].astype(
        np.uint8), qual=ctx["se_quals"][i]) for i in range(a.batch)]
    pe_batch = ctx["pairs"][:PE_BATCH]
    checks = {}

    def se_run(data, recs, device=None):
        al = m.UnpairedAligner(data, pol, device=device)
        return al.collect_raw(al.submit(recs)), al

    def pe_run(data, pairs, device=None, policy=None):
        al = m.PairedAligner(data, policy or pol, device=device)
        fb = al.submit(pairs)
        return al.collect_raw(fb), al, fb

    (g_big, al_big), w_big, ln_big = launched(
        "padded genome, SE", lambda: se_run(d_big, se_recs))
    if not al_big.idx.fw.large or al_big.idx.ref_cum.dtype != torch.int64:
        fail("the padded genome's index is not in the large mode")
    g_small, _al = se_run(d_small, se_recs)
    nd = sum(1 for x, y in zip(g_big, g_small) if x != y)
    aligned = sum(1 for g in g_big if not g[0][0] & 4)
    checks["padded SE vs small index"] = nd
    log(f"padded genome SE: {len(se_recs)} reads ({aligned} aligned) in "
        f"{w_big:.2f} s on the card; launches {ln_big}; vs the two "
        f"references alone: {nd} groups differ")
    if nd or len(g_big) != len(g_small):
        fail(f"padded genome SE: {nd} groups differ from the small index")
    (pg_big, pal_big, fb), pw_big, pln_big = launched(
        "padded genome, PE", lambda: pe_run(d_big, pe_batch))
    if isinstance(fb, tuple):
        fail(f"padded genome PE took the {fb[0]} path, not the fused one")
    pg_small, _pal, _fb = pe_run(d_small, pe_batch)
    nd = sum(1 for x, y in zip(pg_big, pg_small) if x != y)
    checks["padded PE vs small index"] = nd
    log(f"padded genome PE: {len(pe_batch)} pairs in {pw_big:.2f} s on the "
        f"card ({pal_big.stats.conc_one + pal_big.stats.conc_multi} "
        f"concordant, {pal_big.stats.disc} discordant; host-path batches "
        f"{pal_big.metrics.counters.get('host_batches', 0)}); launches "
        f"{pln_big}; vs the two references alone: {nd} groups differ")
    if nd or len(pg_big) != len(pg_small):
        fail(f"padded genome PE: {nd} pairs differ from the small index")
    t1 = time.time()
    cpu_se, _al = se_run(d_big, se_recs[:LARGE_CPU_SE], "cpu")
    card_se, _al = se_run(d_big, se_recs[:LARGE_CPU_SE])
    cpu_pe, _al, _fb = pe_run(d_big, pe_batch[:LARGE_CPU_PE], "cpu")
    card_pe, _al, _fb = pe_run(d_big, pe_batch[:LARGE_CPU_PE])
    nds = sum(1 for x, y in zip(cpu_se, card_se) if x != y)
    ndp = sum(1 for x, y in zip(cpu_pe, card_pe) if x != y)
    checks["padded SE card vs CPU"] = nds
    checks["padded PE card vs CPU"] = ndp
    log(f"padded genome, card vs CPU plain versions: {LARGE_CPU_SE} reads "
        f"{nds} groups differ, {LARGE_CPU_PE} pairs {ndp} differ "
        f"({time.time() - t1:.1f} s)")
    if nds or ndp or len(cpu_se) != len(card_se) or \
            len(cpu_pe) != len(card_pe):
        fail("padded genome: the card's SAM differs from the CPU's")
    del d_big, al_big, pal_big, fb
    torch.cuda.empty_cache()

    # (c) forced large on the earlier cells' genomes: the first SE batch,
    # the first PE batch (fused path) and the first long reads, each
    # against its small-index run of the earlier phases; the forced-large
    # main-path calls hold the `_u32` kernels to their plain versions and
    # time them beside the small-mode kernels on the same inputs
    t1 = time.time()
    rep_l = m.build_index_from_refs([("rep", ctx["genome"].astype(np.uint8))],
                                    large=True)
    eco_l = m.build_index_from_refs([("ecoli_sim", eg)], large=True)
    ctx["rep_l"] = rep_l            # phase 14's `_sh_u32` path; phase 15
    ctx["eco_l"] = eco_l
    log(f"forced-large indexes of the repcorpus and E. coli-sim genomes "
        f"built in {time.time() - t1:.1f} s")
    # each batch twice, small and large index in turns (small, large): one
    # batch's wall time varies by more than the modes differ, so the rates
    # are no comparison of the modes; the host timers say where the time
    # went
    rates = {}
    replay = host_timers([(m.traj_replay, "run_replays")])
    for label, data, run, batch, want, unit in (
            ("repcorpus SE", ctx["data"], se_run, ctx["chunk0"],
             ctx["groups0"], "reads"),
            ("E. coli-sim PE", ctx["edata"], pe_run, ctx["pe_batch0"],
             ctx["pe_groups0"], "pairs")):
        big_data = rep_l if data is ctx["data"] else eco_l
        walls = {"small": [], "large": []}
        spent = {"small": {}, "large": {}}
        for turn, tag in enumerate(("small", "large")):
            r0 = replay.get("run_replays", 0.0)
            rec.take()
            if tag == "large":
                out, w, ln = launched(f"forced large {label}",
                                      lambda: run(big_data, batch))
            else:
                t0 = time.time()
                out = run(data, batch)
                torch.cuda.synchronize()
                w = time.time() - t0
            if turn == 1:            # the first large run: the checks
                nd = sum(1 for x, y in zip(out[0], want) if x != y)
                checks[f"forced large {label}"] = nd
                if nd or len(out[0]) != len(want):
                    fail(f"forced large {label}: {nd} groups differ")
                if unit == "reads":
                    main_args = rec.take()
                launches = ln
            walls[tag].append(w)
            acc = spent[tag]
            for k, v in out[1].metrics.counters.items():
                if k.startswith("t_"):
                    acc[k] = acc.get(k, 0.0) + v
            acc["run_replays"] = acc.get("run_replays", 0.0) + (
                replay.get("run_replays", 0.0) - r0)
        rates[label] = tuple(len(batch) / sum(walls[t])
                             for t in ("small", "large"))
        log(f"forced large {label}: {len(batch)} {unit} a run, "
            f"{rates[label][1]:.1f} {unit}/s (small index, same batch, "
            f"the run before: {rates[label][0]:.1f}); wall s small "
            f"{[round(x, 3) for x in walls['small']]}, large "
            f"{[round(x, 3) for x in walls['large']]}; host s a run small "
            f"{({k: round(v, 3) for k, v in sorted(spent['small'].items())})}"
            f", large "
            f"{({k: round(v, 3) for k, v in sorted(spent['large'].items())})}"
            f"; launches {launches}; vs the small index's run: "
            f"{checks[f'forced large {label}']} groups differ")
    lrecs, lwant = ctx["long_first"], ctx["long_groups"]
    (lg, _al), lw, lln = launched(
        "forced large long reads", lambda: se_run(eco_l, lrecs))
    nd = sum(1 for x, y in zip(lg, lwant) if x != y)
    checks["forced large long reads"] = nd
    log(f"forced large long reads: {len(lrecs)} reads in {lw:.2f} s; "
        f"launches {lln}; vs the small index's run: {nd} groups differ")
    if nd or len(lg) != len(lwant):
        fail(f"forced large long reads: {nd} groups differ")

    # each `_u32` kernel against its plain version on the forced-large
    # main path's first call, and timed there beside the small-mode
    # kernel on the same inputs (phase 6's arguments over the small index
    # of the same genome)
    entries = []
    small_args = ctx["e2e_args"]
    for name, (wrapper, src, repl) in LARGE_KERNELS.items():
        if wrapper not in main_args:
            fail(f"the forced-large SE batch recorded no {wrapper} call")
        margs = main_args[wrapper]
        _got, merr = max_err(kerns[name], plains[name], margs)
        m_ms = time_cuda(lambda: kerns[name](*margs), a.reps)
        sargs = small_args[wrapper]
        same = (margs[0],) + tuple(
            x.long() if wrapper == "sa_resolve" and i == 0 else x
            for i, x in enumerate(sargs[1:]))
        _got, serr = max_err(kerns[name], plains[name], same)
        u_ms = time_cuda(lambda: kerns[name](*same), a.reps)
        s_ms = time_cuda(lambda: getattr(rec, "orig_" + wrapper)(*sargs),
                         a.reps)
        b = big[name]
        e = max(b["err"], merr, serr)
        entry = dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=large_launch.get(name, 0), max_abs_err=e,
            equal=e == 0, ms=round(b["ms"], 4),
            plain_ms=round(b["plain_ms"], 3),
            bound_ms=round(max(b["bytes_ms"], b["ops_ms"]), 5),
            bytes_ms=round(b["bytes_ms"], 5), ops_ms=round(b["ops_ms"], 5),
            bound_by="bytes" if b["bytes_ms"] >= b["ops_ms"]
            else "operations",
            library_ms=None, shape=b["shape"], past_2_31=b["past"],
            forced_large_first_call_ms=round(m_ms, 4),
            same_inputs_ms=round(u_ms, 4), small_mode_ms=round(s_ms, 4),
            ptxas=ptxas_of(build, name, os.path.splitext(
                os.path.basename(src))[0]))
        entries.append(entry)
        log(f"kernel {name}: equal={e == 0} max_abs_err on the large table "
            f"{b['err']}, the forced-large first call {merr}, phase 6's "
            f"inputs {serr}; launches on the large-mode runs "
            f"{entry['launches']}; large table ms={b['ms']:.4f} "
            f"plain_ms={b['plain_ms']:.3f} bound_ms={entry['bound_ms']}; "
            f"forced-large first call ms={m_ms:.4f}; on phase 6's first-call "
            f"inputs ms={u_ms:.4f} against the small-mode kernel's "
            f"{s_ms:.4f} (x{u_ms / s_ms:.3f}); ptxas {entry['ptxas']}")
    missing = [k for k in LARGE_KERNELS if not large_launch.get(k)]
    if missing:
        fail(f"large-mode entries never launched: {missing}")
    log(f"large-mode checks (groups differing): {json.dumps(checks)}; "
        f"rates (small, large): "
        f"{json.dumps({k: [round(x, 1) for x in v] for k, v in rates.items()})}"
        f"; large-mode launches {large_launch}; phase 13: "
        f"{time.time() - t_phase:.1f} s")
    return entries


MH_WORKER = r"""
import os, sys
import numpy as np
sys.path.insert(0, os.environ["BT2X_REPO"])
from bowtie2_tpu_torch.dist.multihost import (init_multihost, shard_path,
                                              shard_windows)
P = int(os.environ["BT2X_NUM_PROCESSES"])
pid = int(os.environ["BT2X_PROCESS_ID"])
if P > 1:
    # NCCL refuses two ranks on one card: the group is gloo's
    init_multihost(backend="gloo")
from bowtie2_tpu_torch.index.build import load_index
from bowtie2_tpu_torch.io.fastx import SeqRecord
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner
from bowtie2_tpu_torch.pipeline.policy import make_policy
d = os.environ["BT2X_DATA"]
codes = np.load(os.path.join(d, "codes.npy"))
quals = np.load(os.path.join(d, "quals.npy"))
al = UnpairedAligner(load_index(os.path.join(d, "index")),
                     make_policy("sensitive"))
reader = (SeqRecord(name=f"w{i}", seq=codes[i], qual=quals[i])
          for i in range(len(codes)))
prefix = os.environ["BT2X_OUT"]
for w, records in shard_windows(reader, pid, P,
                                window=int(os.environ["BT2X_WINDOW"])):
    with open(shard_path(prefix, w), "wb") as f:
        for g in al.collect_raw(al.submit(records)):
            for _, line in g:
                f.write(line + b"\n")
if P > 1:
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
"""


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def multihost_runs(m, edata, codes, quals):
    """Phase 14 (e): the E. coli-sim reads in MH_WINDOWS windows of
    MH_WINDOW, aligned by one process and by two (gloo, both on cuda:0),
    all three started at once; returns (one process's merged bytes, two
    processes', seconds)."""
    from bowtie2_tpu_torch.dist.multihost import merge_shards
    t1 = time.time()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mh_")
    d = tmp.name
    m.save_index(edata, os.path.join(d, "index"))
    np.save(os.path.join(d, "codes.npy"), codes)
    np.save(os.path.join(d, "quals.npy"), quals)
    procs = []
    for nproc, tag in ((1, "one"), (2, "two")):
        port = free_port()
        for pid in range(nproc):
            env = dict(os.environ, BT2X_REPO=HERE,
                       BT2X_NUM_PROCESSES=str(nproc),
                       BT2X_PROCESS_ID=str(pid),
                       BT2X_COORDINATOR=f"localhost:{port}",
                       BT2X_OUT=os.path.join(d, tag), BT2X_DATA=d,
                       BT2X_WINDOW=str(MH_WINDOW))
            procs.append((tag, subprocess.Popen(
                [sys.executable, "-c", MH_WORKER], env=env, cwd=d,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    errs = []
    try:
        for tag, p in procs:
            _out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                errs.append(f"{tag}: exit {p.returncode}: "
                            f"{err.decode(errors='replace')[-1500:]}")
    finally:
        for _tag, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        tmp.cleanup()
        fail("multi-process run: " + " | ".join(errs))
    out = []
    for tag in ("one", "two"):
        merged = os.path.join(d, f"{tag}.sam")
        n = merge_shards(os.path.join(d, tag), merged)
        if n != MH_WINDOWS:
            fail(f"multi-process run ({tag}): {n} shards merged, not "
                 f"{MH_WINDOWS}")
        with open(merged, "rb") as f:
            out.append(f.read())
    tmp.cleanup()
    return out[0], out[1], time.time() - t1


def sharded_half(m, h, S, large=False):
    """An FM half split into S shards on its own card (the tables of
    index/fmindex.py ShardedFMHalf), in the large row mode or its own (the
    int64 mode's occ_cp64 split as fm_blocks is)."""
    dev = h.fchr.device

    def split(t):
        return m.fm.shard_rows(t, [dev] * S, dev)
    return m.ShardedFMHalf(
        n=h.n, z_off=h.z_off, fm_blocks=split(h.fm_blocks), fchr=h.fchr,
        ftab=h.ftab, mark_rows=split(h.mark_rows), offs=split(h.offs),
        row_dtype=torch.int64 if large else h.row_dtype,
        occ_cp64=split(h.occ_cp64) if h.i64 else None)


def k12_work(rows, idx):
    """K12's (bytes, rows gathered): each distinct row an index owns read
    once, the indices read and the output written once."""
    rb = 4 * rows.row_words
    g = idx.reshape(-1).long()
    held = torch.unique(g[(g >= 0) & (g < rows.S * rows.per)]).numel()
    return held * rb + nbytes(idx) + idx.numel() * rb, held


def k12_indices(n, S, per, rng, in_range, dev, dtype=torch.int32):
    """Every index class of the CPU test (tests/test_torch_shardidx.py):
    negative, in range (`in_range` of them), in the padding rows, past the
    padding, and the extremes of int32."""
    idx = np.concatenate([
        rng.integers(-300, 0, 64), rng.integers(0, n, in_range),
        np.arange(n, S * per), rng.integers(S * per, S * per + 300, 64),
        [-1, 0, n - 1, S * per - 1, S * per, per - 1, per,
         -(1 << 31), (1 << 31) - 1]])
    return torch.from_numpy(idx).to(dev, dtype)


def shard_phase(a, m, ctx):
    """Phase 14: the sharded index mode, the data mesh and multi-process
    runs on one card (see the module's docstring). m: the port's modules;
    ctx: what earlier phases made. Returns the `kernels` entries of K12
    (`take_sharded`) and of the eight `_sh` entries."""
    t_phase = time.time()
    fm, build, rec, pol = m.fm, m._build, ctx["rec"], ctx["pol"]
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(a.seed + 14)
    checks = {}
    launch = {}

    def shard_mesh(S):
        return m.make_mesh(devices=[dev] * S, axis="shard")

    def counted(label, fn, need):
        """fn() with the counts set to 0 just before and read just after;
        no plain version may run, and each kernel in `need` must launch."""
        torch.cuda.synchronize()
        build.reset_counts()
        t1 = time.time()
        try:
            out = fn()
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"{label}: {type(e).__name__}: {e}")
        wall = time.time() - t1
        ln, pl = dict(build.LAUNCHES), dict(build.PLAIN_CALLS)
        if pl:
            fail(f"{label}: plain versions ran on the card: {pl}")
        missing = [k for k in need if not ln.get(k)]
        if missing:
            fail(f"{label}: never launched: {missing}")
        for k in list(SHARD_KERNELS) + [K12[0], "ref_gather_aligned_sh"]:
            launch[k] = launch.get(k, 0) + ln.get(k, 0)
        return out, wall, ln

    def differ(label, got, want):
        nd = sum(1 for x, y in zip(got, want) if x != y) + abs(
            len(got) - len(want))
        checks[label] = nd
        if nd:
            fail(f"{label}: {nd} groups differ")
        return nd

    # ---- (c) the sharded index on the main paths ----
    sh_int = [k for k in SHARD_KERNELS if not k.endswith("_u32")]
    sh_u32 = [k for k in SHARD_KERNELS if k.endswith("_u32")]
    se_batches = ctx["chunks"][:2]
    if len(se_batches) < 2:
        fail("phase 14 needs two SE batches of the main path (--reads)")

    def se_run(data, S, batches):
        al = m.UnpairedAligner(data, pol, shard_mesh=shard_mesh(S))
        hs = [al.submit(b) for b in batches]
        return [al.collect_raw(h) for h in hs], al

    # a warm-up batch over each index first, outside the counts and the
    # events: each kernel's first launch in the process loads its code
    for data in (ctx["data"], ctx["rep_l"]):
        se_run(data, 4, [se_batches[0][:256]])
    torch.cuda.synchronize()
    holder = ctx["holder"]
    holder.check("sharded index")    # the warm-up's calls, held apart
    holder.first.pop("ref_gather_aligned_sh", None)
    rec.take()
    # the 4-shard SE, the forced-large and the PE runs under CUDA events
    # (each kernel's total_ms); the 8-shard SE run without
    timer = LaunchTimer(build)
    (g4, al4), w4, ln4 = counted("sharded SE, 4 shards",
                                 lambda: se_run(ctx["data"], 4, se_batches),
                                 sh_int + ["ref_gather_aligned_sh"])
    sh_args = rec.take()
    if "ref_gather_aligned_sh" not in holder.first:
        fail("the sharded SE path never gathered its reference words")
    k7_args = holder.first["ref_gather_aligned_sh"][1]
    for k, (gg, want) in enumerate(zip(g4, ctx["groups"])):
        differ(f"SE batch {k}, 4 shards vs replicated", gg, want)
    differ("SE batch 0, 4 shards vs CPU", g4[0], ctx["cpu_groups"])
    nreads = sum(len(b) for b in se_batches)
    log(f"sharded SE (4 shards on {dev}): {nreads} reads in {w4:.2f} s "
        f"(CUDA events around every launch); host-path batches "
        f"{al4.metrics.counters.get('host_batches', 0)}; launches {ln4}; "
        f"fm_blocks {al4.sidx.fw.fm_blocks.per} rows a shard")
    (gl, all_), wl, lnl = counted(
        "sharded SE, forced large, 4 shards",
        lambda: se_run(ctx["rep_l"], 4, se_batches[:1]),
        sh_u32 + ["ref_gather_aligned_sh"])
    large_args = rec.take()
    if not all_.sidx.fw.large:
        fail("the forced-large sharded index is not in the large mode")
    differ("SE batch 0, forced large, 4 shards vs replicated", gl[0],
           ctx["groups"][0])
    log(f"sharded SE, forced large (4 shards): {len(se_batches[0])} reads "
        f"in {wl:.2f} s (CUDA events); launches {lnl}")

    pairs = ctx["pairs"]
    pe_batches = [pairs[k:k + PE_BATCH] for k in (0, PE_BATCH)]

    def pe_run(batches, **kw):
        al = m.PairedAligner(ctx["edata"], pol, **kw)
        hs = [al.submit(b) for b in batches]
        return [al.collect_raw(h) for h in hs], al
    (pg4, _pal4), pw4, pln4 = counted(
        "sharded PE, 4 shards",
        lambda: pe_run(pe_batches, shard_mesh=shard_mesh(4)),
        sh_int + ["ref_gather_aligned_sh"])
    timer.restore()
    sh_ms = timer.totals()
    rec.take()
    log(f"sharded PE (4 shards): {sum(map(len, pe_batches))} pairs in "
        f"{pw4:.2f} s (CUDA events); launches {pln4}; device time over the "
        f"three sharded runs "
        f"{json.dumps({k: [round(v[0], 4), v[1]] for k, v in sorted(sh_ms.items())})}")
    pe_rep, _pal = pe_run(pe_batches)
    differ("PE batch 0, replicated vs phase 8", pe_rep[0],
           ctx["pe_groups0"])
    for k, (gg, want) in enumerate(zip(pg4, pe_rep)):
        differ(f"PE batch {k}, 4 shards vs replicated", gg, want)
    differ("PE batch 0, 4 shards vs CPU", pg4[0], ctx["pe_cpu0"])
    # 8 shards: the first batch only (the second is the 4-shard run's)
    (g8, al8), w8, ln8 = counted(
        "sharded SE, 8 shards",
        lambda: se_run(ctx["data"], 8, se_batches[:1]),
        sh_int + ["ref_gather_aligned_sh"])
    rec.take()
    differ("SE batch 0, 8 shards vs replicated", g8[0], ctx["groups"][0])
    differ("SE batch 0, 8 shards vs CPU", g8[0], ctx["cpu_groups"])
    log(f"sharded SE (8 shards): {len(se_batches[0])} reads in {w8:.2f} s; "
        f"launches {ln8}")

    # ---- (d) the data mesh ----
    t1 = time.time()
    codes, quals = ctx["se_codes"], ctx["se_quals"]
    mesh_batches = [
        [m.SeqRecord(name=f"m{i}", seq=codes[i].astype(np.uint8),
                     qual=quals[i]) for i in range(k, k + MESH_SE)]
        for k in range(0, MESH_SE * MESH_SE_BATCHES, MESH_SE)]

    def se_mesh(batches, **kw):
        al = m.UnpairedAligner(ctx["edata"], pol, **kw)
        hs = [al.submit(b) for b in batches]
        return [al.collect_raw(h) for h in hs], al
    se_rep, _al = se_mesh(mesh_batches)
    n_cards = torch.cuda.device_count()
    for label, devs in ((f"{n_cards} card(s)", None),
                        ("cuda:0 twice", [dev, dev])):
        mesh = m.make_mesh(devices=devs)
        gs, al = se_mesh(mesh_batches, mesh=mesh)
        for k, (gg, want) in enumerate(zip(gs, se_rep)):
            differ(f"mesh {label}: SE batch {k}", gg, want)
        if min(al.mesh_batches) == 0:
            fail(f"mesh {label}: an entry took no batch: {al.mesh_batches}")
        pgs, pal = pe_run(pe_batches, mesh=mesh)
        for k, (gg, want) in enumerate(zip(pgs, pe_rep)):
            differ(f"mesh {label}: PE batch {k}", gg, want)
        log(f"data mesh over {label} ({[str(d) for d in mesh.devices]}): "
            f"SE {MESH_SE_BATCHES} batches of {MESH_SE} E. coli-sim reads "
            f"(batches an entry {al.mesh_batches}), PE {len(pe_batches)} "
            f"batches (an entry {pal.mesh_batches}): equal to the "
            f"one-device runs")
    log(f"data mesh checks: {time.time() - t1:.1f} s")

    # ---- (e) two processes against one ----
    n_mh = MH_WINDOW * MH_WINDOWS
    one, two, mh_s = multihost_runs(m, ctx["edata"], np.stack(
        [codes[i].astype(np.uint8) for i in range(n_mh)]),
        np.stack([quals[i] for i in range(n_mh)]))
    checks["2 processes vs 1 (bytes equal)"] = int(one != two)
    lines = one.count(b"\n")
    log(f"multi-process run: {MH_WINDOWS} windows of {MH_WINDOW} E. "
        f"coli-sim reads, 1 process and 2 (gloo, each on cuda:0): "
        f"{len(one)} and {len(two)} bytes, equal {one == two} ({lines} "
        f"lines; {mh_s:.1f} s)")
    if one != two or lines < n_mh:
        fail("multi-process run: the merged bytes differ from one process")

    # ---- (a) K12 on the index's tables and the large table ----
    entries = []
    rep = al4.idx                       # the whole index, for table sizes
    sizes = dict(fm_blocks=rep.fw.fm_blocks.shape[0],
                 mark_rows=rep.fw.mark_rows.shape[0],
                 offs=rep.fw.offs.shape[0], ref_words=rep.ref_words.shape[0],
                 refn_words=rep.refn_words.shape[0])
    tables = {}
    for S, si in ((4, al4.sidx), (8, al8.sidx)):
        tables.update({(name, S): t for name, t in (
            ("fm_blocks", si.fw.fm_blocks), ("mark_rows", si.fw.mark_rows),
            ("offs", si.fw.offs), ("ref_words", si.ref_words.words),
            ("refn_words", si.refn_words.words))})
    kern12 = fm.take_sharded
    k12 = {}
    for (name, S), rows in tables.items():
        idx = k12_indices(sizes[name], rows.S, rows.per, rng, 1 << 18, dev)
        err = max_err(kern12, fm._take_sharded, (rows, idx))[1]
        err = max(err, max_err(kern12, fm._take_sharded,
                               (rows, idx.long()))[1])
        ms = time_cuda(lambda: kern12(rows, idx), a.reps)
        byt, held = k12_work(rows, idx)
        k12[name, S] = dict(err=err, ms=round(ms, 4), idx=idx.numel(),
                            rows_held=held, bytes_ms=round(
                                byt / PEAK_BYTES_S * 1e3, 5))
    log(f"kernel take_sharded on the repcorpus index's tables "
        f"(shards, indices of every class): "
        f"{json.dumps({f'{n}@{S}': v for (n, S), v in k12.items()})}")
    t1 = time.time()
    big = torch.from_numpy(ctx["large_fm_blocks"].view(np.int32))
    big_rows = fm.shard_rows(big, [dev] * 4, dev)
    del big
    nb = big_rows.S * big_rows.per
    bidx = k12_indices(ctx["large_fm_blocks"].shape[0], 4, big_rows.per,
                       rng, K12_LARGE_IDX, dev)
    berr = max_err(kern12, fm._take_sharded, (big_rows, bidx))[1]
    bms = time_cuda(lambda: kern12(big_rows, bidx), a.reps)
    bbyt, bheld = k12_work(big_rows, bidx)
    log(f"kernel take_sharded on the large table's fm_blocks ("
        f"{nb} rows padded, 4 shards of {big_rows.per} rows, "
        f"{nbytes(*big_rows.shards) / 1e9:.3f} GB on the card): "
        f"{bidx.numel()} indices, max_abs_err={berr} ms={bms:.4f} "
        f"bound_ms={bbyt / PEAK_BYTES_S * 1e3:.5f} (bytes; {bheld} rows "
        f"held) ({time.time() - t1:.1f} s)")
    del big_rows, bidx
    torch.cuda.empty_cache()
    # K12 on the word indices of the sharded path's first window gather
    # (the gather K12 made there before K7 read the shards itself)
    rows0 = k7_args[0].words
    ast = k7_args[2].long() & ~31
    idx0 = (ast >> 4)[:, None] + torch.arange(
        (32 * ((k7_args[5] + 62) // 32)) // 16, device=dev)[None, :]
    err0 = max_err(kern12, fm._take_sharded, (rows0, idx0))[1]
    ms0 = time_cuda(lambda: kern12(rows0, idx0), a.reps)
    idle0 = time_after_idle(lambda: kern12(rows0, idx0), 5)
    plain0 = time_cuda(lambda: fm._take_sharded(rows0, idx0), 2, spin=0)
    byt0, held0 = k12_work(rows0, idx0)
    e12 = max([err0, berr] + [v["err"] for v in k12.values()])
    tot12 = sh_ms.get(K12[0], [0.0, 0])
    entries.append(dict(
        name=K12[0], route="cuda", source=K12[1], replaces=K12[2],
        launches=launch.get(K12[0], 0), max_abs_err=e12, equal=e12 == 0,
        ms=round(ms0, 4), idle_ms=round(idle0, 4),
        plain_ms=round(plain0, 3),
        bound_ms=round(byt0 / PEAK_BYTES_S * 1e3, 5),
        bytes_ms=round(byt0 / PEAK_BYTES_S * 1e3, 5), ops_ms=0.0,
        bound_by="bytes", library_ms=None,
        total_ms=round(tot12[0], 4), total_spans=tot12[1],
        shape=[list(idx0.shape), [rows0.S, rows0.per, rows0.row_words]],
        tables={f"{n}@{S}": v for (n, S), v in k12.items()},
        large_table=dict(rows=nb, idx=K12_LARGE_IDX, err=berr,
                         ms=round(bms, 4),
                         bound_ms=round(bbyt / PEAK_BYTES_S * 1e3, 5)),
        ptxas=ptxas_of(build, K12[0], "take_sharded")))
    log(f"kernel take_sharded: equal={e12 == 0} max_abs_err={e12}; main "
        f"path's first call {entries[-1]['shape']}: ms={ms0:.4f} "
        f"idle_ms={idle0:.4f} plain_ms={plain0:.3f} bound_ms="
        f"{entries[-1]['bound_ms']} (bytes, {held0} rows held); launches "
        f"{entries[-1]['launches']} total_ms={tot12[0]:.4f} over "
        f"{tot12[1]} launches (4-shard SE); ptxas {entries[-1]['ptxas']}")

    # ---- (b) the `_sh` entries ----
    t1 = time.time()
    kerns = {w: getattr(rec, "orig_" + w) for w in
             ("fm_sweep", "fm_seed", "fm_substring", "sa_resolve")}
    plains = {"fm_sweep": fm._sweep_plain, "fm_substring": fm._substring_plain,
              "fm_seed": fm._seed_plain, "sa_resolve": fm._resolve_plain}
    errs = {k: [] for k in SHARD_KERNELS}

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for (gname, period), (d, g) in ctx["case_indexes"].items():
        flat = m.FMIndex.from_host(d, device=dev).fw
        for large in (False, True):
            h = sharded_half(m, flat, 4, large)
            sfx = "_sh_u32" if large else "_sh"
            for seed, scale in ((0, 1), (1, 8)):
                tag = f"{gname}_p{period}@x{scale}"
                if period == m.cases.RESOLVE_PERIODS[0]:
                    for cname, rr in m.cases.sweep_cases(g, seed=seed,
                                                         scale=scale):
                        for w in ("fm_sweep", "fm_substring"):
                            errs[w + sfx].append((f"{tag}_{cname}", max_err(
                                kerns[w], plains[w], (h, put(rr)))[1]))
                    for cname, sd, valid, slen, K in m.cases.seed_cases(
                            g, d.fw.ftab_chars, seed=seed, scale=scale):
                        errs["fm_seed" + sfx].append((f"{tag}_{cname}", max_err(
                            kerns["fm_seed"], plains["fm_seed"],
                            (h, put(sd), put(valid), slen, K))[1]))
                for kind, rows in m.cases.resolve_cases(d.fw, period,
                                                        seed=seed,
                                                        scale=scale):
                    r = put(rows)
                    errs["sa_resolve" + sfx].append((f"{tag}_{kind}", max_err(
                        kerns["sa_resolve"], plains["sa_resolve"],
                        (h, r.long() if large else r, period))[1]))
    log(f"exactness sweep of the `_sh` entries (4 shards): "
        f"{json.dumps({k: [len(v), max(e for _, e in v)] for k, v in errs.items()})}"
        f" (cases, max abs err; {time.time() - t1:.1f} s)")
    e2e = ctx["e2e_args"]
    flat_l = m.FMIndex.from_host(ctx["rep_l"], device=dev).fw
    sharded = {(S, lg): sharded_half(m, fl, S, lg) for S in SHARDS
               for lg, fl in ((False, e2e["fm_sweep"][0]), (True, flat_l))}
    for name, (w, src, repl) in SHARD_KERNELS.items():
        large = name.endswith("_u32")
        recd = (large_args if large else sh_args).get(w)
        if recd is None:
            fail(f"the sharded path recorded no {w} call for {name}")
        if _sharded_of(recd[0]) is None:
            fail(f"{name}: the recorded {w} call was not over shards")
        rest = tuple(x.long() if large and w == "sa_resolve" and i == 0
                     else x for i, x in enumerate(e2e[w][1:]))
        err = max_err(kerns[w], plains[w], recd)[1]
        for S in SHARDS:
            err = max(err, max_err(kerns[w], plains[w],
                                   (sharded[S, large],) + rest)[1])
        err = max([err] + [e for _, e in errs[name]])
        # in turns on phase 6's first-call inputs: flat, sharded, sharded,
        # flat
        flat_args = ((flat_l if large else e2e[w][0]),) + rest
        sh_in = (sharded[4, large],) + rest
        turns = [time_cuda(lambda: kerns[w](*x), a.reps)
                 for x in (flat_args, sh_in, sh_in, flat_args)]
        same = result_err(kerns[w](*flat_args), kerns[w](*sh_in))
        ms = time_cuda(lambda: kerns[w](*recd), a.reps)
        idle_ms = time_after_idle(lambda: kerns[w](*recd), 5)
        plain_ms = time_cuda(lambda: plains[w](*recd), 2, spin=0)
        flat_recd = ((flat_l if large else e2e[w][0]),) + tuple(recd[1:])
        if w == "sa_resolve":
            byt, ops, _f = resolve_work(fm, flat_recd)
        else:
            byt, lf, _f = fm_work(fm, w, flat_recd)
            ops = lf * OPS_LF
        t_bytes, t_ops = byt / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        total = sh_ms.get(name, [0.0, 0])
        entry = dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launch.get(name, 0), max_abs_err=err, equal=err == 0,
            ms=round(ms, 4), idle_ms=round(idle_ms, 4),
            plain_ms=round(plain_ms, 3),
            bound_ms=round(max(t_bytes, t_ops), 5),
            bytes_ms=round(t_bytes, 5), ops_ms=round(t_ops, 5),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, total_ms=round(total[0], 4),
            total_spans=total[1], sweep_cases=len(errs[name]),
            turns=dict(flat_ms=[round(turns[0], 4), round(turns[3], 4)],
                       sharded_ms=[round(turns[1], 4), round(turns[2], 4)],
                       ratio=round((turns[1] + turns[2])
                                   / (turns[0] + turns[3]), 4),
                       flat_vs_sharded_err=same),
            shape=[list(t.shape) for t in recd
                   if isinstance(t, torch.Tensor)][:1],
            ptxas=ptxas_of(build, name, os.path.splitext(
                os.path.basename(src))[0]))
        entries.append(entry)
        log(f"kernel {name}: equal={err == 0} max_abs_err={err} (the "
            f"sharded path's first call, phase 6's first-call inputs at "
            f"{SHARDS} shards, {len(errs[name])} cases); ms={ms:.4f} "
            f"idle_ms={idle_ms:.4f} plain_ms={plain_ms:.3f} bound_ms="
            f"{entry['bound_ms']} total_ms={total[0]:.4f} over {total[1]} "
            f"launches (4-shard SE); launches {entry['launches']}; in turns "
            f"on phase 6's inputs (flat, 4 shards, 4 shards, flat) "
            f"{[round(x, 4) for x in turns]} (x{entry['turns']['ratio']}); "
            f"flat vs sharded results differ by {same}; ptxas "
            f"{entry['ptxas']}")
    never = [k for k in list(SHARD_KERNELS) + ["ref_gather_aligned_sh"]
             if not launch.get(k)]
    if never:
        fail(f"phase 14: never launched on the sharded paths: {never}")
    # K7 over the shards: the 4-shard SE path's first call
    entries.append(new_entry(
        "ref_gather_aligned_sh", *K7["ref_gather_aligned_sh"], holder,
        k7_args, lambda x, _r: gather_work(x, True), a.reps,
        launch.get("ref_gather_aligned_sh", 0),
        sh_ms.get("ref_gather_aligned_sh", [0.0, 0]), build,
        ctx["win_sweep"]["ref_gather_aligned_sh"],
        more=dict(shards=k7_args[0].words.S)))
    # its one-block floor (held to its plain version); with
    # --compare-parent, the call and that floor in turns with the parent's
    # design
    s_floor = aligned_floor(k7_args)
    floor_turns(a, build, entries[-1], "ref_gather",
                "first sharded SE call (4 shards)",
                holder.kern_of("ref_gather_aligned_sh"),
                holder.plain_of("ref_gather_aligned_sh"), k7_args, s_floor,
                f"{s_floor[2].shape[0]} windows",
                m.parent_libs.get("ref_gather"))
    log(f"phase 14 checks (groups differing): {json.dumps(checks)}; "
        f"launches on the sharded paths {launch}; phase 14: "
        f"{time.time() - t_phase:.1f} s")
    return entries


def pad_genome(data, P):
    """`data` behind an all-N reference of P bp (a multiple of 32), laid
    out as the port's builder lays one out (the same tables, field for
    field, as build_index_from_refs on [("pad", P Ns)] + the references):
    reference words 0 and N bits set across it, nothing in the joined
    text; numpy, without rebuilding the index."""
    words = np.zeros(P // 16 + data.ref_words.size, np.uint32)
    words[P // 16:] = data.ref_words
    nwords = np.empty(P // 32 + data.refn_words.size, np.uint32)
    nwords[:P // 32] = 0xFFFFFFFF
    nwords[P // 32:] = data.refn_words
    return dataclasses.replace(
        data, ref_names=["pad"] + list(data.ref_names),
        ref_lens=np.concatenate([[P], data.ref_lens]).astype(np.int64),
        ref_cum=np.concatenate([[0], P + data.ref_cum]).astype(np.int64),
        seg_global_start=data.seg_global_start + P, ref_words=words,
        refn_words=nwords)


def int64_phase(a, m, ctx):
    """Phase 15, the int64 row mode on the card (see the module's
    docstring). m: the port's modules; ctx: what earlier phases made.
    Returns the `kernels` entries of the eight `_i64` entries."""
    t_phase = time.time()
    fm, build, rec, pol = m.fm, m._build, ctx["rec"], ctx["pol"]
    dev = torch.device("cuda")
    checks = {}
    i64_launch = {}

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def launched(label, fn, want):
        """fn() with the counts set to 0 just before and read just after:
        no plain version may run, no FM entry of another row mode may
        launch, and each entry in `want` must."""
        torch.cuda.synchronize()
        build.reset_counts()
        t1 = time.time()
        try:
            out = fn()
            torch.cuda.synchronize()
        except Exception as e:
            fail(f"{label}: {type(e).__name__}: {e}")
        wall = time.time() - t1
        ln, pl = dict(build.LAUNCHES), dict(build.PLAIN_CALLS)
        if pl:
            fail(f"{label}: plain versions ran on the card: {pl}")
        other = [k for k in ln if k.startswith(("fm_", "sa_resolve"))
                 and not k.endswith("_i64")]
        if other:
            fail(f"{label}: FM entries of another row mode launched: "
                 f"{other}")
        missing = [k for k in want if not ln.get(k)]
        if missing:
            fail(f"{label}: never launched {missing}")
        for k in I64_KERNELS:
            i64_launch[k] = i64_launch.get(k, 0) + ln.get(k, 0)
        return out, wall, ln

    flat = [k for k in I64_KERNELS if "_sh" not in k]
    sharded = [k for k in I64_KERNELS if "_sh" in k]
    plains = {"fm_sweep": fm._sweep_plain, "fm_substring": fm._substring_plain,
              "fm_seed": fm._seed_plain, "sa_resolve": fm._resolve_plain}

    # (a) the eight entries past 2^32 rows, on ops/cases.py i64_fm_case,
    # flat and split into I64_SHARDS shards on the card
    t1 = time.time()
    c = m.cases.i64_fm_case(seed=a.seed)
    t_case = time.time() - t1
    half = m.half_from_tables(c.n, c.z_off, c.fm_blocks, c.fchr, c.ftab,
                              c.mark_rows, c.offs, True, dev,
                              occ_cp64=c.occ_cp64)
    if not half.i64:
        fail("i64_fm_case's half is not in the int64 row mode")
    targs = {
        "fm_sweep": (half, put(c.sweep_rr)),
        "fm_substring": (half, put(c.substring_rr)),
        "fm_seed": (half, put(c.seeds), put(c.seed_valid), c.seed_len,
                    c.ftab_chars),
        "sa_resolve": (half, put(c.resolve_rows), 32)}
    log(f"int64 table: {c.n + 1} rows ({half.fm_blocks.shape[0]} blocks; "
        f"fm_blocks {nbytes(half.fm_blocks) / 1e9:.3f} GB, occ_cp64 "
        f"{nbytes(half.occ_cp64) / 1e9:.3f} GB, mark_rows "
        f"{nbytes(half.mark_rows) / 1e9:.3f} GB, offs "
        f"{nbytes(half.offs) / 1e9:.3f} GB on the card), fchr "
        f"{c.fchr.tolist()}, made on the host in {t_case:.1f} s")
    del c
    shalf = sharded_half(m, half, I64_SHARDS)
    big = {}
    for name, (wrapper, _src, _repl) in I64_KERNELS.items():
        args = targs[wrapper]
        if "_sh" in name:
            args = (shalf,) + args[1:]
        kern = getattr(rec, "orig_" + wrapper)
        build.reset_counts()
        got, err = max_err(kern, plains[wrapper], args)
        if not build.LAUNCHES.get(name):
            fail(f"{name}: the int64 table launched "
                 f"{dict(build.LAUNCHES)}")
        out0 = got[0] if isinstance(got, tuple) else got
        past = int((out0 >= PAST_ROW_I64).sum())
        if past == 0:
            fail(f"{name}: no result past 2^32")
        ms = time_cuda(lambda: kern(*args), a.reps)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        plains[wrapper](*args)
        e1.record()
        torch.cuda.synchronize()
        # the function's work on the flat half (the same rows and offsets
        # whatever holds them)
        if wrapper == "sa_resolve":
            byt, ops, _facts = resolve_work(fm, targs[wrapper])
        else:
            byt, lf, _facts = fm_work(fm, wrapper, targs[wrapper])
            ops = lf * OPS_LF
        big[name] = dict(err=err, ms=ms, plain_ms=e0.elapsed_time(e1),
                         bytes_ms=byt / PEAK_BYTES_S * 1e3,
                         ops_ms=ops / PEAK_OPS_S * 1e3, past=past,
                         shape=[list(t.shape) for t in args
                                if isinstance(t, torch.Tensor)][:1])
        log(f"int64 kernel {name} on the int64 table: max_abs_err={err}; "
            f"{past} of {out0.numel()} results (SA walk: offsets) past "
            f"2^32; ms={ms:.4f} plain_ms={big[name]['plain_ms']:.3f} "
            f"bound_ms={max(big[name]['bytes_ms'], big[name]['ops_ms']):.5f}"
            f" (bytes {big[name]['bytes_ms']:.5f}, operations "
            f"{big[name]['ops_ms']:.5f}) shape {big[name]['shape']}")
    del targs, half, shalf
    torch.cuda.empty_cache()

    # (b) the earlier cells' genomes forced into the int64 mode: the first
    # SE batch (flat, and over I64_SHARDS shards), the first PE batch
    # (fused path) and the first long reads, each against its small-index
    # run of the earlier phases. Each aligner is made over the genome's
    # forced-large index of phase 13 (int64 segment tables) and takes the
    # int64 index in place of its own, as a genome past 2^32 rows has it.
    def int64_aligner(cls, data, shard_mesh=None):
        al = cls(data, pol, shard_mesh=shard_mesh)
        al.idx = m.FMIndex.from_host(data, al.device, int64_rows=True)
        if shard_mesh is not None:
            al.sidx = m.shard_index(data, shard_mesh, al.device,
                                    int64_rows=True)
        return al

    def se_run(data, recs, **kw):
        al = int64_aligner(m.UnpairedAligner, data, **kw)
        return al.collect_raw(al.submit(recs)), al

    rec.take()
    (g_se, al_se), w_se, ln_se = launched(
        "int64 repcorpus SE", lambda: se_run(ctx["rep_l"], ctx["chunk0"]),
        flat)
    main_args = rec.take()
    if not al_se.idx.fw.i64:
        fail("the forced aligner's index is not in the int64 row mode")
    nd = sum(1 for x, y in zip(g_se, ctx["groups0"]) if x != y)
    checks["int64 repcorpus SE"] = nd
    log(f"int64 repcorpus SE: {len(ctx['chunk0'])} reads in {w_se:.2f} s; "
        f"launches {ln_se}; vs the small index's run: {nd} groups differ")
    if nd or len(g_se) != len(ctx["groups0"]):
        fail(f"int64 repcorpus SE: {nd} groups differ")
    mesh = m.make_mesh(devices=[dev] * I64_SHARDS, axis="shard")
    (g_sh, al_sh), w_sh, ln_sh = launched(
        f"int64 repcorpus SE, {I64_SHARDS} shards",
        lambda: se_run(ctx["rep_l"], ctx["chunk0"], shard_mesh=mesh),
        sharded)
    if not al_sh.sidx.fw.i64:
        fail("the sharded index is not in the int64 row mode")
    nd = sum(1 for x, y in zip(g_sh, ctx["groups0"]) if x != y)
    checks[f"int64 repcorpus SE, {I64_SHARDS} shards"] = nd
    log(f"int64 repcorpus SE over {I64_SHARDS} shards: {w_sh:.2f} s; "
        f"launches {ln_sh}; vs the small index's run: {nd} groups differ")
    if nd or len(g_sh) != len(ctx["groups0"]):
        fail(f"int64 sharded SE: {nd} groups differ")
    del al_se, al_sh

    def pe_run():
        al = int64_aligner(m.PairedAligner, ctx["eco_l"])
        fb = al.submit(ctx["pe_batch0"])
        if isinstance(fb, tuple):
            fail(f"int64 PE took the {fb[0]} path, not the fused one")
        return al.collect_raw(fb)
    g_pe, w_pe, ln_pe = launched("int64 E. coli-sim PE", pe_run, flat)
    nd = sum(1 for x, y in zip(g_pe, ctx["pe_groups0"]) if x != y)
    checks["int64 E. coli-sim PE"] = nd
    log(f"int64 E. coli-sim PE: {len(ctx['pe_batch0'])} pairs in "
        f"{w_pe:.2f} s; launches {ln_pe}; vs the small index's run: {nd} "
        f"groups differ")
    if nd or len(g_pe) != len(ctx["pe_groups0"]):
        fail(f"int64 PE: {nd} pairs differ")
    (g_lg, _al), w_lg, ln_lg = launched(
        "int64 long reads", lambda: se_run(ctx["eco_l"], ctx["long_first"]),
        ["fm_seed_i64", "sa_resolve_i64"])
    nd = sum(1 for x, y in zip(g_lg, ctx["long_groups"]) if x != y)
    checks["int64 long reads"] = nd
    log(f"int64 long reads: {len(ctx['long_first'])} reads in {w_lg:.2f} s;"
        f" launches {ln_lg}; vs the small index's run: {nd} groups differ")
    if nd or len(g_lg) != len(ctx["long_groups"]):
        fail(f"int64 long reads: {nd} groups differ")

    # (c) single end past 2^32 global coordinates, and the paired-end
    # refusal there
    t1 = time.time()
    d_pad = pad_genome(ctx["edata"], I64_PAD_BP)
    log(f"padded genome: references {d_pad.ref_names} of "
        f"{d_pad.ref_lens.tolist()} bp, global coordinates to "
        f"{int(d_pad.ref_cum[-1])}; laid out in {time.time() - t1:.1f} s")
    try:
        m.PairedAligner(d_pad, pol)
        fail("the PairedAligner took an index past 2^32 - 4096")
    except NotImplementedError as e:
        if "ROADMAP.md" not in str(e):
            fail(f"the paired-end refusal does not name ROADMAP.md: {e}")
        log(f"paired-end refusal past 2^32 - 4096: {e}")
    se_recs = [m.SeqRecord(name=f"e{i}", seq=ctx["se_codes"][i].astype(
        np.uint8), qual=ctx["se_quals"][i]) for i in range(a.batch)]

    def se_pad():
        al = m.UnpairedAligner(d_pad, pol)
        if not al.idx.fw.large or al.idx.ref_cum.dtype != torch.int64:
            fail("the padded genome's index is not in the large mode")
        return al.collect_raw(al.submit(se_recs))
    g_pad, w_pad, ln_pad = (None, 0.0, {})
    torch.cuda.synchronize()
    build.reset_counts()
    t1 = time.time()
    try:
        g_pad = se_pad()
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"SE past 2^32: {type(e).__name__}: {e}")
    w_pad, ln_pad = time.time() - t1, dict(build.LAUNCHES)
    if build.PLAIN_CALLS:
        fail(f"SE past 2^32: plain versions ran: {dict(build.PLAIN_CALLS)}")
    al_g = m.UnpairedAligner(ctx["edata"], pol)
    g_alone = al_g.collect_raw(al_g.submit(se_recs))
    nd = sum(1 for x, y in zip(g_pad, g_alone) if x != y)
    aligned = sum(1 for g in g_pad if not g[0][0] & 4)
    checks["SE past 2^32 vs the genome alone"] = nd
    log(f"SE past 2^32: {len(se_recs)} reads ({aligned} aligned) in "
        f"{w_pad:.2f} s; launches {ln_pad}; vs the genome alone: {nd} "
        f"groups differ")
    if nd or len(g_pad) != len(g_alone):
        fail(f"SE past 2^32: {nd} groups differ from the genome alone")
    del d_pad, al_g
    torch.cuda.empty_cache()

    # each flat entry against its plain version on the forced main path's
    # first call too
    entries = []
    for name, (wrapper, src, repl) in I64_KERNELS.items():
        merr = 0
        if "_sh" not in name:
            if wrapper not in main_args:
                fail(f"the int64 SE batch recorded no {wrapper} call")
            kern = getattr(rec, "orig_" + wrapper)
            merr = max_err(kern, plains[wrapper], main_args[wrapper])[1]
        b = big[name]
        e = max(b["err"], merr)
        entry = dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=i64_launch.get(name, 0), max_abs_err=e, equal=e == 0,
            ms=round(b["ms"], 4), plain_ms=round(b["plain_ms"], 3),
            bound_ms=round(max(b["bytes_ms"], b["ops_ms"]), 5),
            bytes_ms=round(b["bytes_ms"], 5), ops_ms=round(b["ops_ms"], 5),
            bound_by="bytes" if b["bytes_ms"] >= b["ops_ms"]
            else "operations",
            library_ms=None, shape=b["shape"], past_2_32=b["past"],
            ptxas=ptxas_of(build, name, os.path.splitext(
                os.path.basename(src))[0]))
        entries.append(entry)
        log(f"kernel {name}: equal={e == 0} max_abs_err on the int64 table "
            f"{b['err']}, the forced main path's first call {merr}; "
            f"launches on the int64 runs {entry['launches']}; ms="
            f"{b['ms']:.4f} plain_ms={b['plain_ms']:.3f} bound_ms="
            f"{entry['bound_ms']}; ptxas {entry['ptxas']}")
    missing = [k for k in I64_KERNELS if not i64_launch.get(k)]
    if missing:
        fail(f"int64 entries never launched on the int64 runs: {missing}")
    log(f"int64-mode checks (groups differing): {json.dumps(checks)}; "
        f"int64 launches {i64_launch}; phase 15: "
        f"{time.time() - t_phase:.1f} s")
    return entries


def _sharded_of(half):
    """The half's ShardedRows of fm_blocks, or None for a flat half."""
    fmb = getattr(half, "fm_blocks", None)
    return fmb if hasattr(fmb, "addrs") else None

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per kernel timing")
    ap.add_argument("--pairs", type=int, default=ECOLI_PAIRS,
                    help="E. coli-sim pairs of the paired-end path")
    ap.add_argument("--mixed", type=int, default=1024,
                    help="pairs of the mixed-outcome batch")
    ap.add_argument("--long-reads", type=int, default=1024,
                    help="reads of 10-25 kbp on the long-read path")
    ap.add_argument("--compare-parent", default=None, metavar="DIR",
                    help="another design's CUDA sources (e.g. the parent "
                         "commit's csrc/): each that differs from the "
                         "port's is built and timed in turns with it")
    a = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    try:
        from bowtie2_tpu_torch.index.build import build_index_from_refs
        from bowtie2_tpu_torch.index.fmindex import FMIndex, half_from_tables
        from bowtie2_tpu_torch.io.fastx import SeqRecord
        from bowtie2_tpu_torch.ops import _build, cases, fm, fused, sw
        from bowtie2_tpu_torch.pipeline import align as align_mod
        from bowtie2_tpu_torch.pipeline.align import (UnpairedAligner,
                                                      bucket_groups)
        from bowtie2_tpu_torch.pipeline.paired import PairedAligner
        from bowtie2_tpu_torch.pipeline import traj_replay
        from bowtie2_tpu_torch.index.build import load_index
        from bowtie2_tpu_torch.cli.main import main as cli_main
        from bowtie2_tpu_torch.pipeline.policy import make_policy
        from bowtie2_tpu_torch.dist.mesh import make_mesh
        from bowtie2_tpu_torch.index.build import save_index
        from bowtie2_tpu_torch.index.fmindex import ShardedFMHalf
        from bowtie2_tpu_torch.dist.sharded import shard_index
        from bowtie2_tpu_torch.ops import ref as ref_mod
        from bowtie2_tpu_torch.utils.metrics import TRACE
        mrc = load_repcorpus()
    except (ImportError, FileNotFoundError) as e:
        fail(f"the port is not beside this script: {e}")
    if "jax" in sys.modules or any(m.startswith("bowtie2_tpu.")
                                   for m in sys.modules):
        fail("the JAX package was imported")

    # ---------------- phase 1: card, versions, kernel build ----------------
    phase(1, "card, versions, kernel build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.time()
    try:
        _build.build()
    except Exception as e:                      # nvcc missing or failing
        fail(f"kernel build: {e}")
    log(f"kernel build: {time.time() - t0:.1f} s "
        f"({', '.join(_build.SOURCES)})")
    log(f"ptxas: {json.dumps(_build.PTXAS, sort_keys=True)}")
    parents = parent_libs(_build, a.compare_parent) if a.compare_parent \
        else {}

    # ---------------- phase 2: corpus + index ----------------
    phase(2, "corpus + index")
    t0 = time.time()
    rng = np.random.default_rng(a.seed)
    genome = mrc.make_genome(rng)
    reads = mrc.sample_reads(rng, genome, a.reads)
    records = [SeqRecord(name=f"rr{i}", seq=r.astype(np.uint8),
                         qual=q.astype(np.uint8))
               for i, (r, q) in enumerate(reads)]
    data = build_index_from_refs([("rep", genome.astype(np.uint8))])
    log(f"corpus: {genome.size} bp genome, {len(records)} reads, index "
        f"built in {time.time() - t0:.1f} s")

    # ---------------- phase 3: the main path on the card ----------------
    phase(3, "the main path on the card")
    props = torch.cuda.get_device_properties(0)
    threads = props.multi_processor_count * getattr(
        props, "max_threads_per_multi_processor", 2048)
    # the calls past these sizes are replayed in phase 6 too: the walks
    # that take the one-thread-a-walk kernel, the SA rows past the threads
    # the card holds; and the searches' first call of another size at once
    rec = Recorder(fm, sw, fused, bulk={
        "backtrace": BT_WARP_WALKS_PER_SM * props.multi_processor_count,
        "sa_resolve": threads, "fm_seed": None, "fm_substring": None})
    holder = Holder(ref_mod, fused, align_mod, sw)
    holder.label = "SE main path"
    pol = make_policy("sensitive")
    aligner = UnpairedAligner(data, pol)
    spent = host_timers([(aligner, "submit"), (aligner, "collect_raw"),
                         (aligner, "_decode"),
                         (aligner, "_search_candidates"),
                         (traj_replay, "run_replays"),
                         (traj_replay, "emit_overrides")])
    torch.cuda.synchronize()

    def run(al, recs):
        by_bucket = bucket_groups([r.seq.size for r in recs])
        handles, firsts = [], []
        for bkt in sorted(by_bucket):
            idxs = by_bucket[bkt]
            for k in range(0, len(idxs), a.batch):
                chunk = [recs[j] for j in idxs[k:k + a.batch]]
                handles.append(al.submit(chunk))
                firsts.append(chunk)
        groups = [al.collect_raw(h) for h in handles]
        return groups, firsts

    _build.reset_counts()
    TRACE.clear()
    TRACE.on = True
    t0 = time.time()
    try:
        groups, chunks = run(aligner, records)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"main path: {type(e).__name__}: {e}")
    wall = time.time() - t0
    TRACE.on = False
    launches = dict(_build.LAUNCHES)
    plain = dict(_build.PLAIN_CALLS)
    n_groups = sum(len(g) for g in groups)
    aligned = sum(1 for gs in groups for g in gs if not g[0][0] & 4)
    timers = span_totals(TRACE)
    log(f"main path: {len(records)} reads in {wall:.2f} s = "
        f"{len(records) / wall:.1f} reads/s; {aligned} aligned; "
        f"host-path batches {aligner.metrics.counters.get('host_batches', 0)}"
        f" of {len(chunks)}; trajectory overrides "
        f"{aligner.metrics.counters.get('traj_overridden', 0)}; "
        f"launches {launches}; plain calls {plain}; port spans {timers}; "
        f"wall s in {({k: round(v, 2) for k, v in spent.items()})}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if n_groups != len(records):
        fail(f"{n_groups} SAM groups for {len(records)} reads")
    missing = [k for k in list(KERNELS) + ["ref_gather_aligned",
                                           "ref_gather", K10SE[0]]
               if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if plain:
        fail(f"plain versions ran on the card's main path: {plain}")
    if aligned < 0.9 * len(records):
        fail(f"only {aligned} of {len(records)} reads aligned")
    for gs in groups:
        for g in gs:
            for _flag, line in g:
                if line.count(b"\t") < 10:
                    fail(f"malformed SAM line: {line[:80]!r}")

    # the same run again, with a fresh aligner, under CUDA events: kept
    # apart from the timed window so that reads/s carries no spin or event
    timer = LaunchTimer(_build)
    _build.reset_counts()
    t0 = time.time()
    try:
        run(UnpairedAligner(data, pol), records)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"device-time pass: {type(e).__name__}: {e}")
    twall = time.time() - t0
    tlaunches = dict(_build.LAUNCHES)
    timer.restore()
    dev_ms = timer.totals()
    se_gather_shapes = timer.totals(by_shape=True).get("ref_gather", {})
    se_aligned_shapes = timer.totals(by_shape=True).get(
        "ref_gather_aligned", {})
    se_readout_shapes = timer.totals(by_shape=True).get(K10SE[0], {})
    shapes = {k: {str(sh): [round(v[0], 4), v[1]] for sh, v in sorted(d.items())}
              for k, d in timer.totals(by_shape=True).items()}
    busy_s = sum(v[0] for v in dev_ms.values()) / 1e3
    spans = {k: [round(v[0], 4), v[1]] for k, v in sorted(dev_ms.items())}
    spin = ("on" if timer.spin is not None
            else "off (spans include launch latency)")
    log(f"device time: {json.dumps(spans)} (total ms, spans); sum "
        f"{busy_s:.4f} s = {100 * busy_s / wall:.4f} % of the main path's "
        f"{wall:.2f} s wall time; stream spin before each span {spin}; this "
        f"pass {twall:.2f} s, launches "
        f"{'as the main path' if tlaunches == launches else tlaunches}")
    log(f"call shapes: {json.dumps(shapes)} (total ms, calls; backtrace by "
        f"(walks, Lmax, W, S), sa_resolve by rows, fm_seed by (seeds, "
        f"seed length, K), fm_substring by (states, columns), ref_gather by "
        f"(windows, width), ref_gather_aligned by (windows, aligned "
        f"width)); the card "
        f"holds {threads} threads at once")

    # ---------------- phase 4: card vs CPU on the first batch -------------
    phase(4, "card vs CPU on the first batch")
    t0 = time.time()
    cpu_al = UnpairedAligner(data, pol, device="cpu")
    cpu_groups = cpu_al.collect_raw(cpu_al.submit(chunks[0]))
    ndiff = sum(1 for x, y in zip(groups[0], cpu_groups) if x != y)
    log(f"SAM check: first batch of {len(chunks[0])} reads, card vs CPU "
        f"plain versions: {ndiff} groups differ ({time.time() - t0:.1f} s)")
    if len(cpu_groups) != len(groups[0]) or ndiff:
        fail(f"card and CPU SAM differ in {ndiff} of {len(chunks[0])} reads")
    e2e_args = rec.take()
    holder.check("SE --local")

    # ---------------- phase 5: the --local path, first batch ---------------
    phase(5, "the --local path, first batch")
    lpol = make_policy("sensitive", local=True)
    laligner = UnpairedAligner(data, lpol)
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.time()
    try:
        lgroups = laligner.collect_raw(laligner.submit(chunks[0]))
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"--local path: {type(e).__name__}: {e}")
    lwall = time.time() - t0
    llaunches = dict(_build.LAUNCHES)
    lplain = dict(_build.PLAIN_CALLS)
    laligned = sum(1 for g in lgroups if not g[0][0] & 4)
    log(f"--local path: {len(chunks[0])} reads in {lwall:.2f} s; "
        f"{laligned} aligned; launches {llaunches}; plain calls {lplain}")
    missing = [k for k in list(KERNELS) + ["ref_gather_aligned"]
               if llaunches.get(k, 0) == 0]
    if missing:
        fail(f"kernels never launched on the --local path: {missing}")
    if lplain:
        fail(f"plain versions ran on the card's --local path: {lplain}")
    t0 = time.time()
    cpu_l = UnpairedAligner(data, lpol, device="cpu")
    cpu_lgroups = cpu_l.collect_raw(cpu_l.submit(chunks[0]))
    ndiff = sum(1 for x, y in zip(lgroups, cpu_lgroups) if x != y)
    log(f"SAM check (--local): card vs CPU plain versions: {ndiff} groups "
        f"differ ({time.time() - t0:.1f} s)")
    if len(cpu_lgroups) != len(lgroups) or ndiff:
        fail(f"--local card and CPU SAM differ in {ndiff} reads")
    local_args = rec.take()
    holder.check(None)

    # ---------------- phase 6: each kernel against its plain version ------
    phase(6, "each kernel against its plain version")
    plains = {"fm_sweep": fm._sweep_plain, "fm_substring": fm._substring_plain,
              "fm_seed": fm._seed_plain, "sa_resolve": fm._resolve_plain,
              "sw_rect": sw._sw_banded_plain, "backtrace": sw._backtrace_plain,
              "sw_rect_origin": lambda *x: sw._sw_banded_plain(
                  *x, track_origin=True),
              "sw_rect@rescue": sw._sw_banded_plain}
    t0 = time.time()
    port = types.SimpleNamespace(cases=cases, sw=sw, FMIndex=FMIndex,
                                 build_index_from_refs=build_index_from_refs)
    case_indexes = {}           # phase 14 splits them into shards
    sweep_errs = exactness_sweep(
        port, {k: getattr(rec, "orig_" + k)
               for k in list(KERNELS) + ["sw_rect_origin"]},
        plains, data, genome, torch.device("cuda"), keep=case_indexes)
    for name, errs in sweep_errs.items():
        bad = [(c, e) for c, e in errs if e]
        log(f"exactness sweep {name}: {len(errs)} cases, "
            f"{len(errs) - len(bad)} equal to the plain version, "
            f"max abs err {max(e for _, e in errs)}"
            + (f"; differ: {bad}" if bad else "")
            + f" ({time.time() - t0:.1f} s)")

    # the chain floor: one block's worth of problems alone on the card
    # (4 DP problems, 64 sweep states, 8 walks, 128 SA rows, 128 seeds, 64
    # half-read states)
    def first(args, n):
        return tuple(x[:n].contiguous() if isinstance(x, torch.Tensor)
                     else x for x in args)
    bt_args = e2e_args["backtrace"]
    rs_args = e2e_args["sa_resolve"]
    chain_ms = {
        "sw_rect": time_cuda(lambda: rec.orig_sw_rect(
            *first_lanes(e2e_args["sw_rect"], 4)), a.reps),
        "fm_sweep": time_cuda(lambda: rec.orig_fm_sweep(
            e2e_args["fm_sweep"][0], e2e_args["fm_sweep"][1][:64]), a.reps),
        "backtrace": time_cuda(lambda: rec.orig_backtrace(
            bt_args[0], *first(bt_args[1:], 8)), a.reps),
        "sa_resolve": time_cuda(lambda: rec.orig_sa_resolve(
            rs_args[0], rs_args[1][:128].contiguous(), rs_args[2]), a.reps),
        "fm_seed": time_cuda(lambda: rec.orig_fm_seed(
            *first(e2e_args["fm_seed"], 128)), a.reps),
        "fm_substring": time_cuda(lambda: rec.orig_fm_substring(
            *first(e2e_args["fm_substring"], 64)), a.reps)}
    smi_clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    try:
        clock_hz = float(smi_clk.stdout.split()[0]) * 1e6
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no SM clock: {smi_clk.stdout!r}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    kernels_out = []
    ok = all(e == 0 for errs in sweep_errs.values() for _, e in errs)
    port_mods = types.SimpleNamespace(
        sw=sw, _build=_build, cases=cases, align_mod=align_mod,
        traj_replay=traj_replay, SeqRecord=SeqRecord,
        UnpairedAligner=UnpairedAligner,
        PairedAligner=PairedAligner, bucket_groups=bucket_groups,
        parent_libs=parents)
    rect_lib = parents.get("sw_rect")
    for name, (src, repl) in KERNELS.items():
        args = e2e_args[name]
        kern = getattr(rec, "orig_" + name)
        # the DP over the region its n_live contract specifies
        err_fn = rect_err if name == "sw_rect" else None
        got, err = max_err(kern, plains[name], args, err_fn)
        lerr = max_err(kern, plains[name], local_args[name], err_fn)[1] \
            if name in local_args else 0
        if name == "sw_rect":
            # the host path's first call (a host count of live lanes)
            host_args = e2e_args.get("sw_rect@host")
            if host_args is None:
                fail("the SE host path recorded no DP call")
            lerr = max(lerr, max_err(kern, plains[name], host_args,
                                     err_fn)[1])
        # the main path's first call past Recorder's bulk size, whose
        # launch shape differs from the first call's
        bulk_args = e2e_args.get(name + "@bulk")
        bulk = None
        if bulk_args is not None:
            berr = max_err(kern, plains[name], bulk_args)[1]
            bulk = dict(shape=[list(t.shape) for t in bulk_args
                               if isinstance(t, torch.Tensor)][:2],
                        max_abs_err=berr,
                        ms=round(time_cuda(lambda: kern(*bulk_args),
                                           a.reps), 4))
        equal = err == 0 and lerr == 0 and (bulk is None or berr == 0)
        ok &= equal
        ms = time_cuda(lambda: kern(*args), a.reps)
        idle_ms = time_after_idle(lambda: kern(*args), 5)
        plain_ms = time_cuda(lambda: plains[name](*args), 2, spin=0)
        extra = {}      # measured: into the JSON line
        derived = {}    # derived from a model or a replay: log line only
        if name in ("fm_sweep", "fm_substring", "fm_seed"):
            byt, lf, derived = fm_work(fm, name, args)
            ops = lf * OPS_LF
            if derived:
                # the modelled sectors' bytes over the measured kernel time
                derived["l2_tb_s"] = round(
                    derived["l2_sectors"] * 32 / ms / 1e9, 3)
        elif name == "sa_resolve":
            byt, ops, facts = resolve_work(fm, args)
            # the modelled sectors' bytes over the measured kernel time
            derived = dict(
                lane_idle_share=round(facts["lane_idle_share"], 4),
                l2_sectors=facts["sectors"],
                l2_sectors_warp=facts["sectors_warp"],
                l2_tb_s=round(facts["sectors"] * 32 / ms / 1e9, 3),
                l2_warp_tb_s=round(facts["sectors_warp"] * 32 / ms / 1e9, 3),
                walk_steps=facts["steps"])
        elif name == "sw_rect":
            # cells the data needs: each problem's rows x its rect columns
            byt, cells = dp_work(args, False)
            ops = cells * OPS_DP_CELL
            extra = dict(cells=cells, cells_launched=rect_cells(args)[1],
                         n_live=live_count(args))
            # derived, not measured: those cells at OPS_DP_CELL
            # instructions each, one instruction a lane a clock on every
            # SM at the maximum SM clock
            issue_ms = ops / (n_sm * 128 * clock_hz) * 1e3
        else:   # backtrace
            byt, ops, tail = walk_work(got, *args[1:4])
            extra = dict(tail_share=tail, steps=args[8])
        t_bytes = byt / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_OPS_S * 1e3
        sweep_err = max((e for _, e in sweep_errs.get(name, [])), default=0)
        src_name = os.path.splitext(os.path.basename(src))[0]
        regs = ptxas_of(_build, name, src_name)
        total = dev_ms.get(name, [0.0, 0])
        entry = dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches.get(name, 0),
            max_abs_err=max(err, lerr, sweep_err),
            equal=equal, launches_local=llaunches.get(name, 0),
            ms=round(ms, 4), idle_ms=round(idle_ms, 4),
            plain_ms=round(plain_ms, 3),
            bound_ms=round(max(t_bytes, t_ops), 5),
            bytes_ms=round(t_bytes, 5), ops_ms=round(t_ops, 5),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            total_ms=round(total[0], 4), total_spans=total[1],
            ptxas=regs,
            shape=[list(t.shape) for t in args
                   if isinstance(t, torch.Tensor)][:2])
        if name in chain_ms:
            entry["chain_ms"] = round(chain_ms[name], 4)
            entry["sweep_cases"] = len(sweep_errs[name])
        if bulk is not None:
            entry["bulk"] = bulk
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       bulk["max_abs_err"])
        entry.update(extra)
        kernels_out.append(entry)
        if name == "sw_rect" and rect_lib is not None:
            entry["turns"] = [
                rect_turns(a, port_mods, label, kern, targs, rect_lib)
                for label, targs in (("fused SE, first call", args),
                                     ("SE host path, first call",
                                      host_args))]
            ok &= all(t["max_abs_err"] == 0 for t in entry["turns"])
        log(f"kernel {name}: equal={equal} max_abs_err={err} "
            f"(local {lerr}, sweep {sweep_err}) "
            f"ms={ms:.4f} idle_ms={idle_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_bytes, t_ops):.5f} (bytes {t_bytes:.5f}, "
            f"operations {t_ops:.5f}) total_ms={total[0]:.4f} over "
            f"{total[1]} launches"
            + (f" chain_ms={chain_ms[name]:.4f}" if name in chain_ms else "")
            + "".join(f" {k}={v}" for k, v in extra.items())
            + (f" bulk call {bulk['shape']}: max_abs_err="
               f"{bulk['max_abs_err']} ms={bulk['ms']}" if bulk else
               f" (no call past {rec.bulk[name]} on the main path)"
               if rec.bulk.get(name) else
               f" (no call of another size than "
               f"{rec.first_size(name, e2e_args)} on the main path)"
               if name in rec.bulk else "")
            + (" derived, not measured:" + "".join(
                f" {k}={v}" for k, v in derived.items()) if derived else "")
            + (f" cells={cells} issue floor (derived: cells x "
               f"{OPS_DP_CELL} / ({n_sm} SMs x 128 lanes x "
               f"{clock_hz / 1e6:.0f} MHz)) {issue_ms:.5f} ms"
               if name == "sw_rect" else ""))

    # K7, the window gather: the fused path's first call (the aligned
    # form) and the SE host path's first (the unaligned form), and every
    # ops/cases.py window_cases case at scale 1 and 8 (the aligned form
    # also over each case's tables split into 4 shards)
    if "ref_gather_aligned" not in holder.first or \
            "ref_gather" not in holder.first:
        fail("the SE paths never gathered their windows")
    t0 = time.time()
    win_sweep = window_sweep(ref_mod, fm, cases, holder,
                             torch.device("cuda"))
    log(f"exactness sweep of K7 (ops/cases.py window_cases): "
        f"{json.dumps({k: [len(v), max(e for _, e in v)] for k, v in win_sweep.items()})}"
        f" (cases, max abs err; {time.time() - t0:.1f} s)")
    k7_entries = {}
    for name, args, aligned in (
            ("ref_gather_aligned", holder.first["ref_gather_aligned"][1],
             True),
            ("ref_gather", holder.first["ref_gather"][1], False)):
        k7_entries[name] = new_entry(
            name, *K7[name], holder, args,
            lambda x, _r, _a=aligned: gather_work(x, _a), a.reps,
            launches.get(name, 0), dev_ms.get(name, [0.0, 0]), _build,
            win_sweep[name])
        kernels_out.append(k7_entries[name])
    # the unaligned form's one-block floor; with --compare-parent, its
    # first call and floor in turns with the parent's design
    g_args = holder.first["ref_gather"][1]
    g_kern = holder.kern_of("ref_gather")
    k7u = k7_entries["ref_gather"]
    g_floor = gather_floor(g_args)
    k7u["chain_ms"] = round(time_cuda(lambda: g_kern(*g_floor), a.reps), 5)
    log(f"kernel ref_gather: one block alone (chain_ms) {k7u['chain_ms']}"
        f" on {g_floor[2].shape[0]} windows")
    gather_lib = parents.get("ref_gather")
    if gather_lib is not None:
        k7u["turns"] = [short_turns(
            a, _build, "ref_gather", "first SE host-path call", g_kern,
            g_args, g_floor, gather_lib)]
        k7u["max_abs_err"] = max(k7u["max_abs_err"],
                                 k7u["turns"][0]["max_abs_err"])
        k7u["equal"] = k7u["max_abs_err"] == 0
    # the aligned form's one-block floor (held to its plain version); with
    # --compare-parent, the fused SE path's first call and that floor in
    # turns with the parent's design (the PE path's first call follows in
    # phase 12)
    a_args = holder.first["ref_gather_aligned"][1]
    a_floor = aligned_floor(a_args)
    floor_turns(a, _build, k7_entries["ref_gather_aligned"], "ref_gather",
                "first fused SE call", holder.kern_of("ref_gather_aligned"),
                holder.plain_of("ref_gather_aligned"), a_args, a_floor,
                f"{a_floor[2].shape[0]} windows", gather_lib)

    # K10 SE, the gapless readout of the fused path: its first call on the
    # main path, every call the Holder kept, and every ops/cases.py
    # readout_cases case at scale 1 and 8
    if K10SE[0] not in holder.first:
        fail("the fused path never read a diagonal out")
    t0 = time.time()
    ro_sweep = readout_sweep(cases, sw, holder, torch.device("cuda"))
    log(f"exactness sweep of K10 SE (ops/cases.py readout_cases): "
        f"{len(ro_sweep)} cases, max abs err "
        f"{max(e for _, e in ro_sweep)} ({time.time() - t0:.1f} s)")
    ro_args = holder.first[K10SE[0]][1]
    kernels_out.append(new_entry(
        K10SE[0], *K10SE[1:], holder, ro_args, readout_work, a.reps,
        launches.get(K10SE[0], 0), dev_ms.get(K10SE[0], [0.0, 0]), _build,
        ro_sweep, more=dict(library_reason="no single PyTorch call "
                            "computes the readout (a gather along each "
                            "diagonal, masked sums and the transposed op "
                            "bytes)"),
        shape=list(ro_args[0].shape) + [ro_args[2].shape[1]]))
    # its one-block floor (held to its plain version); with
    # --compare-parent, its first call and that floor in turns with the
    # parent's design
    ro = kernels_out[-1]
    ro_floor = readout_floor(ro_args)
    ro_kern, ro_plain = holder.kern_of(K10SE[0]), holder.plain_of(K10SE[0])
    ro_lib = parents.get(K10SE[0])
    floor_turns(a, _build, ro, K10SE[0], "first fused SE call", ro_kern,
                ro_plain, ro_args, ro_floor,
                f"{ro_floor[0].shape[0]} candidates", ro_lib)
    # a call past the 256-step tile, at the fused path's shape for
    # 250-300-bp reads (bucket 384), held to its plain version and timed
    # (with --compare-parent, in turns with the parent's design)
    lg = long_readout_args(ro_args, READOUT_LONG_LMAX, a.seed)
    lg_ms = time_cuda(lambda: ro_kern(*lg), a.reps)
    lg_bytes, lg_ops = readout_work(lg, None)
    ro["long"] = dict(shape=list(lg[0].shape) + [lg[2].shape[1]],
                      ms=round(lg_ms, 5),
                      bound_ms=round(max(lg_bytes / PEAK_BYTES_S,
                                         lg_ops / PEAK_OPS_S) * 1e3, 5),
                      max_abs_err=max_err(ro_kern, ro_plain, lg)[1])
    log(f"kernel {K10SE[0]} at Lmax {READOUT_LONG_LMAX}: "
        f"{json.dumps(ro['long'])}")
    errs = [ro["long"]["max_abs_err"]]
    if ro_lib is not None:
        ro["turns"].append(short_turns(
            a, _build, K10SE[0], f"Lmax {READOUT_LONG_LMAX} call", ro_kern,
            lg, readout_floor(lg), ro_lib, ro_plain))
        # every shape the SE main path launched, by class, in turns
        ro["launch_classes"] = {"SE main path": gather_classes(
            a, _build, ro_kern, holder.kept.get(("SE main path", K10SE[0]),
                                                {}),
            se_readout_shapes, ro_lib, entry=K10SE[0], src=K10SE[0],
            below=lambda Bc, _L, _W: Bc <= READOUT_BLOCK)}
        log(f"compare {K10SE[0]} launch classes: "
            f"{json.dumps(ro['launch_classes'])}")
        errs += [ro["turns"][-1]["max_abs_err"]] + [
            c["max_abs_err"] for c in ro["launch_classes"][
                "SE main path"].values()]
    ro["max_abs_err"] = max([ro["max_abs_err"]] + errs)
    ro["equal"] = ro["max_abs_err"] == 0

    # one whole fused_se batch (the main path's first) under CUPTI: device
    # time by kernel, and by the torch-op regions between the kernels
    split_al = UnpairedAligner(data, pol)
    se_total, se_by, se_reg = cupti(
        lambda: split_al.submit(chunks[0]), reps=1, regions=(
            (fused, "diag_readout", "K10 diag_readout"),
            (fused, "gather_windows_aligned", "K7 gather_windows_aligned"),
            (fused, "_core", "fused _core (phases 1-4)")))
    se_ours = split_line(f"one fused_se batch ({len(chunks[0])} reads)",
                         se_total, se_by, se_reg, _build)
    k7_entries["ref_gather_aligned"]["batch_cupti_ms"] = se_ours.get(
        "aligned_kernel<int, false>")

    # ---------------- phase 7: E. coli-sim corpus, index by the CLI -------
    phase(7, "E. coli-sim corpus, index by the CLI")
    t0 = time.time()
    egenome, (se_codes, se_quals), (c1, c2, q1, q2) = ecoli_corpus(a.pairs)
    pairs = [(SeqRecord(name=f"p{i}", seq=c1[i].astype(np.uint8),
                        qual=q1[i]),
              SeqRecord(name=f"p{i}", seq=c2[i].astype(np.uint8),
                        qual=q2[i])) for i in range(len(c1))]
    if not pairs:
        fail("no pairs for the paired-end path")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tdir = tmp.name
    alpha = np.frombuffer(b"ACGT", np.uint8)
    with open(os.path.join(tdir, "ecoli.fa"), "w") as f:
        f.write(">ecoli_sim\n")
        gb = alpha[egenome.astype(np.int64)].tobytes().decode()
        for k in range(0, len(gb), 70):
            f.write(gb[k:k + 70] + "\n")
    idx = os.path.join(tdir, "ecoli")
    if cli_main(["build", os.path.join(tdir, "ecoli.fa"), idx]) != 0:
        fail("bt2x build failed")
    edata = load_index(idx)
    nse = min(CLI_SE, len(se_codes))
    write_fastq(os.path.join(tdir, "se.fq"), [f"e{i}" for i in range(nse)],
                se_codes[:nse], se_quals[:nse])
    npe = min(PE_BATCH, len(pairs))
    for m, (cc, qq) in enumerate(((c1, q1), (c2, q2))):
        write_fastq(os.path.join(tdir, f"pe_{m + 1}.fq"),
                    [f"p{i}" for i in range(npe)], cc[:npe], qq[:npe])
    log(f"E. coli-sim corpus: {egenome.size} bp genome, {len(pairs)} pairs "
        f"of 100 bp; index built by `build` and loaded in "
        f"{time.time() - t0:.1f} s")

    # ---------------- phase 8: the paired-end path ----------------
    phase(8, "the paired-end path")
    # one batch first, as bench.py warms the JAX package up: the first
    # calls of the pairing's torch ops load their CUDA code
    t0 = time.time()
    try:
        PairedAligner(edata, pol).align_pairs_fast(
            pairs[:PE_BATCH], batch=PE_BATCH, raw=True)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"paired-end warm-up: {type(e).__name__}: {e}")
    log(f"paired-end warm-up: {min(PE_BATCH, len(pairs))} pairs in "
        f"{time.time() - t0:.2f} s")
    rec.take()
    holder.label = "PE main path"
    pal = PairedAligner(edata, pol)
    pspent = host_timers([(pal, n) for n in (
        "submit", "collect_raw", "_pe_decode", "_pe_fast_prep",
        "_collect_fused_fast_raw", "_collect_fused_legacy",
        "align_batch_host", "_run_dp", "_backtrace_sel", "_gapless_tb_raw")])
    first_groups = []
    timed_collect = pal.collect_raw

    def keep_first(h, suffix=b""):
        out = timed_collect(h, suffix)
        if not first_groups:
            first_groups.append(out)
        return out
    pal.collect_raw = keep_first
    torch.cuda.synchronize()
    _build.reset_counts()
    TRACE.clear()
    TRACE.on = True
    t0 = time.time()
    try:
        pal.align_pairs_fast(pairs, batch=PE_BATCH, raw=True)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"paired-end path: {type(e).__name__}: {e}")
    pwall = time.time() - t0
    TRACE.on = False
    plaunches = dict(_build.LAUNCHES)
    pplain = dict(_build.PLAIN_CALLS)
    pc = pal.metrics.counters
    ptimers = span_totals(TRACE)
    log(f"paired-end path: {len(pairs)} pairs in {pwall:.2f} s = "
        f"{len(pairs) / pwall:.1f} pairs/s; {pal.stats.conc_one} + "
        f"{pal.stats.conc_multi} concordant, {pal.stats.disc} discordant; "
        f"host-path batches {pc.get('host_batches', 0)}; mate DPs "
        f"{pc.get('mate_dps', 0)}; launches {plaunches}; plain calls "
        f"{pplain}; port spans {ptimers}; wall s in "
        f"{({k: round(v, 2) for k, v in pspent.items()})}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    pe_args = rec.take()
    for k in ("sw_rect_origin", "sw_rect@block", "pe_pairing",
              "ref_gather_aligned", "ref_gather"):
        if plaunches.get(k, 0) == 0:
            fail(f"{k} never launched on the paired-end path")
    if pplain:
        fail(f"plain versions ran on the card's paired-end path: {pplain}")
    # inserts run to 550 against -X 500: about an eighth of the pairs
    # align discordantly
    if pal.stats.conc_one + pal.stats.conc_multi + pal.stats.disc \
            < 0.9 * len(pairs):
        fail("fewer than 90 % of the pairs aligned as pairs")

    # the same run again under CUDA events, apart from the timed window
    ptimer = LaunchTimer(_build)
    t0 = time.time()
    try:
        PairedAligner(edata, pol).align_pairs_fast(pairs, batch=PE_BATCH,
                                                   raw=True)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"paired-end device-time pass: {type(e).__name__}: {e}")
    ptwall = time.time() - t0
    ptimer.restore()
    pdev_ms = ptimer.totals()
    pe_gather_shapes = ptimer.totals(by_shape=True).get("ref_gather", {})
    pe_aligned_shapes = ptimer.totals(by_shape=True).get(
        "ref_gather_aligned", {})
    pbusy = sum(v[0] for v in pdev_ms.values()) / 1e3
    log(f"paired-end device time: "
        f"{json.dumps({k: [round(v[0], 4), v[1]] for k, v in sorted(pdev_ms.items())})}"
        f" (total ms, spans); sum {pbusy:.4f} s = "
        f"{100 * pbusy / pwall:.4f} % of the paired-end path's {pwall:.2f} "
        f"s wall time; this pass {ptwall:.2f} s")
    for name, e in k7_entries.items():
        e["pe_launches"] = plaunches.get(name, 0)
        e["pe_total_ms"] = round(pdev_ms.get(name, [0.0, 0])[0], 4)

    # ---------------- phase 9: paired-end output checks ----------------
    phase(9, "paired-end output checks")
    # (the PE main path's kept calls of the new kernels held first; then
    # the checks' batches: the mixed-outcome batch's hostneed pairs and
    # the overflow batch's host path)
    holder.check("PE checks")

    def pe_cpu_check(label, policy, batch, groups, **kw):
        t1 = time.time()
        cpu_pa = PairedAligner(edata if kw.get("data") is None
                               else kw["data"], policy, device="cpu")
        cg = cpu_pa.collect_raw(cpu_pa.submit(batch))
        nd = sum(1 for x, y in zip(groups, cg) if x != y)
        log(f"PE SAM check ({label}): {len(batch)} pairs, card vs CPU plain "
            f"versions: {nd} groups differ ({time.time() - t1:.1f} s)")
        if len(cg) != len(groups) or nd:
            fail(f"PE {label}: card and CPU SAM differ in {nd} pairs")
        return cg

    batch0 = pairs[:PE_BATCH]
    pe_cpu0 = pe_cpu_check("end to end, first batch", pol, batch0,
                           first_groups[0])
    fhal = PairedAligner(edata, pol)
    fhal.force_host_pairing = True
    fhg = fhal.collect_raw(fhal.submit(batch0))
    nd = sum(1 for x, y in zip(first_groups[0], fhg) if x != y)
    log(f"PE first batch: device pairing vs force_host_pairing on the card: "
        f"{nd} groups differ")
    if nd or len(fhg) != len(first_groups[0]):
        fail(f"device pairing and host pairing differ in {nd} pairs")
    lpal = PairedAligner(edata, lpol)
    rec.take()      # from here on, the --local batch's calls only
    _build.reset_counts()
    try:
        lpg = lpal.collect_raw(lpal.submit(batch0))
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"paired-end --local: {type(e).__name__}: {e}")
    pl_launch = dict(_build.LAUNCHES)
    log(f"paired-end --local, first batch: launches {pl_launch}; plain "
        f"calls {dict(_build.PLAIN_CALLS)}")
    if _build.PLAIN_CALLS or pl_launch.get("sw_rect_origin", 0) == 0:
        fail("the --local paired-end path did not run on the kernels")
    pe_local_args = rec.take()
    if "sw_rect_origin" not in pe_local_args:
        fail("the --local paired-end batch recorded no origin DP call")
    pe_cpu_check("--local, first batch", lpol, batch0, lpg)

    # a mixed-outcome batch over the repcorpus genome, at 0.5 % errors (at
    # the recipe's 2 % the repeats overflow the fused DP budget, and the
    # batch would skip the device pairing)
    mixed = [(SeqRecord(name=nm, seq=x, qual=q), SeqRecord(name=nm, seq=y,
                                                          qual=q))
             for nm, x, y, q in mk_pairs(data, np.random.default_rng(7),
                                         a.mixed, err=0.005)]
    mal = PairedAligner(data, pol)
    mfpb = mal.submit(mixed)
    n_hostneed = hostneed_pairs(mfpb, fused)
    mg = mal.collect_raw(mfpb)
    hal = PairedAligner(data, pol)
    hal.force_host_pairing = True
    hg = hal.collect_raw(hal.submit(mixed))
    nd = sum(1 for x, y in zip(mg, hg) if x != y)
    log(f"PE mixed-outcome batch: {len(mixed)} pairs over the repcorpus "
        f"genome; {n_hostneed} pairs raised hostneed; host-path batches "
        f"{mal.metrics.counters.get('host_batches', 0)}; concordant "
        f"{mal.stats.conc_one + mal.stats.conc_multi}, discordant "
        f"{mal.stats.disc}; device pairing vs force_host_pairing on the "
        f"card: {nd} groups differ")
    if nd or len(mg) != len(hg):
        fail(f"device pairing and host pairing differ in {nd} pairs")
    pe_cpu_check("mixed outcomes", pol, mixed, mg, data=data)

    # the recipe's own 2 % errors: the repeats overflow the fused DP budget
    # end to end, and the batch takes the phase-by-phase host path
    # (align_batch_host, mate rescue included) on the card
    over = [(SeqRecord(name=nm, seq=x, qual=q), SeqRecord(name=nm, seq=y,
                                                         qual=q))
            for nm, x, y, q in mk_pairs(data, np.random.default_rng(7),
                                        a.mixed, err=0.02)]
    oal = PairedAligner(data, pol)
    _build.reset_counts()
    og = oal.collect_raw(oal.submit(over))
    torch.cuda.synchronize()
    n_host = oal.metrics.counters.get("host_batches", 0)
    log(f"PE overflow batch: {len(over)} pairs at 2 % errors; host-path "
        f"batches {n_host}; mate DPs "
        f"{oal.metrics.counters.get('mate_dps', 0)}; launches "
        f"{dict(_build.LAUNCHES)}; plain calls {dict(_build.PLAIN_CALLS)}")
    if n_host != 1:
        fail("the 2 % batch did not take the paired-end host path")
    if _build.PLAIN_CALLS:
        fail("plain versions ran on the card's paired-end host path")
    pe_cpu_check("overflow to the host path", pol, over, og, data=data)

    # ---------------- phase 10: the paired-end kernels ----------------
    phase(10, "the paired-end kernels")
    holder.check(None)
    if "sw_rect_origin" not in pe_args or "sw_rect@rescue" not in pe_args:
        fail("the paired-end path recorded no origin DP or rescue DP call")
    oargs = pe_args["sw_rect_origin"]
    chain_o = time_cuda(lambda: rec.orig_sw_rect_origin(
        *first_lanes(oargs, 4)), a.reps)
    kernels_out.append(dp_entry(
        "sw_rect_origin", rec.orig_sw_rect_origin, plains["sw_rect_origin"],
        oargs, [pe_local_args[k] for k in ("sw_rect_origin",)
                if k in pe_local_args], a.reps,
        pdev_ms.get("sw_rect_origin", [0.0, 0]),
        plaunches.get("sw_rect_origin", 0), chain_o,
        sweep_errs["sw_rect_origin"], _build, True))
    oentry = kernels_out[-1]
    # the block origin kernel (Wp > 64, not on the main path): the
    # 533-column mate-rescue-shaped origin cases of the sweep, and one of
    # them at scale 8 timed
    blk = next(c for c in cases.origin_cases(seed=1, scale=8)
               if c.name == "o_W533_e2e")
    bargs = sw.sw_args(*[torch.from_numpy(x).cuda() for x in (
        blk.reads, blk.quals, blk.lens, blk.wins)], sw.SWParams(
        **blk.params()), blk.band, torch.from_numpy(blk.rect_cols).cuda(),
        None)
    n_blk = _build.LAUNCHES["sw_rect_origin@block"]
    _got, berr = max_err(rec.orig_sw_rect_origin, plains["sw_rect_origin"],
                         bargs, rect_err)
    if _build.LAUNCHES["sw_rect_origin@block"] == n_blk:
        fail("the 533-column origin case did not take the block kernel")
    oentry["block"] = dict(
        case=f"{blk.name}@x8", shape=list(blk.wins.shape),
        max_abs_err=berr, ms=round(time_cuda(
            lambda: rec.orig_sw_rect_origin(*bargs), a.reps), 4),
        sweep_cases={c: e for c, e in sweep_errs["sw_rect_origin"]
                     if "W533" in c},
        ptxas=ptxas_of(_build, "sw_rect_origin@block", "sw_rect"))
    # the block origin kernel at the longer length buckets (every PE
    # bucket past 512 columns takes it), end to end and local
    buckets = {}
    for tag, (shape, len_lo) in BLOCK_ORIGIN_CALLS.items():
        errs = []
        for c in cases.padded_origin_cases(seed=2, shapes=(shape,),
                                           len_lo=len_lo):
            cargs = sw.sw_args(*[torch.from_numpy(x).cuda() for x in (
                c.reads, c.quals, c.lens, c.wins)], sw.SWParams(
                **c.params()), c.band, torch.from_numpy(c.rect_cols).cuda(),
                torch.from_numpy(c.col_lo).cuda(),
                torch.tensor(c.n_live, dtype=torch.int32, device="cuda"))
            n_blk = _build.LAUNCHES["sw_rect_origin@block"]
            errs.append(max_err(rec.orig_sw_rect_origin,
                                plains["sw_rect_origin"], cargs, rect_err)[1])
            if _build.LAUNCHES["sw_rect_origin@block"] == n_blk:
                fail(f"the origin case {c.name} did not take the block "
                     "kernel")
            if not c.local:
                timed = c, cargs
        c, cargs = timed
        buckets[tag] = dict(
            case=c.name, shape=list(c.wins.shape), n_live=c.n_live,
            Lmax=c.reads.shape[1], max_abs_err=max(errs),
            ms=round(time_cuda(lambda: rec.orig_sw_rect_origin(*cargs),
                               a.reps), 4),
            idle_ms=round(time_after_idle(
                lambda: rec.orig_sw_rect_origin(*cargs), 5), 4),
            cells_launched=rect_cells(cargs)[1])
        if rect_lib is not None:
            buckets[tag]["turns"] = rect_turns(
                a, port_mods, f"block origin, {tag}",
                rec.orig_sw_rect_origin, cargs, rect_lib)
            ok &= buckets[tag]["turns"]["max_abs_err"] == 0
        berr = max(berr, max(errs))
    oentry["block"]["buckets"] = buckets
    oentry["max_abs_err"] = max(oentry["max_abs_err"], berr)
    oentry["equal"] = oentry["max_abs_err"] == 0
    log(f"kernel sw_rect_origin@block: {json.dumps(oentry['block'])}")
    if rect_lib is not None:
        oentry["turns"] = [
            rect_turns(a, port_mods, label, rec.orig_sw_rect_origin, targs,
                       rect_lib)
            for label, targs in (("fused_pe, first call", oargs),
                                 ("fused_pe --local, first call",
                                  pe_local_args["sw_rect_origin"]))]
        ok &= all(t["max_abs_err"] == 0 for t in oentry["turns"])
    rargs = pe_args["sw_rect@rescue"]
    kernels_out.append(dp_entry(
        "sw_rect@rescue", rec.orig_sw_rect, plains["sw_rect@rescue"], rargs,
        [pe_local_args[k] for k in ("sw_rect@rescue",)
         if k in pe_local_args], a.reps,
        pdev_ms.get("sw_rect@block", [0.0, 0]),
        plaunches.get("sw_rect@block", 0), None, [], _build, False))
    ok &= all(e["equal"] for e in kernels_out[-2:])
    # K10's paired-end half, the device pairing: the first fused_pe call's
    # inputs, every PE batch's (kept by the holder: the main path, the
    # mixed-outcome batch's hostneed pairs) and every ops/cases.py
    # pairing_cases case at scale 1 and 8, int32 and int64 extents
    if "pe_pairing" not in holder.first:
        fail("the paired-end path never paired on the device")
    t0 = time.time()
    pair_sweep = []
    for seed, scale in ((0, 1), (1, 8)):
        for large in (False, True):
            for c in cases.pairing_cases(seed=seed, scale=scale,
                                         large=large):
                cargs = (c.pairing, c.B, c.Bp, c.T) + tuple(
                    torch.from_numpy(np.ascontiguousarray(x)).cuda()
                    for x in c.arrays)
                pair_sweep.append((c.name, max_err(
                    holder.kern_of("pe_pairing"),
                    holder.plain_of("pe_pairing"), cargs)[1]))
    log(f"exactness sweep of pe_pairing (ops/cases.py pairing_cases): "
        f"{len(pair_sweep)} cases, max abs err "
        f"{max(e for _, e in pair_sweep)} ({time.time() - t0:.1f} s)")
    pargs = holder.first["pe_pairing"][1]
    p_kern = holder.kern_of("pe_pairing")
    p_floor = pairing_floor(pargs)
    p_chain = time_cuda(lambda: p_kern(*p_floor), a.reps)
    kernels_out.append(new_entry(
        K10PE[0], *K10PE[1:], holder, pargs, pairing_work, a.reps,
        plaunches.get(K10PE[0], 0), pdev_ms.get(K10PE[0], [0.0, 0]),
        _build, pair_sweep, more=dict(hostneed_pairs=n_hostneed,
                                      chain_ms=round(p_chain, 5))))
    # with --compare-parent, the first call and its first 8 pairs in
    # turns with the parent's design
    pair_lib = parents.get("pe_pairing")
    if pair_lib is not None:
        pe = kernels_out[-1]
        pe["turns"] = [short_turns(
            a, _build, "pe_pairing", "first fused_pe call", p_kern, pargs,
            p_floor, pair_lib)]
        pe["max_abs_err"] = max(pe["max_abs_err"],
                                pe["turns"][0]["max_abs_err"])
        pe["equal"] = pe["max_abs_err"] == 0
    # one whole fused_pe batch (the first) under CUPTI
    split_pal = PairedAligner(edata, pol)
    pe_total, pe_by, pe_reg = cupti(
        lambda: split_pal.submit(batch0), reps=1, regions=(
            (fused, "_pe_pairing", "K10 PE _pe_pairing"),
            (fused, "gather_windows_aligned", "K7 gather_windows_aligned"),
            (fused, "_core", "fused _core (phases 1-4)")))
    pe_ours = split_line(f"one fused_pe batch ({len(batch0)} pairs)",
                         pe_total, pe_by, pe_reg, _build)
    kernels_out[-1]["batch_cupti_ms"] = round(sum(
        v for k, v in pe_ours.items() if k.startswith("pairing_kernel")), 4)

    # ---------------- phase 11: the CLI, card vs --device cpu ------------
    phase(11, "the CLI, card vs --device cpu")
    for label, inp in (("-U", ["-U", os.path.join(tdir, "se.fq")]),
                       ("-1/-2", ["-1", os.path.join(tdir, "pe_1.fq"),
                                  "-2", os.path.join(tdir, "pe_2.fq")])):
        outs = []
        t1 = time.time()
        for dev in ([], ["--device", "cpu"]):
            sam = os.path.join(tdir, f"out{len(outs)}.sam")
            if cli_main(["align", "-x", idx, "-S", sam, "--quiet"]
                        + dev + inp) != 0:
                fail(f"bt2x align {label} {' '.join(dev)} failed")
            outs.append(sam_without_cl(sam))
        nd = sum(1 for x, y in zip(*outs) if x != y)
        log(f"CLI align {label}: {len(outs[0])} SAM lines, card vs --device "
            f"cpu: {nd} differ apart from @PG CL ({time.time() - t1:.1f} s)")
        if nd or len(outs[0]) != len(outs[1]):
            fail(f"CLI align {label}: card and CPU SAM differ")
    tmp.cleanup()

    # ---------------- phase 12: long reads ----------------
    phase(12, "long reads")
    holder.label = "long reads"
    long_entries, long_first, long_groups = long_phase(
        a, port_mods, egenome, edata, pol, lpol, rec)
    kernels_out.extend(long_entries)
    ok &= all(e["equal"] for e in long_entries)
    # K7's unaligned form at the long path's widest window, held and timed
    wide = max(holder.calls.get("ref_gather", {}).values(),
               key=lambda x: x[5] * x[2].shape[0], default=None)
    if wide is None:
        fail("the long-read path kept no ref_gather call")
    we = k7_entries["ref_gather"]
    we["long_launches"] = port_mods.long_launches.get("ref_gather", 0)
    we["long_total_ms"] = round(port_mods.long_dev_ms.get(
        "ref_gather", [0.0, 0])[0], 4)
    w_ms = time_cuda(lambda: holder.kern_of("ref_gather")(*wide), a.reps)
    w_bytes, w_ops = gather_work(wide, False)
    we["wide"] = dict(shape=[wide[2].shape[0], wide[5]], ms=round(w_ms, 4),
                      idle_ms=round(time_after_idle(
                          lambda: holder.kern_of("ref_gather")(*wide), 5), 4),
                      bound_ms=round(max(w_bytes / PEAK_BYTES_S,
                                         w_ops / PEAK_OPS_S) * 1e3, 5))
    log(f"kernel ref_gather at the long path's widest call: "
        f"{json.dumps(we['wide'])}; long path launches "
        f"{we['long_launches']} total_ms={we['long_total_ms']}")
    if gather_lib is not None:
        we["turns"].append(short_turns(
            a, port_mods._build, "ref_gather", "long path's widest call",
            holder.kern_of("ref_gather"), wide, gather_floor(wide),
            gather_lib))
        # every shape each main path launched, by class, in turns
        we["launch_classes"] = {}
        for label, counts in (("SE main path", se_gather_shapes),
                              ("PE main path", pe_gather_shapes),
                              ("long reads", port_mods.long_gather_shapes)):
            kept = {k[:2]: v for k, v in
                    holder.kept.get((label, "ref_gather"), {}).items()}
            we["launch_classes"][label] = gather_classes(
                a, port_mods._build, holder.kern_of("ref_gather"), kept,
                counts, gather_lib)
        log(f"compare ref_gather launch classes: "
            f"{json.dumps(we['launch_classes'])}")
        we["max_abs_err"] = max(
            [we["max_abs_err"]] + [t["max_abs_err"] for t in we["turns"]]
            + [c["max_abs_err"] for d in we["launch_classes"].values()
               for c in d.values()])
        we["equal"] = we["max_abs_err"] == 0
        # the aligned form: the fused PE path's first call and its floor,
        # and every shape the SE and PE main paths launched, in turns
        ae = k7_entries["ref_gather_aligned"]
        pe_kept = holder.kept.get(("PE main path", "ref_gather_aligned"))
        if not pe_kept:
            fail("the PE main path kept no ref_gather_aligned call")
        pe_first = next(iter(pe_kept.values()))
        ae["turns"].append(short_turns(
            a, port_mods._build, "ref_gather", "first fused PE call",
            holder.kern_of("ref_gather_aligned"), pe_first,
            aligned_floor(pe_first), gather_lib,
            holder.plain_of("ref_gather_aligned")))
        ae["launch_classes"] = {}
        for label, counts in (("SE main path", se_aligned_shapes),
                              ("PE main path", pe_aligned_shapes)):
            kept = {(k[0], 32 * ((k[1] + 62) // 32)): v for k, v in
                    holder.kept.get((label, "ref_gather_aligned"),
                                    {}).items()}
            ae["launch_classes"][label] = gather_classes(
                a, port_mods._build, holder.kern_of("ref_gather_aligned"),
                kept, counts, gather_lib, entry="ref_gather_aligned")
        log(f"compare ref_gather_aligned launch classes: "
            f"{json.dumps(ae['launch_classes'])}")
        ae["max_abs_err"] = max(
            [ae["max_abs_err"]] + [t["max_abs_err"] for t in ae["turns"]]
            + [c["max_abs_err"] for d in ae["launch_classes"].values()
               for c in d.values()])
        ae["equal"] = ae["max_abs_err"] == 0
    holder.check("large index mode")

    # ---------------- phase 13: the large index mode ----------------
    phase(13, "the large index mode")
    port_mods.fm = fm
    port_mods.half_from_tables = half_from_tables
    port_mods.build_index_from_refs = build_index_from_refs
    large_ctx = dict(
        rec=rec, pol=pol, egenome=egenome, se_codes=se_codes,
        se_quals=se_quals, pairs=pairs, genome=genome, data=data,
        edata=edata, chunk0=chunks[0], groups0=groups[0],
        pe_batch0=batch0, pe_groups0=first_groups[0], long_first=long_first,
        long_groups=long_groups, e2e_args=e2e_args)
    large_entries = large_phase(a, port_mods, large_ctx)
    kernels_out.extend(large_entries)
    ok &= all(e["equal"] for e in large_entries)
    holder.check("sharded index")
    # the large mode's int64 positions went through each new kernel
    for e in ("ref_gather_aligned", "ref_gather"):
        shapes = holder.checks.get(e, {}).get("large index mode", {}).get(
            "shapes", [])
        if not any(sh[2] == "int64" for sh in shapes):
            fail(f"phase 13 made no {e} call with int64 positions")
    if not holder.checks.get("pe_pairing", {}).get("large index mode"):
        fail("phase 13 made no pe_pairing call")

    # ---------------- phase 14: sharded index, data mesh, processes -------
    phase(14, "sharded index, data mesh, processes")
    port_mods.ref = ref_mod
    port_mods.FMIndex = FMIndex
    port_mods.ShardedFMHalf = ShardedFMHalf
    port_mods.make_mesh = make_mesh
    port_mods.save_index = save_index
    shard_entries = shard_phase(a, port_mods, dict(
        rec=rec, pol=pol, data=data, chunks=chunks, groups=groups,
        cpu_groups=cpu_groups, e2e_args=e2e_args, case_indexes=case_indexes,
        rep_l=large_ctx["rep_l"],
        large_fm_blocks=large_ctx["large_fm_blocks"], edata=edata,
        pairs=pairs, pe_groups0=first_groups[0], pe_cpu0=pe_cpu0,
        se_codes=se_codes, se_quals=se_quals, holder=holder,
        win_sweep=win_sweep))
    kernels_out.extend(shard_entries)
    ok &= all(e["equal"] for e in shard_entries)
    holder.check("int64 row mode")

    # ---------------- phase 15: the int64 row mode ----------------
    phase(15, "the int64 row mode")
    port_mods.shard_index = shard_index
    i64_entries = int64_phase(a, port_mods, dict(
        rec=rec, pol=pol, rep_l=large_ctx["rep_l"], chunk0=chunks[0],
        groups0=groups[0], edata=edata, eco_l=large_ctx["eco_l"],
        pe_batch0=batch0, pe_groups0=first_groups[0], long_first=long_first,
        long_groups=long_groups, se_codes=se_codes, se_quals=se_quals))
    kernels_out.extend(i64_entries)
    ok &= all(e["equal"] for e in i64_entries)
    holder.check(None)
    # every kept call of the Holder's kernels, phases 13 to 15 included
    for e in kernels_out:
        if e["name"] in K7 or e["name"] in (K10PE[0], K10SE[0]):
            e["checks"] = holder.checks.get(e["name"], {})
            e["max_abs_err"] = max(e["max_abs_err"],
                                   holder.max_err(e["name"]))
            e["equal"] = e["max_abs_err"] == 0
            ok &= e["equal"]
    log(f"new kernels held to their plain versions, every phase: "
        f"{json.dumps(holder.checks)}")

    print(json.dumps({"kernels": kernels_out}), flush=True)
    if not ok:
        fail("a kernel disagrees with its plain version")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
