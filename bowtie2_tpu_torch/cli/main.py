"""Command-line interface of the PyTorch/CUDA port: build / align /
inspect (`python -m bowtie2_tpu_torch.cli`).

A copy of bowtie2_tpu/cli/main.py over the port's modules, with one flag
more: `align --device` (default: the CUDA card; `--device cpu` runs the
kernels' plain PyTorch versions). Flag surface mirrors the reference
binaries (bt2_search.cpp parseOptions:1668 + usage text :746-950,
bt2_build.cpp, bt2_inspect.cpp). Options whose semantics are not
implemented yet fail loudly rather than silently diverging;
observability-only options are accepted.
"""

import argparse
import sys
import time


def cmd_build(argv):
    ap = argparse.ArgumentParser(prog="bt2x build")
    ap.add_argument("fasta", help="comma-separated FASTA file(s)")
    ap.add_argument("prefix")
    ap.add_argument("-o", "--offrate", type=int, default=4)
    ap.add_argument("-t", "--ftabchars", type=int, default=10)
    ap.add_argument("--threads", type=int, default=1)   # chunk-pass pool
    ap.add_argument("-f", action="store_true")          # input is FASTA (always)
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    from bowtie2_tpu_torch.index.build import build_index_from_refs, save_index
    from bowtie2_tpu_torch.io.fastx import read_fasta
    t0 = time.time()
    refs = []
    for path in args.fasta.split(","):
        refs.extend(read_fasta(path))
    if not refs:
        print("error: no sequences in input", file=sys.stderr)
        return 1
    data = build_index_from_refs(refs, ftab_chars=args.ftabchars,
                                 off_rate=args.offrate,
                                 threads=max(args.threads, 1))
    save_index(data, args.prefix)
    if not args.quiet:
        print(f"built index for {len(data.ref_names)} sequence(s), "
              f"{data.n_joined} bp joined, in {time.time()-t0:.1f}s",
              file=sys.stderr)
    return 0


def _parse_func(s):
    from bowtie2_tpu_torch.pipeline.policy import SimpleFunc
    return SimpleFunc.parse(s)


def _build_align_parser():
    ap = argparse.ArgumentParser(prog="bt2x align", add_help=True)
    # main arguments
    ap.add_argument("-x", dest="index", required=True)
    ap.add_argument("-U", dest="unpaired", default=None)
    ap.add_argument("-1", dest="mate1", default=None)
    ap.add_argument("-2", dest="mate2", default=None)
    ap.add_argument("--interleaved", default=None)
    ap.add_argument("--tab5", default=None)
    ap.add_argument("--tab6", default=None)
    ap.add_argument("-b", dest="bam", default=None)
    ap.add_argument("--preserve-tags", action="store_true",
                    help="keep input BAM aux fields on output records")
    ap.add_argument("--qseq", action="store_true")
    ap.add_argument("-S", dest="out", default=None)
    # input options
    ap.add_argument("-q", dest="fastq_reads", action="store_true")
    ap.add_argument("-f", dest="fasta_reads", action="store_true")
    ap.add_argument("-r", dest="raw_reads", action="store_true")
    ap.add_argument("-F", dest="fasta_cont", default=None,
                    help="k:<int>,i:<int> — sample length-k reads every i "
                         "bases from the -U FASTA (FASTA-continuous)")
    ap.add_argument("-s", "--skip", type=int, default=0)
    ap.add_argument("-u", "--upto", "--qupto", dest="upto", type=int,
                    default=None)
    ap.add_argument("-5", "--trim5", type=int, default=0)
    ap.add_argument("-3", "--trim3", type=int, default=0)
    ap.add_argument("--phred33", "--phred33-quals", action="store_true")
    ap.add_argument("--phred64", "--phred64-quals", action="store_true")
    ap.add_argument("--solexa-quals", action="store_true")
    ap.add_argument("--int-quals", "--integer-quals", action="store_true")
    ap.add_argument("--trim-to", default=None,
                    help="[3:|5:]<int> trim reads longer than <int> from "
                         "the given end (default 3')")
    ap.add_argument("--sample", type=float, default=None,
                    help="align only this random fraction of input reads")
    ap.add_argument("--non-deterministic", "--nondeterministic",
                    dest="non_deterministic", action="store_true",
                    help="re-seed per-read RNG arbitrarily instead of from "
                         "read name/seq/qual")
    # presets
    for name in ("very-fast", "fast", "sensitive", "very-sensitive"):
        ap.add_argument(f"--{name}", dest="preset", action="store_const",
                        const=name)
        ap.add_argument(f"--{name}-local", dest="preset_local",
                        action="store_const", const=name)
    # alignment options
    ap.add_argument("-N", dest="seed_mms", type=int, default=None)
    ap.add_argument("-L", dest="seed_len", type=int, default=None)
    ap.add_argument("-i", dest="seed_ival", type=str, default=None)
    ap.add_argument("--n-ceil", type=str, default=None)
    ap.add_argument("--dpad", type=int, default=15)
    ap.add_argument("--gbar", type=int, default=4)
    ap.add_argument("--ignore-quals", action="store_true")
    ap.add_argument("--nofw", action="store_true")
    ap.add_argument("--norc", action="store_true")
    ap.add_argument("--no-1mm-upfront", action="store_true")
    ap.add_argument("--1mm-upfront", dest="mm1_upfront",
                    action="store_true")
    ap.add_argument("--no-exact-upfront", action="store_true")
    ap.add_argument("--exact-upfront", action="store_true")
    ap.add_argument("--seed-boost", type=int, default=None,
                    help="re-seed rounds fire past this avg hits/seed "
                         "(default 300, bt2_search.cpp:490)")
    ap.add_argument("--454", "--ion-torrent", dest="noisy_hpoly",
                    action="store_true",
                    help="homopolymer-noise gap penalties (RDG/RFG 3,1)")
    ap.add_argument("--xeq", action="store_true")
    ap.add_argument("--end-to-end", dest="local", action="store_false",
                    default=None)
    ap.add_argument("--local", dest="local", action="store_true")
    ap.add_argument("--bwa-sw-like", dest="bwa_sw_like", action="store_true",
                    help="local with BWA-SW scoring: MA=1, MMP=C3, "
                         "RDG/RFG=5,2, min score a*max{30, 5.5*ln(len)} "
                         "(bt2_search.cpp:1114-1125, :2960-2971)")
    # scoring
    ap.add_argument("--ma", type=int, default=None)
    ap.add_argument("--mp", type=str, default=None)       # MX,MN
    ap.add_argument("--np", type=int, default=None)
    ap.add_argument("--rdg", type=str, default=None)      # open,extend
    ap.add_argument("--rfg", type=str, default=None)
    ap.add_argument("--score-min", type=str, default=None)
    # reporting
    ap.add_argument("-k", dest="khits", type=int, default=None)
    ap.add_argument("-a", "--all", dest="all_hits", action="store_true")
    ap.add_argument("-M", dest="mhits", type=int, default=None)
    ap.add_argument("--mapq-v", dest="mapq_v", type=int, default=None)
    ap.add_argument("--log-dp", dest="log_dp", default=None,
                    help="log one descriptor per seed-extend DP problem "
                         "(analog of the reference's SwAligner dpLog)")
    ap.add_argument("--sam-opt-config", dest="sam_opt_config", default=None,
                    help="comma-separated opt-field toggles, '-' prefix "
                         "disables (e.g. '-md,-xs'; sam.h "
                         "parseSamPrintFlags)")
    ap.add_argument("--soft-clipped-unmapped-tlen", dest="sc_unmapped_tlen",
                    action="store_true",
                    help="local mode only: soft-clipped bases count as "
                         "unmapped for TLEN (reference ARG_SC_UNMAPPED)")
    ap.add_argument("--sam-xt", dest="sam_xt", action="store_true",
                    help="XT:i elapsed-microseconds opt field; on this "
                         "batched pipeline the value is the device batch "
                         "time amortized per read (the reference's is "
                         "per-read wall time)")
    ap.add_argument("-D", dest="fail_streak", type=int, default=None)
    ap.add_argument("-R", dest="seed_rounds", type=int, default=None)
    # paired-end
    ap.add_argument("-I", "--minins", type=int, default=0)
    ap.add_argument("-X", "--maxins", type=int, default=500)
    ap.add_argument("--fr", dest="orient", action="store_const", const="fr")
    ap.add_argument("--rf", dest="orient", action="store_const", const="rf")
    ap.add_argument("--ff", dest="orient", action="store_const", const="ff")
    ap.add_argument("--no-mixed", action="store_true")
    ap.add_argument("--dovetail", action="store_true")
    ap.add_argument("--no-contain", action="store_true")
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--no-discordant", action="store_true")
    # output
    ap.add_argument("--un", default=None)
    ap.add_argument("--al", default=None)
    ap.add_argument("--un-conc", default=None)
    ap.add_argument("--al-conc", default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--no-unal", action="store_true")
    ap.add_argument("--no-head", "--no-hd", "--sam-nohead", "--sam-no-hd",
                    dest="no_head", action="store_true")
    ap.add_argument("--no-sq", "--sam-nosq", "--sam-no-sq", dest="no_sq",
                    action="store_true")
    ap.add_argument("--rg-id", "--sam-rg-id", dest="rg_id", default=None)
    ap.add_argument("--rg", "--sam-rg", dest="rg", action="append",
                    default=[])
    ap.add_argument("--omit-sec-seq", "--sam-omit-sec-seq",
                    dest="omit_sec_seq", action="store_true",
                    help="print '*' for SEQ/QUAL of secondary alignments")
    ap.add_argument("--sam-no-qname-trunc", action="store_true",
                    help="do not truncate read names at whitespace")
    ap.add_argument("--sam-append-comment", action="store_true",
                    help="append FASTQ/FASTA comment to the SAM record")
    ap.add_argument("--refidx", action="store_true",
                    help="refer to reference sequences by 0-based index")
    ap.add_argument("--fullref", action="store_true",
                    help="print whole reference name (not just up to the "
                         "first whitespace)")
    ap.add_argument("-t", "--time", dest="timing", action="store_true",
                    help="print the wall time, and each of the port's spans "
                         "with its calls, total and self seconds")
    ap.add_argument("--met-file", default=None)
    ap.add_argument("--met-stderr", action="store_true")
    ap.add_argument("--met", type=int, default=1)
    ap.add_argument("--reorder", action="store_true")   # always ordered
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-p", "--threads", type=int, default=1)
    ap.add_argument("--batch", "--reads-per-batch", dest="batch",
                    type=int, default=None)
    ap.add_argument("--mm", action="store_true")        # index sharing n/a
    ap.add_argument("--qc-filter", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="batches kept in flight on the device (default 3; "
                         "-p maps here: device batching replaces threads)")
    ap.add_argument("--device", default=None,
                    help="torch device to align on (default: the CUDA "
                         "card; 'cpu' runs the plain PyTorch versions)")
    return ap


def cmd_align(argv):
    ap = _build_align_parser()
    args = ap.parse_args(argv)

    import os as _os

    from bowtie2_tpu_torch.index.build import load_index, save_index
    from bowtie2_tpu_torch.io.fastx import (iter_bam, iter_interleaved, iter_many,
                                      iter_qseq, iter_tab, trim_record)

    def iter_qseq_many(paths, qc):
        for pth in paths.split(","):
            yield from iter_qseq(pth, qc_filter=qc)
    from bowtie2_tpu_torch.io.sam import SamWriter
    from bowtie2_tpu_torch.pipeline.align import (UnpairedAligner,
                                                  bucket_groups)
    from bowtie2_tpu_torch.pipeline.paired import PairedAligner
    from bowtie2_tpu_torch.pipeline.policy import SimpleFunc, make_policy

    if args.seed_mms not in (None, 0, 1):
        print("error: -N accepts 0 or 1", file=sys.stderr)
        return 2

    local = bool(args.local) if args.local is not None else \
        args.preset_local is not None
    preset = args.preset_local or args.preset or "sensitive"
    overrides = {}
    if args.bwa_sw_like:
        # --bwa-sw-like: localAlign + polstr MA=1;MMP=C3;RDG=5,2;RFG=5,2
        # with the BWA-SW min-score rule (explicit flags still override)
        local = True
        overrides.update(bwa_sw_like=True, match_bonus=1, mm_pen_max=3,
                         mm_pen_min=3, read_gap_open=5, read_gap_extend=2,
                         ref_gap_open=5, ref_gap_extend=2)
    if args.seed_len is not None:
        overrides["seed_len"] = args.seed_len
    if args.seed_ival is not None:
        overrides["seed_ival"] = SimpleFunc.parse(args.seed_ival)
    if args.seed_mms is not None:
        overrides["seed_mms"] = args.seed_mms
    if args.khits is not None:
        overrides["khits"] = args.khits
        overrides["mhits"] = 0      # -k disables -M (bt2_search.cpp:1326)
    if args.all_hits:
        overrides["all_hits"] = True
        overrides["mhits"] = 0      # -a disables -M
    if args.mhits is not None:
        overrides["mhits"] = args.mhits
    if args.mapq_v is not None:
        overrides["mapq_v"] = args.mapq_v
    if args.fail_streak is not None:
        overrides["fail_streak"] = args.fail_streak
    if args.seed_rounds is not None:
        overrides["seed_rounds"] = args.seed_rounds
    if args.score_min is not None:
        overrides["score_min"] = SimpleFunc.parse(args.score_min)
    if args.n_ceil is not None:
        overrides["n_ceil"] = SimpleFunc.parse(args.n_ceil)
    for flag, attr in (("norc", "norc"), ("nofw", "nofw"),
                       ("no_mixed", "no_mixed"),
                       ("no_discordant", "no_discordant"),
                       ("no_1mm_upfront", "no_1mm"), ("xeq", "xeq"),
                       ("sam_xt", "sam_xt"),
                       ("sc_unmapped_tlen", "sc_unmapped_tlen"),
                       ("ignore_quals", "ignore_quals"),
                       ("no_exact_upfront", "no_exact"),
                       ("omit_sec_seq", "omit_sec_seq"),
                       ("sam_no_qname_trunc", "sam_no_qname_trunc"),
                       ("sam_append_comment", "sam_append_comment")):
        if getattr(args, flag):
            overrides[attr] = True
    if args.seed_boost is not None:
        overrides["seed_boost"] = args.seed_boost
    if args.seed:
        overrides["rng_seed"] = args.seed
    if args.non_deterministic:
        overrides["non_deterministic"] = True
    if args.noisy_hpoly:
        # --454/--ion-torrent: homopolymer-noise gap penalties (scoring.h
        # DEFAULT_*_GAP_*_BADHPOLY; explicit --rdg/--rfg still override)
        overrides.setdefault("read_gap_open", 3)
        overrides.setdefault("read_gap_extend", 1)
        overrides.setdefault("ref_gap_open", 3)
        overrides.setdefault("ref_gap_extend", 1)
    if args.sc_unmapped_tlen and not args.local:
        ap.error("--soft-clipped-unmapped-tlen can only be set for local "
                 "alignments")
    overrides["minins"] = args.minins
    overrides["maxins"] = args.maxins
    if args.orient:
        overrides["mate_fw_rc"] = args.orient
    if args.dovetail:
        overrides["dovetail_ok"] = True
    if getattr(args, "no_contain"):
        overrides["contain_ok"] = False
    if getattr(args, "no_overlap"):
        overrides["olap_ok"] = False
    if args.ma is not None:
        overrides["match_bonus"] = args.ma
    if args.np is not None:
        overrides["n_pen"] = args.np
    if args.mp is not None:
        mx, mn = (args.mp.split(",") + [args.mp])[:2]
        overrides["mm_pen_max"], overrides["mm_pen_min"] = int(mx), int(mn)
    if args.rdg is not None:
        o, e = args.rdg.split(",")
        overrides["read_gap_open"], overrides["read_gap_extend"] = int(o), int(e)
    if args.rfg is not None:
        o, e = args.rfg.split(",")
        overrides["ref_gap_open"], overrides["ref_gap_extend"] = int(o), int(e)
    overrides["max_half"] = args.dpad
    pol = make_policy(preset, local=local, **overrides)
    pol.gap_barrier = args.gbar

    if _os.path.exists(args.index + ".bt2t.json"):
        data = load_index(args.index)
    elif (_os.path.exists(args.index + ".1.bt2")
          or _os.path.exists(args.index + ".1.bt2l")):
        # drop-in use of an existing bowtie2 index: reconstruct the
        # references from .1/.3/.4 and rebuild in this layout (cached)
        from bowtie2_tpu_torch.index.bt2_import import import_bt2
        print(f"importing bowtie2 index {args.index} "
              f"(converted copy cached as {args.index}.bt2t.*)",
              file=sys.stderr)
        data = import_bt2(args.index)
        try:
            save_index(data, args.index)
        except OSError:
            pass   # read-only location — keep in memory only
    else:
        print(f"error: no index found at {args.index}", file=sys.stderr)
        return 1
    # --refidx / --fullref are accepted but inert, matching the 2.5.5
    # binary (probed): SAM output prints the stored (first-whitespace-
    # token) names regardless — both builders truncate at index time
    # (ref_read.cpp), so there is no full name to print back.
    data.ref_names = [n.split()[0] if n.split() else n
                      for n in data.ref_names]
    paired = bool((args.mate1 is not None and args.mate2 is not None)
                  or args.interleaved or args.tab5 or args.tab6)
    if args.batch is None:
        args.batch = 2048 if paired else 8192
    try:
        aligner = (PairedAligner if paired else UnpairedAligner)(
            data, pol, device=args.device)
    except NotImplementedError as e:    # PairedAligner past 2^32 - 4096
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.log_dp:
        aligner.dp_log = open(args.log_dp, "w")
    # binary output: the unpaired path emits finished line bytes from the
    # native builder; object records go through a thin text adapter
    bout = open(args.out, "wb") if args.out else sys.stdout.buffer

    class _TextOut:
        @staticmethod
        def write(s):
            bout.write(s.encode())
    writer = SamWriter(_TextOut(), data.ref_names, data.ref_lens,
                       prog_args=" ".join(["bt2x align"] + argv),
                       no_head=args.no_head, no_sq=args.no_sq,
                       rg_id=args.rg_id, rg_fields=args.rg)
    # --sam-opt-config (sam.h:160 parseSamPrintFlags): comma tokens,
    # leading '-' disables a field. Filtering happens on record objects,
    # so configured runs route through the object emit path.
    sam_cfg = None
    if args.sam_opt_config:
        sam_cfg = {}
        for tok in args.sam_opt_config.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok[0] == "-":
                sam_cfg[tok[1:].lower()] = False
            else:
                sam_cfg[tok.lower()] = True
    raw_mode = (sam_cfg is None and not args.sam_xt
                and not args.omit_sec_seq and not args.sam_append_comment
                and not args.sam_no_qname_trunc)
    rg_suffix = f"\tRG:Z:{args.rg_id}".encode() if args.rg_id else b""

    if not args.unpaired and not paired and not args.bam:
        print("provide -U, -1/-2, -b, --interleaved, --tab5 or --tab6",
              file=sys.stderr)
        return 2
    qoff = 64 if args.phred64 else 33
    fmt = ("fasta" if args.fasta_reads else
           "fastq" if args.fastq_reads else "auto")

    if args.qc_filter and not args.qseq:
        print("error: --qc-filter requires --qseq input (reference "
              "semantics: QSEQ QC field)", file=sys.stderr)
        return 2
    if args.mm:
        print("note: --mm (memory-mapped index sharing) is not applicable "
              "on the GPU; the index is device-resident", file=sys.stderr)
    if args.fasta_cont:
        from bowtie2_tpu_torch.io.fastx import iter_fasta_continuous
        spec = args.fasta_cont.replace("k:", "").replace("i:", "")
        kF, iF = (int(x) for x in spec.split(","))

        def _fc_many():
            for pth in args.unpaired.split(","):
                yield from iter_fasta_continuous(pth, kF, iF)
        reader = _fc_many()
    elif args.bam:
        reader = iter_bam(args.bam,
                          preserve_tags=args.preserve_tags)
    elif args.qseq and paired:
        reader = zip(iter_qseq_many(args.mate1, args.qc_filter),
                     iter_qseq_many(args.mate2, args.qc_filter))
    elif args.qseq and args.unpaired:
        reader = iter_qseq_many(args.unpaired, args.qc_filter)
    elif args.tab5 or args.tab6:
        reader = iter_tab(args.tab5 or args.tab6, qual_offset=qoff)
    elif args.interleaved:
        reader = iter_interleaved(args.interleaved, fmt=fmt, qual_offset=qoff)
    elif paired:
        reader = zip(iter_many(args.mate1, fmt=fmt, qual_offset=qoff,
                               solexa=args.solexa_quals,
                               int_quals=args.int_quals),
                     iter_many(args.mate2, fmt=fmt, qual_offset=qoff,
                               solexa=args.solexa_quals,
                               int_quals=args.int_quals))
    else:
        reader = iter_many(args.unpaired, fmt=fmt, qual_offset=qoff,
                           raw=args.raw_reads, solexa=args.solexa_quals,
                           int_quals=args.int_quals)

    # --trim-to [3:|5:]N: hard-trim reads above N bp from the given end
    # AFTER -5/-3 (pat.h:1219 finalize order); 3' is the default end
    trim_to = None
    if args.trim_to is not None:
        spec = args.trim_to
        if ":" in spec:
            end_s, n_s = spec.split(":", 1)
            if end_s not in ("3", "5"):
                ap.error("--trim-to: trim position must be either 3 or 5")
            trim_to = (int(end_s), int(n_s))
        else:
            trim_to = (3, int(spec))
        if trim_to[1] < 0:
            ap.error("--trim-to: the number of bases to trim must be >= 0")
    if args.sample is not None and args.non_deterministic:
        ap.error("--sample requires content-derived read seeds")

    def _trim_to(rec):
        if trim_to is None or rec.seq.size <= trim_to[1]:
            return rec
        if trim_to[0] == 3:
            rec.seq = rec.seq[:trim_to[1]]
            rec.qual = rec.qual[:trim_to[1]]
        else:
            rec.seq = rec.seq[rec.seq.size - trim_to[1]:]
            rec.qual = rec.qual[rec.qual.size - trim_to[1]:]
        return rec

    _sample_frac = None
    if args.sample is not None and args.sample < 1.0:
        import numpy as np
        from bowtie2_tpu_torch.pipeline.rng import (RefRng, gen_rand_seed,
                                              rng_name)
        _sample_frac = np.float32(args.sample)

    def _sampled_out(rec):
        """--sample: rnd.init(ROTL(read.seed, 2)); nextFloat() < frac
        (bt2_search.cpp:3274-3277); skipped reads produce NO output.

        Reference quirk preserved: the ROTL macro is ROTL(n, x) =
        rotate x left by n (bt2_search.cpp:2869), so the call site
        actually rotates the CONSTANT 2 by `seed` bits — the sampling
        RNG has only 32 possible states, 1 << ((seed + 1) & 31)."""
        seed = gen_rand_seed(rec.seq, rec.qual + 33, rng_name(rec),
                             seed=args.seed)
        rot = 1 << ((int(seed) + 1) & 31)
        f = np.float32(RefRng(rot).next_u32()) / np.float32(0xFFFFFFFF)
        return not (f < _sample_frac)

    # -s/-u slicing and -5/-3 trimming
    def _sliced(it):
        n = 0
        for i, rec in enumerate(it):
            if i < args.skip:
                continue
            if args.upto is not None and n >= args.upto:
                return
            n += 1
            if paired:
                rec = (_trim_to(trim_record(rec[0], args.trim5, args.trim3)),
                       _trim_to(trim_record(rec[1], args.trim5, args.trim3)))
            else:
                rec = _trim_to(trim_record(rec, args.trim5, args.trim3))
            # --sample draws on the final (trimmed) read's seed
            if _sample_frac is not None and _sampled_out(
                    rec[0] if paired else rec):
                continue
            yield rec
    reader = _sliced(reader)

    def _illumina_comment(c: str) -> bool:
        """sam.h:429 isIllumina: walk the comment's first space-token and
        check colon-separated fields look like '1:N:0:...' (read 1|2,
        Y/N, even control number; a 4th colon fails; NO colons passes)."""
        start, fld = 0, 0
        for j, ch in enumerate(c):
            if ch == ' ':
                break
            if ch == ':':
                tok = c[start:j]
                if fld == 0:
                    try:
                        if int(tok) not in (1, 2):
                            return False
                    except ValueError:
                        return False
                elif fld == 1:
                    if not tok or tok[0] not in "NY":
                        return False
                elif fld == 2:
                    try:
                        if int(tok) % 2 != 0:
                            return False
                    except ValueError:
                        return False
                else:
                    return False
                start, fld = j + 1, fld + 1
        return True

    def _sam_extras(r, src):
        """--omit-sec-seq / --sam-no-qname-trunc / --sam-append-comment
        record transforms (sam.cpp omitSecSeq/truncQname, sam.h:416
        printComment — note the reference appends the tab even when the
        read has no comment)."""
        if args.omit_sec_seq and (r.flag & 0x100):
            r.seq, r.qual = "*", "*"
        if args.sam_no_qname_trunc and src.comment:
            r.qname = f"{src.name} {src.comment}"
        if args.sam_append_comment:
            c = src.comment or ""
            pre = "BC:Z:" if c and _illumina_comment(c) else ""
            r.raw_tags = (r.raw_tags or "") + "\t" + pre + c

    # --un/--al read dumps (reference: wrapper-script splitting)
    from bowtie2_tpu_torch.io.sam import FLAG_UNMAPPED, write_fastq_record
    def _dump_open(path):
        # --un/--al(-conc) accept .gz targets (reference wrapper's
        # --un-gz etc.); plain text otherwise
        if path.endswith(".gz"):
            import gzip
            return gzip.open(path, "wt")
        return open(path, "w")

    un_f = _dump_open(args.un) if args.un else None
    al_f = _dump_open(args.al) if args.al else None
    unc_f = [_dump_open(args.un_conc.replace("%", str(m)))
             for m in (1, 2)] if args.un_conc else None
    alc_f = [_dump_open(args.al_conc.replace("%", str(m)))
             for m in (1, 2)] if args.al_conc else None

    from bowtie2_tpu_torch.utils.metrics import TRACE, MetricsSink
    if args.timing:
        TRACE.clear()
        TRACE.on = True
    met_sink = None
    if args.met_file or args.met_stderr:
        met_sink = MetricsSink(aligner.metrics,
                               stream=sys.stderr if args.met_stderr else None,
                               path=args.met_file, every=args.met)

    t0 = time.time()
    nreads = nbatches = 0
    window_n = args.batch * 8
    done = False
    while not done:
        window = []
        for rec in reader:
            window.append(rec)
            if len(window) >= window_n:
                break
        else:
            done = True
        if not window:
            break
        if paired:
            lens_w = [max(rec[0].seq.size, rec[1].seq.size)
                      for rec in window]
        else:
            lens_w = [rec.seq.size for rec in window]
        by_bucket = bucket_groups(lens_w)
        results = [None] * len(window)
        chunks = []
        for bkt in sorted(by_bucket):
            idxs = by_bucket[bkt]
            for k in range(0, len(idxs), args.batch):
                chunks.append(idxs[k:k + args.batch])
        # pipelined dispatch: keep a few batches in flight so host
        # parse/emit overlaps device compute (asynchronous CUDA launches)
        from collections import deque
        # -p historically adds worker threads; the device pipeline replaces
        # them — map thread count to in-flight batch depth instead
        DEPTH = args.pipeline_depth if args.pipeline_depth is not None \
            else max(3, min(args.threads, 8))
        pend = deque()

        def _drain():
            chunk, h = pend.popleft()
            _t0 = time.time()
            if raw_mode:
                outs = aligner.collect_raw(h, rg_suffix)
            elif paired:
                outs = aligner.collect(h)
                # group per pair (secondaries not emitted in PE mode)
                outs = [outs[2 * t:2 * t + 2] for t in range(len(chunk))]
            else:
                # SE object path (e.g. --sam-opt-config): group a primary
                # record plus its following secondaries per read
                flat = aligner.collect(h)
                outs = []
                t = 0
                for _ in range(len(chunk)):
                    grp = [flat[t]]
                    t += 1
                    while t < len(flat) and (flat[t].flag & 0x100):
                        grp.append(flat[t])
                        t += 1
                    outs.append(grp)
            if met_sink:
                met_sink.maybe_report()
            if args.sam_xt and not raw_mode:
                # XT:i elapsed-us (reference bt2_search.cpp:3305 per-read
                # wall time): on this batched pipeline the collect wall
                # time is amortized over the batch's reads
                xt_us = int((time.time() - _t0) * 1e6 / max(len(chunk), 1))
                for rec_out in outs:
                    for r in rec_out:
                        r.opts.append(("XT", "i", xt_us))
            for j, rec_out in zip(chunk, outs):
                results[j] = rec_out

        for chunk in chunks:
            pend.append((chunk,
                         aligner.submit([window[j] for j in chunk])))
            nbatches += 1
            if len(pend) > DEPTH:
                _drain()
        while pend:
            _drain()
        if raw_mode:
            need_flags = args.no_unal or un_f or al_f or unc_f or alc_f
            if need_flags:
                for i, group in enumerate(results):
                    for fl, line in group:
                        if args.no_unal and (fl & FLAG_UNMAPPED):
                            continue
                        bout.write(line)
                        bout.write(b"\n")
                    prim_unal = group[0][0] & FLAG_UNMAPPED
                    if un_f and prim_unal:
                        write_fastq_record(un_f, window[i])
                    if al_f and not prim_unal:
                        write_fastq_record(al_f, window[i])
                    if unc_f or alc_f:
                        conc = all(fl & 0x2 for fl, _ in group[:2])
                        if unc_f and not conc:
                            for m in range(2):
                                write_fastq_record(unc_f[m], window[i][m])
                        if alc_f and conc:
                            for m in range(2):
                                write_fastq_record(alc_f[m], window[i][m])
            else:
                bout.write(b"\n".join(
                    line for group in results for _, line in group))
                bout.write(b"\n")
        else:
            for i, group in enumerate(results):
                for r in group:
                    if args.no_unal and (r.flag & FLAG_UNMAPPED):
                        continue
                    if sam_cfg is not None:
                        r.opts = [o for o in r.opts
                                  if sam_cfg.get(o[0].lower(), True)]
                    if (args.omit_sec_seq or args.sam_no_qname_trunc
                            or args.sam_append_comment):
                        src = (window[i][1] if paired and (r.flag & 0x80)
                               else window[i][0] if paired else window[i])
                        _sam_extras(r, src)
                    writer.write(r)
                conc = all((g.flag & 0x2) for g in group[:2])
                if unc_f and not conc:
                    for m, g in enumerate(group[:2]):
                        write_fastq_record(unc_f[m], window[i][m])
                if alc_f and conc:
                    for m, g in enumerate(group[:2]):
                        write_fastq_record(alc_f[m], window[i][m])
        nreads += len(window)
    dt = time.time() - t0
    for f in [un_f, al_f] + (unc_f or []) + (alc_f or []):
        if f:
            f.close()
    if met_sink:
        met_sink.final()
    if not args.quiet:
        print(aligner.stats.summary(), file=sys.stderr)
        _host_path_report(aligner.metrics.counters, nbatches)
    if args.timing:
        print(f"Time searching: {dt:.2f}s", file=sys.stderr)
        print(f"# {nreads} {'pairs' if paired else 'reads'} in {dt:.1f}s = "
              f"{nreads/max(dt,1e-9):.0f} /s", file=sys.stderr)
        for name, (n, total, own) in TRACE.totals().items():
            print(f"Span {name}: {n} calls, {total:.3f} s, self "
                  f"{own:.3f} s", file=sys.stderr)
        TRACE.on = False
    if args.out:
        bout.close()
    else:
        bout.flush()
    return 0


def _host_path_report(counters, nbatches):
    """The run's batches that left the fused device path, on stderr: those
    over the fused DP budget, and those whose pairing was re-run on the
    host; then the fused paths' backtrace walks and the soft-clipped
    records."""
    k = counters.get("overflow_batches", 0)
    if k:
        print(f"fused DP budget exceeded in {k} of {nbatches} batches "
              f"({counters.get('overflow_dropped', 0)} candidates); they "
              f"ran on the host path", file=sys.stderr)
    k = counters.get("repair_batches", 0)
    if k:
        print(f"pairing re-run on the host in {k} of {nbatches} batches "
              f"({counters.get('repair_pairs', 0)} pairs, of which the "
              f"device pairing flagged "
              f"{counters.get('hostneed_pairs', 0)})", file=sys.stderr)
    k = counters.get("bt_walks", 0)
    if k:
        print(f"backtrace walks of the fused paths: {k}", file=sys.stderr)
    k = counters.get("clipped_records", 0)
    if k:
        print(f"soft-clipped records: {k} "
              f"({counters.get('clipped_bases', 0)} bases clipped)",
              file=sys.stderr)


def cmd_inspect(argv):
    ap = argparse.ArgumentParser(prog="bt2x inspect")
    ap.add_argument("prefix")
    ap.add_argument("-n", "--names", action="store_true")
    ap.add_argument("-s", "--summary", action="store_true")
    args = ap.parse_args(argv)
    from bowtie2_tpu_torch.index.build import load_index
    data = load_index(args.prefix)
    if args.names:
        for n in data.ref_names:
            print(n)
        return 0
    if args.summary:
        print(f"Sequences: {len(data.ref_names)}")
        for n, l in zip(data.ref_names, data.ref_lens):
            print(f"Sequence\t{n}\t{int(l)}")
        print(f"Joined length\t{data.n_joined}")
        print(f"Offrate\t{data.off_rate}")
        # the port's own line, on stderr: stdout stays the JAX CLI's
        from bowtie2_tpu_torch.index.fmindex import row_mode
        print(f"Row mode\t{row_mode(data)}", file=sys.stderr)
        return 0
    # full FASTA reconstruction from the 2-bit reference + N mask
    import numpy as np
    from bowtie2_tpu_torch.constants import CODE_TO_CHAR
    for ri, name in enumerate(data.ref_names):
        print(f">{name}")
        lo, hi = int(data.ref_cum[ri]), int(data.ref_cum[ri + 1])
        pos = np.arange(lo, hi)
        word = data.ref_words[pos >> 4]
        code = (word >> (2 * (pos & 15))) & 3
        nbit = (data.refn_words[pos >> 5] >> (pos & 31)) & 1
        code = np.where(nbit == 1, 4, code).astype(np.uint8)
        s = CODE_TO_CHAR[code].tobytes().decode()
        for k in range(0, len(s), 60):
            print(s[k:k + 60])
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: bt2x {build|align|inspect} ...", file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    # -A <argfile> batch mode (reference bowtie_main.cpp:72-100): one full
    # argument set per line, dispatched sequentially; the index and the
    # compiled pipelines stay warm across lines within this process.
    if cmd == "-A" or (rest and rest[0] == "-A"):
        if cmd == "-A":
            pre, file = [], rest[0] if rest else None
        else:
            pre, file = [cmd], rest[1] if len(rest) > 1 else None
        if file is None:
            print("-A requires an argument file", file=sys.stderr)
            return 2
        lastret = -1
        with open(file) as f:
            for line in f:
                args = line.split()
                if not args:
                    continue
                lastret = main(pre + args)
        if lastret == -1:
            print(f"Warning: No arg strings parsed from {file}",
                  file=sys.stderr)
            return 0
        return lastret
    if cmd == "build":
        return cmd_build(rest)
    if cmd == "align":
        return cmd_align(rest)
    if cmd == "inspect":
        return cmd_inspect(rest)
    print(f"unknown command: {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
