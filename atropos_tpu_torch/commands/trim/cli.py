"""Trim command line interface (flag-compatible with the reference
``atropos/commands/trim/cli.py``, including cross-option validation,
aligner-specific defaulting, and the miRNA/bisulfite presets)."""
import logging
import sys

from atropos_tpu_torch.commands.cli import (
    BaseCommandParser,
    CharList,
    Delimited,
    configure_threads,
    int_or_str,
    parse_stat_args,
    positive,
    probability,
    readable_file,
    readwriteable_file,
    writeable_file,
)
from atropos_tpu_torch.io import STDERR, STDOUT


class CommandParser(BaseCommandParser):
    name = "trim"
    usage = """
atropos trim -a ADAPTER [options] [-o output.fastq] -se input.fastq
atropos trim -a ADAPT1 -A ADAPT2 [options] -o out1.fastq -p out2.fastq -pe1 in1.fastq -pe2 in2.fastq
"""
    description = """
Trim adapters and low-quality bases, and perform other NGS preprocessing.
"""
    details = ""

    def add_command_options(self):
        self.parser.set_defaults(
            zero_cap=None, action="trim", batch_size=None, known_adapter=None
        )

        group = self.add_group("Adapters", title="Finding adapters")
        group.add_argument(
            "-a", "--adapter", action="append", default=[], metavar="ADAPTER",
            dest="adapters",
            help="Sequence of an adapter ligated to the 3' end. '$' suffix "
            "anchors it. (none)",
        )
        group.add_argument(
            "-g", "--front", action="append", default=[], metavar="ADAPTER",
            help="Sequence of an adapter ligated to the 5' end. '^' prefix "
            "anchors it. (none)",
        )
        group.add_argument(
            "-b", "--anywhere", action="append", default=[], metavar="ADAPTER",
            help="Adapter that may be ligated to either end. (none)",
        )
        group.add_argument(
            "-F", "--known-adapters-file", type=readable_file, action="append",
            default=None,
            help="Path or URL of a FASTA file containing adapter sequences.",
        )
        group.add_argument(
            "--no-default-adapters", action="store_false", dest="default_adapters",
            default=True, help="Don't load the default adapter list.",
        )
        group.add_argument(
            "--adapter-cache-file", type=readwriteable_file, default=".adapters",
            help="File where adapter sequences are cached.",
        )
        group.add_argument(
            "--no-cache-adapters", action="store_false", dest="cache_adapters",
            default=True, help="Don't cache adapters in the working directory.",
        )
        group.add_argument(
            "--no-trim", action="store_const", dest="action", const=None,
            help="Match and redirect reads but do not remove adapters. (no)",
        )
        group.add_argument(
            "--mask-adapter", action="store_const", dest="action", const="mask",
            help="Mask adapters with 'N' instead of trimming them. (no)",
        )
        group.add_argument(
            "--gc-content", type=probability, default=0.5,
            help="Expected GC content of sequences.",
        )
        group.add_argument(
            "--aligner", choices=("adapter", "insert"), default="adapter",
            help="Alignment algorithm: semi-global adapter alignment or the "
            "paired-end insert-based algorithm. (adapter)",
        )
        group.add_argument(
            "-e", "--error-rate", type=probability, default=None,
            help="Maximum allowed error rate for adapter match. (0.1)",
        )
        group.add_argument(
            "--indel-cost", type=positive(int, True), default=None, metavar="COST",
            help="Integer cost of indels during adapter match. (1)",
        )
        group.add_argument(
            "--no-indels", action="store_false", dest="indels", default=True,
            help="Allow only mismatches in alignments. (allow indels)",
        )
        group.add_argument(
            "-n", "--times", type=positive(int, False), default=1, metavar="COUNT",
            help="Remove up to COUNT adapters from each read. (1)",
        )
        group.add_argument(
            "--match-read-wildcards", action="store_true", default=False,
            help="Interpret IUPAC wildcards in reads. (no)",
        )
        group.add_argument(
            "-N", "--no-match-adapter-wildcards", action="store_false",
            dest="match_adapter_wildcards", default=True,
            help="Do not interpret IUPAC wildcards in adapters. (no)",
        )
        group.add_argument(
            "-O", "--overlap", type=positive(int, False), default=None,
            metavar="MINLENGTH",
            help="Minimum overlap between read and adapter for a match. (3)",
        )
        group.add_argument(
            "--adapter-max-rmp", type=probability, default=None, metavar="PROB",
            help="Max random-match probability for adapter matches when no "
            "minimum overlap is given. (1E-6)",
        )
        group.add_argument(
            "--insert-max-rmp", type=probability, default=1e-6, metavar="PROB",
            help="Max random-match probability for insert matches. (1E-6)",
        )
        group.add_argument(
            "--insert-match-error-rate", type=probability, default=None,
            help="Maximum allowed error rate for insert match. (0.2)",
        )
        group.add_argument(
            "--insert-match-adapter-error-rate", type=probability, default=None,
            help="Maximum allowed error rate for adapter match after insert "
            "match. (0.2)",
        )
        group.add_argument(
            "-R", "--merge-overlapping", action="store_true", default=False,
            help="Merge overlapping read pairs into a single sequence. (no)",
        )
        group.add_argument(
            "--merge-min-overlap", type=positive(float, True), default=0.9,
            help="Minimum overlap for merging: fraction of the shorter read "
            "if in (0,1], else absolute bp (min 2). (0.9)",
        )
        group.add_argument(
            "--merge-error-rate", type=probability, default=None,
            help="Maximum error rate for merging. (0.2)",
        )
        group.add_argument(
            "--correct-mismatches", choices=("liberal", "conservative", "N"),
            default=None,
            help="How to correct mismatches in overlapping regions. (no)",
        )

        group = self.add_group("Modifications", title="Additional read modifications")
        group.add_argument(
            "--op-order", type=CharList(choices=("A", "C", "G", "Q", "W")),
            default="CGQAW",
            help="Order of trimming operations: A=adapter, C=cut, G=NextSeq, "
            "Q=quality, W=overwrite. (CGQAW)",
        )
        group.add_argument(
            "-u", "--cut", type=int, action="append", default=[], metavar="LENGTH",
            help="Remove LENGTH bases from each read (>0 front, <0 back). (no)",
        )
        group.add_argument(
            "-q", "--quality-cutoff",
            type=Delimited(data_type=positive(int, True), min_len=1, max_len=2),
            default=None, metavar="[5'CUTOFF,]3'CUTOFF",
            help="Trim low-quality bases before adapter removal. (no)",
        )
        group.add_argument(
            "-i", "--cut-min", type=int, action="append", default=[],
            metavar="LENGTH",
            help="Like -u but applied after adapter trimming and only to make "
            "up a minimum. (no)",
        )
        group.add_argument(
            "--nextseq-trim", type=positive(), default=None, metavar="3'CUTOFF",
            help="NextSeq-specific quality trimming (dark-cycle G bases). (no)",
        )
        group.add_argument(
            "--trim-n", action="store_true", default=False,
            help="Trim N's on ends of reads. (no)",
        )
        group.add_argument(
            "-x", "--prefix", default="",
            help="Prefix to add to read names ('{name}' = adapter name). (no)",
        )
        group.add_argument(
            "-y", "--suffix", default="",
            help="Suffix to add to read names ('{name}' = adapter name). (no)",
        )
        group.add_argument(
            "--strip-suffix", action="append", default=[],
            help="Remove this suffix from read names if present. (no)",
        )
        group.add_argument(
            "--length-tag", metavar="TAG",
            help="Rewrite 'TAG<number>' in read names to the trimmed length. (no)",
        )

        group = self.add_group("Filtering", title="Filtering of processed reads")
        group.add_argument(
            "--discard-trimmed", "--discard", action="store_true", default=False,
            help="Discard reads that contain an adapter. (no)",
        )
        group.add_argument(
            "--discard-untrimmed", "--trimmed-only", action="store_true",
            default=False, help="Discard reads not containing an adapter. (no)",
        )
        group.add_argument(
            "-m", "--minimum-length", type=positive(int, True), default=None,
            metavar="LENGTH",
            help="Discard trimmed reads shorter than LENGTH. (0)",
        )
        group.add_argument(
            "-M", "--maximum-length", type=positive(int, True), default=sys.maxsize,
            metavar="LENGTH",
            help="Discard trimmed reads longer than LENGTH. (no limit)",
        )
        group.add_argument(
            "--max-n", type=positive(float, True), default=None, metavar="COUNT",
            help="Discard reads with more than COUNT N bases (count if >= 1, "
            "else proportion). (no)",
        )

        group = self.add_group("Output")
        group.add_argument(
            "-o", "--output", type=writeable_file, metavar="FILE",
            help="Write trimmed reads to FILE ('{name}' demultiplexes). (stdout)",
        )
        group.add_argument(
            "--info-file", type=writeable_file, metavar="FILE",
            help="Write per-read adapter match information to FILE. (no)",
        )
        group.add_argument(
            "-r", "--rest-file", type=writeable_file, metavar="FILE",
            help="Write the rest after mid-read adapter matches to FILE. (no)",
        )
        group.add_argument(
            "--wildcard-file", type=writeable_file, metavar="FILE",
            help="Write read bases matching adapter wildcards to FILE. (no)",
        )
        group.add_argument(
            "--too-short-output", type=writeable_file, metavar="FILE",
            help="Write reads that are too short to FILE. (discard)",
        )
        group.add_argument(
            "--too-long-output", type=writeable_file, metavar="FILE",
            help="Write reads that are too long to FILE. (discard)",
        )
        group.add_argument(
            "--untrimmed-output", type=writeable_file, default=None, metavar="FILE",
            help="Write reads without adapters to FILE. (default output)",
        )
        group.add_argument(
            "--merged-output", type=writeable_file, default=None, metavar="FILE",
            help="Write merged reads to FILE. (discard)",
        )
        group.add_argument(
            "--report-file", type=writeable_file, default="-", metavar="FILE",
            help="Write report to file rather than stdout/stderr. (no)",
        )
        group.add_argument(
            "--report-formats", nargs="*",
            choices=("txt", "json", "yaml", "pickle"), default=None,
            metavar="FORMAT",
            help="Report type(s) to generate. (guessed from extension)",
        )
        group.add_argument(
            "--stats", nargs="*", default=None,
            help="Read-level statistics to compute: none, pre, post, both, "
            "optionally with ':tiles[=regexp]'. (none)",
        )

        group = self.add_group("Colorspace options")
        group.add_argument(
            "-d", "--double-encode", action="store_true", default=False,
            help="Double-encode colors (0,1,2,3,4 to A,C,G,T,N). (no)",
        )
        group.add_argument(
            "-t", "--trim-primer", action="store_true", default=False,
            help="Trim primer base and the first color. (no)",
        )
        group.add_argument(
            "--strip-f3", action="store_true", default=False,
            help="Strip the _F3 suffix of read names. (no)",
        )
        group.add_argument(
            "--maq", "--bwa", action="store_true", default=False,
            help="MAQ/BWA-compatible colorspace output (-c -d -t --strip-f3 "
            "-y '/1'). (no)",
        )
        group.add_argument(
            "--no-zero-cap", dest="zero_cap", action="store_false",
            help="Do not change negative quality values to zero. (no)",
        )
        group.add_argument(
            "-z", "--zero-cap", action="store_true",
            help="Change negative quality values to zero. (colorspace default)",
        )

        group = self.add_group("Paired", title="Paired-end options")
        group.add_argument(
            "-A", "--adapter2", action="append", dest="adapters2", default=[],
            metavar="ADAPTER",
            help="3' adapter to be removed from second read in a pair. (no)",
        )
        group.add_argument(
            "-G", "--front2", action="append", dest="front2", default=[],
            metavar="ADAPTER",
            help="5' adapter to be removed from second read in a pair. (no)",
        )
        group.add_argument(
            "-B", "--anywhere2", action="append", dest="anywhere2", default=[],
            metavar="ADAPTER",
            help="5'/3' adapter to be removed from second read in a pair. (no)",
        )
        group.add_argument(
            "-U", "--cut2", type=int, action="append", dest="cut2", default=[],
            metavar="LENGTH",
            help="Remove LENGTH bases from second read in a pair. (no)",
        )
        group.add_argument(
            "-I", "--cut-min2", type=int, action="append", default=[],
            metavar="LENGTH",
            help="Like -U, but applied after adapter trimming. (no)",
        )
        group.add_argument(
            "-w", "--overwrite-low-quality",
            type=Delimited(data_type=positive(int, True), min_len=3, max_len=3),
            default=None, metavar="LOWQ,HIGHQ,WINDOW",
            help="Overwrite the worse read with the better read when qualities "
            "differ sufficiently over the first WINDOW bases.",
        )
        group.add_argument(
            "-p", "--paired-output", type=writeable_file, metavar="FILE",
            help="Write second read in a pair to FILE. (no)",
        )
        group.add_argument(
            "-L", "--interleaved-output", type=writeable_file, metavar="FILE",
            help="Write output to interleaved file.",
        )
        group.add_argument(
            "--pair-filter", choices=("any", "both"), default=None,
            metavar="(any|both)",
            help="How many reads in a pair must match a filter for the pair "
            "to be filtered. (any)",
        )
        group.add_argument(
            "--untrimmed-paired-output", type=writeable_file, default=None,
            metavar="FILE",
            help="Write second read to this FILE when no adapter was found in "
            "the first read. (no)",
        )
        group.add_argument(
            "--too-short-paired-output", type=writeable_file, default=None,
            metavar="FILE",
            help="Write second read to this file if pair is too short. (no)",
        )
        group.add_argument(
            "--too-long-paired-output", type=writeable_file, default=None,
            metavar="FILE",
            help="Write second read to this file if pair is too long. (no)",
        )

        group = self.add_group("Method-specific options")
        group = group.add_mutually_exclusive_group()
        group.add_argument(
            "--bisulfite", default=False, metavar="METHOD",
            help="Preset for bisulfite-treated data: rrbs, non-directional, "
            "non-directional-rrbs, truseq, epignome, swift, or custom "
            "'<read1>[;<read2>]' parameters. (no)",
        )
        group.add_argument(
            "--mirna", action="store_true", default=False,
            help="Preset for miRNA data. (no)",
        )

        group = self.add_group("Parallel", title="Parallel (multi-core) options")
        group.add_argument(
            "-T", "--threads", type=positive(int, True), default=None,
            metavar="THREADS",
            help="Number of threads for read trimming (0 = all). (serial)",
        )
        group.add_argument(
            "--no-writer-process", action="store_false", dest="writer_process",
            default=True,
            help="Each worker writes its own output shard with a '.N' suffix. (no)",
        )
        group.add_argument(
            "--preserve-order", action="store_true", default=False,
            help="Preserve order of reads in input files. (no)",
        )
        group.add_argument(
            "--process-timeout", type=positive(int, True), default=60,
            metavar="SECONDS",
            help="Seconds to wait before escalating messages to ERROR. (60)",
        )
        group.add_argument(
            "--read-queue-size", type=int_or_str, default=None, metavar="SIZE",
            help="Size of queue for batches of reads. (THREADS * 100)",
        )
        group.add_argument(
            "--result-queue-size", type=int_or_str, default=None, metavar="SIZE",
            help="Size of queue for batches of results. (THREADS * 100)",
        )
        group.add_argument(
            "--compression", choices=("worker", "writer"), default=None,
            help="Where data compression is performed. (auto)",
        )

    def validate_command_options(self, options):
        parser = self.parser
        paired = options.paired

        if not paired:
            if not options.output:
                parser.error("An output file is required")
            if options.untrimmed_paired_output:
                parser.error(
                    "Option --untrimmed-paired-output can only be used when "
                    "trimming paired-end reads (with option -p)."
                )
        else:
            if not options.interleaved_output:
                if not options.output:
                    parser.error(
                        "When you use -p or --paired-output, you must also "
                        "use the -o option."
                    )
                if not options.paired_output:
                    parser.error(
                        "When paired-end trimming is enabled via -A/-G/-B/-U, "
                        "a second output file needs to be specified via -p "
                        "(--paired-output)."
                    )
                if bool(options.untrimmed_output) != bool(
                    options.untrimmed_paired_output
                ):
                    parser.error(
                        "When trimming paired-end reads, you must use either "
                        "none or both of the --untrimmed-output/"
                        "--untrimmed-paired-output options."
                    )
                if options.too_short_output and not options.too_short_paired_output:
                    parser.error(
                        "When using --too-short-output with paired-end reads, "
                        "you also need to use --too-short-paired-output"
                    )
                if options.too_long_output and not options.too_long_paired_output:
                    parser.error(
                        "When using --too-long-output with paired-end reads, "
                        "you also need to use --too-long-paired-output"
                    )

            # any of these options switches off legacy mode
            if (
                options.adapters2 or options.front2 or options.anywhere2
                or options.cut2 or options.cut_min2 or options.quality_cutoff
                or options.trim_n or options.interleaved_input
                or options.pair_filter or options.too_short_paired_output
                or options.too_long_paired_output or options.overwrite_low_quality
            ):
                paired = "both"
            else:
                paired = "first"

            options.paired = paired

        if options.output is None and options.report_file == STDOUT:
            options.report_file = STDERR

        if options.aligner == "adapter":
            if options.indels and options.indel_cost is None:
                options.indel_cost = 1
            if options.overlap is None:
                if options.adapter_max_rmp is None:
                    options.overlap = 3
                else:
                    options.overlap = 1
        elif options.aligner == "insert":
            if paired != "both":
                parser.error("Insert aligner only works with paired-end reads")
            if options.indels and options.indel_cost is None:
                options.indel_cost = 3
            if options.overlap is None:
                options.overlap = 1
                if options.adapter_max_rmp is None:
                    options.adapter_max_rmp = 1e-6
            if options.insert_match_error_rate is None:
                options.insert_match_error_rate = options.error_rate or 0.2
            if options.insert_match_adapter_error_rate is None:
                options.insert_match_adapter_error_rate = (
                    options.insert_match_error_rate
                )

        if options.merge_overlapping:
            if options.merged_output is None:
                logging.getLogger().warning(
                    "--merge-output is not set; merged reads will be discarded"
                )
            if options.merge_error_rate is None:
                options.merge_error_rate = options.error_rate or 0.2

        if options.mirna:
            if not (options.adapters or options.front or options.anywhere):
                options.adapters = ["TGGAATTCTCGG"]  # Illumina small RNA adapter
            if options.quality_cutoff is None:
                options.quality_cutoff = (20, 20)
            if options.minimum_length is None:
                options.minimum_length = 16
            if options.error_rate is None:
                options.error_rate = 0.12
        elif options.bisulfite:
            if options.bisulfite == "swift" and paired != "both":
                parser.error("Swift trimming is only compatible with paired-end reads")
            if options.bisulfite not in (
                "rrbs", "non-directional", "truseq", "epignome", "swift",
                "non-directional-rrbs",
            ):

                def parse_bisulfite_params(arg):
                    try:
                        parts = [int(part) for part in arg.split(",")]
                        assert len(parts) == 4
                        if parts[0] <= 0 and parts[1] <= 0:
                            return None
                        return dict(
                            zip(
                                ("lengths", "count_trimmed", "only_trimmed"),
                                (
                                    (parts[0], -1 * parts[1]),
                                    (False, True)[parts[2]],
                                    (False, True)[parts[3]],
                                ),
                            )
                        )
                    except Exception:
                        parser.error("Invalidate format for bisulfite parameters")

                temp = [
                    parse_bisulfite_params(arg)
                    for arg in options.bisulfite.split(";")
                ]
                if paired == "both" and len(temp) == 1:
                    temp = [temp[0], temp[0]]
                elif paired != "both" and len(temp) > 1:
                    parser.error("Too many bisulfite parameters for single-end reads")
                options.bisulfite = temp

        if options.overwrite_low_quality:
            if not paired:
                parser.error(
                    "--overwrite-low-quality is not valid for single-end reads"
                )
            if options.overwrite_low_quality[0] > options.overwrite_low_quality[1]:
                parser.error("For --overwrite-low-quality, LOWQ must be <= HIGHQ")

        if options.quality_cutoff:
            if all(c <= 0 for c in options.quality_cutoff):
                options.quality_cutoff = None
            elif len(options.quality_cutoff) == 1:
                options.quality_cutoff = [0] + options.quality_cutoff

        if options.pair_filter is None:
            options.pair_filter = "any"

        if (options.discard_trimmed or options.discard_untrimmed) and (
            options.untrimmed_output is not None
        ):
            parser.error(
                "Only one of the --discard-trimmed, --discard-untrimmed "
                "and --untrimmed-output options can be used at the same time."
            )

        if options.output is not None and "{name}" in options.output:
            if options.discard_trimmed:
                parser.error("Do not use --discard-trimmed when demultiplexing.")
            if paired:
                parser.error("Demultiplexing not supported for paired-end files, yet.")

        if options.maq:
            options.colorspace = True
            options.double_encode = True
            options.trim_primer = True
            options.suffix = "/1"

        if options.strip_f3 or options.maq:
            options.strip_suffix.append("_F3")

        if options.zero_cap is None:
            options.zero_cap = options.colorspace

        if options.colorspace:
            if options.anywhere:
                parser.error(
                    "Using --anywhere with colorspace reads is currently not "
                    "supported."
                )
            if options.match_read_wildcards:
                parser.error("IUPAC wildcards not supported in colorspace")
            options.match_adapter_wildcards = False
        else:
            if options.trim_primer:
                parser.error("Trimming the primer makes only sense in colorspace.")
            if options.double_encode:
                parser.error("Double-encoding makes only sense in colorspace.")

        if options.error_rate is None:
            options.error_rate = 0.1

        for cut_attr in ("cut", "cut_min"):
            cut = getattr(options, cut_attr)
            if cut:
                if len(cut) > 2:
                    parser.error("You cannot remove bases from more than two ends.")
                if len(cut) == 2 and cut[0] * cut[1] > 0:
                    parser.error("You cannot remove bases from the same end twice.")

        if paired == "both":
            for cut_attr in ("cut2", "cut_min2"):
                cut = getattr(options, cut_attr)
                if cut:
                    if len(cut) > 2:
                        parser.error(
                            "You cannot remove bases from more than two ends."
                        )
                    if len(cut) == 2 and cut[0] * cut[1] > 0:
                        parser.error(
                            "You cannot remove bases from the same end twice."
                        )

        if not options.stats or options.stats == "none":
            options.stats = None
        else:
            stats = {}
            for stat_spec in options.stats:
                parts = stat_spec.split(":")
                name = parts[0]
                args = {} if len(parts) == 1 else parse_stat_args(parts[1])
                if name == "both":
                    stats["pre"] = stats["post"] = args
                else:
                    stats[name] = args
            options.stats = stats

        if options.threads is not None:
            threads = configure_threads(options, parser)

            if options.compression is None:
                if options.writer_process and 2 < threads < 8:
                    from atropos_tpu_torch.io import compression

                    if compression.can_use_system_compression():
                        options.compression = "writer"
                    else:
                        options.compression = "worker"
                else:
                    options.compression = "worker"
            elif options.compression == "writer":
                if not options.writer_process:
                    parser.error(
                        "Writer compression and --no-writer-process are "
                        "mutually exclusive"
                    )
                elif threads == 2:
                    logging.getLogger().warning(
                        "Writer compression requires > 2 threads; using "
                        "worker compression instead"
                    )
                    options.compression = "worker"

            if options.read_queue_size is None:
                options.read_queue_size = threads * (
                    100 if options.compression == "writer" else 500
                )
            elif 0 < options.read_queue_size < threads:
                parser.error("Read queue size must be >= 'threads'")

            if options.result_queue_size is None:
                options.result_queue_size = threads * (
                    100 if options.compression == "worker" else 500
                )
            elif 0 < options.result_queue_size < threads:
                parser.error("Result queue size must be >= 'threads'")

            max_queue_size = options.read_queue_size + options.result_queue_size
            if options.batch_size is None:
                options.batch_size = max(1000, max_queue_size / 10e6)
            elif options.batch_size * max_queue_size > 10e6:
                logging.getLogger().warning(
                    "Combination of batch size %d and total queue size %d "
                    "may lead to excessive memory usage",
                    options.batch_size,
                    max_queue_size,
                )

        if options.batch_size is None:
            options.batch_size = 1000
