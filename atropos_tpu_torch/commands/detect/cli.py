"""Command-line interface for the detect command (counterpart of
``atropos_tpu/commands/detect/cli.py``, flag for flag)."""
from atropos_tpu_torch.commands.cli import (
    BaseCommandParser,
    positive,
    probability,
    readable_url,
    readwriteable_file,
    writeable_file,
)
from atropos_tpu_torch.io import STDERR, STDOUT


class CommandParser(BaseCommandParser):
    name = "detect"
    usage = """
atropos detect -se input.fastq
atropos detect -pe1 in1.fq -pe2 in2.fq
"""
    description = """
Detect adapter sequences directly from read sequences.
"""

    def add_command_options(self):
        parser = self.parser
        parser.set_defaults(max_reads=10000, counter_magnitude="K")

        group = self.add_group("Adapter Detection")
        group.add_argument(
            "-d", "--detector", choices=("known", "heuristic", "khmer"),
            default=None, help="Which detector to use. (auto)",
        )
        group.add_argument(
            "-k", "--kmer-size", type=positive(), default=12,
            help="Size of k-mer used to scan reads for adapters. (12)",
        )
        group.add_argument(
            "-e", "--past-end-bases", nargs="*", default=("A",),
            help="Bases whose runs signify sequencing past the fragment end; "
            "they are removed before contaminant matching. May be a regexp.",
        )
        group.add_argument(
            "-i", "--include-contaminants",
            choices=("all", "known", "unknown"), default="all",
            help="Which contaminants to search for. (all)",
        )
        group.add_argument(
            "-x", "--known-contaminant", action="append", dest="known_adapter",
            default=None,
            help="Known contaminants as 'name=sequence' (repeatable).",
        )
        group.add_argument(
            "-F", "--known-contaminants-file", type=readable_url,
            action="append", dest="known_adapters_file", default=None,
            help="FASTA file or URL with known contaminants.",
        )
        group.add_argument(
            "--no-default-contaminants", action="store_false",
            dest="default_adapters", default=True,
            help="Don't load the default contaminant list.",
        )
        group.add_argument(
            "--contaminant-cache-file", type=readwriteable_file,
            dest="adapter_cache_file", default=".adapters",
            help="File where known contaminant sequences are cached.",
        )
        group.add_argument(
            "--no-cache-contaminants", action="store_false",
            dest="cache_adapters", default=True,
            help="Don't cache the contaminant list in the working directory.",
        )

        group = self.add_group("Known Detector Options")
        group.add_argument(
            "--min-kmer-match-frac", type=probability, default=0.5,
            help="Minimum fraction of contaminant kmers found in a read for "
            "a match. (0.5)",
        )

        group = self.add_group("Heuristic Detector Options")
        group.add_argument(
            "--min-frequency", type=probability, default=0.001,
            help="Minimum frequency required to retain a k-mer. (0.001)",
        )
        group.add_argument(
            "--min-contaminant-match-frac", type=probability, default=0.9,
            help="Minimum aligned-nucleotide fraction for a detected "
            "contaminant to match a known adapter. (0.9)",
        )

        group = self.add_group("Output")
        group.add_argument(
            "-o", "--output", type=writeable_file, default=STDOUT,
            metavar="FILE",
            help="File for the summary of detected adapters. (stdout)",
        )
        group.add_argument(
            "-O", "--output-formats", nargs="*",
            choices=("txt", "fasta", "json", "yaml", "pickle"), default=None,
            metavar="FORMAT", dest="report_formats",
            help="Report type(s) to generate.",
        )
        group.add_argument(
            "--fasta", nargs="*", choices=("union", "perinput"), default=None,
            metavar="OPTIONS",
            help="FASTA output options: perinput = one output per input; "
            "union = one merged output.",
        )
        group.add_argument(
            "-m", "--max-adapters", type=positive(), default=None,
            help="Maximum number of candidate adapters to report. (all)",
        )

    def validate_command_options(self, options):
        options.report_file = options.output
        is_std = options.report_file in (STDOUT, STDERR)
        if options.fasta:
            if is_std and "perinput" in options.fasta:
                self.parser.error("Per-input fasta cannot be written to stdout")
            if not options.report_formats:
                options.report_formats = ["fasta"]
            elif "fasta" not in options.report_formats:
                options.report_formats = list(options.report_formats) + ["fasta"]
        elif (
            is_std
            and options.report_formats
            and "fasta" in options.report_formats
        ):
            options.fasta = ["union"]
