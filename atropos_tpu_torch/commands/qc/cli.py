"""Command line interface for the qc command (counterpart of
``atropos_tpu/commands/qc/cli.py``, flag for flag)."""
from atropos_tpu_torch.commands.cli import (
    BaseCommandParser,
    configure_threads,
    int_or_str,
    parse_stat_args,
    positive,
    writeable_file,
)


class CommandParser(BaseCommandParser):
    name = "qc"
    usage = """
atropos qc -se input.fastq
atropos qc -pe1 in1.fastq -pe2 in2.fastq
"""
    description = """
Compute read-level statistics. The output is identical to running the
'trim' command with '--stats pre'.
"""

    def add_command_options(self):
        self.parser.set_defaults(action="qc", batch_size=None)

        group = self.add_group("Output")
        group.add_argument(
            "-o", "--output", type=writeable_file, default="-", metavar="FILE",
            help="Write stats to file rather than stdout.",
        )

        group = self.add_group("Report", title="Report content and formatting")
        group.add_argument(
            "--report-formats", nargs="*", choices=("txt", "json"),
            default=None, metavar="FORMAT",
            help="Report type(s) to generate. (guessed from extension)",
        )
        group.add_argument(
            "--stats", type=parse_stat_args, default=None,
            help="Additional statistic-collection arguments, e.g. "
            "'tiles[=regexp]' for tile-level statistics.",
        )

        group = self.add_group("Parallel", title="Parallel (multi-core) options")
        group.add_argument(
            "-T", "--threads", type=positive(int, True), default=None,
            metavar="THREADS", help="Number of threads. (serial)",
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

    def validate_command_options(self, options):
        options.report_file = options.output
        if options.threads is not None:
            threads = configure_threads(options, self.parser)
            if options.read_queue_size is None:
                options.read_queue_size = threads * 100
            elif 0 < options.read_queue_size < threads:
                self.parser.error("Read queue size must be >= than 'threads'")
        if options.batch_size is None:
            options.batch_size = 1000
