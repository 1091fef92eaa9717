"""Command-line interface for the error command (counterpart of
``atropos_tpu/commands/error/cli.py``, flag for flag)."""
from atropos_tpu_torch.commands.cli import BaseCommandParser, writeable_file
from atropos_tpu_torch.io import STDOUT


class CommandParser(BaseCommandParser):
    name = "error"
    usage = """
atropos error -se input.fastq
atropos error -pe1 in1.fq -pe2 in2.fq
"""
    description = """
Estimate the sequencing error rate, to help decide the value of the max
error rate (-e) parameter.
"""

    def add_command_options(self):
        parser = self.parser
        parser.set_defaults(
            max_reads=10000, counter_magnitude="K", report_formats=["txt"]
        )
        group = self.add_group("Error Estimation")
        group.add_argument(
            "-a", "--algorithm", choices=("quality", "shadow"), default="quality",
            help="Method for estimating error rates: quality = base "
            "qualities, shadow = shadow regression (slow). (quality)",
        )
        group.add_argument(
            "-m", "--max-bases", type=int, default=None,
            help="Maximum number of 5' bases of each read to use. (all)",
        )

        group = self.add_group("Output")
        group.add_argument(
            "-o", "--output", type=writeable_file, default=STDOUT,
            help="File for the estimated error rates. (stdout)",
        )
        group.add_argument(
            "--output_formats", nargs="*",
            choices=("txt", "json", "yaml", "pickle"), default=None,
            metavar="FORMAT", dest="report_formats",
            help="Report type(s) to generate.",
        )

    def validate_command_options(self, options):
        options.report_file = options.output
