"""CLI framework: base parser, argparse type combinators, common options.

The flag surface and validation/defaulting rules are compatible with the
reference (``atropos/commands/cli.py``) so existing Atropos command lines
work unchanged.
"""
from argparse import (
    ArgumentParser,
    ArgumentTypeError,
    HelpFormatter,
)
import logging
from multiprocessing import cpu_count
import os
import platform
import re
import sys
import textwrap
import urllib

from atropos_tpu_torch import __version__
from atropos_tpu_torch.io import STDERR, STDOUT, check_path, check_writeable, resolve_path
from atropos_tpu_torch.io.compression import splitext_compressed
from atropos_tpu_torch.io.seqio import PAIRED, SINGLE
from atropos_tpu_torch.util import ALPHABETS, MAGNITUDE


class BaseCommandParser:
    """Base class for subcommand parsers; subclasses define name,
    description, usage, and add_command_options."""

    preamble = "Atropos-TPU version {version}"
    usage = "atropos {command} [options]"
    description = ""
    details = ""

    def __init__(self):
        self.groups = {}
        self.create_parser()
        self.add_common_options()
        self.add_command_options()

    def parse(self, args):
        options = self.parser.parse_args(args)
        options.orig_args = list(args)
        self.setup_logging(options)
        self.validate_common_options(options)
        self.validate_command_options(options)
        return options

    def create_parser(self):
        format_args = dict(name=self.name, version=__version__)
        self.parser = ArgumentParser(
            prog="atropos {}".format(format_args["name"]),
            usage=self.usage.format(**format_args),
            description=self.get_description(**format_args),
            formatter_class=ParagraphHelpFormatter,
        )

    def get_description(self, **kwargs):
        parts = (self.preamble, self.description, self.details)
        return "\n\n".join(p.strip() for p in parts).format(**kwargs)

    def add_group(self, name, title=None, description=None, mutex=False, required=False):
        if name in self.groups:
            raise ValueError("Group already exists: {}".format(name))
        self.groups[name] = group = (
            self.parser.add_mutually_exclusive_group(required)
            if mutex
            else self.parser.add_argument_group(title or name, description)
        )
        return group

    def get_group(self, name):
        return self.groups.get(name) or self.add_group(name)

    def add_common_options(self):
        self.parser.set_defaults(
            orig_args=None,
            paired=False,
            default_outfile=STDOUT,
            report_file=None,
            report_formats=None,
            batch_size=1000,
            counter_magnitude="M",
            sra_reader=None,
        )
        self.parser.add_argument(
            "--debug", action="store_true", default=False,
            help="Print debugging information. (no)",
        )
        self.parser.add_argument(
            "--progress", choices=("bar", "msg"), default=None,
            help="Show progress. bar = progress bar; msg = status message. (no)",
        )
        self.parser.add_argument(
            "--quiet", action="store_true", default=False,
            help="Print only error messages. (no)",
        )
        self.parser.add_argument(
            "--log-level", choices=("DEBUG", "INFO", "WARN", "ERROR"), default=None,
            help="Logging level. (ERROR when --quiet else INFO)",
        )
        self.parser.add_argument(
            "--log-file", type=writeable_file, default=None, metavar="FILE",
            help="File to write logging info. (stdout)",
        )
        self.parser.add_argument(
            "--version", action="version", version=__version__,
            help="Show version information and exit.",
        )

        group = self.add_group("Input")
        group.add_argument(
            "-pe1", "--input1", type=readable_file, default=None, metavar="FILE1",
            help="The first input file.",
        )
        group.add_argument(
            "-pe2", "--input2", type=readable_file, default=None, metavar="FILE2",
            help="The second input file.",
        )
        group.add_argument(
            "-l", "--interleaved-input", type=readable_file, default=None,
            metavar="FILE", help="Interleaved input file.",
        )
        group.add_argument(
            "-se", "--single-input", type=readable_file, default=None, metavar="FILE",
            help="A single-end read file.",
        )
        group.add_argument(
            "--single-input-read", type=int, dest="input_read", choices=(1, 2),
            default=None,
            help="When treating an interleaved FASTQ or paired-end SAM/BAM file "
            "as single-end, which of the two reads to process. (both)",
        )
        group.add_argument(
            "-sq", "--single-quals", type=readable_file, default=None, metavar="FILE",
            help="A single-end qual file.",
        )
        group.add_argument(
            "-sra", "--sra-accession", default=None, metavar="ACCN",
            help="Accession to stream from SRA (requires optional dependency).",
        )
        group.add_argument(
            "-f", "--format",
            choices=("fasta", "fastq", "sra-fastq", "sam", "bam"), default=None,
            help="Input file format. (auto-detect from file name extension)",
        )
        group.add_argument(
            "-Q", "--quality-base", type=positive(), default=33,
            help="Quality values are encoded as ascii(quality + QUALITY_BASE). (33)",
        )
        group.add_argument(
            "-c", "--colorspace", action="store_true", default=False,
            help="Enable colorspace mode. (no)",
        )
        group.add_argument(
            "--max-reads", type=int_or_str, default=None, metavar="N",
            help="Maximum number of reads/pairs to process (no max)",
        )
        group.add_argument(
            "--subsample", type=probability, default=None, metavar="PROB",
            help="Subsample a fraction of reads. (no)",
        )
        group.add_argument(
            "--subsample-seed", type=int, default=None, metavar="SEED",
            help="Seed for the subsampling pseudorandom number generator.",
        )
        group.add_argument(
            "--batch-size", type=int_or_str, metavar="SIZE",
            help="Number of records to process in each batch. (1000)",
        )
        group.add_argument(
            "-D", "--sample-id", default=None, metavar="ID",
            help="Optional sample ID. Added to the summary output.",
        )
        group.add_argument(
            "--alphabet", default=None, metavar="NAME",
            choices=tuple(ALPHABETS.keys()),
            help="Sequence alphabet for validating inputs. (no validation)",
        )

        group = self.add_group("Device", title="Device options")
        group.add_argument(
            "--device", choices=("cuda", "cpu"), default=None,
            help="Where the command's device work runs. Without this "
                 "option the run is on 'cuda' and fails when no card is "
                 "usable; only an explicit 'cpu' runs on the CPU. (cuda)",
        )

    def add_command_options(self):
        raise NotImplementedError()

    def setup_logging(self, options):
        root = logging.getLogger()
        if not root.handlers:
            level = getattr(
                logging,
                options.log_level or ("ERROR" if options.quiet else "INFO"),
            )
            handler = self._make_log_handler(options)
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
            )
            handler.setLevel(level)
            root.setLevel(level)
            root.addHandler(handler)
        root.info(
            "This is Atropos-TPU %s with Python %s",
            __version__,
            platform.python_version(),
        )

    @staticmethod
    def _make_log_handler(options):
        if options.log_file is not None:
            return logging.FileHandler(options.log_file)
        # stderr when product output occupies stdout (or goes nowhere)
        std_out_taken = getattr(options, "output", None) in (None, STDOUT, STDERR)
        return logging.StreamHandler(sys.stderr if std_out_taken else sys.stdout)

    def validate_common_options(self, options):
        self._resolve_input_mode(options)
        if options.input_read is None:
            options.input_read = PAIRED if options.paired else SINGLE
        if options.sample_id is None:
            options.sample_id = self._derive_sample_id(options)

        if options.quiet:
            options.progress = None
        elif options.progress and getattr(options, "output", None) == STDERR:
            logging.getLogger().warning(
                "Progress bar may corrupt output written to STDERR"
            )

        if options.report_file in (STDOUT, STDERR) and options.quiet:
            logging.getLogger().warning(
                "Quiet mode - report will not be written to stdout"
            )
            options.report_file = None

    def _resolve_input_mode(self, options):
        """Resolve the four input modes (SRA / -se / -l-as-single / PE)
        into (input1, input2, paired)."""
        parser = self.parser
        if options.sra_accession:
            self._open_sra(options)
        elif options.single_input:
            if options.input1 or options.input2 or options.interleaved_input:
                parser.error("Cannot use -se together with -pe1, -pe2, or -l")
            options.paired = False
            options.input1 = options.single_input
            options.input2 = options.single_quals
        elif options.interleaved_input and options.input_read:
            options.input1 = options.interleaved_input
            options.paired = False
        else:
            if not options.interleaved_input and (
                not options.input1 or not options.input2
            ):
                parser.error(
                    "Both '-pe1' and '-pe2' are required for paired-end "
                    "trimming. If this is an interleaved file, use '-l' "
                    "instead."
                )
            options.paired = True

    def _open_sra(self, options):
        """Stream directly from an SRA accession when the optional
        srastream library is installed (reference
        ``atropos/commands/cli.py:262-283``)."""
        if options.format not in ("fastq", "sam", "bam", None):
            raise ValueError(
                "Invalid file format for SRA accession: {}".format(
                    options.format
                )
            )
        options.format = "fastq"
        logging.getLogger().debug(
            "Opening reader for SRA Accession %s", options.sra_accession
        )
        try:
            from srastream import SraReader

            reader = SraReader(
                options.sra_accession, batch_size=options.batch_size or 1000
            )
            reader.start()
            options.sra_reader = reader
            options.paired = reader.paired
        except Exception:
            logging.getLogger().exception(
                "Error while fetching accession %s from SRA",
                options.sra_accession,
            )
            self.parser.error(
                "Unable to read from accession {}".format(
                    options.sra_accession
                )
            )

    @staticmethod
    def _derive_sample_id(options):
        """Sample id = input basename without extensions; for pairs, the
        common prefix of both names (reference behavior, one trailing
        dot stripped). SRA streams have no file name — the reader's name
        (the accession) is the sample id (ref commands/cli.py:306-308)."""
        if getattr(options, "sra_reader", None):
            return getattr(
                options.sra_reader, "name", options.sra_accession
            )
        fname = os.path.basename(options.input1 or options.interleaved_input)
        name = splitext_compressed(fname)[0]
        if options.input2:
            other = splitext_compressed(os.path.basename(options.input2))[0]
            name = os.path.commonprefix([name, other])
        return name[:-1] if name.endswith(".") else name

    def validate_command_options(self, options):
        pass


# --- argument conversion & validation (composable closures) -----------------
#
# Every option type is a plain function ``str -> value``; richer types are
# built by closing over parameters and chaining converters. argparse treats
# ArgumentTypeError as a per-flag usage error, so validators raise that.


class ParagraphHelpFormatter(HelpFormatter):
    def _fill_text(self, text, width, indent):
        text = re.sub("[ \t]{2,}", " ", text)
        paragraphs = [
            textwrap.fill(p, width, initial_indent=indent, subsequent_indent=indent)
            for p in re.split("\n\n", text)
        ]
        return "\n\n".join(paragraphs)


def chain(*steps):
    """Compose converters left to right: chain(f, g)(x) == g(f(x))."""

    def convert(value):
        for step in steps:
            value = step(value)
        return value

    return convert


def bounded(type_=int, low=None, high=None, low_exclusive=False):
    """Numeric converter with range validation."""

    def convert(text):
        value = type_(text)
        if low is not None:
            if value < low or (low_exclusive and value == low):
                raise ArgumentTypeError(
                    "value must be {} {}, got {}".format(
                        ">" if low_exclusive else ">=", low, value
                    )
                )
        if high is not None and value > high:
            raise ArgumentTypeError(
                "value must be <= {}, got {}".format(high, value)
            )
        return value

    return convert


def positive(type_=int, inclusive=False):
    """A number > 0 (or >= 0 when ``inclusive``)."""
    return bounded(type_, low=0, low_exclusive=not inclusive)


def between(min_val=None, max_val=None, type_=int):
    return bounded(type_, low=min_val, high=max_val)


probability = between(0, 1, float)


def CharList(choices):
    """A bare string of characters, each drawn from ``choices``."""
    allowed = frozenset(choices)

    def convert(text):
        chars = list(text)
        bad = [c for c in chars if c not in allowed]
        if bad:
            raise ArgumentTypeError(
                "invalid characters {!r}; allowed: {}".format(
                    "".join(bad), "".join(sorted(allowed))
                )
            )
        return chars

    return convert


def Delimited(delim=",", data_type=None, choices=None, min_len=None, max_len=None):
    """A delimiter-separated list with optional per-item conversion,
    ``*``-expansion to all choices, and length bounds."""

    def convert(value):
        if isinstance(value, str):
            items = value.split(delim) if delim else (value,)
        else:
            items = value
        if choices is not None and items[0] == "*":
            items = choices
        if data_type:
            items = [data_type(item) for item in items]
        if min_len and len(items) < min_len:
            raise ArgumentTypeError(
                "there must be at least {} values".format(min_len)
            )
        if max_len and len(items) > max_len:
            raise ArgumentTypeError(
                "there can be at most {} values".format(max_len)
            )
        return items

    return convert


def _readable(kind):
    """Path converter asserting read access (std streams pass through)."""

    def convert(path):
        if kind == "f" and path in (STDOUT, STDERR):
            return path
        return check_path(path, kind, os.R_OK)

    return convert


def _writeable(kind):
    def convert(path):
        if kind == "f" and path in (STDOUT, STDERR):
            return path
        return check_writeable(path, kind)

    return convert


def existing_path(path):
    if path == STDOUT:
        return path
    return resolve_path(path)


readable_file = chain(existing_path, _readable("f"))
writeable_file = _writeable("f")


def readwriteable_file(path):
    """A file that will be read if present and (re)written either way."""
    if os.path.exists(path):
        path = _readable("f")(path)
    return _writeable("f")(path)


def readable_url(url):
    parsed = urllib.parse.urlparse(url)
    if (parsed.scheme or "file") == "file":
        return "file:" + readable_file(parsed.path)
    return url


str_list = Delimited(data_type=str)

INT_OR_STR_RE = re.compile(r"([\d\.]+)([KkMmGg]?)")


def int_or_str(arg):
    """int() that also accepts K/M/G magnitude suffixes."""
    if arg is None or isinstance(arg, int):
        return arg
    if not isinstance(arg, str):
        raise ValueError("Unsupported type {}".format(arg))
    num, mult = INT_OR_STR_RE.match(arg.upper()).groups()
    return int(float(num) * MAGNITUDE.get(mult, 1))


def configure_threads(options, parser):
    """Resolve ``--threads``: 0/negative means all cores; 1 is an error
    (use the serial pipeline instead); debug mode is single-process only."""
    if options.debug:
        parser.error("Cannot use debug mode with multiple threads")
    if options.threads == 1:
        parser.error("--threads must be >= 2")
    options.threads = (
        cpu_count() if options.threads <= 0 else options.threads
    )
    return options.threads


def parse_stat_args(args_str):
    """';'-separated key[=value] flags -> dict (bare keys become True)."""
    parsed = {}
    for part in args_str.split(";"):
        key, eq, value = part.partition("=")
        parsed[key] = value if eq else True
    return parsed
