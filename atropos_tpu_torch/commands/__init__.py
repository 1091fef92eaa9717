"""
Atropos-TPU version {}

usage: atropos [--config <config file>] <command> [options]

commands
--------
{}

optional arguments:
  -h, --help                show this help message and exit
  --config <config file>    provide options in a config file

Use "atropos <command> --help" to see all options for a specific command.
"""
import logging
import os
import re
import textwrap
from functools import cached_property
from importlib import import_module
from pkgutil import walk_packages

from atropos_tpu_torch import (
    DeviceUnavailableError,
    NotPortedError,
    __version__,
    resolve_device,
)


class Command:
    """One subcommand, resolved by package convention.

    A command is a package under ``atropos_tpu_torch.commands`` exposing
    ``CommandRunner`` (in ``__init__``), ``cli.CommandParser`` and
    ``reports.ReportGenerator``; the registry below discovers them by
    walking subpackages (reference convention:
    ``atropos/commands/__init__.py:156-159``).
    """

    def __init__(self, name):
        self.name = name
        self._package = "atropos_tpu_torch.commands." + name

    @cached_property
    def parser_class(self):
        return import_module(self._package + ".cli").CommandParser

    @cached_property
    def runner_class(self):
        return import_module(self._package).CommandRunner

    @cached_property
    def report_generator_class(self):
        return import_module(self._package + ".reports").ReportGenerator

    @property
    def usage(self):
        return self.parser_class.usage

    @property
    def description(self):
        return self.parser_class.description

    def get_help(self, fmt="* {name}: {description}", wrap=80, indent=2):
        text = fmt.format(name=self.name, description=self.description.strip())
        if wrap:
            text = "\n".join(
                textwrap.wrap(
                    re.sub(r"\s+", " ", text),
                    wrap,
                    subsequent_indent=" " * indent,
                )
            )
        return text

    def parse_args(self, args):
        return self.parser_class().parse(args)

    def run_command(self, options):
        return self.runner_class(options).run()

    def generate_reports(self, summary, options):
        self.report_generator_class(options).generate_reports(summary)

    def execute(self, args=(), device=None):
        """Parse, run, report. Returns (retcode, summary).

        The device is resolved before anything is opened or written:
        ``device`` overrides the parsed ``--device``, None means ``cuda``,
        and ``cuda`` without a usable card raises here.
        """
        options = self.parse_args(args)
        if device is not None:
            options.device = device
        options.device = str(resolve_device(getattr(options, "device", None)))
        retcode, summary = self.run_command(options)
        log = logging.getLogger()
        if retcode == 0 and options.report_file:
            log.debug("Writing report to %s", options.report_file)
            self.generate_reports(summary, options)
        else:
            log.debug("Not generating report file")
        return retcode, summary


COMMANDS = {
    name: Command(name)
    for _, name, ispkg in walk_packages([os.path.dirname(__file__)])
    if ispkg
}


def get_command(name):
    try:
        return COMMANDS[name]
    except KeyError:
        raise ValueError("Invalid command: {}".format(name))


def iter_commands():
    for name in sorted(COMMANDS):
        yield COMMANDS[name]


def print_subcommands():
    listing = "\n".join(command.get_help() for command in iter_commands())
    print(__doc__.format(__version__, listing))


def _read_config_args(path):
    """Tokenize an options file: whitespace-separated, newline-agnostic."""
    with open(path, "rt") as config:
        return [token for line in config for token in line.rstrip().split()]


def _split_command(args):
    """(command_name, remaining_args); a leading option implies 'trim'."""
    if not args or args[0].startswith("-"):
        return "trim", args
    return args[0], args[1:]


def execute_cli(args=(), device=None):
    """Top-level dispatch with ``--config FILE`` support.

    ``device`` is handed to :meth:`Command.execute`. A
    :class:`~atropos_tpu_torch.NotPortedError` and a missing card
    propagate to the caller; other errors are logged and return 2.

    Config-file tokens are prepended to the command's arguments; when the
    command line holds nothing but ``--config``, the command name itself
    comes from the file.
    """
    args = list(args)
    if not args or args[0] in ("-h", "--help"):
        print_subcommands()
        return 2

    config_args = None
    if args[0] == "--config":
        config_args = _read_config_args(args[1])
        args = args[2:]

    if args:
        command_name, args = _split_command(args)
        if config_args:
            args = config_args + args
    else:
        command_name, args = _split_command(config_args)

    command = get_command(command_name)
    try:
        retcode, summary = command.execute(args, device=device)
        if "exception" in summary:
            logging.getLogger().error(
                "Error executing command %s",
                command_name,
                exc_info=summary["exception"]["details"],
            )
        return retcode
    except (NotPortedError, DeviceUnavailableError):
        raise
    except Exception as err:
        logging.getLogger().error(
            "Error executing command: %s", command_name, exc_info=err
        )
        return 2
