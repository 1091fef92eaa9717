"""Output routing: destination filters -> formatters -> file handles.

A processed record's destination (the filter type that fired, or NoFilter
for kept reads) selects a sequence formatter; formatters append output
strings into a per-batch ``{path: [str]}`` result dict; ``Writers`` owns
the actual file handles and drains result dicts into them. Demultiplexing
replaces the ``{name}`` placeholder in the output template with the
matched adapter's name. Side files (info/rest/wildcard) are delimited
rows appended for every record. Output bytes are identical to the
reference (``atropos/commands/trim/writers.py:9-230``).
"""
import sys

from atropos_tpu_torch.commands.trim.filters import NoFilter
from atropos_tpu_torch.io import STDOUT, open_output, xopen
from atropos_tpu_torch.io.compression import splitext_compressed
from atropos_tpu_torch.io.seqio import create_seq_formatter


def add_suffix_to_path(path, suffix):
    """``out.fastq.gz`` + ``.3`` -> ``out.3.fastq.gz`` (shard naming)."""
    stem, format_ext, compression_ext = splitext_compressed(path)
    return "{}{}{}{}".format(stem, suffix, format_ext, compression_ext or "")


class Writers:
    """Lazily-opened output handles, keyed by logical path.

    In parallel-write mode every shard sets ``suffix`` so each worker
    owns private physical files for the same logical outputs. Paths in
    ``force_create`` are created even if no record ever routes to them.
    """

    def __init__(self, force_create=None):
        self.writers = {}
        self.force_create = list(force_create or ())
        self.suffix = None

    def get_writer(self, file_desc, compressed=False):
        mode = None
        if compressed:
            path, mode = file_desc
        else:
            path = file_desc
        handle = self.writers.get(path)
        if handle is None:
            physical = (
                add_suffix_to_path(path, self.suffix) if self.suffix else path
            )
            if compressed:
                # data arrives pre-compressed from workers: raw write
                handle = open_output(physical, mode)
            else:
                handle = xopen(physical, "w")
            self.writers[path] = handle
        return handle

    def write(self, file_desc, data, compressed=False):
        self.get_writer(file_desc, compressed).write(data)

    def write_result(self, result, compressed=False):
        for file_desc, data in result.items():
            self.write(file_desc, data, compressed)

    def close(self):
        for path in self.force_create:
            if path != STDOUT and path not in self.writers:
                xopen(path, "w").close()
        for handle in self.writers.values():
            if handle not in (sys.stdout, sys.stderr):
                handle.close()


class Formatters:
    """Destination-filter -> sequence-formatter routing table.

    Demultiplex formatters are created on first use per adapter name;
    info-file formatters run on every record regardless of destination.
    """

    def __init__(self, output, seq_formatter_args):
        self.output = output
        self.multiplexed = output is not None and "{name}" in output
        self.seq_formatter_args = seq_formatter_args
        self.seq_formatters = {}
        self.mux_formatters = {}
        self.info_formatters = []
        self.discarded = 0

    def add_seq_formatter(self, filter_type, file1, file2=None):
        self.seq_formatters[filter_type] = create_seq_formatter(
            file1, file2, **self.seq_formatter_args
        )

    def add_info_formatter(self, formatter):
        self.info_formatters.append(formatter)

    def get_mux_formatter(self, name):
        assert self.multiplexed
        formatter = self.mux_formatters.get(name)
        if formatter is None:
            formatter = create_seq_formatter(
                self.output.format(name=name), **self.seq_formatter_args
            )
            self.mux_formatters[name] = formatter
        return formatter

    def get_seq_formatters(self):
        """All formatters that wrote at least one record."""
        active = set()
        for formatter in self.seq_formatters.values():
            if formatter.written > 0:
                active.add(formatter)
        for formatter in self.mux_formatters.values():
            if formatter.written > 0:
                active.add(formatter)
        return active

    def format(self, result, dest, read1, read2=None):
        if self.multiplexed and dest == NoFilter and read1.match:
            target = self.get_mux_formatter(read1.match.adapter.name)
            target.format(result, read1, read2)
        elif dest in self.seq_formatters:
            self.seq_formatters[dest].format(result, read1, read2)
        else:
            self.discarded += 1
        for side in self.info_formatters:
            side.format(result, read1)
            if read2:
                side.format(result, read2)

    def summarize(self):
        active = self.get_seq_formatters()
        return dict(
            records_written=sum(f.written for f in active),
            bp_written=[
                sum(f.read1_bp for f in active),
                sum(f.read2_bp for f in active),
            ],
        )


# -- side files (delimited per-record rows) ------------------------------------


class DelimFormatter:
    """Base for side files: subclasses yield zero or more field rows per
    read; each row becomes one delimited output line."""

    delim = " "

    def __init__(self, path, delim=None):
        self.path = path
        if delim is not None:
            self.delim = delim

    def rows(self, read):
        raise NotImplementedError()

    def format(self, result, read):
        for fields in self.rows(read):
            line = self.delim.join(str(field) for field in fields)
            result[self.path].append(line + "\n")


class RestFormatter(DelimFormatter):
    """Sequence remaining after the adapter (``-r``)."""

    def rows(self, read):
        if read.match:
            rest = read.match.rest()
            if rest:
                yield (rest, read.name)


class InfoFormatter(DelimFormatter):
    """Per-match alignment details (``--info-file``)."""

    delim = "\t"

    def rows(self, read):
        if read.match:
            for match_info in read.match_info:
                yield match_info[0:11]
        else:
            yield (
                read.name,
                -1,
                read.sequence,
                read.qualities if read.qualities is not None else "",
            )


class WildcardFormatter(DelimFormatter):
    """Read bases matched by adapter wildcard positions (``-w``)."""

    def rows(self, read):
        if read.match:
            yield (read.match.wildcards(), read.name)
