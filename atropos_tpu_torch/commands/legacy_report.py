"""Cutadapt/Atropos-style plain-text reports.

Layout-compatible with the reference
(``atropos/commands/legacy_report.py:223-942``): a run summary, the
trimming count/bp tables, per-adapter removed-length histograms with
expected-by-chance columns and per-length error-count mini-histograms,
adjacent-base warnings, and the pre-/post-trim read-statistics tables
(``--stats``). The byte-level layout equals that of
``atropos_tpu/commands/legacy_report.py``.
"""
import math
import textwrap

from atropos_tpu_torch.io import open_output
from atropos_tpu_torch.util import truncate_string, weighted_median

INDENT = "  "
PARAGRAPH = textwrap.TextWrapper()
INDENTED = textwrap.TextWrapper(initial_indent=INDENT, subsequent_indent=INDENT)


def _column_width(*values, seps=True, prec=1):
    """Formatted width of the widest value (commas included)."""
    sample = values[0]
    if isinstance(sample, str):
        return max(len(v) for v in values)
    if isinstance(sample, int):
        width = len(str(max(values)))
        if seps:
            width += width // 3
        return width
    if isinstance(sample, float):
        width = len(str(round(max(values), prec)))
        if seps:
            width += (width - prec - 1) // 3
        return width
    raise ValueError("Unexpected data type: {}".format(sample.__class__))


# exported under the reference-compatible name
sizeof = _column_width


def _as_tuple(value, scalar_type):
    return (value,) if isinstance(value, scalar_type) else tuple(value)


class Printer:
    """print() bound to a file, with optional indent prefixes."""

    def __init__(self, outfile, indent=None, **kwargs):
        self.outfile = outfile
        self.indent = indent
        self.print_args = kwargs

    def _print(self, *args, **kwargs):
        merged = dict(self.print_args, **kwargs) if self.print_args else kwargs
        print(*args, file=self.outfile, **merged)

    def __call__(self, *args, indent=None, **kwargs):
        if isinstance(indent, int):
            indent = self.indent * indent
        else:
            indent = indent or self.indent
        if indent:
            self._print(indent, end="")
        self._print(*args, **kwargs)

    def newline(self):
        print(file=self.outfile)


class TitlePrinter(Printer):
    """Section titles with per-level over/underline characters."""

    def __init__(
        self,
        outfile,
        levels=(("=", "="), ("-", "-"), ("-", None), ("~", None)),
        **kwargs,
    ):
        super().__init__(outfile, **kwargs)
        self.levels = levels

    def __call__(self, *title, level=None, newline=True, **kwargs):
        text = " ".join(title)
        if level is None:
            self._print(text, **kwargs)
        else:
            if level >= len(self.levels):
                raise ValueError("Invalid level: {}".format(level))
            underline, overline = self.levels[level]
            if overline is True:
                overline = underline
            if overline:
                self._print(overline * len(text), **kwargs)
            self._print(text, **kwargs)
            if underline:
                self._print(underline * len(text), **kwargs)
        if newline:
            self.newline()


class RowPrinter(Printer):
    """Aligned table rows: per-column widths, justification, indents.

    ints render with thousands separators, floats with one decimal (as a
    percentage when ``pct``), strings are truncated to the column.
    """

    def __init__(
        self,
        outfile,
        colwidths=10,
        justification=("<", ">"),
        indent="",
        pct=False,
        default=0,
        **kwargs,
    ):
        super().__init__(outfile, **kwargs)
        self.colwidths = _as_tuple(colwidths, int)
        self.justification = _as_tuple(justification, str)
        self.indent = _as_tuple(indent, str)
        self.pct = pct
        self.default = default

    @staticmethod
    def _fit(values, ncols, extra=None):
        """Pad/trim a per-column setting tuple to exactly ncols."""
        if len(values) == ncols:
            return values
        if len(values) > ncols:
            return values[:ncols]
        filler = extra if extra is not None else values[-1]
        return values + (filler,) * (ncols - len(values))

    def _render_cell(self, position, value, width, just, ind, pct):
        if value is None:
            value = self.default
        if isinstance(value, str):
            spec = "s"
            if len(value) > width:
                value = truncate_string(value, width)
        elif isinstance(value, float):
            spec = ",.1" + ("%" if pct else "f")
        else:
            spec = ",d"
        template = "{ind}{{{i}:{just}{width}{spec}}}".format(
            ind=ind, i=position, just=just, width=width - len(ind), spec=spec
        )
        return template, value

    def __call__(
        self,
        *args,
        colwidths=None,
        extra_width=None,
        justification=None,
        extra_justification=None,
        indent=None,
        extra_indent=None,
        header=False,
        underline="-",
        pct=None,
        default=None,
        **kwargs,
    ):
        ncols = len(args)
        if ncols == 0:
            self.newline()
            return
        if pct is None:
            pct = self.pct
        if default is not None:
            # per-call default for None cells
            saved_default, self.default = self.default, default
        try:
            widths = self._fit(colwidths or self.colwidths, ncols, extra_width)
            justs = self._fit(
                justification or self.justification, ncols, extra_justification
            )
            indents = self._fit(indent or self.indent, ncols, extra_indent)
            if header:
                widths = tuple(
                    max(w, len(str(a))) for w, a in zip(widths, args)
                )
            templates = []
            cells = []
            for i, (value, width, just, ind) in enumerate(
                zip(args, widths, justs, indents)
            ):
                template, cell = self._render_cell(
                    i, value, width, just, ind, pct
                )
                templates.append(template)
                cells.append(cell)
            self._print(" ".join(templates).format(*cells), **kwargs)
            if header:
                self._print(
                    " ".join(underline * w for w in widths), **kwargs
                )
        finally:
            if default is not None:
                self.default = saved_default

    def print_rows(self, *rows, header=None, **kwargs):
        """Print a header + body with widths fitted to the data."""
        widths = tuple(_column_width(*col) for col in zip(*rows))
        if header:
            if isinstance(header[0], str):
                header_widths = (_column_width(h) for h in header)
                header_rows = [header]
            else:
                header_widths = (
                    max(_column_width(part) for part in column)
                    for column in header
                )
                header_rows = list(zip(*header))
            widths = tuple(max(h, c) for h, c in zip(header_widths, widths))
            for i, row in enumerate(header_rows, 1):
                self(
                    *row,
                    colwidths=widths,
                    header=(i == len(header_rows)),
                    **kwargs,
                )
        for row in rows:
            self(*row, colwidths=widths)


# -- entry points ----------------------------------------------------------------


def generate_report(summary, outfile):
    """Full legacy report: summary + trim + pre/post stats sections."""
    print_summary_report(summary, outfile)
    if "trim" in summary:
        print_trim_report(summary, outfile)
    if "pre" in summary:
        print_pre_trim_report(summary, outfile)
    if "post" in summary:
        print_post_trim_report(summary, outfile)


def generate_trim_report(summary, outfile):
    with open_output(outfile, "w", context_wrapper=True) as out:
        generate_report(summary, out)


# -- run summary -------------------------------------------------------------------


def print_summary_report(summary, outfile):
    title = TitlePrinter(outfile)
    emit = Printer(outfile)

    title("Atropos", level=0)
    emit("Atropos version: {}".format(summary["version"]))
    emit("Python version: {}".format(summary["python"]))
    emit(
        "Command line parameters: {} {}".format(
            summary["command"], " ".join(summary["options"]["orig_args"])
        )
    )
    emit()
    emit("Sample ID: {}".format(summary["sample_id"]))
    emit("Input format: {}".format(summary["derived"]["input_format"]))
    emit("Input files:")
    for infile in summary["input"]["input_names"]:
        if infile is not None:
            emit(infile, indent=INDENT)
    emit()

    timing = summary["timing"]
    total = summary["total_record_count"]
    wallclock = ["Wallclock time: {:.2F} s".format(timing["wallclock"])]
    if total > 0:
        wallclock.append(
            "({0:.0F} us/read; {1:.2F} M reads/minute)".format(
                1e6 * timing["wallclock"] / total,
                total / timing["wallclock"] * 60 / 1e6,
            )
        )
    emit("Start time: {}".format(timing["start"]))
    emit(*wallclock)
    emit("CPU time (main process): {0:.2F} s".format(timing["cpu"]))
    emit()


# -- trimming section ----------------------------------------------------------------


def print_trim_report(summary, outfile):
    _TrimSection(summary, outfile).write()


class _TrimSection:
    """The Trimming tables: record counts, bp counts, adapter details."""

    def __init__(self, summary, outfile):
        self.summary = summary
        self.outfile = outfile
        self.paired = summary["options"]["paired"]
        self.pairs_or_reads = "Pairs" if self.paired else "Reads"
        self.total_bp = sum(summary["total_bp_counts"])
        self.total = summary["total_record_count"]
        width = len(str(self.total_bp))
        self.max_width = width + width // 3  # room for comma separators
        self.title = TitlePrinter(outfile)
        self.row = RowPrinter(outfile, (35, self.max_width))

    def write(self):
        if self.total == 0:
            Printer(self.outfile)(
                "No reads processed! Either your input file is empty or you "
                "used the wrong -f/--format parameter."
            )
            return
        sections = self.summary["trim"]
        self.modifiers = sections["modifiers"]
        self.filters = sections["filters"]
        self.formatters = sections["formatters"]
        self._classify_modifiers()

        self.title("Trimming", level=1)
        self._write_record_counts()
        self.row()
        self._write_bp_counts()
        if self.adapter_cutter:
            self.row()
            print_adapter_report(
                self.adapter_cutter["adapters"],
                self.outfile,
                self.paired,
                self.total,
                self.max_width,
            )

    def _classify_modifiers(self):
        self.adapter_cutter = None
        error_corrector = None
        for stats in self.modifiers.values():
            if self.adapter_cutter is None and "adapters" in stats:
                self.adapter_cutter = stats
                break
            if error_corrector is None and "bp_corrected" in stats:
                error_corrector = stats
        self.error_corrector = error_corrector
        self.trimmers = [
            (name, stats)
            for name, stats in self.modifiers.items()
            if "bp_trimmed" in stats
        ]
        self.corrected = None
        if self.summary["options"]["correct_mismatches"]:
            for stats in self.modifiers.values():
                if "records_corrected" in stats:
                    self.corrected = stats

    def _write_record_counts(self):
        row = self.row
        row(self.pairs_or_reads, "records", "fraction", header=True)
        row(
            "Total {} processed:".format(
                "read pairs" if self.paired else "reads"
            ),
            self.total,
        )
        if self.adapter_cutter:
            hits = self.adapter_cutter["records_with_adapters"]
            fracs = self.adapter_cutter["fraction_records_with_adapters"]
            if self.paired:
                for read in range(2):
                    row(
                        "Read {} with adapter:".format(read + 1),
                        hits[read],
                        fracs[read],
                        indent=(INDENT, ""),
                        pct=True,
                    )
            else:
                row("Reads with adapters:", hits[0], fracs[0], pct=True)

        for key, phrase in (
            ("too_short", "that were"),
            ("too_long", "that were"),
            ("too_many_n", "with"),
        ):
            if key in self.filters:
                row(
                    "{} {} {}:".format(
                        self.pairs_or_reads, phrase, key.replace("_", " ")
                    ),
                    self.filters[key]["records_filtered"],
                    self.filters[key]["fraction_records_filtered"],
                    pct=True,
                )

        row(
            "{} written (passing filters):".format(self.pairs_or_reads),
            self.formatters["records_written"],
            self.formatters["fraction_records_written"],
            pct=True,
        )
        if self.corrected:
            row(
                "Pairs corrected:",
                self.corrected["records_corrected"],
                self.corrected["fraction_records_corrected"],
                pct=True,
            )

    def _write_bp_line(self, label, stats, key, default=0):
        row = self.row
        if self.paired:
            row(
                label,
                stats["total_" + key],
                stats["fraction_total_" + key],
                pct=True,
            )
            for read in range(2):
                row(
                    "Read {}:".format(read + 1),
                    stats[key][read],
                    stats["fraction_" + key][read],
                    indent=(INDENT, ""),
                    pct=True,
                    default=default,
                )
        else:
            row(
                label,
                stats[key][0],
                stats["fraction_" + key][0],
                pct=True,
                default=default,
            )

    def _write_bp_counts(self):
        row = self.row
        row("Base pairs", "bp", "fraction", header=True)
        row("Total bp processed:", self.total_bp)
        if self.paired:
            for read in range(2):
                row(
                    "Read {}:".format(read + 1),
                    self.summary["total_bp_counts"][read],
                    indent=(INDENT, ""),
                )
        for _, stats in self.trimmers:
            self._write_bp_line(stats["desc"], stats, "bp_trimmed")
        self._write_bp_line(
            "Total bp written (filtered):", self.formatters, "bp_written"
        )
        if self.error_corrector:
            self._write_bp_line(
                "Total bp corrected:", self.error_corrector, "bp_corrected"
            )


# -- adapter section -----------------------------------------------------------------


def print_adapter_report(adapters, outfile, paired, total_records, max_width):
    _AdapterSection(adapters, outfile, paired, total_records, max_width).write()


class _AdapterSection:
    """Per-adapter tables: removed-length histogram + expected-by-chance
    column + per-length error mini-histograms + adjacent-base warning."""

    def __init__(self, adapters, outfile, paired, total_records, max_width):
        self.adapters = adapters
        self.outfile = outfile
        self.paired = paired
        self.total_records = total_records
        self.emit = Printer(outfile)
        self.title = TitlePrinter(outfile)
        self.adj_row = RowPrinter(outfile, (12, 5), pct=True, indent=(INDENT, ""))
        self.seq_row = RowPrinter(
            outfile,
            (self._longest_sequence(), 14, 3, max_width),
            ("<", "<", ">"),
        )
        self.hist_row = RowPrinter(
            outfile, justification=(">", ">", ">", ">", "<")
        )
        self.incomplete_warning = False

    def _longest_sequence(self):
        lengths = []
        for side in self.adapters:
            for stats in (side or {}).values():
                if stats["where"]["name"] == "linked":
                    lengths.append(
                        3
                        + len(stats["front_sequence"] + stats["back_sequence"])
                    )
                else:
                    lengths.append(len(stats["sequence"]))
        return max(lengths)

    def write(self):
        for side in range(2 if self.paired else 1):
            if self.adapters[side] is None:
                continue
            header = "Adapter {}"
            if self.paired:
                header = (
                    "First read: " if side == 0 else "Second read: "
                ) + header
            for name, stats in self.adapters[side].items():
                if stats is not None:
                    self._write_one(header.format(name), stats)
        if self.incomplete_warning:
            self.emit("WARNING:")
            self.emit(
                "\n".join(
                    INDENTED.wrap(
                        "One or more of your adapter sequences may be "
                        "incomplete. Please see the detailed output above."
                    )
                )
            )

    def _write_one(self, header, stats):
        self.title(header, level=1)
        kind = stats["where"]["name"]
        if kind == "linked":
            front_len = len(stats["front_sequence"])
            back_len = len(stats["back_sequence"])
            self.seq_row.print_rows(
                (
                    "{}...{}".format(
                        stats["front_sequence"], stats["back_sequence"]
                    ),
                    "linked",
                    "{}+{}".format(front_len, back_len),
                    stats["total_front"],
                    stats["total_back"],
                ),
                header=(
                    "Sequence", "Type", "Length", "Trimmed (x)",
                    "Half matches (x)",
                ),
            )
        else:
            seq_len = len(stats["sequence"])
            self.seq_row.print_rows(
                (
                    stats["sequence"],
                    stats["where"]["desc"],
                    seq_len,
                    stats["total"],
                ),
                header=("Sequence", "Type", "Length", "Trimmed (x)"),
            )
        self.emit()
        if stats["total"] == 0:
            return

        if kind == "anywhere":
            self.emit(
                stats["total_front"],
                "times, it overlapped the 5' end of a read",
            )
            self.emit(
                stats["total_back"],
                "times, it overlapped the 3' end or was within the read",
            )
            self.emit()
            self._error_ranges(seq_len, stats["max_error_rate"])
            self.emit("Overview of removed sequences (5'):")
            self._histogram(stats, "lengths_front", "errors_front", seq_len)
            self.emit()
            self.emit("Overview of removed sequences (3' or within):")
            self._histogram(stats, "lengths_back", "errors_back", seq_len)
        elif kind == "linked":
            self._error_ranges(front_len, stats["front_max_error_rate"])
            self._error_ranges(back_len, stats["back_max_error_rate"])
            self.emit("Overview of removed sequences at 5' end:")
            self._histogram(
                stats, "front_lengths_front", "front_errors_front", front_len,
                error_rate=stats["front_max_error_rate"],
                probabilities=stats["front_match_probabilities"],
            )
            self.emit()
            self.emit("Overview of removed sequences at 3' end:")
            self._histogram(
                stats, "back_lengths_back", "back_errors_back", back_len,
                error_rate=stats["back_max_error_rate"],
                probabilities=stats["back_match_probabilities"],
            )
        elif kind in ("front", "prefix"):
            self._error_ranges(seq_len, stats["max_error_rate"])
            self.emit("Overview of removed sequences:")
            self._histogram(stats, "lengths_front", "errors_front", seq_len)
        elif kind in ("back", "suffix"):
            self._error_ranges(seq_len, stats["max_error_rate"])
            if self._adjacent_bases(stats["adjacent_bases"]):
                self.incomplete_warning = True
            self.emit("Overview of removed sequences:")
            self._histogram(stats, "lengths_back", "errors_back", seq_len)

    def _error_ranges(self, adapter_length, error_rate):
        """'No. of allowed errors' line: the length bands within which
        0, 1, 2, ... errors are permitted."""
        self.emit("No. of allowed errors:")
        band_start = 0
        max_errors = int(error_rate * adapter_length)
        for errors in range(1, max_errors + 1):
            band_end = int(errors / error_rate)
            self.emit(
                "{0}-{1} bp: {2};".format(band_start, band_end - 1, errors - 1),
                end=" ",
            )
            band_start = band_end
        if band_start == adapter_length:
            self.emit("{0} bp: {1}".format(adapter_length, max_errors))
        else:
            self.emit(
                "{0}-{1} bp: {2}".format(band_start, adapter_length, max_errors)
            )
        self.emit()

    def _histogram(
        self, stats, lengths_key, errors_key, adapter_length,
        error_rate=None, probabilities=None,
    ):
        if error_rate is None:
            error_rate = stats["max_error_rate"]
        if probabilities is None:
            probabilities = stats["match_probabilities"]
        data = stats[lengths_key]
        errors = stats[errors_key]

        rows = []
        error_rows = []
        for length, count in data.items():
            capped = min(length, adapter_length)
            rows.append(
                [
                    length,
                    count,
                    self.total_records * probabilities[capped],
                    int(error_rate * capped),
                ]
            )
            error_rows.append(errors["rows"][length])

        digit_widths = [len(str(max(col))) for col in zip(*error_rows)]

        def render_error_counts(counts):
            cells = []
            significant = False
            for i in range(len(counts) - 1, -1, -1):
                if not significant and counts[i] == 0:
                    continue  # suppress trailing zeros
                significant = True
                cells.append(
                    ("{:<" + str(digit_widths[i]) + "d}").format(counts[i])
                )
            return " ".join(reversed(cells))

        for row, counts in zip(rows, error_rows):
            row.append(render_error_counts(counts))

        error_header = " ".join(
            ("{:<" + str(width) + "d}").format(i)
            for i, width in enumerate(digit_widths)
        )
        self.hist_row.print_rows(
            *rows,
            header=(
                ("length", ""),
                ("count", ""),
                ("expect", ""),
                ("max.err", ""),
                ("error counts", error_header),
            ),
        )
        self.hist_row.newline()

    def _adjacent_bases(self, bases):
        """Base-composition table before removed 3' adapters; returns True
        when one base dominates suspiciously."""
        total = sum(bases.values())
        if total == 0:
            return False
        self.emit("Bases preceding removed adapters:")
        dominant = None
        for base in ("A", "C", "G", "T", ""):
            label = base if base else "none/other"
            fraction = 1.0 * bases[base] / total
            self.adj_row(label, fraction)
            if fraction > 0.8 and base:
                dominant = label
        if total >= 20 and dominant is not None:
            self.emit("WARNING:")
            self.emit(
                "\n".join(
                    INDENTED.wrap(
                        'The adapter is preceded by "{0}" extremely often. '
                        "The provided adapter sequence may be incomplete. To "
                        'fix the problem, add "{0}" to the beginning of the '
                        "adapter sequence.".format(dominant)
                    )
                )
            )
            self.emit()
            return True
        self.emit()
        return False


# -- read-statistics sections -----------------------------------------------------------


def print_pre_trim_report(summary, outfile):
    title = TitlePrinter(outfile)
    emit = Printer(outfile)
    title("Pre-trimming stats", level=1)
    for source, data in summary["pre"].items():
        _print_source_block(summary, title, emit)
        print_stats_report(data, outfile)


def print_post_trim_report(summary, outfile):
    title = TitlePrinter(outfile)
    emit = Printer(outfile)
    title("Post-trimming stats", level=1)
    for dest, stats in summary["post"].items():
        title("Destination: {}".format(dest), level=2)
        for source, data in stats.items():
            _print_source_block(summary, title, emit)
            print_stats_report(data, outfile)


def _print_source_block(summary, title, emit):
    title("Source", level=3, newline=False)
    for read, src in enumerate(summary["input"]["input_names"], 1):
        if src is not None:
            emit("Read {}: {}".format(read, src))
    emit()


def print_stats_report(data, outfile):
    _StatsSection(data, outfile).write()


class _StatsSection:
    """FastQC-style tables for one stats block; one column per mate."""

    def __init__(self, data, outfile):
        self._data = data
        self._reads = ["read1", "read2"] if "read2" in data else ["read1"]
        self._title = TitlePrinter(outfile)
        counts = max(self._data[r]["counts"] for r in self._reads)
        width = len(str(counts))
        width += (width // 3) + 1
        self._row = RowPrinter(outfile, (35, width))

    @property
    def paired(self):
        return len(self._reads) > 1

    def write(self):
        row = self._row
        row("", *("Read{}".format(i + 1) for i in range(len(self._reads))),
            header=True)
        row(
            "Read pairs:" if self.paired else "Reads:",
            *(self._data[r]["counts"] for r in self._reads),
        )
        row()
        self._histogram("Sequence lengths:", "lengths", "hist")
        self._histogram("Sequence qualities:", "qualities", "hist")
        self._histogram("Sequence GC content (%)", "gc", "hist")
        self._tile_histograms(
            "per-tile sequence qualities (%)", "tile_sequence_qualities"
        )
        self._base_histograms("base qualities (%)", "base_qualities")
        self._base_histograms("base composition (%)", "bases")
        self._tile_base_histograms(
            "per-tile base qualities (%)", "tile_base_qualities"
        )

    # -- table renderers ---------------------------------------------------

    def _histogram(self, heading, key1, key2):
        if key1 not in self._data["read1"]:
            return
        self._title(heading, level=2)
        hists = [self._data[r][key1][key2] for r in self._reads]
        if hists[0] is None:
            self._row("No Data")
        else:
            if self.paired:
                keys = sorted(set(hists[0]) | set(hists[1]))
                body = (
                    (k, hists[0].get(k, 0), hists[1].get(k, 0)) for k in keys
                )
            else:
                body = sorted(hists[0].items(), key=lambda x: x[0])
            for row in body:
                self._row(*row)
        self._row()

    def _base_table(self, heading, hist, extra_width=4, index_name="Pos"):
        self._title(heading, level=2)
        if hist is None:
            self._row("No Data")
            return
        self._row(
            index_name, *hist["columns"], header=True, extra_width=extra_width
        )
        for pos, counts in hist["rows"].items():
            total = sum(counts)
            self._row(
                pos,
                *(round(count * 100 / total, 1) for count in counts),
                extra_width=extra_width,
            )

    def _tile_width(self, ncolumns):
        per_tile = math.ceil(self._data["read1"]["counts"] / ncolumns)
        return max(4, len(str(per_tile))) + 1

    def _tile_histograms(self, heading, key):
        if key not in self._data["read1"]:
            return
        for read in self._reads:
            hist = self._data[read][key]
            label = "Read {} {}".format(read[-1], heading)
            if hist is None:
                self._title(label, level=2)
                self._row("No Data")
            else:
                self._base_table(
                    label,
                    hist,
                    extra_width=self._tile_width(len(hist["columns"])),
                    index_name="Tile",
                )
            self._row()

    def _base_histograms(self, heading, key):
        if key not in self._data["read1"]:
            return
        for read in self._reads:
            self._base_table(
                "Read {} {}".format(read[-1], heading), self._data[read][key]
            )
            self._row()

    def _tile_base_histograms(self, heading, key):
        if key not in self._data["read1"]:
            return
        for read in self._reads:
            self._one_tile_base_histogram(
                "Read {} {}".format(read[-1], heading), self._data[read][key]
            )
            if self.paired:
                self._row()

    def _one_tile_base_histogram(self, heading, hist):
        """Median quality per (position, tile)."""
        self._title(heading, level=2)
        if hist is None:
            self._row("No Data")
            return
        quals = hist["columns"]
        tiles = hist["columns2"]
        width = self._tile_width(len(tiles))
        self._row("Pos", *tiles, header=True, extra_width=width)
        for pos, tile_rows in hist["rows"].items():
            self._row(
                pos,
                *(
                    weighted_median(list(quals), list(counts))
                    for counts in tile_rows.values()
                ),
                extra_width=width,
            )
