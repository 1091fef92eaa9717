"""Report generation framework (txt/json/yaml/pickle).

Structure and derived fields match the reference
(``atropos/commands/reports.py``); per-command text reports subclass
``BaseReportGenerator.generate_text_report``.
"""
import importlib
import os

from atropos_tpu_torch.io import STDERR, STDOUT, open_output
from atropos_tpu_torch.io.seqio import PAIRED

SERIALIZERS = dict(json="t", yaml="t", pickle="b")


class BaseReportGenerator:
    def __init__(self, options):
        report_file = options.report_file
        report_formats = options.report_formats
        if report_file in (STDOUT, STDERR):
            self.report_formats = report_formats or ("txt",)
            self.report_files = (report_file,) * len(self.report_formats)
        else:
            file_parts = os.path.splitext(report_file)
            self.report_formats = report_formats or (
                file_parts[1][1:] if file_parts[1] else "txt",
            )
            if len(self.report_formats) == 1:
                self.report_files = (report_file,)
            else:
                self.report_files = tuple(
                    "{}.{}".format(report_file, fmt) for fmt in self.report_formats
                )
        self.report_args = tuple(
            self.get_report_args(fmt, options) for fmt in self.report_formats
        )

    def get_report_args(self, fmt, options):
        return {}

    def generate_reports(self, summary):
        self.add_derived_data(summary)
        for fmt, outfile, kwargs in zip(
            self.report_formats, self.report_files, self.report_args
        ):
            if fmt in SERIALIZERS:
                mode = SERIALIZERS[fmt]
                self.serialize(summary, fmt, mode, outfile, **kwargs)
            else:
                self.generate_text_report(fmt, summary, outfile, **kwargs)

    def add_derived_data(self, summary):
        derived = {}
        derived["mean_sequence_lengths"] = tuple(
            None if bp is None else bp / summary["total_record_count"]
            for bp in summary["total_bp_counts"]
        )

        inp = summary["input"]
        fmt = inp["file_format"]
        if inp["input_read"] == PAIRED:
            fmt += ", Paired"
        else:
            fmt += ", Read {}".format(inp["input_read"])
        if inp["colorspace"]:
            fmt += ", Colorspace"
        if inp["interleaved"]:
            fmt += ", Interleaved"
        if inp["delivers_qualities"]:
            fmt += ", w/ Qualities"
        else:
            fmt += ", w/o Qualities"
        derived["input_format"] = fmt

        summary["derived"] = derived

    def serialize(self, obj, fmt, mode, outfile, **kwargs):
        mod = importlib.import_module(fmt)
        with open_output(outfile, "w" + mode, context_wrapper=True) as stream:
            mod.dump(obj, stream, **kwargs)

    def generate_text_report(self, fmt, summary, outfile, **kwargs):
        """Default text report: render a Jinja2 template for the format
        (reference ``atropos/commands/reports.py:107-110``). Commands
        override this for their purpose-built txt reports."""
        self.generate_from_template(fmt, summary, outfile, **kwargs)

    def generate_from_template(
        self,
        fmt,
        summary,
        outfile,
        template_name=None,
        template_paths=None,
        template_globals=None,
    ):
        """Render a report through a Jinja2 template named
        ``template.<fmt>`` discovered on ``template_paths`` plus the
        generator's ``template_path`` (reference
        ``atropos/commands/reports.py:112-170``)."""
        import jinja2

        if not template_name:
            template_name = "template.{}".format(fmt)
        if not template_paths:
            template_paths = []
        if hasattr(self, "template_path"):
            template_paths.append(self.template_path)

        try:
            env = jinja2.Environment(
                loader=jinja2.FileSystemLoader(template_paths)
            )
            if template_globals:
                env.globals.update(template_globals)
            template = env.get_template(template_name)
        except Exception:
            raise IOError(
                "Could not load template file '{}'".format(template_name)
            )

        report_output = template.render(summary=summary)

        is_path = isinstance(outfile, str)
        if is_path:
            stream = open_output(outfile, "w")
        else:
            stream = outfile
        try:
            print(report_output, file=stream)
        finally:
            if is_path:
                stream.close()


def prettyprint_summary(summary, outfile="summary.dump.txt"):
    from pprint import pprint

    with open(outfile, "w") as out:
        pprint(summary, out)
