"""Trim command report generator (txt/json/yaml/pickle + templates).

The legacy Cutadapt-style text report is produced by
``atropos_tpu_torch.commands.legacy_report``; other text formats render
Jinja2 ``template.<fmt>`` files from this package's ``templates``
directory or user-supplied paths (reference
``atropos/commands/trim/reports.py``).
"""
import os

from atropos_tpu_torch.commands.reports import BaseReportGenerator


class ReportGenerator(BaseReportGenerator):
    template_path = os.path.join(os.path.dirname(__file__), "templates")

    def generate_text_report(self, fmt, summary, outfile, **kwargs):
        if fmt == "txt":
            from atropos_tpu_torch.commands.legacy_report import generate_trim_report

            generate_trim_report(summary, outfile)
        else:
            super().generate_from_template(fmt, summary, outfile, **kwargs)
