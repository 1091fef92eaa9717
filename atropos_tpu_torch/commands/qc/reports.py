"""Report generator for the qc command."""
from atropos_tpu_torch.commands.reports import BaseReportGenerator
from atropos_tpu_torch.io import open_output


class ReportGenerator(BaseReportGenerator):
    def generate_text_report(self, fmt, summary, outfile, **kwargs):
        if fmt == "txt":
            from atropos_tpu_torch.commands.legacy_report import generate_stats_report

            with open_output(outfile, context_wrapper=True) as out:
                generate_stats_report(out, summary)
        else:
            super().generate_text_report(fmt, summary, outfile, **kwargs)
