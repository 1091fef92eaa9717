"""Trim record handler, statistics wrapper and summary.

The turbo runner (:mod:`atropos_tpu_torch.engine.turbo`) routes whole
batches as interval arithmetic; what it needs from here is the holder of
the modifier/filter/formatter stacks, whose ``summarize`` feeds the
report, the ``--stats`` wrapper that holds the pre- and post-trim
statistics tables the runner fills from its batch matrices, and the
summary class that derives the fraction/total fields. The per-record
scalar pipeline and the multi-process result handlers of
``atropos_tpu/commands/trim/pipeline.py`` are not part of this package.
"""
from collections.abc import Sequence

from atropos_tpu_torch.commands.base import Summary
from atropos_tpu_torch.commands.stats import (
    PairedEndReadStatistics,
    SingleEndReadStatistics,
)


class RecordHandler:
    """Holder of the modify -> filter -> format stacks of one run."""

    def __init__(self, modifiers, filters, formatters):
        self.modifiers = modifiers
        self.filters = filters
        self.formatters = formatters

    def summarize(self):
        return dict(
            trim=dict(
                modifiers=self.modifiers.summarize(),
                filters=self.filters.summarize(),
                formatters=self.formatters.summarize(),
            )
        )


class StatsRecordHandlerWrapper:
    """Pre- and/or post-trim statistics around a handler.

    Post-trim statistics are kept per destination filter, so reports can
    show the composition of kept vs discarded reads separately. The turbo
    runner fills the tables (``pre`` and ``post``: source -> statistics,
    ``post`` under each destination filter) from its batch matrices;
    ``kwargs`` go to every statistics object (``qualities``,
    ``quality_base``, ``device``), each side's options from
    ``stats_args`` beside them.
    """

    def __init__(self, record_handler, paired, stats_args, **kwargs):
        self.record_handler = record_handler
        self.read_statistics_class = (
            PairedEndReadStatistics if paired else SingleEndReadStatistics
        )
        self.pre = self.post = None
        if "pre" in stats_args:
            self.pre = {}
            self.pre_kwargs = dict(kwargs, **stats_args["pre"])
        if "post" in stats_args:
            self.post = {}
            self.post_kwargs = dict(kwargs, **stats_args["post"])

    def summarize(self):
        summary = self.record_handler.summarize()
        if self.pre is not None:
            summary["pre"] = {
                source: stats.summarize()
                for source, stats in self.pre.items()
            }
        if self.post is not None:
            # route filters without a short name (Trimmed/Untrimmed) fall
            # back to the class name, mirroring FilterWrapper.name
            summary["post"] = {
                getattr(dest, "name", dest.__name__): {
                    source: stats.summarize()
                    for source, stats in table.items()
                }
                for dest, table in self.post.items()
            }
        return summary


class TrimSummary(Summary):
    """Summary that derives fraction_*/total_* fields for count stats."""

    @staticmethod
    def _ratio(part, whole):
        return (part / whole) if part and whole != 0 else 0

    def _post_process_other(self, node, key, value):
        if self.has_exception or not isinstance(key, str):
            return
        if key.startswith("records_"):
            whole = self["total_record_count"]
            if isinstance(value, Sequence):
                node["fraction_" + key] = [
                    self._ratio(item, whole) for item in value
                ]
                node["total_" + key] = sum(item for item in value if item)
            else:
                node["fraction_" + key] = self._ratio(value, whole)
        elif key.startswith("bp_"):
            whole = self["sum_total_bp_count"]
            if isinstance(value, Sequence):
                node["fraction_" + key] = [
                    self._ratio(item, per_read)
                    for item, per_read in zip(value, self["total_bp_counts"])
                ]
                total = sum(item for item in value if item)
                node["total_" + key] = total
                node["fraction_total_" + key] = self._ratio(total, whole)
            else:
                node["fraction_" + key] = self._ratio(value, whole)
