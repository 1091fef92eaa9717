"""Trim record handler and summary.

The turbo runner (:mod:`atropos_tpu_torch.engine.turbo`) routes whole
batches as interval arithmetic; what it needs from here is the holder of
the modifier/filter/formatter stacks, whose ``summarize`` feeds the
report, and the summary class that derives the fraction/total fields.
The per-record scalar pipeline, the statistics wrapper and the
multi-process result handlers of ``atropos_tpu/commands/trim/pipeline.py``
are not part of this package.
"""
from collections.abc import Sequence

from atropos_tpu_torch.commands.base import Summary


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
