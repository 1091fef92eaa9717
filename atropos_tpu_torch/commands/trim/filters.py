"""Read-discarding criteria and their routing container.

Each criterion is a predicate over a single read; wrappers lift it to
record pairs (single-end / legacy mode inspects only read1, "both" mode
requires ``min_affected`` of the two reads to match). ``Filters.filter``
returns the *type* of the first criterion that fires — downstream, that
type is the routing key selecting which output file receives the record.
Semantics per the reference (``atropos/commands/trim/filters.py:20-233``).
"""
from collections import OrderedDict

DISCARD = True
KEEP = False


# -- criteria (single-read predicates) ----------------------------------------


class NoFilter:
    """Sentinel criterion: the destination key for kept records."""

    name = "NoFilter"

    def __call__(self, read):
        return False


class TooShortReadFilter:
    name = "too_short"

    def __init__(self, minimum_length):
        self.minimum_length = minimum_length

    def __call__(self, read):
        return len(read) < self.minimum_length


class TooLongReadFilter:
    name = "too_long"

    def __init__(self, maximum_length):
        self.maximum_length = maximum_length

    def __call__(self, read):
        return len(read) > self.maximum_length


class NContentFilter:
    """Too many ambiguous bases: an absolute count when the cutoff is
    >= 1, otherwise a fraction of the read length."""

    name = "too_many_n"

    def __init__(self, count):
        assert count >= 0
        self.is_proportion = count < 1.0
        self.cutoff = count

    def __call__(self, read):
        found = read.sequence.lower().count("n")
        if not self.is_proportion:
            return found > self.cutoff
        return len(read) > 0 and found / len(read) > self.cutoff


class UntrimmedFilter:
    def __call__(self, read):
        return read.match is None


class TrimmedFilter:
    def __call__(self, read):
        return read.match is not None


class MergedReadFilter:
    def __call__(self, read):
        return read.merged


# -- pair-level wrappers -------------------------------------------------------


class FilterWrapper:
    """Lifts a criterion to record pairs and counts what it discards."""

    def __init__(self, criterion):
        self.filter = criterion
        self.filtered = 0

    def __call__(self, read1, read2=None):
        if self._filter(read1, read2):
            self.filtered += 1
            return DISCARD
        return KEEP

    def _filter(self, read1, read2=None):
        raise NotImplementedError()

    @property
    def name(self):
        return getattr(self.filter, "name", self.filter.__class__.__name__)

    def summarize(self):
        return dict(records_filtered=self.filtered)


class SingleWrapper(FilterWrapper):
    """Single-end and legacy paired mode: only read1 decides."""

    def _filter(self, read1, read2=None):
        return self.filter(read1)


class PairedWrapper(FilterWrapper):
    """'both' paired mode: the pair is discarded when at least
    ``min_affected`` (1 = any, 2 = both) reads match the criterion.
    A missing read2 counts as matching."""

    def __init__(self, criterion, min_affected=1):
        super().__init__(criterion)
        if min_affected not in (1, 2):
            raise ValueError("min_affected must be 1 or 2")
        self.min_affected = min_affected

    def _filter(self, read1, read2):
        first = self.filter(read1)
        if self.min_affected == 1 and first:
            return True
        if self.min_affected == 2 and not first:
            return False
        return read2 is None or self.filter(read2)


class FilterFactory:
    """Builds the appropriate wrapper for the pipeline's pairing mode."""

    def __init__(self, paired, min_affected):
        self.paired = paired
        self.min_affected = min_affected

    def __call__(self, filter_type, *args, **kwargs):
        criterion = filter_type(*args, **kwargs)
        if self.paired == "both":
            return PairedWrapper(criterion, self.min_affected)
        return SingleWrapper(criterion)


class Filters:
    """Registration-ordered criteria; the first to fire routes the record."""

    def __init__(self, filter_factory):
        self.filters = OrderedDict()
        self.filter_factory = filter_factory

    def add_filter(self, filter_type, *args, **kwargs):
        self.filters[filter_type] = self.filter_factory(
            filter_type, *args, **kwargs
        )

    def filter(self, read1, read2=None):
        for filter_type, wrapper in self.filters.items():
            if wrapper(read1, read2):
                return filter_type
        return NoFilter

    def __contains__(self, filter_type):
        return filter_type in self.filters

    def __getitem__(self, filter_type):
        return self.filters[filter_type]

    def summarize(self):
        return {
            wrapper.name: wrapper.summarize()
            for wrapper in self.filters.values()
        }
