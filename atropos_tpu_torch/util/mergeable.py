"""Summary-merge algebra.

Every pipeline component reports its statistics as a tree of plain values
and the counter types below. Trees produced by independent shards (worker
processes, distributed hosts, device partitions) combine associatively:
numbers add, counters add keywise, constants must agree, containers
recurse. These classes are the host-side representation that reports
consume.

Behavioral contract follows the reference summary machinery
(``atropos/util/__init__.py:176-464``) so report output is unchanged.
"""
from collections import Counter, OrderedDict, defaultdict
from collections.abc import Iterable
from numbers import Number


class Mergeable:
    """A value that knows how to combine itself with a same-typed peer."""

    def merge(self, other):
        raise NotImplementedError()


class Summarizable:
    """A value that collapses itself to plain data for reporting."""

    def summarize(self):
        raise NotImplementedError()


class Const(Mergeable):
    """A value that must be identical in every shard's summary.

    Merging is an equality assertion — useful for run metadata that gets
    replicated into each worker's summary and must not silently diverge.
    """

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def merge(self, other):
        if self != other:
            raise ValueError("mismatched constants: {} != {}".format(self, other))
        return self

    def __eq__(self, other):
        peer = other.value if isinstance(other, Const) else other
        return self.value == peer

    def __repr__(self):
        return str(self.value)


def ordered_dict(items):
    """An insertion-ordered dict built from (key, value) pairs."""
    return OrderedDict(items)


class CountingDict(Counter, Mergeable, Summarizable):
    """Counter with a configurable summary rendering.

    ``sort_by=0`` renders sorted by key, ``sort_by=1`` by count;
    ``summary_type`` picks a dict or tuple-of-pairs rendering.
    """

    def __init__(self, keys=None, sort_by=0, summary_type="dict"):
        super().__init__(keys or ())
        self.sort_by = sort_by
        self.summary_type = summary_type

    def increment(self, key, inc=1):
        self[key] += inc

    def __reduce__(self):
        # Counter's own __reduce__ would drop the rendering attributes;
        # summaries cross process boundaries (worker queues), so preserve
        # them explicitly.
        return (
            _restore_counting_dict,
            (type(self), dict(self), self.sort_by, self.summary_type),
        )

    def merge(self, other):
        if not isinstance(other, CountingDict):
            raise ValueError(
                "cannot merge {} into a CountingDict".format(type(other))
            )
        self.update(other)
        return self

    def get_sorted_items(self):
        return sorted(self.items(), key=lambda pair: pair[self.sort_by])

    def summarize(self):
        items = self.get_sorted_items()
        if self.summary_type == "dict":
            return ordered_dict(items)
        return tuple(items)


class Histogram(CountingDict):
    """CountingDict whose summary adds weighted distribution statistics."""

    def summarize(self):
        from atropos_tpu_torch.util.stats import weighted_summary

        return dict(
            hist=super().summarize(),
            summary=weighted_summary(tuple(self.keys()), tuple(self.values())),
        )


class NestedDict(defaultdict, Mergeable, Summarizable):
    """Two-level counter table: outer key -> CountingDict, auto-created.

    Summarized either "long" (a flat tuple of (k1, k2, count) triples) or
    "wide" (a dense table over the union of inner keys).
    """

    def __init__(self, shape="wide"):
        super().__init__(CountingDict)
        self.shape = shape

    def __reduce__(self):
        # defaultdict's __reduce__ would pass the factory as ``shape``
        return (_restore_nested_dict, (type(self), self.shape, dict(self)))

    def merge(self, other):
        if not isinstance(other, NestedDict):
            raise ValueError(
                "cannot merge {} into a NestedDict".format(type(other))
            )
        for key, counts in other.items():
            if key in self:
                self[key].merge(counts)
            else:
                self[key] = counts
        return self

    def summarize(self):
        outer = sorted(self.keys())
        if self.shape == "long":
            return tuple(
                (key1, key2, count)
                for key1 in outer
                for key2, count in self[key1].items()
            )
        inner = sorted(set().union(*(self[key].keys() for key in outer))) if outer else []
        return dict(
            columns=tuple(inner),
            rows=ordered_dict(
                (key1, tuple(self[key1].get(key2, 0) for key2 in inner))
                for key1 in outer
            ),
        )


def _restore_counting_dict(cls, counts, sort_by, summary_type):
    restored = cls(sort_by=sort_by, summary_type=summary_type)
    restored.update(counts)
    return restored


def _restore_nested_dict(cls, shape, contents):
    restored = cls(shape=shape)
    restored.update(contents)
    return restored


class MergingDict(OrderedDict, Mergeable):
    """Ordered dict whose merge recursively applies the value algebra."""

    def merge(self, other):
        merge_dicts(self, other)
        return self


def merge_dicts(dest, src):
    """Merge ``src`` into ``dest`` in place, key by key.

    A missing or None destination slot adopts the source value; a None
    source leaves the destination untouched; otherwise the typed value
    rules below combine the two.
    """
    for key, incoming in src.items():
        current = dest.get(key)
        if current is None:
            dest[key] = incoming
        elif incoming is not None:
            dest[key] = merge_values(current, incoming)


# The value-combination rules, tried in order. Order matters: Mergeable
# beats dict (CountingDict is both), str beats Iterable, Number beats
# nothing else. Each rule is (predicate, combiner); the first predicate
# accepting the destination value wins.


def _merge_mergeable(dest, src):
    return dest.merge(src)


def _merge_mapping(dest, src):
    assert isinstance(src, dict)
    merge_dicts(dest, src)
    return dest


def _merge_string(dest, src):
    assert dest == src
    return dest


def _merge_number(dest, src):
    return dest + src


def _merge_sequence(dest, src):
    left, right = tuple(dest), tuple(src)
    if not left:
        return right
    if not right:
        return dest
    return [merge_values(a, b) for a, b in zip(left, right)]


_MERGE_RULES = (
    (Mergeable, _merge_mergeable),
    (dict, _merge_mapping),
    (str, _merge_string),
    (Number, _merge_number),
    (Iterable, _merge_sequence),
)


def merge_values(dest, src):
    """Combine two summary values by the first matching typed rule."""
    for accepts, combine in _MERGE_RULES:
        if isinstance(dest, accepts):
            return combine(dest, src)
    assert dest == src
    return dest
