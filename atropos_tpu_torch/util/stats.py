"""Descriptive statistics over plain and weighted (value, count) data.

Histograms in this framework are counters keyed by observed value, so all
distribution statistics come in a weighted form that consumes the counter
without expanding it. Plain-sequence forms exist for small host-side data
(e.g. per-tile medians in the read statistics).

Accumulation is deliberately sequential-left-to-right so values match the
reference report output digit for digit (``atropos/util/__init__.py:567-702``).
"""
import itertools
import statistics
from bisect import bisect_left


def _require_data(values, what):
    if len(values) == 0:
        raise ValueError(
            "Cannot determine the {} of an empty sequence".format(what)
        )


def _require_paired(values, counts):
    if len(values) != len(counts):
        raise ValueError("'values' and 'counts' must be the same length")


def mean(values):
    _require_data(values, "mean")
    return sum(values) / len(values)


def stdev(values, mu0=None):
    """Population standard deviation."""
    _require_data(values, "stdev")
    if len(values) == 1:
        return 0
    center = mean(values) if mu0 is None else mu0
    accum = 0
    for value in values:
        accum += (value - center) ** 2
    return (accum / len(values)) ** 0.5


def median(values):
    _require_data(values, "median")
    values.sort()
    return statistics.median(values)


def modes(values):
    _require_data(values, "mode")
    if len(values) == 1:
        return values
    tally = {}
    for value in values:
        tally[value] = tally.get(value, 0) + 1
    return _modal_values(tally.items())


def weighted_mean(values, counts):
    _require_data(values, "mean")
    _require_paired(values, counts)
    total = weight = 0
    for value, count in zip(values, counts):
        total += value * count
        weight += count
    return total / weight


def weighted_stdev(values, counts, mu0=None):
    """Population standard deviation of a weighted sample."""
    _require_data(values, "stdev")
    _require_paired(values, counts)
    if len(values) == 1:
        return 0
    center = weighted_mean(values, counts) if mu0 is None else mu0
    accum = weight = 0
    for value, count in zip(values, counts):
        accum += ((value - center) ** 2) * count
        weight += count
    return (accum / weight) ** 0.5


def weighted_median(values, counts):
    """Median of a weighted sample; None when all weights are zero."""
    _require_data(values, "median")
    _require_paired(values, counts)
    cumulative = list(itertools.accumulate(counts))
    total = cumulative[-1]
    if total == 0:
        return None
    # ranks (1-based) of the two middle elements; equal when total is odd
    upper_rank = total // 2 + 1
    lower_rank = upper_rank - 1 if total % 2 == 0 else upper_rank
    lower = values[bisect_left(cumulative, lower_rank)]
    upper = values[bisect_left(cumulative, upper_rank)]
    return float(lower + upper) / 2


def weighted_modes(values, counts):
    _require_data(values, "mode")
    _require_paired(values, counts)
    if len(values) == 1:
        return values
    return _modal_values(zip(values, counts))


def _modal_values(pairs):
    """All values sharing the maximum count, sorted ascending."""
    pairs = tuple(pairs)
    top = max(count for _, count in pairs)
    return sorted(value for value, count in pairs if count == top)


def weighted_summary(values, counts):
    """The four summary statistics reports print for a histogram."""
    center = weighted_mean(values, counts)
    return dict(
        mean=center,
        stdev=weighted_stdev(values, counts, center),
        median=weighted_median(values, counts),
        modes=weighted_modes(values, counts),
    )
