"""Host-side primitives: sequence alphabets, probability of chance
alignment matches, timing, and process-level error handling.

The summary-merge algebra lives in :mod:`atropos_tpu_torch.util.mergeable` and
the weighted statistics in :mod:`atropos_tpu_torch.util.stats`; both are
re-exported here as the package's stable surface. Observable numeric
behavior follows the reference (``atropos/util/__init__.py``) so that
RMP-gated trim decisions and report values reproduce exactly.
"""
import errno
import logging
import math
import time
from datetime import datetime

from atropos_tpu_torch import AtroposError
from atropos_tpu_torch.util.mergeable import (  # noqa: F401
    Const,
    CountingDict,
    Histogram,
    Mergeable,
    MergingDict,
    NestedDict,
    Summarizable,
    merge_dicts,
    merge_values,
    ordered_dict,
)
from atropos_tpu_torch.util.stats import (  # noqa: F401
    mean,
    median,
    modes,
    stdev,
    weighted_mean,
    weighted_median,
    weighted_modes,
    weighted_stdev,
)

LOG2 = math.log(2)

#: suffix multipliers accepted by CLI size arguments (e.g. ``--max-reads 2M``)
MAGNITUDE = dict(G=1e9, M=1e6, K=1e3)


# -- alphabets ---------------------------------------------------------------


class NotInAlphabetError(Exception):
    def __init__(self, character):
        super().__init__()
        self.character = character


class Alphabet:
    """A set of permitted characters plus the replacement used for any
    character outside it (``None`` means invalid characters are errors)."""

    __slots__ = ("valid_characters", "default_character")

    def __init__(self, valid_characters, default_character):
        permitted = set(valid_characters)
        if default_character is not None:
            permitted.add(default_character)
        self.valid_characters = permitted
        self.default_character = default_character

    def __contains__(self, character):
        return character in self.valid_characters

    def validate(self, character):
        if character not in self:
            raise NotInAlphabetError(character)

    def validate_string(self, string):
        for character in string:
            self.validate(character)

    def resolve(self, character):
        if character in self.valid_characters:
            return character
        return self.default_character

    def resolve_string(self, string):
        return "".join(map(self.resolve, string))


ALPHABETS = dict(
    dna=Alphabet("ACGT", "N"),
    iso=None,
    colorspace=Alphabet("0123", None),
)


# -- nucleotide complements ---------------------------------------------------

# Watson-Crick pairs plus IUPAC ambiguity-code pairs; the table is closed
# under complement and case.
_PAIRINGS = (
    ("A", "T"), ("C", "G"),
    ("R", "Y"), ("S", "S"), ("W", "W"), ("K", "M"),
    ("B", "V"), ("D", "H"), ("N", "N"),
)


def build_iso_nucleotide_table():
    table = {}
    for base, comp in _PAIRINGS:
        for one, two in ((base, comp), (comp, base)):
            table[one] = two
            table[one.lower()] = two.lower()
    return table


BASE_COMPLEMENTS = build_iso_nucleotide_table()

IUPAC_BASES = frozenset(("X",) + tuple(BASE_COMPLEMENTS.keys()))

GC_BASES = frozenset("CGRYSKMBDHVN")

_COMPLEMENTS = str.maketrans(BASE_COMPLEMENTS)


def complement(seq):
    """IUPAC-aware complement."""
    return seq.translate(_COMPLEMENTS)


def reverse_complement(seq):
    """IUPAC-aware reverse complement."""
    return complement(seq)[::-1]


def sequence_complexity(seq):
    """Shannon entropy (bits) of the ACGT composition, in [0, 2]."""
    seq = seq.upper()
    length = float(len(seq))
    entropy = 0.0
    for base in "ACGT":
        count = seq.count(base)
        if count:
            frac = count / length
            entropy -= frac * math.log(frac) / LOG2
    return entropy


# -- quality scores -----------------------------------------------------------


def qual2int(qual, base=33):
    return ord(qual) - base


def quals2ints(quals, base=33):
    return (ord(q) - base for q in quals)


def qual2prob(qchar):
    return 10 ** (-qual2int(qchar) / 10)


# -- chance-match probability --------------------------------------------------


class RandomMatchProbability:
    """P(>= ``matches`` of ``size`` random bases match), binomial tail.

    Gates adapter and insert matches (``--adapter-max-rmp``,
    ``--insert-max-rmp``). Results are memoized, and the factorial table
    grows on demand. The floating-point evaluation order is part of the
    contract: decisions near the threshold must reproduce the reference's
    (``atropos/util/__init__.py:104-174``) bit for bit.
    """

    def __init__(self, init_size=150):
        self.cache = {}
        self.factorials = [1] * init_size
        self.max_n = 1
        self.cur_array_size = init_size

    def __call__(self, matches, size, match_prob=0.25, mismatch_prob=0.75):
        key = (matches, size, match_prob)
        cached = self.cache.get(key)
        if cached:
            return cached
        if matches == size:
            prob = match_prob ** matches
        else:
            prob = self._binomial_tail(matches, size, match_prob, mismatch_prob)
        self.cache[key] = prob
        return prob

    def _binomial_tail(self, matches, size, match_prob, mismatch_prob):
        nfac = self.factorial(size)
        prob = 0.0
        for i in range(matches, size + 1):
            j = size - i
            # float division until the factorials outgrow float range,
            # then exact integer division (identical to the reference's
            # OverflowError fallback)
            try:
                div = nfac / self.factorial(i) / self.factorial(j)
            except OverflowError:
                div = nfac // self.factorial(i) // self.factorial(j)
            prob += (mismatch_prob ** j) * (match_prob ** i) * div
        return prob

    def factorial(self, num):
        if num > self.max_n:
            self._extend(num)
        return self.factorials[num]

    def _extend(self, num):
        if num >= self.cur_array_size:
            self.factorials += [1] * (num - self.cur_array_size + 1)
            self.cur_array_size = len(self.factorials)
        for idx in range(self.max_n, num):
            self.factorials[idx + 1] = (idx + 1) * self.factorials[idx]
        self.max_n = num


# -- timing -------------------------------------------------------------------


class Timestamp:
    """Wallclock + CPU clock snapshot."""

    def __init__(self):
        self.dtime = datetime.now()
        self.process_time = time.process_time()

    def timestamp(self):
        return self.dtime.timestamp()

    def isoformat(self):
        return self.dtime.isoformat()

    def __sub__(self, other, minval=0.01):
        return dict(
            wallclock=max(minval, self.timestamp() - other.timestamp()),
            cpu=max(minval, self.process_time - other.process_time),
        )


class Timing(Summarizable):
    """Context manager measuring a run; summarizes to start/wallclock/cpu."""

    def __init__(self):
        self.start_time = None
        self.cur_time = None

    def __enter__(self):
        self.start_time = Timestamp()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.update()

    def update(self):
        self.cur_time = Timestamp()

    def summarize(self):
        if self.cur_time is None:
            self.update()
        assert self.start_time is not None
        report = dict(start=self.start_time.isoformat())
        report.update(self.cur_time - self.start_time)
        return report


# -- misc ---------------------------------------------------------------------


def enumerate_range(collection, start, end):
    """Like enumerate() but only over indexes [start, end)."""
    source = iter(collection)
    for idx in range(start, end):
        yield idx, next(source)


def truncate_string(string, max_len=100):
    """Shorten to at most max_len characters, eliding with '...'."""
    if string is None:
        return None
    if len(string) > max_len:
        return string[: max_len - 3] + "..."
    return string


def run_interruptible(func, *args, **kwargs):
    """Run ``func``, translating failures to process exit codes.

    Ctrl-C -> 130, broken pipe -> 1, framework/EOF errors -> 1 (logged),
    anything else -> 1 (logged with traceback); success -> 0.
    """
    try:
        func(*args, **kwargs)
    except KeyboardInterrupt:
        logging.getLogger().error("Interrupted")
        return 130
    except IOError as err:
        if err.errno != errno.EPIPE:
            raise
        return 1
    except (AtroposError, EOFError):
        logging.getLogger().error("Atropos error", exc_info=True)
        return 1
    except Exception:  # pylint: disable=broad-except
        logging.getLogger().error("Unknown error", exc_info=True)
        return 1
    return 0
