"""Adapter model: type flags, the Adapter matcher, and linked adapters.

Match policy parity with the reference
(``atropos/adapters/__init__.py:231-505,615-745``): exact substring
first, then no-indel anchored comparison or the banded DP aligner,
validated against min-overlap / error-rate / max-RMP gates. The turbo
runner reads these objects' parameters — their translated sequences and
flags become the run-time arguments of the DP kernels
(:mod:`atropos_tpu_torch.align.cuda_kernel`) — while trim bookkeeping and
statistics stay here.
"""
from functools import reduce
from operator import or_

from atropos_tpu_torch import align
from atropos_tpu_torch.align import Match
from atropos_tpu_torch.adapters.parser import next_adapter_name, parse_braces
from atropos_tpu_torch.util import (
    ALPHABETS,
    Const,
    CountingDict,
    GC_BASES,
    IUPAC_BASES,
    MergingDict,
    NestedDict,
)


class AdapterType:
    """A named adapter placement and its alignment-flag encoding."""

    def __init__(self, name, desc, *flags):
        self.name = name
        self.desc = desc
        self.flags = reduce(or_, flags) if isinstance(flags[0], int) else flags[0]

    def asdict(self):
        return dict(name=self.name, desc=self.desc, flags=Const(self.flags))


ADAPTER_TYPES = dict(
    back=AdapterType(
        "back",
        "regular 3'",
        align.START_WITHIN_SEQ2,
        align.STOP_WITHIN_SEQ2,
        align.STOP_WITHIN_SEQ1,
    ),
    front=AdapterType(
        "front",
        "regular 5'",
        align.START_WITHIN_SEQ2,
        align.STOP_WITHIN_SEQ2,
        align.START_WITHIN_SEQ1,
    ),
    prefix=AdapterType("prefix", "anchored 5'", align.STOP_WITHIN_SEQ2),
    suffix=AdapterType("suffix", "anchored 3'", align.START_WITHIN_SEQ2),
    anywhere=AdapterType("anywhere", "variable 5'/3'", align.SEMIGLOBAL),
    linked=AdapterType("linked", "linked", "linked"),
)

BACK = ADAPTER_TYPES["back"].flags
FRONT = ADAPTER_TYPES["front"].flags
PREFIX = ADAPTER_TYPES["prefix"].flags
SUFFIX = ADAPTER_TYPES["suffix"].flags
ANYWHERE = ADAPTER_TYPES["anywhere"].flags
LINKED = ADAPTER_TYPES["linked"].flags


def where_int_to_dict(where):
    for adapter_type in ADAPTER_TYPES.values():
        if where == adapter_type.flags:
            return adapter_type.asdict()
    raise ValueError("Invalid WHERE value: {}".format(where))


def _normalize_sequence(sequence, adapter_wildcards, alphabet):
    """Uppercase, expand braces, validate the character set. Returns
    (sequence, effective adapter_wildcards)."""
    if len(sequence) == 0:
        raise ValueError("Empty adapter sequence")
    sequence = parse_braces(sequence.upper().replace("U", "T"))
    present = set(sequence)
    if present <= set("ACGT"):
        adapter_wildcards = False
    if adapter_wildcards and not present <= IUPAC_BASES:
        raise ValueError(
            "Invalid character(s) in adapter sequence: {}".format(
                ",".join(present - IUPAC_BASES)
            )
        )
    if alphabet:
        if isinstance(alphabet, str):
            alphabet = ALPHABETS[alphabet]
        alphabet.validate_string(sequence)
    return sequence, adapter_wildcards


class Adapter:
    """One adapter: sequence, placement, aligner, and trim statistics."""

    def __init__(
        self,
        sequence,
        where,
        max_error_rate=0.1,
        min_overlap=3,
        read_wildcards=False,
        adapter_wildcards=True,
        name=None,
        indels=True,
        indel_cost=1,
        match_probability=None,
        max_rmp=None,
        gc_content=0.5,
        alphabet=None,
    ):
        sequence, adapter_wildcards = _normalize_sequence(
            sequence, adapter_wildcards, alphabet
        )
        self.debug = False
        self.name = name if name is not None else next_adapter_name()
        self.sequence = sequence
        self.where = where
        self.max_error_rate = max_error_rate
        self.min_overlap = min(min_overlap, len(sequence))
        self.match_probability = match_probability
        self.max_rmp = max_rmp
        self.gc_content = gc_content
        self.indels = indels
        self.adapter_wildcards = adapter_wildcards
        self.read_wildcards = read_wildcards

        # placement decides the trim direction; 'anywhere' defers to the
        # match position
        self._front_flag = (
            None if where == ANYWHERE else where not in (BACK, SUFFIX)
        )
        self.trimmed = {
            FRONT: self._trimmed_front,
            PREFIX: self._trimmed_front,
            BACK: self._trimmed_back,
            SUFFIX: self._trimmed_back,
            ANYWHERE: self._trimmed_anywhere,
        }[where]

        # removed-length / error histograms for the report
        self.lengths_front = CountingDict()
        self.lengths_back = CountingDict()
        self.errors_front = NestedDict()
        self.errors_back = NestedDict()
        self.adjacent_bases = {"A": 0, "C": 0, "G": 0, "T": 0, "": 0}

        self.aligner = align.Aligner(
            sequence,
            max_error_rate,
            flags=where,
            wildcard_ref=adapter_wildcards,
            wildcard_query=read_wildcards,
        )
        self.aligner.min_overlap = self.min_overlap
        # no-indel mode suppresses indels by pricing them out of the band
        self.aligner.indel_cost = indel_cost if indels else 100000

    def __repr__(self):
        return (
            '<Adapter(name="{name}", sequence="{sequence}", where={where}, '
            "max_error_rate={max_error_rate}, min_overlap={min_overlap}, "
            "read_wildcards={read_wildcards}, "
            "adapter_wildcards={adapter_wildcards}, "
            "indels={indels})>".format(**vars(self))
        )

    def __len__(self):
        return len(self.sequence)

    def enable_debug(self):
        self.debug = True
        self.aligner.enable_debug()

    # -- matching -----------------------------------------------------------------

    def _find_exact(self, read_seq):
        """Position of a wildcard-free exact occurrence, or -1."""
        if self.adapter_wildcards:
            return -1
        if self.where == PREFIX:
            return 0 if read_seq.startswith(self.sequence) else -1
        if self.where == SUFFIX:
            if read_seq.endswith(self.sequence):
                return len(read_seq) - len(self.sequence)
            return -1
        return read_seq.find(self.sequence)

    def _align_approximate(self, read_seq):
        """No-indel anchored comparison, or the DP aligner."""
        if not self.indels and self.where in (PREFIX, SUFFIX):
            compare = (
                align.compare_prefixes
                if self.where == PREFIX
                else align.compare_suffixes
            )
            return compare(
                self.sequence,
                read_seq,
                wildcard_ref=self.adapter_wildcards,
                wildcard_query=self.read_wildcards,
            )
        alignment = self.aligner.locate(read_seq)
        if self.debug:
            print(self.aligner.dpmatrix)  # pragma: no cover
        return alignment

    def accepts(self, matches, errors, size):
        """The min-overlap / error-rate / RMP acceptance gates."""
        if size < self.min_overlap or errors / size > self.max_error_rate:
            return False
        return (
            self.max_rmp is None
            or self.match_probability(matches, size) <= self.max_rmp
        )

    def match_to(self, read):
        """Best acceptable match of this adapter to the read, or None."""
        read_seq = read.sequence.upper()

        pos = self._find_exact(read_seq)
        if pos >= 0:
            m = len(self.sequence)
            return Match(
                0, m, pos, pos + m, m, 0, self._front_flag, self, read
            )

        alignment = self._align_approximate(read_seq)
        if alignment:
            astart, astop, rstart, rstop, matches, errors = alignment
            if self.accepts(matches, errors, astop - astart):
                return Match(
                    astart, astop, rstart, rstop, matches, errors,
                    self._front_flag, self, read,
                )
        return None

    # -- trimming + statistics ------------------------------------------------------

    def _trimmed_anywhere(self, match):
        return (
            self._trimmed_front(match)
            if match.front
            else self._trimmed_back(match)
        )

    def _trimmed_front(self, match):
        self.lengths_front[match.rstop] += 1
        self.errors_front[match.rstop][match.errors] += 1
        return match.read[match.rstop :]

    def _trimmed_back(self, match):
        removed = len(match.read) - match.rstart
        self.lengths_back[removed] += 1
        self.errors_back[removed][match.errors] += 1
        neighbor = match.read.sequence[match.rstart - 1 : match.rstart]
        if neighbor not in "ACGT":
            neighbor = ""
        self.adjacent_bases[neighbor] += 1
        return match.read[: match.rstart]

    def random_match_probabilities(self):
        """probabilities[i] = P(last i bases match a random sequence),
        scanning from the matching end inward."""
        seq = self.sequence[::-1] if self._front_flag else self.sequence
        p_gc = self.gc_content / 2.0
        p_at = (1 - self.gc_content) / 2.0
        gc_like = frozenset(GC_BASES if self.adapter_wildcards else "GC")
        probabilities = [1.0] * (len(seq) + 1)
        running = 1.0
        for idx, base in enumerate(seq, 1):
            running *= p_gc if base in gc_like else p_at
            probabilities[idx] = running
        return probabilities

    def summarize(self):
        total_front = sum(self.lengths_front.values())
        total_back = sum(self.lengths_back.values())
        where = self.where
        assert (
            where in (ANYWHERE, LINKED)
            or (where in (BACK, SUFFIX) and total_front == 0)
            or (where in (FRONT, PREFIX) and total_back == 0)
        )
        stats = MergingDict(
            adapter_class=self.__class__.__name__,
            total_front=total_front,
            total_back=total_back,
            total=total_front + total_back,
            match_probabilities=Const(self.random_match_probabilities()),
        )
        stats["where"] = where_int_to_dict(where)
        stats["sequence"] = Const(self.sequence)
        stats["max_error_rate"] = Const(self.max_error_rate)
        if where in (ANYWHERE, FRONT, PREFIX):
            stats["lengths_front"] = self.lengths_front
            stats["errors_front"] = self.errors_front
        if where in (ANYWHERE, BACK, SUFFIX):
            stats["lengths_back"] = self.lengths_back
            stats["errors_back"] = self.errors_back
        if where in (BACK, SUFFIX):
            stats["adjacent_bases"] = self.adjacent_bases
        return stats


class LinkedMatch:
    """Match of a linked adapter; the front part is always present."""

    def __init__(self, front_match, back_match, adapter):
        assert front_match is not None
        self.front_match = front_match
        self.back_match = back_match
        self.adapter = adapter

    def get_info_record(self):
        chosen = self.back_match or self.front_match
        return chosen.get_info_record()


class LinkedAdapter:
    """5'-anchored adapter followed by a 3' adapter; the 3' search only
    runs on reads where the 5' part matched."""

    def __init__(
        self,
        front_sequence,
        back_sequence,
        front_anchored=True,
        back_anchored=False,
        name=None,
        **kwargs,
    ):
        assert front_anchored and not back_anchored
        self.front_anchored = front_anchored
        self.back_anchored = back_anchored
        self.where = LINKED
        self.name = name if name is not None else next_adapter_name()
        self.front_adapter = Adapter(
            front_sequence,
            where=PREFIX if front_anchored else FRONT,
            name=None,
            **kwargs,
        )
        self.back_adapter = Adapter(
            back_sequence,
            where=SUFFIX if back_anchored else BACK,
            name=None,
            **kwargs,
        )

    def enable_debug(self):
        self.front_adapter.enable_debug()
        self.back_adapter.enable_debug()

    def match_to(self, read):
        front_match = self.front_adapter.match_to(read)
        if front_match is None:
            return None
        remainder = read[front_match.rstop :]
        back_match = self.back_adapter.match_to(remainder)
        return LinkedMatch(front_match, back_match, self)

    def trimmed(self, match):
        front_trimmed = self.front_adapter.trimmed(match.front_match)
        if match.back_match:
            return self.back_adapter.trimmed(match.back_match)
        return front_trimmed

    def summarize(self):
        front, back = self.front_adapter, self.back_adapter
        total_front = sum(front.lengths_front.values())
        total_back = sum(back.lengths_back.values())
        stats = MergingDict(
            total_front=total_front,
            total_back=total_back,
            total=total_front + total_back,
        )
        stats["where"] = where_int_to_dict(self.where)
        for prefix, part in (("front", front), ("back", back)):
            stats[prefix + "_sequence"] = Const(part.sequence)
            stats[prefix + "_match_probabilities"] = Const(
                part.random_match_probabilities()
            )
        stats["front_max_error_rate"] = Const(front.max_error_rate)
        stats["back_max_error_rate"] = Const(back.max_error_rate)
        for prefix, part in (("front", front), ("back", back)):
            stats[prefix + "_lengths_front"] = part.lengths_front
            stats[prefix + "_lengths_back"] = part.lengths_back
        for prefix, part in (("front", front), ("back", back)):
            stats[prefix + "_errors_front"] = part.errors_front
            stats[prefix + "_errors_back"] = part.errors_back
        return stats
