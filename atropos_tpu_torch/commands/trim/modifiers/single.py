"""Single-read modifiers: fixed cuts, quality trimming, name rewriting,
colorspace transforms, and bisulfite protocols.

Semantics per the reference (``atropos/commands/trim/modifiers.py``,
cited per class); the quality kernels have batched device counterparts in
:mod:`atropos_tpu_torch.align.batched` that these scalar forms specify.
"""
import re

from atropos_tpu_torch.commands.trim.modifiers.base import (
    Modifier,
    Trimmer,
    signed_cut_lengths,
)
from atropos_tpu_torch.commands.trim.qualtrim import (
    nextseq_trim_index,
    quality_trim_index,
)


class UnconditionalCutter(Trimmer):
    """``-u``: always cut fixed base counts off the ends
    (ref ``modifiers.py:565-590``)."""

    display_str = "Cut unconditionally"

    def __init__(self, lengths=None):
        super().__init__()
        self.front_length, self.back_length = signed_cut_lengths(lengths)

    def __call__(self, read):
        return self.clip(read, self.front_length, self.back_length)


class MinCutter(Trimmer):
    """``-i``: guarantee a minimum total cut at each end, crediting bases
    other stages already removed (ref ``modifiers.py:592-650``).

    ``count_trimmed`` credits adapter-trimmed bases and all clips;
    otherwise only clips that happened after adapter trimming count (or
    before, for reads with no adapter match). ``only_trimmed`` restricts
    cutting to reads that had an adapter match, on the matched side(s).
    """

    display_str = "Cut conditionally"

    def __init__(self, lengths=None, count_trimmed=True, only_trimmed=False):
        super().__init__()
        self.front_length, self.back_length = signed_cut_lengths(lengths)
        self.count_trimmed = count_trimmed
        self.only_trimmed = only_trimmed

    def _sides_to_cut(self, read):
        """(cut_front?, cut_back?) honoring only_trimmed."""
        if not self.only_trimmed:
            return True, True
        if not read.match:
            return False, False
        front_flags = [info.is_front for info in read.match_info]
        if not any(front_flags):
            return False, True
        if all(front_flags):
            return True, False
        return True, True

    def _credited(self, read, offset, is_front):
        """Bases already removed from this end that count toward the
        minimum. ``read.clipped`` is [front_before, back_before,
        front_after, back_after] relative to adapter trimming."""
        if self.count_trimmed:
            credit = read.clipped[offset] + read.clipped[offset + 2]
            if read.match:
                credit += sum(
                    info.rsize_total
                    for info in read.match_info
                    if info.is_front == is_front
                )
            return credit
        if read.match:
            return read.clipped[offset + 2]
        return read.clipped[offset]

    def __call__(self, read):
        cut_front, cut_back = self._sides_to_cut(read)
        if not (cut_front or cut_back):
            return read
        front = back = 0
        if cut_front:
            front = max(self.front_length - self._credited(read, 0, True), 0)
        if cut_back:
            back = min(self._credited(read, 1, False) + self.back_length, 0)
        return self.clip(read, front, back)


# -- quality-based trimming -----------------------------------------------------


class QualityTrimmer(Trimmer):
    """``-q``: BWA-style partial-sum quality trimming at either end
    (ref ``modifiers.py:732-756``; kernel ``_qualtrim.pyx:7-49``)."""

    display_str = "Quality-trimmed"

    def __init__(self, cutoff_front=0, cutoff_back=0, base=33):
        super().__init__()
        self.cutoff_front = cutoff_front
        self.cutoff_back = cutoff_back
        self.base = base

    def __call__(self, read):
        if len(read) == 0:
            return read
        start, stop = quality_trim_index(
            read.qualities, self.cutoff_front, self.cutoff_back, self.base
        )
        return self.subseq(read, start, stop)


class NextseqQualityTrimmer(Trimmer):
    """``--nextseq-trim``: 3' quality trim treating G as a dark cycle
    (ref ``modifiers.py:758-764``; kernel ``_qualtrim.pyx:52-84``)."""

    display_str = "Quality trimmed (NextSeq)"

    def __init__(self, cutoff=0, base=33):
        super().__init__()
        self.cutoff = cutoff
        self.base = base

    def __call__(self, read):
        if len(read) == 0:
            return read
        return self.subseq(read, end=nextseq_trim_index(read, self.cutoff, self.base))


class NEndTrimmer(Trimmer):
    """``--trim-n``: strip N runs off both ends (ref ``modifiers.py:766-784``)."""

    display_str = "End Ns trimmed"

    _LEADING = re.compile(r"^N+")
    _TRAILING = re.compile(r"N+$")

    def __call__(self, read):
        if len(read) == 0:
            return read
        seq = read.sequence
        head = self._LEADING.match(seq)
        tail = self._TRAILING.search(seq)
        return self.subseq(
            read,
            head.end() if head else 0,
            tail.start() if tail else len(read),
        )


# -- read-name modifiers ---------------------------------------------------------


class LengthTagModifier(Modifier):
    """``--length-tag``: refresh 'length=N' tags after trimming
    (ref ``modifiers.py:652-665``)."""

    def __init__(self, length_tag="length="):
        self.length_tag = length_tag
        self.regex = re.compile(r"\b" + length_tag + r"[0-9]*\b")

    def __call__(self, read):
        read = read[:]
        if self.length_tag in read.name:
            read.name = self.regex.sub(
                self.length_tag + str(len(read.sequence)), read.name
            )
        return read


class SuffixRemover(Modifier):
    """``--strip-suffix`` (ref ``modifiers.py:667-678``)."""

    def __init__(self, suffixes=None):
        self.suffixes = list(suffixes or ())

    def __call__(self, read):
        read = read[:]
        name = read.name
        for suffix in self.suffixes:
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        read.name = name
        return read


class PrefixSuffixAdder(Modifier):
    """``-x``/``-y``: decorate names; '{name}' expands to the matched
    adapter (ref ``modifiers.py:680-695``)."""

    def __init__(self, prefix="", suffix=""):
        self.prefix = prefix
        self.suffix = suffix

    def __call__(self, read):
        read = read[:]
        adapter = read.match.adapter.name if read.match else "no_adapter"
        read.name = "".join(
            (
                self.prefix.replace("{name}", adapter),
                read.name,
                self.suffix.replace("{name}", adapter),
            )
        )
        return read


# -- colorspace -------------------------------------------------------------------


class DoubleEncoder(Modifier):
    """``-d``: re-encode colorspace digits as bases (ref ``modifiers.py:697-706``)."""

    _TRANS = str.maketrans("0123.", "ACGTN")

    def __call__(self, read):
        read = read[:]
        read.sequence = read.sequence.translate(self._TRANS)
        return read


class ZeroCapper(Modifier):
    """``-z``: clamp negative colorspace qualities to zero
    (ref ``modifiers.py:708-719``)."""

    def __init__(self, quality_base=33):
        floor = chr(quality_base)
        self._trans = str.maketrans(
            {chr(code): floor for code in range(quality_base)}
        )

    def __call__(self, read):
        read = read[:]
        read.qualities = read.qualities.translate(self._trans)
        return read


class PrimerTrimmer(Trimmer):
    """``--trim-primer`` (ref ``modifiers.py:721-730``)."""

    display_str = "Primer-trimmed"

    def __call__(self, read):
        read = self.clip(read, 1)
        read.primer = ""
        return read


# -- bisulfite protocols -----------------------------------------------------------


class RRBSTrimmer(MinCutter):
    """RRBS: adapter-trimmed reads lose 2 extra 3' bp (filled-in cytosines;
    ref ``modifiers.py:786-798``)."""

    display_str = "RRBS-trimmed"

    def __init__(self, trim_5p=0, trim_3p=2):
        super().__init__(
            (trim_5p, -trim_3p), count_trimmed=False, only_trimmed=True
        )


class NonDirectionalBisulfiteTrimmer(Modifier):
    """Non-directional protocol: C[AG]A-starting reads lose 5' bases;
    others optionally get RRBS treatment (ref ``modifiers.py:800-836``)."""

    display_str = "Bisulfite-trimmed (Non-directional)"

    _CAA_CGA = re.compile(r"^C[AG]A")

    def __init__(self, trim_5p=2, trim_3p=2, rrbs=False):
        self._front_cutter = MinCutter(
            [trim_5p], count_trimmed=False, only_trimmed=False
        )
        self.rrbs = rrbs
        self._rrbs_cutter = RRBSTrimmer(trim_3p) if rrbs else None

    def __call__(self, read):
        if len(read) == 0:
            return read
        if self._CAA_CGA.match(read.sequence):
            return self._front_cutter(read)
        if self._rrbs_cutter is not None:
            return self._rrbs_cutter(read)
        return read

    def summarize(self):
        trimmed = self._front_cutter.trimmed_bases
        if self._rrbs_cutter is not None:
            trimmed += self._rrbs_cutter.trimmed_bases
        return dict(bp_trimmed=trimmed)


class TruSeqBisulfiteTrimmer(MinCutter):
    """EpiGnome/TruSeq: at least 6 bp off the 5' end (ref ``modifiers.py:838-845``)."""

    display_str = "Bisulfite-trimmed (EpiGnome/TruSeq)"

    def __init__(self):
        super().__init__((6,), count_trimmed=True, only_trimmed=False)
