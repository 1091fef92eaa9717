"""Modifier protocol: a modifier transforms one read (or one pair) and
tracks what it did for the run summary.

Trimming modifiers operate through ``Sequence.subseq``/``Sequence.clip``
so the read's provenance fields (``clipped``) stay correct — downstream
modifiers (MinCutter) and the info-file formats depend on them.
"""


class Modifier:
    """A callable over a single read."""

    @property
    def name(self):
        return self.__class__.__name__

    @property
    def description(self):
        return getattr(self, "display_str", self.name)

    def summarize(self):
        return {}


class ReadPairModifier(Modifier):
    """A callable over (read1, read2), returning the new pair."""

    def __call__(self, read1, read2):
        raise NotImplementedError()


class Trimmer(Modifier):
    """A modifier that removes bases, accounting them in ``trimmed_bases``."""

    def __init__(self):
        self.trimmed_bases = 0

    def __call__(self, read):
        raise NotImplementedError()

    def subseq(self, read, begin=0, end=None):
        """Keep read[begin:end], tallying what falls off."""
        if not begin and end is None:
            return read
        front_bases, back_bases, trimmed = read.subseq(begin, end)
        self.trimmed_bases += front_bases + back_bases
        return trimmed

    def clip(self, read, front=0, back=0):
        """Remove ``front`` leading and ``-back`` trailing bases."""
        if not (front or back) or len(read) == 0:
            return read
        front_bases, back_bases, clipped = read.clip(front, back)
        self.trimmed_bases += front_bases + back_bases
        return clipped

    def summarize(self):
        return dict(bp_trimmed=self.trimmed_bases)


def signed_cut_lengths(lengths):
    """Split a list of signed cut lengths into (front_total, back_total);
    positive values cut from the 5' end, negative from the 3' end."""
    front = back = 0
    for value in lengths or ():
        if value > 0:
            front += value
        else:
            back += value
    return front, back
